"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. the card's name and power limit, torch and CUDA versions;
  2. build the CUDA kernels from csrc/ (one nvcc per source, together);
  3. each kernel against its plain PyTorch version on synthetic inputs,
     edge cases included, and split_mega, the partition and leaf_hist
     (the range and both children of its partition) on the cases their
     tile-compacted partition and fixed-point histograms risk most (start
     at every offset mod 16, counts around one tile, one row, a leaf
     ending at N_pad, one bin, |grad| ~ 1e4, a child of no rows) and over
     20 launches; leaf_hist's state launch (the histogram-state update
     hist_rmw, folded into it) bit-identical to its plain twin on the
     root, small left / small right, wa == wb, a child of no rows and a
     child at each offset mod 16, the larger child's slot equal to a
     direct fixed-point histogram of its rows;
  4. train the HIGGS shape (10.5M x 28, seed 7, as bench.py makes it;
     binary, num_leaves=255, max_bin=255) for a few iterations through
     lightgbm_tpu_torch on the card, on each of the learner's two split
     paths in turn -- the mega path (split_mega + split_pair) and the
     histogram-subtraction path (tpu_megakernel=off: partition +
     leaf_hist with the state epilogue + split_pair), each step's
     bookkeeping by tree_step, every tree one replay of a captured CUDA
     graph -- from one constructed Dataset.  Per path: the eager oracle
     (build_tree_eager, the host loop) grows the first tree and its
     kernel calls' inputs are captured for phase 5 (on the subtraction
     path every split's larger-child slot is checked against a direct
     fixed-point histogram of its rows); every wrapper's launch count
     is set to 0, the graph loop trains under torch.profiler, and the
     counts are read: each wrapper ran twice (the run that sizes
     everything before the capture, then the capture), and each device
     function of the path's kernels launched, by the profiler's kernel
     events, as often as the graph holds it times the trees, plus that
     first run; the graph
     loop's first tree bit-identical to the oracle's (leafmat, nodemat,
     the row order of both row buffers); one host sync a tree, and an
     iteration under torch.cuda.set_sync_debug_mode("error") makes no
     implicit one.  Then predict 100k rows, save, reload and predict
     again; profile one more iteration (each kernel's device time and
     launches beside its per-iteration bound; every device function of
     the path's kernels must show device time) for the busy share;
     tree_step against tree_step_plain on the root, 12 steps and the
     final commit of a real tree; the device time by graph replay of a
     whole step of a stopped tree and of each split kernel on a 1024-row
     leaf with its grid sized for the leaf and for the root's rows; and
     the port on the card against the port on the CPU on
     examples/binary_classification (and how examples/regression's
     exactly-empty-bin ties fall on the subtraction path);
  4b. the frontier (tpu_frontier_k=4, then the auto K) on the mega path
     at the HIGGS shape: each tree bit-identical to the K=1 graph loop's
     (leafmat, nodemat, both row buffers), and on
     examples/binary_classification at 12 leaves, where the replay prunes
     speculative splits, bit-identical to K=1 on the card; every
     wrapper's count set to 0 before and read after, the device launches
     by function from torch.profiler's kernel events equal to what the
     graph's steps taken hold (the IF nodes of the steps a tree stopped
     before launch nothing; this profiled run goes first, in a child
     process, ``--frontier-window``: the profiler names a conditional
     graph's kernels right only in a process's first window), one host
     sync a tree; the bookkeeping kernel
     bit-identical to frontier_step_plain on every state of the first
     tree, the key row and the undo (of a leaf partitioned on purpose)
     equal to their plain versions and the undo to the rows before the
     partition, split_pair over the 2K children equal to its plain
     version; their times (the bookkeeping's by CUDA events, launched
     alone on the states of the launches the graph takes in that tree,
     queued back to back), a stopped
     step's, and ms an iteration beside K=1's;
  4c. the training API on the card at the HIGGS shape with the UCI
     split's held-out rows (11M rows made, the last 500,000 a validation
     set; binary_logloss, auc, binary_error): on each body (mega K=1,
     mega auto, subtraction) 8 iterations of lgt.train without and with
     the validation set (record_evaluation, early_stopping(50)), every
     wrapper's count set to 0 before the validation run and read after
     it, each kernel of the body launched; the validation scores against
     a fresh raw prediction (atol 1e-5), every recorded metric against a
     numpy float64 evaluation of the card's scores after that iteration
     (rtol 1e-6 logloss, 1e-9 auc and error), one tree read a tree, the
     trees bit-identical to the run without the validation set, and
     s/iteration with and without it, the validation update's device ms a
     tree (torch.profiler); early stopping on
     examples/binary_classification loaded from its text files, the card
     against the CPU (best iteration, trees, eval history rtol 1e-5); a
     numpy binary objective on the HIGGS rows against the built-in one
     (first tree, train scores from the physical order against predict);
     3 trees saved and 3 more from the file with the validation set
     (train and valid scores against predict, atol 1e-5);
  4d. (4d, 4e and 4f run after 4b, before 4c) row and feature sampling at
     the HIGGS shape: bagging 0.8 / freq 1,
     GOSS at its defaults and feature_fraction 0.8, beside the unsampled
     run, on the mega path (auto: the frontier at K=4) and the subtraction
     path, 4 iterations each: one graph capture per learner for every
     draw (the bag count is a device word), one tree read a tree, each
     tree's root counting the rows the sampling pass kept (the learner's
     bag word, the payload's nonzero hessians), sample launched once an
     iteration, logloss falling; sample.cu bit-identical to sample_plain
     at full size in each mode (payload words and in-bag count); its ms a
     launch beside the plain version's and a torch.rand of the same
     length, and the GOSS threshold's (torch.topk);
  4e. EFB bundles: 2,000,000 rows (cut from 10.5M for the host's dense
     f32 matrix and binning) of HIGGS' 28 features and 8 categoricals of
     32 levels one-hot encoded (F = 284): the groups (28 dense, 8 bundles
     of 32 indicators), the bundled body (subtraction, K=1, feat_view
     between the state update and the pair search) with its first tree
     bit-identical to the eager oracle's, every wrapper's count set to 0
     before 4 profiled iterations and read after, the device launches by
     function, one capture, one tree read a tree, logloss falling; the
     trees against enable_bundle=False on the subtraction path (equal, or
     the first difference an exact tie in f64); feat_view and split_pair
     at F = 284 bit-identical to their plain versions on 13 states of a
     real tree, with their times; s/iteration and device ms;
  4f. categorical features (in a child process, ``--cat``: its
     profiled launch counts, as the frontier window's, are read in a
     process that made no profile before): 4e's 2,000,000 rows with the
     8 categoricals as integer columns (``categorical_feature``) and two
     more of 3 and 200 levels (F = 38): the learner on the subtraction
     body at K=1 with split_cat after the pair search; the first tree
     bit-identical to the eager oracle's (category sets and row order
     included), with
     one-vs-rest and sorted-arm categorical nodes; on a 500,000-row cut
     the card's first tree equal to the CPU plain loop's (or its first
     difference an exact tie in f64); every
     wrapper's count set to 0 before 4 profiled iterations and read after,
     the device launches by function, one capture, one tree read a tree,
     logloss falling; split_cat bit-identical to split_cat_plain on every
     launch of a tree and the partition of categorical steps to
     partition_leaf_plain; 100,000 rows with NaN, negative, unseen and
     non-integer categories predicted as the host Tree.predict, again
     after a save and reload; split_cat's ms a launch; s/iteration beside
     4e's one-hot run;
  4g. (after 4d) the other objectives on the HIGGS rows and bins, two
     new labels (a fixed linear combination of the features plus seeded
     noise, and its quintiles): quantile (alpha 0.9, leaves renewed) 4
     iterations and multiclass (5 classes) 3 on each body,
     multiclassova 2 on the mega path, binary beside them: the metric
     falling every iteration, every wrapper's count set to 0 before a
     run and the body's kernels launched, one capture and one tree read
     a tree, save / reload / predict bit-identical ((100k, 5) for 5
     classes), the card's renewal bit-identical to its run on the host on
     the same inputs, the first iteration's trees against the CPU plain
     loop's on a 200,000-row cut (the same partitions, or a first
     difference within the CPU's f32 resolution; quantile's renewed
     values equal, the card's class-tree values -G / H of their rows in
     f64); s/iteration and device ms an iteration beside binary's, the
     renewal's device ms a tree, the class gather / scatter's and the
     5-class gradients' ms;
  4h. (after 4f) wide bins, uint16 bin matrices: the HIGGS shape at
     max_bin 1023 (a 588 MB uint16 matrix) on the subtraction body at K=1
     beside the same run at max_bin 255, 4 iterations and a profiled one
     each, every wrapper's count set to 0 before a run and read after it,
     each kernel's ms an iteration beside its bound (the bin bytes
     doubled), logloss falling; 4e's rows with 4f's categoricals, a
     categorical of 1,000 levels (the uint16 matrix comes from that
     column) and 4 one-hot columns that bundle: split_cat past 256 bins
     with sets of more than 8 words and feat_view at Bp > 256 on the
     main path, the first tree equal to the eager oracle's, on a
     200,000-row cut the card's first tree equal to the CPU's (or its
     first difference an exact tie in f64), save / reload / predict bit
     for bit; on the root and 8 steps of a real tree of each, every
     uint16 and wide kernel (the partition, the state launch, split_pair
     at BF = 1024, split_cat, feat_view, tree_step at W = 32 and 31 set
     words) bit-identical to its plain version, and its ms a launch; the
     wide histogram arm (max_bin 16383, one group's planes past a block's
     shared memory) on 500,000 rows x 4 against its plain version and
     through a short training;
  4i. (after 4h) quantized-gradient training (``use_quantized_grad``,
     4 bins) at the HIGGS shape on the mega body (auto: K=4) and the
     subtraction body: float, quantized and quantized with
     ``quant_train_renew_leaf``, 4 iterations each, every wrapper's count
     set to 0 before a run and read after it (the body's kernels, and
     ``quantize`` once an iteration), one capture and one tree read a
     tree, logloss falling; s/iteration, device ms an iteration and the
     training AUC beside the float run; ``quantize`` bit-identical to
     quantize_plain on each quantized run's first call, and its ms a
     launch beside its bound, its plain version and torch.rand with the
     elementwise operations; split_mega's and leaf_hist's scale arms on
     the quantized runs' payloads bit-identical to their plain twins,
     timed beside their unscaled launches; on a 200,000-row cut (L2 from
     a zero score) the card's carriers and trees equal the CPU plain
     loop's, or part at an exact tie of the carriers' f64 gains; 3-class
     multiclass with bagging (the eager draws); a pandas frame of 500,000
     rows with bundling one-hot columns, a category and a bool column
     through feat_view (its scale arm against its twin) and split_cat,
     its model text's pandas_categorical reloaded;
  4j. (after 4, before 4b) monotone constraints at the HIGGS shape
     (``monotone_constraints`` the sign of make_data's weight on the
     first 8 features): the unconstrained subtraction run, ``basic``,
     ``intermediate`` and ``basic`` with ``monotone_penalty`` 1, 4
     iterations each, every wrapper's count set to 0 before a run and
     read after it, one capture and one tree read a tree, logloss
     falling; s/iteration and device ms (a profiled iteration), whose
     device launches by function equal what the graph holds; every new
     arm and kernel (split_pair's monotone arm, tree_step's commit and
     election with the bin boxes, mono_refresh, mono_planes,
     mono_overlay) bit-identical to its plain twin on 6 refreshes of a
     real tree, and its ms a launch beside its bound; the monotonicity
     sweep on 1,000 rows of the basic and intermediate models; on a
     200,000-row cut (quantized L2 from a zero score, 63 leaves,
     intermediate, penalty 1) the card's first tree equals the CPU's bit for
     bit; 4i's frame of 500,000 rows (bundles, a category, a bool)
     intermediate and quantized: split_cat's clamp arm and the bundled
     planes against their twins, split_cat over the L leaves timed;
  4k. (a process of its own, started with the run: it makes and bins
     its data and runs its CPU side on the host meanwhile, and waits to
     be released onto the card after phase 4f) learning to rank at the
     MSLR-WEB30K shape: a
     seeded synthetic set of 3,771,125 rows x 136 dense features in
     31,531 queries (up to 2,048 documents), graded labels 0-4;
     lambdarank, 255 leaves, ndcg@10, 4 iterations on the mega path
     (auto: the frontier at K=4, G = 136) and on the subtraction path:
     every wrapper's count set to 0 before a run and each kernel of the
     body launched, one capture and one tree read a tree, NDCG@10 rising
     and within 1e-6 of a numpy f64 evaluation of the card's scores, the
     lambdas' ms an iteration (CUDA events) and share, one profiled
     iteration (each kernel's ms beside its bound, the busy share); on a
     200,000-row cut of whole queries (the 2,048-wide bucket in chunks)
     the card's lambdas against the CPU's (rtol 1e-5 / atol 1e-6), the
     first tree against the CPU's (``tree_tie``), and 3 iterations each
     of rank_xendcg and of lambdarank with positions, NDCG rising;
  4l. (after 4i) DART, random forest, the eager iteration and rollback
     on the HIGGS rows and Dataset of phase 4 (binary, 255 leaves): DART
     (``drop_rate`` 0.3, ``skip_drop`` 0, ``max_drop`` 50) 10 iterations
     on the mega body (auto: K=4) and the subtraction body beside GBDT's
     10 on the same body, the dropped count each iteration, s/iteration
     (median of 2-9), the walks of past trees (CUDA events) a walk and an
     iteration, the device's busy share of a profiled iteration; RF
     (bagging 0.632, ``feature_fraction`` 0.8) 10 iterations, the
     training AUC each; ``tpu_fused_iteration=false`` with bagging 0.7
     beside the fused run; GOSS with ``regression_l1`` on 4g's continuous
     label, the renewal's ms a tree; rollback (5 iterations, 2 rolled
     back: the scores within 1e-6 of a 3-iteration run's, the trees
     equal); each run's body kernels launched (counts set to 0 before
     it), one capture and one tree read a tree; a saved DART and a saved
     RF model reloaded predict bit for bit; on a 200,000-row cut at 63
     leaves the card against the CPU plain loop for DART, RF, eager
     bagging and GOSS with L1, quantized (both sum exact integer
     carriers): DART's
     drop sets equal, the trees equal up to an exact tie (``tree_tie``)
     and, with none, the scores within atol 1e-5;
     ``python3 chip_smoke.py --boost`` runs it alone;
  4m. (after 4l) linear trees (``linear_tree``) at the HIGGS shape:
     regression on 4g's continuous label (a linear combination of the
     features plus noise), phase 4's bins with 1% of the rows NaN in
     each of three features (rebinned by their mappers) and the raw f32
     rows on the card: ``linear_tree_mode`` refit 10 iterations on the
     mega body (auto: K=4) and the subtraction body beside GBDT's 10 on
     the same body, s/iteration (median of 2-9), the leaf fit's and the
     linear score update's ms a tree (CUDA events), the leaves by fit
     status, a profiled iteration's busy share, the iteration's peak
     memory; leafwise_gain 10 iterations (the subtraction body at K=1:
     the linear search in the graph), the search's ms a split (graph
     replay: CUDA events, and device ms and launches by torch.profiler);
     training
     L2 falling every iteration; each run's body kernels launched (counts
     set to 0 before it), one capture and one tree read a tree; 100,000
     rows predicted (NaN rows at their leaves' constant values) within
     1e-5 of the train scores and 1e-9 of the host trees' f64 oracle, bit
     for bit after a save and reload; on a quantized 200,000-row cut at
     63 leaves the card against the CPU plain loop (refit at K=4,
     leafwise_gain), the trees equal up to an exact tie (``tree_tie``)
     and the linear leaves within rtol 1e-4 / atol 1e-5;
     ``python3 chip_smoke.py --linear`` runs it alone;
  5. each kernel against its plain version on inputs captured from the
     first tree of its path, through its host-int entry and through the
     step entry the graph loop launches (a step block made beforehand,
     the grid sized for the HIGGS rows), and its time at those shapes
     (the step entry by graph replay) beside the least time the card
     could take for the same work;
  6. python -m lightgbm_tpu_torch.bench at BENCH_ROWS=2000000
     BENCH_REPEATS=2 BENCH_ITERS=5 (the mega path at K 1, 2, 4, 8, then
     the subtraction path), its JSON lines printed.
The line before the last is a JSON object of per-kernel numbers; the
last line is {"ok": true, "device": {...}}.

    python3 chip_smoke.py --digest

trains the HIGGS shape 2 iterations on each body and prints a sha256 of
the trees and row buffers a body, to compare two checkouts on one card;
``python3 chip_smoke.py --wide`` runs phase 4h alone, ``--efb`` phase 4e
alone, ``--quant`` phase 4i alone, ``--mono`` phase 4j alone, ``--rank``
phase 4k alone, ``--boost`` phase 4l alone, ``--linear`` phase 4m alone.
"""

import atexit
import contextlib
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
ROWS, FEATURES, ITERS = 10_500_000, 28, 4
PEAK_BYTES_S = 3.35e12          # H100 SXM HBM3
PEAK_F32_S = 67e12              # H100 SXM f32 outside the tensor cores
NAN_WORD = 0x7FC00001           # a NaN payload whose bits a float move
#                                 could rewrite
T0 = time.time()


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def say(msg):
    print(f"[{time.time() - T0:7.1f} s] {msg}", flush=True)


def make_data(rows, weights=False):
    """bench.py _make_data: HIGGS-shaped synthetic binary data; with
    ``weights`` its (FEATURES,) weight vector too."""
    rng = np.random.RandomState(7)
    X = rng.normal(size=(rows, FEATURES)).astype(np.float32)
    w = rng.normal(size=FEATURES)
    logit = X.dot(w) * 0.5
    y = (logit + rng.normal(size=rows) > 0).astype(np.float32)
    return (X, y, w) if weights else (X, y)


def cuda_ms(fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_ms(fn, reps):
    """Device time per call of a kernel shorter than the host's launch
    interval: reps calls captured in one CUDA graph, timed on replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def queued_ms(calls, spin_cycles=200_000_000):
    """(device ms summed over the calls, number of calls) for one-shot
    launches that cannot be repeated on the same state.  The calls are
    queued behind a device spin, each between two CUDA events, so the card
    runs them back to back and the events see no host launch cost; the
    spin doubles until the host has queued every call before it ends."""
    for _ in range(4):
        torch.cuda.synchronize()
        spun = torch.cuda.Event()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in calls]
        torch.cuda._sleep(spin_cycles)
        spun.record()
        for (e0, e1), call in zip(ev, calls):
            e0.record()
            call()
            e1.record()
        drained = spun.query()
        torch.cuda.synchronize()
        if not drained:
            return sum(e0.elapsed_time(e1) for e0, e1 in ev), len(calls)
        spin_cycles *= 2
    raise RuntimeError("queued_ms: the host could not queue the calls "
                       "within the device spin")


def bound(nbytes, ops):
    """(least ms on the card, what bounds it) for nbytes moved and ops f32
    operations."""
    tb, to = nbytes / PEAK_BYTES_S, ops / PEAK_F32_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def hist_excess(h, ref, mass, rtol, atol):
    """How far |h - ref| exceeds rtol*|ref| + atol*mass (<= 0 passes):
    f32 sums err in proportion to the bins' absolute mass, so the
    tolerance scales with it."""
    ref = ref.to(torch.float64)
    err = (h.to(torch.float64) - ref).abs()
    return float((err - rtol * ref.abs() - atol * mass).max())


def check_mega(sm, pb, pg, sc, B, G, what, absmax=None, runs=2):
    """Kernel vs plain on the card: the partition (bins, payload words,
    left count) bit-identical to the plain version; the kernel's
    fixed-point histogram bit-identical to hist_fixed_plain (integer sums
    are exact in any order), within rtol 1e-4 / atol 1e-5 x bin mass of
    the f64 sums, and within rtol 1e-4 / atol 1e-4 x bin mass of the
    plain version's f32 sums (whose own rounding grows with the rows per
    bin); ``runs`` kernel launches bit-identical."""
    outs = []
    for _ in range(runs):
        b, g = pb.clone(), pg.clone()
        nl, acc = sm.split_mega(b, g, sc, num_bins=B, num_groups=G,
                                absmax=absmax)
        outs.append((b, g, nl, acc))
    b0, g0 = pb.clone(), pg.clone()
    ref, mass = sm.hist_reference(b0, g0, sc, num_bins=B, num_groups=G)
    fixed = sm.hist_fixed_plain(b0, g0, sc, num_bins=B, num_groups=G,
                                absmax=absmax)
    enl, eacc = sm.split_mega_plain(b0, g0, sc, num_bins=B, num_groups=G)
    torch.cuda.synchronize()
    for b, g, nl, acc in outs:
        check(int(nl) == int(enl), f"{what}: left count {int(nl)} vs "
                                   f"{int(enl)}")
        check(torch.equal(b, b0), f"{what}: bins differ")
        check(torch.equal(g.view(torch.int32), g0.view(torch.int32)),
              f"{what}: payload differs")
        check(torch.equal(acc.view(torch.int32), fixed.view(torch.int32)),
              f"{what}: histogram differs from hist_fixed_plain")
        ex = hist_excess(acc, ref, mass, 1e-4, 1e-5)
        check(ex <= 0, f"{what}: histogram off the f64 sums by {ex}")
        ex = hist_excess(acc, eacc, mass, 1e-4, 1e-4)
        check(ex <= 0, f"{what}: histogram off the plain version by {ex}")
    ref = ref.to(torch.float64)
    return {"vs_plain": float((outs[0][3] - eacc).abs().max()),
            "kernel_vs_f64": float((outs[0][3].double() - ref).abs().max()),
            "plain_vs_f64": float((eacc.double() - ref).abs().max()),
            "max_abs_bin": float(ref.abs().max()),
            "max_bin_mass": float(mass.max())}


def check_partition(tpart, pb, pg, sc, what):
    """Kernel vs plain on the card: bins, all 8 payload rows as words and
    the left count bit-identical.  Returns the kernel's partitioned
    buffers and left count, and the largest difference (0)."""
    b, g = pb.clone(), pg.clone()
    nl = tpart.partition_leaf(b, g, sc)
    b0, g0 = pb.clone(), pg.clone()
    enl = tpart.partition_leaf_plain(b0, g0, sc)
    torch.cuda.synchronize()
    check(int(nl) == int(enl), f"{what}: left count {int(nl)} vs {int(enl)}")
    err = max(float((b.int() - b0.int()).abs().max()) if b.numel() else 0.0,
              float((g.view(torch.int32).long()
                     - g0.view(torch.int32).long()).abs().max()))
    check(err == 0.0, f"{what}: bins or payload words differ by {err}")
    return b, g, nl, err


def risk_cases(T, n_pad):
    """Scalars (start, cnt, col, bstart, isb, nb, dbin, mtype, thr, dl)
    and buffer variant of the cases that the tile-compacted partition and
    the fixed-point histogram are most likely to get wrong."""
    def c(start, cnt, thr=120):
        return (start, cnt, 5, 0, 0, 255, 0, 0, thr, 1)
    out = {f"offset {o}": (c(4096 + o, 5000), None) for o in range(16)}
    for d in (-1, 0, 1):
        out[f"tile{d:+d}"] = (c(4096, T + d), None)
        out[f"unaligned tile{d:+d}"] = (c(4096 + 9, T + d), None)
    out["one row"] = (c(4096 + 7, 1), None)
    out["ends at N_pad"] = (c(n_pad - 3005, 3005), None)
    out["one bin"] = (c(4096 + 1, 300_000), "one_bin")
    out["all left, |grad| ~ 1e4"] = (c(4096 + 2, 300_000, 255), "scale")
    out["all right, |grad| ~ 1e4"] = (c(4096 + 2, 300_000, -1), "scale")
    out["|grad| ~ 1e4"] = (c(4096 + 2, 300_000), "scale")
    return out


def variant_buffers(variant, pb, pg):
    """The synthetic buffers, or a variant: every group but the split
    column in one bin (the most colliding adds), or grad and hess at
    regression scale (|grad| ~ 1e4)."""
    if variant == "one_bin":
        vb = torch.full_like(pb, 7)
        vb[5] = pb[5]
        return vb, pg
    if variant == "scale":
        vg = pg.clone()
        vg[:2] *= 1e4
        vg[1].abs_()
        return pb, vg
    return pb, pg


def check_leaf_hist(th, pb, pg, start, cnt, child, B, G, what, absmax=None,
                    runs=2):
    """Kernel vs plain on the card: the kernel's fixed-point histogram
    bit-identical to leaf_hist_fixed_plain with the same bound (integer
    sums are exact in any order) and within rtol 1e-4 / atol 1e-5 x bin
    mass of the f64 sums of leaf_hist_reference; the plain version (f64
    sums rounded once, what the CPU runs) within the same bar; ``runs``
    kernel launches bit-identical."""
    kw = dict(num_bins=B, num_groups=G, child=child, planes=True)
    outs = [th.leaf_hist(pb, pg, start, cnt, absmax=absmax, **kw)
            for _ in range(runs)]
    ref, mass = th.leaf_hist_reference(pb, pg, start, cnt, num_bins=B,
                                       num_groups=G, child=child)
    fixed = th.leaf_hist_fixed_plain(pb, pg, start, cnt, absmax=absmax, **kw)
    plain = th.leaf_hist_plain(pb, pg, start, cnt, **kw)
    torch.cuda.synchronize()
    for h in outs:
        check(torch.equal(h.view(torch.int32), fixed.view(torch.int32)),
              f"{what}: histogram differs from leaf_hist_fixed_plain")
    for h in (outs[0], plain):
        ex = hist_excess(h, ref, mass, 1e-4, 1e-5)
        check(ex <= 0, f"{what}: histogram off the f64 sums by {ex}")
    return {"vs_plain": float((outs[0] - plain).abs().max()),
            "kernel_vs_f64": float((outs[0].double() - ref).abs().max()),
            "plain_vs_f64": float((plain.double() - ref).abs().max()),
            "max_abs_bin": float(ref.abs().max()),
            "max_bin_mass": float(mass.max())}


def check_exact(th, pb, pg, start, cnt, k, state, what):
    """The invariant the int64 histogram state buys, after a fused call
    with keywords ``k``: each slot it wrote equals the direct fixed-point
    sums of that leaf's own rows at the tree's scale, bit for bit (for a
    split, the larger child's slot is parent minus smaller)."""
    parent, wa, wb, sil = k["idx"]
    kw = dict(num_bins=k["num_bins"], num_groups=k["num_groups"],
              absmax=k["absmax"], kcnt=k["kcnt"])
    if parent < 0:
        want = {wa: th.leaf_hist_fixed_sums(pb, pg, start, cnt, **kw)[0]}
    else:
        nl = k["child"][0]
        want = {slot: th.leaf_hist_fixed_sums(pb, pg, start, cnt,
                                              child=(nl, side), **kw)[0]
                for side, slot in ((0, wa), (1, wb)) if side or wa != wb}
    for slot, sums in want.items():
        check(torch.equal(state[slot], sums),
              f"{what}: slot {slot} differs from the direct fixed-point "
              f"sums of its rows")


def check_fused(hs, th, pb, pg, start, cnt, k, state, what, exact=True):
    """leaf_hist's state launch vs its plain twin on the card: the int64
    state and the f32 children bit-identical to leaf_hist_rmw_fixed_plain
    (the twin's fixed-point histogram at the tree's scale, then
    hist_rmw_fixed_plain); with ``exact``, the slots it wrote equal the
    direct sums of their rows (the parent slot must hold the parent's
    sums).  ``state`` is left as the launch leaves it.  Returns the
    largest difference of the children (0)."""
    st0 = state.clone()
    ch = hs.leaf_hist_rmw(pb, pg, start, cnt, state=state, **k)
    ch0 = hs.leaf_hist_rmw_fixed_plain(pb, pg, start, cnt, state=st0, **k)
    torch.cuda.synchronize()
    check(torch.equal(state, st0), f"{what}: int64 state differs from "
                                   f"leaf_hist_rmw_fixed_plain")
    check(torch.equal(ch.view(torch.int32), ch0.view(torch.int32)),
          f"{what}: children differ from leaf_hist_rmw_fixed_plain")
    if exact:
        check_exact(th, pb, pg, start, cnt, k, state, what)
    return float((ch - ch0).abs().max())


def fused_cases(hs, th, tpart, make_scalars, pb, pg, B, G):
    """The state launch on synthetic leaves: the root launch (no parent)
    into the parent slot, the partition, then the smaller child's launch
    -- small left and small right, into wa == wb, a child of no rows
    (all left / all right), and a child at each offset mod 16."""
    kcnt = pb.shape[1]                  # the tree's root count
    absmax = pg[:2].abs().amax(dim=1)
    cases = {
        "small left": (4096, 300_000, 120, 0, (2, 2, 5, 1)),
        "small right": (4096, 300_000, 120, 1, (2, 2, 5, 0)),
        "wa == wb, small left": (4096 + 3, 300_000, 120, 0, (2, 7, 7, 1)),
        "wa == wb, small right": (4096 + 3, 300_000, 120, 1, (2, 7, 7, 0)),
        "right child of no rows": (4096 + 5, 5000, 255, 1, (2, 2, 5, 0)),
        "left child of no rows": (4096 + 5, 5000, -1, 0, (2, 2, 5, 1)),
    }
    cases.update({f"offset {o}": (4096 + o, 5000, 120, o % 2,
                                  (2, 2, 5, 1 - o % 2)) for o in range(16)})
    err = 0.0
    for what, (start, cnt, thr, side, idx) in cases.items():
        b, g = pb.clone(), pg.clone()
        state = hs.new_state(8, G, B, pb.device)
        k = dict(num_bins=B, num_groups=G, absmax=absmax, kcnt=kcnt)
        err = max(err, check_fused(hs, th, b, g, start, cnt,
                                   dict(k, idx=(-1, idx[0], idx[0], 0)),
                                   state, f"leaf_hist_rmw {what} root"))
        nl = tpart.partition_leaf(b, g, make_scalars(start, cnt, 5, 0, 0,
                                                     255, 0, 0, thr, 1))
        err = max(err, check_fused(hs, th, b, g, start, cnt,
                                   dict(k, idx=idx, child=(nl, side)),
                                   state, f"leaf_hist_rmw {what}"))
    return len(cases), err


def bits_err(got, want):
    """The largest difference of two tensors' bit views, as integers."""
    if got.numel() == 0:
        return 0.0
    w = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
         8: torch.int64}[got.element_size()]
    return float((got.view(w).long() - want.view(w).long()).abs().max())


def check_step_entries(tpart, sm, hs, cap, bound_rows, dev):
    """The captured calls of the first trees again, each through the step
    entry the graph loop launches: a step block made beforehand, grids and
    scratch sized for ``bound_rows`` (the learner's bound, the root's
    rows).  Against the plain and fixed-point twins bit for bit: the
    partition (bins, payload words, left count), split_mega's histogram,
    leaf_hist's int64 state and f32 children; the step block's error
    word stays 0.  Returns the largest bit difference of each."""
    err = {"split_mega": 0.0, "partition": 0.0, "leaf_hist": 0.0}

    def moved(what, step, b, g, nl, b0, g0, enl):
        check(int(step[tpart.SB_ERR]) == 0, f"{what}: error word set")
        e = max(bits_err(b, b0), bits_err(g, g0), bits_err(nl, enl))
        check(e == 0.0, f"{what}: rows or left count differ by {e}")
        return e

    for i, (cpb, cpg, sc, k) in enumerate(cap["mega"]):
        what = f"split_mega_step captured {i} @ bound {bound_rows}"
        G, B = k["num_groups"], k["num_bins"]
        BH, _ = sm.hist_geometry(B)
        b, g = cpb.clone(), cpg.clone()
        step = tpart.step_block(sc, dev)
        nl = torch.zeros(1, dtype=torch.int32, device=dev)
        hist = torch.zeros((G, 4 * BH, 16), device=dev)
        sm.split_mega_step(b, g, step, nl, hist, num_bins=B, num_groups=G,
                           absmax=k["absmax"], bound=bound_rows)
        b0, g0 = cpb.clone(), cpg.clone()
        fixed = sm.hist_fixed_plain(b0, g0, sc, num_bins=B, num_groups=G,
                                    absmax=k["absmax"])
        enl = tpart.partition_leaf_plain(b0, g0, sc)
        e = max(moved(what, step, b, g, nl, b0, g0, enl),
                bits_err(hist, fixed))
        check(e == 0.0, f"{what}: histogram differs from hist_fixed_plain")
        err["split_mega"] = max(err["split_mega"], e)
    for i, (cpb, cpg, sc) in enumerate(cap["partition"]):
        what = f"partition_step captured {i} @ bound {bound_rows}"
        b, g = cpb.clone(), cpg.clone()
        step = tpart.step_block(sc, dev)
        nl = torch.zeros(1, dtype=torch.int32, device=dev)
        tpart.partition_step(b, g, step, nl, bound=bound_rows)
        b0, g0 = cpb.clone(), cpg.clone()
        enl = tpart.partition_leaf_plain(b0, g0, sc)
        err["partition"] = max(err["partition"],
                               moved(what, step, b, g, nl, b0, g0, enl))
    for i, (cpb, cpg, start, cnt, k, cst) in enumerate(cap["lhr"]):
        what = (f"leaf_hist_rmw_step captured {i} (idx {k['idx']}) @ bound "
                f"{bound_rows}")
        child = k["child"]
        step = tpart.step_block(
            tpart.make_scalars(start, cnt, 0, 0, 0, 0, 0, 0, 0, 0), dev,
            k["idx"], 0 if child is None else child[1] + 1)
        G, B = k["num_groups"], k["num_bins"]
        _, Bp = sm.hist_geometry(B)
        st, st0 = cst.clone(), cst.clone()
        out = torch.zeros((2, 2, G, Bp), device=dev)
        hs.leaf_hist_rmw_step(cpb, cpg, step,
                              None if child is None else child[0],
                              num_bins=B, num_groups=G, state=st,
                              absmax=k["absmax"], kcnt=k["kcnt"], out=out,
                              bound=bound_rows)
        ch0 = hs.leaf_hist_rmw_fixed_plain(cpb, cpg, start, cnt, state=st0,
                                           **k)
        check(int(step[tpart.SB_ERR]) == 0, f"{what}: error word set")
        e = max(bits_err(st, st0), bits_err(out, ch0))
        check(e == 0.0, f"{what}: state or children differ from "
                        f"leaf_hist_rmw_fixed_plain by {e}")
        err["leaf_hist"] = max(err["leaf_hist"], e)
    return err


def near_ties(sp, args, kw):
    """Children whose best gain has a runner-up on another feature within
    1e-6 relative (the winner's feature masked out and searched again)."""
    hg, hh, fm, info = (a.cpu() for a in args)
    F = hg.shape[0] // 2
    best = sp.split_pair_plain(hg, hh, fm, info, **kw)
    out = []
    for c in range(2):
        g1 = float(best[c, 0])
        f1 = int(best[c, 1:2].view(torch.int32))
        masked = info.clone()
        masked[c * F + f1, 4] = 0.0
        g2 = float(sp.split_pair_plain(hg, hh, fm, masked, **kw)[c, 0])
        if np.isfinite(g1) and abs(g1 - g2) <= 1e-6 * abs(g1):
            out.append((c, g1, g2))
    return out


def check_pair(sp, args, kw, what):
    """Kernel vs plain.  The plain version runs the kernel's exact f32
    operation order and its blocked f64 prefix sums as elementwise adds,
    so every field must be bit-identical to it, on the CPU and on the
    card.  Near-ties (a runner-up on another feature within 1e-6) are
    printed.  Returns the largest difference (0)."""
    got = sp.split_pair(*args, **kw).cpu()
    cpu = sp.split_pair_plain(*(a.cpu() for a in args), **kw)
    dev = sp.split_pair_plain(*args, **kw).cpu()
    for want, where in ((cpu, "CPU"), (dev, "card")):
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"{what}: kernel vs plain ({where}) differ:\n{got}\n{want}")
    for c, g1, g2 in near_ties(sp, args, kw):
        print(f"  near-tie {what} child {c}: gains {g1!r} vs {g2!r}")
    return float((got - dev).nan_to_num(0.0).abs().max())


# device functions of each port kernel, per split path (the partition's
# functions run inside split_mega on the mega path); every one must show
# device time in the profiled iteration
KERNEL_FUNCS = {
    "mega": {"mega_hist": "split_mega", "part_tiles": "split_mega",
             "part_copyback": "split_mega", "pair_search": "split_pair",
             "tree_step": "tree_step"},
    "subtraction": {"part_tiles": "partition", "part_copyback": "partition",
                    "leaf_hist_state": "leaf_hist",
                    "pair_search": "split_pair", "tree_step": "tree_step"},
    "efb": {"part_tiles": "partition", "part_copyback": "partition",
            "leaf_hist_state": "leaf_hist", "feat_view": "feat_view",
            "pair_search": "split_pair", "tree_step": "tree_step"},
    "cat": {"part_tiles": "partition", "part_copyback": "partition",
            "leaf_hist_state": "leaf_hist", "cat_search": "split_cat",
            "pair_search": "split_pair", "tree_step": "tree_step"},
    # phase 4h's uint16 bodies: the subtraction body, and on the wide
    # categorical data the wide arms of the categorical search and the
    # EFB view beside it
    "u16": {"part_tiles": "partition", "part_copyback": "partition",
            "leaf_hist_state": "leaf_hist", "pair_search": "split_pair",
            "tree_step": "tree_step"},
    "u16cat": {"part_tiles": "partition", "part_copyback": "partition",
               "leaf_hist_state": "leaf_hist",
               "cat_search_wide": "split_cat",
               "feat_view_wide": "feat_view",
               "pair_search": "split_pair", "tree_step": "tree_step"},
}


# the device function whose launches are each port kernel's launches
# (hist_rmw is leaf_hist's state epilogue: each state launch runs it)
MAIN_FUNC = {"split_mega": "mega_hist", "partition": "part_tiles",
             "leaf_hist": "leaf_hist_state", "hist_rmw": "leaf_hist_state",
             "split_pair": "pair_search", "tree_step": "tree_step"}
SPLITS = 254                    # a HIGGS tree's splits at num_leaves=255


def per_tree(label):
    """Each kernel's wrapper calls a tree in the graph (the root's
    included): every step runs, split or not."""
    n = SPLITS
    if label == "mega":
        return {"split_mega": n + 1, "split_pair": n + 1,
                "tree_step": n + 2}
    return {"partition": n, "leaf_hist": n + 1, "hist_rmw": n + 1,
            "split_pair": n + 1, "tree_step": n + 2}


def funcs_per_tree(label):
    """Device launches a tree of each device function of the path: the
    mega path's root call builds its histogram and moves no rows."""
    c = per_tree(label)
    if label == "mega":
        return {"mega_hist": c["split_mega"],
                "part_tiles": c["split_mega"] - 1,
                "part_copyback": c["split_mega"] - 1,
                "pair_search": c["split_pair"], "tree_step": c["tree_step"]}
    return {"part_tiles": c["partition"], "part_copyback": c["partition"],
            "leaf_hist_state": c["leaf_hist"],
            "pair_search": c["split_pair"], "tree_step": c["tree_step"]}


def func(key):
    """The device function's name in a profiler key ("void f(Args)", or
    a template's "void f<T, ...>(Args)": its name without the
    arguments)."""
    head = key.split("(")[0]
    return head.split("<")[0].split()[-1]


def device_rows(prof):
    """(key, device ms, launches) of a profile's device-side events
    (kernels, copies, sets; the CPU-side op events carry the same device
    time again)."""
    return [(e.key, getattr(e, "device_time_total", 0) / 1e3, e.count)
            for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and getattr(e, "device_time_total", 0) > 0]


def profile_iteration(bst, plain_s, label):
    """One more boosting iteration (a graph replay) under torch.profiler:
    device time by device function, and the device's busy share of the
    profiled iteration's wall time and of ``plain_s``, an iteration's
    wall time without it.  Returns {port kernel: (device ms, device
    launches)} of the iteration (KERNEL_FUNCS) and the busy ms; fails when
    a device function of the path's kernels shows no device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        bst.update()
        torch.cuda.synchronize()
        wall = time.time() - t0
    rows = device_rows(prof)
    busy = sum(ms for _, ms, _ in rows)
    check(rows, f"profile {label}: the profiler saw no device events")
    print(f"profile {label}: iteration {wall * 1e3:.1f} ms wall, device "
          f"busy {busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}%; "
          f"{100 * busy / (plain_s * 1e3):.1f}% of the "
          f"{plain_s * 1e3:.1f} ms median iteration without the profiler)")
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:14]:
        print(f"  {ms:9.3f} ms  x{n:<6d} {key[:90]}")
    per, seen = {}, set()
    for key, ms, n in rows:
        fn = func(key)
        kernel = KERNEL_FUNCS[label].get(fn)
        if kernel:
            seen.add(fn)
            t, c = per.get(kernel, (0.0, 0))
            per[kernel] = (t + ms, c + n)
    missing = set(KERNEL_FUNCS[label]) - seen
    check(not missing, f"profile {label}: no device time for {missing}")
    return per, busy


def iteration_bounds(tree, label, G, R, Bp, N, pair_bytes, step_bytes,
                     steps, bsize=1):
    """Per-iteration bound (ms) of each port kernel on one path: the sum
    over the tree's splits of the kernel's bytes formula, each split's
    rows from the tree's internal counts (no bagging: the bag-aware count
    is the row count), plus the root's calls; tree_step's bytes at each
    of its ``steps`` launches; a bin is ``bsize`` bytes (2 for uint16
    data).  On the subtraction path hist_rmw is
    leaf_hist's state epilogue: its bytes (a parent slot read, two int64
    slots and two f32 children written a split; one slot and two f32
    copies at the root) are in leaf_hist's bound too."""
    ns = tree.num_leaves - 1
    cnt = tree.internal_count[:ns].astype(np.float64)

    def child(c):
        return np.where(c >= 0, tree.internal_count[np.maximum(c, 0)],
                        tree.leaf_count[np.maximum(~c, 0)])
    small = np.minimum(child(tree.left_child[:ns]),
                       child(tree.right_child[:ns])).astype(np.float64)
    hist4, hist2 = G * 4 * Bp * 4, 2 * G * Bp * 4
    move = float((2 * cnt * (R * bsize + 32)).sum())
    nbytes = {"split_pair": (ns + 1) * pair_bytes,
              "tree_step": steps * step_bytes}
    if label == "mega":
        nbytes["split_mega"] = N * (G + 8) + hist4 + move + ns * hist4
    else:
        nbytes["partition"] = move
        nbytes["hist_rmw"] = (ns * 8 + 4) * hist2
        row = G * bsize + 8
        nbytes["leaf_hist"] = (N * row + float((small * row).sum())
                               + nbytes["hist_rmw"])
    return {k: v / PEAK_BYTES_S * 1e3 for k, v in nbytes.items()}


def report_iteration(per, bounds, tree, label, calls):
    """Print each kernel's device ms per iteration beside its bound and
    its device launches per call (``calls``: each kernel's calls a tree in
    the graph, the root's included), and the path's device launches a
    tree."""
    out = {}
    launches = sum(n for _, n in per.values())
    print(f"  {label}: {launches} device launches of the path's kernels a "
          f"tree ({tree.num_leaves - 1} splits)", flush=True)
    for k, b in bounds.items():
        if k == "hist_rmw":
            check(k not in per, f"{label}: hist_rmw has device launches of "
                                f"its own")
            print(f"  {label} hist_rmw: no launch of its own (leaf_hist's "
                  f"state epilogue), bound {b:.4f} ms per iteration, "
                  f"inside leaf_hist's", flush=True)
            out[k] = (None, b)
            continue
        ms, n = per.get(k, (0.0, 0))
        check(ms > 0, f"{label} {k}: no device time in the profiled "
                      f"iteration")
        out[k] = (ms, b)
        print(f"  {label} {k}: {ms:.3f} ms device time per iteration, "
              f"bound {b:.4f} ms; {n} device launches for {calls[k]} calls "
              f"({n / calls[k]:.3f} a call)", flush=True)
    return out


def tree_args(lr):
    return (lr.leafmat, lr.nodemat, lr.step, lr.nl, lr.pair_out, lr.fmeta,
            lr.info, lr.sums, lr.bag, lr.fmask, lr.leafcat, lr.nodecat,
            lr.paircat)


def check_tree_steps(ts, lr, pb, pg, steps):
    """tree_step on the card against tree_step_plain on the CPU, bit for
    bit, on the states of a real tree: the root, then ``steps`` steps of
    the learner's own sequence on copies of its row buffers (each step's
    inputs copied to the CPU before the kernel runs), then a final commit.
    Returns the largest difference of the outputs' bit views (as
    integers) and the plain version's median host ms a step."""
    pb, pg = pb.clone(), pg.clone()
    kw = dict(row0=lr.row0, N=lr.N)

    plain_s, err = [], [0]

    def one(mode, what):
        host = [t.cpu() for t in tree_args(lr)]
        ts.tree_step(mode, *tree_args(lr), **kw)
        t0 = time.perf_counter()
        ts.tree_step_plain(mode, *host, **kw)
        plain_s.append(time.perf_counter() - t0)
        for got, want in zip(tree_args(lr), host):
            got = got.cpu()
            if got.dtype == torch.float32:
                got, want = got.view(torch.int32), want.view(torch.int32)
            if got.numel():
                err[0] = max(err[0], int((got.long() - want.long()).abs()
                                         .max()))
            check(torch.equal(got, want),
                  f"tree_step {what}: kernel and tree_step_plain differ")

    torch.amax(pg[:2].abs(), dim=1, out=lr._absmax)
    lr._body(pb, pg, lr.root_step)
    torch.stack([lr.children[0, 0, 0].sum(), lr.children[1, 0, 0].sum()],
                out=lr.sums)
    one(ts.MODE_ROOT, "root")
    lr._pair(lr.root_step)
    for i in range(steps):
        one(ts.MODE_STEP, f"step {i}")
        lr._body(pb, pg, lr.step)
        lr._pair()
    one(ts.MODE_FINAL, "final")
    return float(err[0]), 1e3 * float(np.median(plain_s))


def step_costs(lr, pb, pg, label, ts, tpart, hs, sm):
    """Device ms by graph replay of what the fixed grids cost: a whole
    step of a stopped tree (cnt == 0: tree_step, the split body and the
    pair search), tree_step alone on it, and each split kernel on a
    1024-row leaf with its grid sized for the leaf and for the root's
    rows (the tree loop's bound)."""
    lr._step(ts.MODE_ROOT)         # a tree whose root has no split
    lr.pair_out[:, 0] = float("-inf")
    lr._step(ts.MODE_STEP)
    check(int(lr.step[tpart.SB_DONE]) == 1 and int(lr.step[tpart.SB_CNT])
          == 0, "step_costs: the tree did not stop")
    b, g = pb.clone(), pg.clone()
    out = {"empty_step": graph_ms(lambda: (lr._step(ts.MODE_STEP),
                                           lr._body(b, g, lr.step),
                                           lr._pair()), 50),
           "tree_step_stopped": graph_ms(
               lambda: lr._step(ts.MODE_STEP), 200)}
    sc = tpart.make_scalars(lr.row0 + 5, 1024, 5, 0, 0, 255, 0, 0, 120, 1)
    step = tpart.step_block(sc, b.device, (1, 1, 2, 1), 1)
    kw = dict(num_bins=lr.B, num_groups=lr.G, ws=lr.ws)
    for bound in (1024, lr.N):
        if label == "mega":
            out[f"split_mega_1k@{bound}"] = graph_ms(
                lambda: sm.split_mega_step(b, g, step, lr.nl, lr.hist4[0],
                                           absmax=lr._absmax, bound=bound,
                                           **kw), 100)
        else:
            out[f"partition_1k@{bound}"] = graph_ms(
                lambda: tpart.partition_step(b, g, step, lr.nl, bound=bound,
                                             ws=lr.ws), 100)
            out[f"leaf_hist_state_1k@{bound}"] = graph_ms(
                lambda: hs.leaf_hist_rmw_step(b, g, step, lr.nl,
                                              state=lr.state,
                                              absmax=lr._absmax, kcnt=lr.N,
                                              out=lr.children, bound=bound,
                                              **kw), 100)
    print(f"fixed-grid costs {label} (ms a launch, graph replay): "
          + ", ".join(f"{k} {v:.4f}" for k, v in out.items()), flush=True)
    return out


def train_path(lgt, learner_mod, mods, ds, params, label, capture):
    """The eager oracle's first tree (``build_tree_eager``, whose host-int
    kernel calls the ``capture`` wrappers of learner_mod record for phase
    5), then ITERS iterations of the graph loop under torch.profiler,
    with every wrapper's launch count set to 0 just before and read just
    after.  The wrappers run twice a learner (the run that sizes
    everything, then the capture); the replays launch without them, so
    the run's device launches are counted from the profiler's kernel
    events by device function: each function of the path must have
    launched as often as the graph holds it, times the trees plus that
    first run.  The graph loop's first tree must equal the oracle's bit
    for bit (leafmat, nodemat and the row order of both row buffers).
    Returns the booster, the iteration times (under the profiler), the
    losses, the splits, the wrapper counts and the device launches by
    function."""
    from torch.profiler import ProfilerActivity, profile
    ref = lgt.Booster(params=params, train_set=ds)
    ref._gbdt.learner.build_tree = ref._gbdt.learner.build_tree_eager
    real = {name: getattr(learner_mod, name) for name in capture}

    def wrap(name):
        def call(*a, **k):
            after = capture[name](*a, **k)
            out = real[name](*a, **k)
            if after is not None:
                after(out)
            return out
        return call

    for name in capture:
        setattr(learner_mod, name, wrap(name))
    ref.update()
    for name, fn in real.items():
        setattr(learner_mod, name, fn)
    torch.cuda.synchronize()

    bst = lgt.Booster(params=params, train_set=ds)
    for m in mods.values():
        m.launches = 0
    iter_s, losses, splits = [], [], 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for it in range(ITERS):
            t0 = time.time()
            bst.update()
            torch.cuda.synchronize()
            iter_s.append(time.time() - t0)
            splits += bst._gbdt.models[-1].num_leaves - 1
            losses.append(bst.eval_train()[0][2])
            if it == 0:
                la, lb = bst._gbdt.learner, ref._gbdt.learner
                for t in ("leafmat", "nodemat"):
                    check(torch.equal(getattr(la, t).view(torch.int32),
                                      getattr(lb, t).view(torch.int32)),
                          f"{label}: the graph loop's first tree's {t} "
                          f"differs from the eager oracle's")
                (pa, ga), (pr, gr) = bst._gbdt._phys, ref._gbdt._phys
                check(torch.equal(pa, pr) and torch.equal(
                    ga.view(torch.int32), gr.view(torch.int32)),
                      f"{label}: the row order after the graph loop's "
                      f"first tree differs from the eager oracle's")
                del ref, pr, gr, lb
    calls = {k: m.launches for k, m in mods.items()}
    device = {}
    for key, _, n in device_rows(prof):
        fn = func(key)
        if fn in KERNEL_FUNCS[label]:
            device[fn] = device.get(fn, 0) + n
    del prof
    lr = bst._gbdt.learner
    say(f"train {label}: per-iteration s under the profiler "
        f"{[round(s, 3) for s in iter_s]}; splits {splits} over {ITERS} "
        f"trees; wrapper calls {calls}; device launches {device}; host "
        f"syncs {lr.syncs} ({lr.syncs / ITERS:.3f} a tree), graph replays "
        f"{lr.replays}; binary_logloss {losses}; first tree bit-identical "
        f"to the eager oracle's (leafmat, nodemat, row order)")
    check(lr.syncs == ITERS and lr.replays == ITERS,
          f"{label}: {lr.syncs} host syncs and {lr.replays} graph replays "
          f"for {ITERS} trees (want one each a tree)")
    # wrapper calls: the run that sizes everything and the capture
    for k in mods:
        want = 2 * per_tree(label).get(k, 0)
        check(calls[k] == want, f"{label}: {k}: {calls[k]} wrapper calls, "
                                f"expected {want}")
    # device launches: each replay's, plus the run before the capture
    for fn, n in funcs_per_tree(label).items():
        want = (ITERS + 1) * n
        check(device.get(fn, 0) == want,
              f"{label}: {fn}: {device.get(fn, 0)} device launches in the "
              f"run, expected {want}")
    launches = {k: device[MAIN_FUNC[k]] for k in per_tree(label)}
    # no host sync inside an iteration but the learner's one read of the
    # tree: any implicit synchronisation raises in this mode
    syncs = lr.syncs
    torch.cuda.set_sync_debug_mode("error")
    bst.update()
    torch.cuda.set_sync_debug_mode(0)
    check(lr.syncs == syncs + 1, f"{label}: an iteration made "
                                 f"{lr.syncs - syncs} counted syncs")
    say(f"{label}: one iteration under torch.cuda.set_sync_debug_mode"
        f"('error'): no implicit host sync; syncs per tree 1")
    check(all(a > b for a, b in zip(losses, losses[1:])),
          f"{label}: training logloss does not fall: {losses}")
    return bst, iter_s, losses, splits, launches


def check_predict(lgt, bst, Xp, label):
    t0 = time.time()
    p1 = bst.predict(Xp, raw_score=True)
    pred_s = time.time() - t0
    check(p1.shape == (len(Xp),) and np.isfinite(p1).all(),
          f"{label}: raw predictions not finite / wrong shape")
    out_dir = os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        path = os.path.join(tmp, "model.txt")
        bst.save_model(path)
        p2 = lgt.Booster(model_file=path).predict(Xp, raw_score=True)
    check(np.array_equal(p1, p2), f"{label}: reloaded predictions differ: "
                                  f"max {np.abs(p1 - p2).max()}")
    say(f"predict {label}: {len(Xp)} rows in {pred_s:.3f} s; save/reload "
        f"equal")


def regression_ties(lgt):
    """examples/regression on the subtraction path (31 leaves, lambda_l2
    1, 5 trees), the card against the CPU, at min_data_in_leaf 10 and 20:
    where the CPU's f32 subtraction leaves a residue in exactly-empty
    bins that decides between tied thresholds (ROADMAP.md C), while the
    card's int64 state leaves them exactly empty.  Reported, not checked:
    prints, per setting, whether the trees agree and each split whose
    feature or threshold bin differs."""
    d = np.loadtxt(os.path.join(ROOT, "examples", "regression",
                                "regression.train"))
    for mdl in (10, 20):
        p = {"objective": "regression", "num_leaves": 31, "lambda_l2": 1.0,
             "min_data_in_leaf": mdl, "verbosity": -1,
             "tpu_megakernel": "off"}
        b_gpu = lgt.train(p, lgt.Dataset(d[:, 1:], label=d[:, 0]), 5)
        b_cpu = lgt.train(dict(p, device_type="cpu"),
                          lgt.Dataset(d[:, 1:], label=d[:, 0]), 5)
        diffs = []
        for t, (a, b) in enumerate(zip(b_gpu._gbdt.models,
                                       b_cpu._gbdt.models)):
            if a.num_leaves != b.num_leaves:
                diffs.append(f"tree {t}: card {a.num_leaves} leaves, CPU "
                             f"{b.num_leaves}")
                continue
            for i, fa in enumerate(a.split_feature.tolist()):
                fb = b.split_feature[i]
                ta, tb = a.threshold_bin[i], b.threshold_bin[i]
                if fa != fb or ta != tb:
                    diffs.append(f"tree {t} split {i}: card feature {fa} "
                                 f"bin {ta}, CPU feature {fb} bin {tb}")
        say(f"regression ties, subtraction path, min_data_in_leaf {mdl}: "
            f"card and CPU trees "
            f"{'identical' if not diffs else 'differ: ' + '; '.join(diffs)}")


def card_vs_cpu(lgt, d, extra, label):
    """The port on the card against the port on the CPU, small input:
    identical trees, leaf values within rtol 1e-4 / atol 1e-5."""
    small = dict({"objective": "binary", "num_leaves": 15, "verbosity": -1},
                 **extra)
    b_gpu = lgt.train(small, lgt.Dataset(d[:, 1:], label=d[:, 0]), 5)
    b_cpu = lgt.train(dict(small, device_type="cpu"),
                      lgt.Dataset(d[:, 1:], label=d[:, 0]), 5)
    for a, b in zip(b_gpu._gbdt.models, b_cpu._gbdt.models):
        check(a.split_feature.tolist() == b.split_feature.tolist()
              and a.threshold_bin.tolist() == b.threshold_bin.tolist()
              and a.left_child.tolist() == b.left_child.tolist(),
              f"{label}: card and CPU trees differ on "
              f"examples/binary_classification")
        check(np.allclose(a.leaf_value, b.leaf_value, rtol=1e-4, atol=1e-5),
              f"{label}: card and CPU leaf values differ")
    err = float(np.abs(b_gpu.predict(d[:, 1:], raw_score=True)
                       - b_cpu.predict(d[:, 1:], raw_score=True)).max())
    check(err < 1e-5, f"{label}: card vs CPU raw predictions differ by {err}")
    say(f"reference {label}: card vs CPU on binary.train, 5 trees "
        f"identical, max raw err {err:.2e}")


# phase 4c: the HIGGS shape with the UCI split's 500,000 held-out rows
API_ROWS, API_VALID, API_ITERS = 11_000_000, 500_000, 8


def np_sigmoid(score):
    return 1.0 / (1.0 + np.exp(-np.asarray(score, np.float64)))


def np_logloss(score, y):
    p = np.clip(np_sigmoid(score), 1e-15, 1.0 - 1e-15)
    return float(np.mean(-(y * np.log(p) + (1.0 - y) * np.log(1.0 - p))))


def np_auc(score, y):
    """Mann-Whitney AUC in float64, tied scores at their average rank."""
    s = np.asarray(score, np.float64)
    order = np.argsort(s, kind="stable")
    ss = s[order]
    starts = np.flatnonzero(np.r_[True, ss[1:] != ss[:-1]])
    ends = np.r_[starts[1:], len(ss)]
    ranks = np.empty(len(s))
    ranks[order] = np.repeat((starts + ends + 1) / 2.0, ends - starts)
    pos = np.asarray(y) > 0
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def np_error(score, y):
    return float(np.mean((np_sigmoid(score) > 0.5) != (np.asarray(y) > 0.5)))


def iteration_timer(times, snaps=None):
    """An after-iteration callback (first in order): the wall seconds of
    each iteration after the first (update and evaluation, ended by a
    device sync), and the validation scores after it in ``snaps``,
    copied outside the timed span."""
    last = []

    def cb(env):
        torch.cuda.synchronize()
        now = time.perf_counter()
        if last:
            times.append(now - last[0])
        if snaps is not None:
            snaps.append(env.model._gbdt.valid_scores[0].cpu().numpy().copy())
        last[:] = [time.perf_counter()]
    cb.order = 0
    return cb


def same_trees(a, b, exact=True):
    """Tree lists equal in structure (features, bins, children, counts);
    leaf values bit for bit or within rtol 1e-4 / atol 1e-5."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        n = x.num_nodes()
        if (x.num_leaves != y.num_leaves
                or x.split_feature[:n].tolist() != y.split_feature[:n].tolist()
                or x.threshold_bin[:n].tolist() != y.threshold_bin[:n].tolist()
                or x.threshold[:n].tolist() != y.threshold[:n].tolist()
                or x.left_child[:n].tolist() != y.left_child[:n].tolist()
                or x.right_child[:n].tolist() != y.right_child[:n].tolist()
                or x.leaf_count.tolist() != y.leaf_count.tolist()):
            return False
        if exact and not np.array_equal(x.leaf_value, y.leaf_value):
            return False
        if not np.allclose(x.leaf_value, y.leaf_value, rtol=1e-4, atol=1e-5):
            return False
    return True


def api_path(lgt, mods, fro, card):
    """Phase 4c: the training API on the card at the HIGGS shape, with the
    last 500,000 of 11M rows held out as a validation set.  For each body
    (mega K=1, mega auto, subtraction): 8 iterations through lgt.train
    without, then with the validation set (record_evaluation,
    early_stopping(50)), every wrapper's count set to 0 just before the
    validation run and read just after; the valid scores against a fresh
    raw prediction, every recorded metric against a numpy float64
    evaluation of the card's valid scores after that iteration, one tree
    read a tree, and the trees bit-identical to the run without the
    validation set; the validation update's device ms a tree
    (torch.profiler; CUDA events beside it).  Then early stopping on
    examples/binary_classification (loaded from its text files) on the
    card against the CPU; a numpy objective on the HIGGS rows against the
    built-in one; and training continued from a saved model with the
    validation set."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.time()
    X, y = make_data(API_ROWS)
    n_tr = API_ROWS - API_VALID
    Xt, yt, Xv, yv = X[:n_tr], y[:n_tr], X[n_tr:], y[n_tr:]
    metrics = ["binary_logloss", "auc", "binary_error"]
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
              "learning_rate": 0.1, "verbosity": -1, "metric": metrics}
    ds = lgt.Dataset(Xt, label=yt)
    ds.construct(params)
    dv = ds.create_valid(Xv, label=yv)
    dv.construct(params)
    say(f"api: data {X.shape}, train {Xt.shape} and valid {Xv.shape} "
        f"constructed in {time.time() - t0:.1f} s")
    bodies = (("mega K=1", {"tpu_frontier_k": 1},
               ("split_mega", "split_pair", "tree_step")),
              ("mega auto", {"tpu_frontier_k": "auto"},
               ("split_mega", "split_pair", "frontier_step", "frontier_key")),
              ("subtraction", {"tpu_megakernel": "off"},
               ("partition", "leaf_hist", "hist_rmw", "split_pair",
                "tree_step")))
    out = {}
    for label, extra, path_kernels in bodies:
        p = dict(params, **extra)
        plain_t = []
        b0 = lgt.train(p, ds, API_ITERS, callbacks=[iteration_timer(plain_t)])
        for m in mods.values():
            m.launches = 0
        for k in fro.launches:
            fro.launches[k] = 0
        valid_t, ev, snaps = [], {}, []
        bv = lgt.train(p, ds, API_ITERS, valid_sets=[dv], callbacks=[
            iteration_timer(valid_t, snaps),
            lgt.record_evaluation(ev), lgt.early_stopping(50, verbose=False)])
        counts = dict({k: m.launches for k, m in mods.items()},
                      **fro.launches)
        for k in path_kernels:
            check(counts[k] > 0, f"api {label}: {k} launched no time in the "
                                 f"run with the validation set: {counts}")
        g0, gv = b0._gbdt, bv._gbdt
        check(gv.learner.syncs == API_ITERS == g0.learner.syncs
              and gv.learner.replays == API_ITERS,
              f"api {label}: tree reads {gv.learner.syncs} with the valid "
              f"set, {g0.learner.syncs} without, {gv.learner.replays} "
              f"replays, for {API_ITERS} trees (want one a tree)")
        check(same_trees(g0.models, gv.models),
              f"api {label}: the validation set changed the trees")
        vs = gv.valid_scores[0].cpu().numpy()
        pv = bv.predict(Xv, raw_score=True, num_iteration=-1)
        verr = float(np.abs(vs - pv).max())
        check(vs.shape == (API_VALID,) and np.isfinite(vs).all()
              and verr <= 1e-5, f"api {label}: valid scores vs predict "
                                f"differ by {verr}")
        rec = ev["valid_0"]
        check(list(rec) == metrics and all(len(v) == API_ITERS
                                           for v in rec.values())
              and len(snaps) == API_ITERS, f"api {label}: recorded {rec}")
        merr = {m: 0.0 for m in metrics}
        for i, sc in enumerate(snaps):
            for m, fn, tol in (("binary_logloss", np_logloss, 1e-6),
                               ("auc", np_auc, 1e-9),
                               ("binary_error", np_error, 1e-9)):
                want = fn(sc, yv)
                e = abs(rec[m][i] - want) / abs(want)
                merr[m] = max(merr[m], e)
                check(e <= tol, f"api {label}: {m} at iteration {i + 1}: "
                                f"{rec[m][i]!r} vs numpy f64 {want!r}")
        check(all(a > b for a, b in zip(rec["binary_logloss"],
                                        rec["binary_logloss"][1:])),
              f"api {label}: valid logloss does not fall: "
              f"{rec['binary_logloss']}")
        # the validation update of the last tree, again, on its own
        last = len(gv.models) - 1
        depth = learner_depth(gv.device_trees[last])
        reps = 5
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                gv._tree_to_scores(last, 1.0, train=False)
            torch.cuda.synchronize()
        trav_ms = sum(ms for _, ms, _ in device_rows(prof)) / reps
        check(trav_ms > 0, f"api {label}: the profiler saw no device time "
                           f"in the validation update")
        trav_ev_ms = cuda_ms(
            lambda: gv._tree_to_scores(last, 1.0, train=False), 5)
        out[label] = {
            "s_per_iter_no_valid": float(np.median(plain_t)),
            "s_per_iter_valid": float(np.median(valid_t)),
            "valid_update_device_ms_per_tree": trav_ms,
            "valid_update_event_ms_per_tree": trav_ev_ms,
            "last_tree_depth": depth, "valid_vs_predict_max_err": verr,
            "metric_rel_err_vs_numpy": merr,
            "best_iteration": bv.best_iteration,
            "valid_logloss": rec["binary_logloss"][-1],
            "valid_auc": rec["auc"][-1], "launches": counts}
        say(f"api {label}: s/iteration without the valid set "
            f"{[round(t, 4) for t in plain_t]}, with it "
            f"{[round(t, 4) for t in valid_t]}; validation update "
            f"{trav_ms:.3f} ms a tree (profiler; events {trav_ev_ms:.3f}) at "
            f"depth {depth}; valid scores vs predict {verr:.2e}; metrics vs "
            f"numpy f64 {merr}; one tree read a tree; trees equal without "
            f"the valid set; wrapper counts {counts}")
        del b0, bv, g0, gv, snaps
        torch.cuda.empty_cache()

    # early stopping on examples/binary_classification: card and CPU
    base = os.path.join(ROOT, "examples", "binary_classification")
    pe = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
          "metric": "auc,binary_logloss", "early_stopping_round": 10}
    es = {}
    for where in ("cuda", "cpu"):
        d = lgt.Dataset(os.path.join(base, "binary.train"))
        v = lgt.Dataset(os.path.join(base, "binary.test"), reference=d)
        ev = {}
        b = lgt.train(dict(pe, device_type=where), d, 500, valid_sets=[v],
                      callbacks=[lgt.record_evaluation(ev)])
        es[where] = (b, ev)
    (bg, eg), (bc, ec) = es["cuda"], es["cpu"]
    check(bg.best_iteration == bc.best_iteration > 0
          and bg.num_trees() == bc.num_trees() < 500,
          f"api early stopping: best iteration card {bg.best_iteration} / "
          f"CPU {bc.best_iteration}, trees {bg.num_trees()} / "
          f"{bc.num_trees()}")
    check(same_trees(bg._gbdt.models, bc._gbdt.models, exact=False),
          "api early stopping: card and CPU trees differ")
    herr = 0.0
    for m in ("auc", "binary_logloss"):
        a, c = np.asarray(eg["valid_0"][m]), np.asarray(ec["valid_0"][m])
        herr = max(herr, float(np.max(np.abs(a - c) / np.abs(c))))
    check(herr <= 1e-5, f"api early stopping: eval histories differ by "
                        f"{herr} (rtol)")
    say(f"api early stopping on examples/binary_classification (text "
        f"files): best iteration {bg.best_iteration} of {bg.num_trees()} "
        f"trees on the card and the CPU, trees equal, eval history rtol "
        f"{herr:.2e}")

    # a numpy objective on the card against the built-in one
    calls = []

    def fobj(score, dataset):
        calls.append(len(score))
        p_ = np_sigmoid(score)
        yy = dataset.get_label()
        return p_ - yy, p_ * (1.0 - p_)

    quiet = dict(params, metric="None")
    bf = lgt.train(dict(quiet, objective=fobj), ds, 3)
    bb = lgt.train(dict(quiet, boost_from_average=False), ds, 3)
    check(calls == [n_tr] * 3 and bf._gbdt.objective is None,
          f"api fobj: calls {calls}")
    check(same_trees(bf._gbdt.models[:1], bb._gbdt.models[:1], exact=False),
          "api fobj: the first tree differs from the built-in objective's")
    ferr = float(np.abs(bf._gbdt.scores.cpu().numpy()
                        - bf.predict(Xt, raw_score=True)).max())
    check(ferr <= 1e-5, f"api fobj: train scores vs predict differ by {ferr}")
    say(f"api fobj: a numpy binary logloss on {n_tr} rows, 3 trees; the "
        f"first tree equal to objective=binary's; train scores (from the "
        f"physical order) vs predict {ferr:.2e}")
    del bf, bb

    # continued training from a saved model, with the validation set
    b3 = lgt.train(quiet, ds, 3)
    out_dir = os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        path = os.path.join(tmp, "model.txt")
        b3.save_model(path)
        bi = lgt.train(params, ds, 3, valid_sets=[dv], init_model=path)
    check(bi.num_trees() == 6, f"api init_model: {bi.num_trees()} trees")
    terr = float(np.abs(bi._gbdt.scores.cpu().numpy()
                        - bi.predict(Xt, raw_score=True,
                                     num_iteration=-1)).max())
    ierr = float(np.abs(bi._gbdt.valid_scores[0].cpu().numpy()
                        - bi.predict(Xv, raw_score=True,
                                     num_iteration=-1)).max())
    check(terr <= 1e-5 and ierr <= 1e-5,
          f"api init_model: train scores vs predict {terr}, valid {ierr}")
    say(f"api init_model: 3 trees saved, 3 more from the file with the "
        f"validation set; train / valid scores vs predict of the 6 trees "
        f"{terr:.2e} / {ierr:.2e}")
    print(f"api (phase 4c, {card}): " + json.dumps(out), flush=True)
    del b3, bi, ds, dv, X, y, Xt, Xv
    gc.collect()
    torch.cuda.empty_cache()
    return out


def learner_depth(dt):
    """The depth of the tree of a booster's device record."""
    from lightgbm_tpu_torch.ops.predict import tree_depth
    return tree_depth(dt["node"]["left"], dt["node"]["right"])


FR_K, FR_TREES = 4, 4          # the frontier phase: K, and trees a booster


def fr_funcs(K, steps, pruned):
    """Device launches of one frontier tree by device function: the root's
    histogram, the K split bodies of each step taken (a record of no rows
    launches too), the root's and each step's pair search, the
    bookkeeping (reset, the root's selection, each step, the renumber),
    the key row written and cleared, and the undo's two launches when the
    tree pruned."""
    return {"mega_hist": 1 + K * steps, "part_tiles": K * steps,
            "part_copyback": K * steps, "pair_search": 1 + steps,
            "frontier_step": steps + 3, "frontier_key": 2,
            "undo_merge": int(pruned), "undo_copy": int(pruned)}


def same_tree(lr_a, bufs_a, want, what):
    la, na = lr_a.leafmat, lr_a.nodemat
    pa, ga = bufs_a
    lw, nw, pw, gw = want
    check(torch.equal(la.view(torch.int32), lw.view(torch.int32))
          and torch.equal(na.view(torch.int32), nw.view(torch.int32)),
          f"{what}: leafmat or nodemat differs from K=1's")
    check(torch.equal(pa, pw) and torch.equal(ga.view(torch.int32),
                                              gw.view(torch.int32)),
          f"{what}: the row order after the tree differs from K=1's")


def k1_trees(lgt, ds, params, n):
    """n trees of the K=1 graph loop on the Dataset ds: each tree's
    leafmat, nodemat and row buffers, and the iteration times."""
    ref = lgt.Booster(params=dict(params, tpu_frontier_k=1), train_set=ds)
    want, times = [], []
    for _ in range(n):
        t0 = time.time()
        ref.update()
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        lr = ref._gbdt.learner
        pb, pg = ref._gbdt._phys
        want.append((lr.leafmat.clone(), lr.nodemat.clone(), pb.clone(),
                     pg.clone()))
    return want, times


def frontier_path(lgt, learner_mod, mods, fro, ds, params, d, profiled):
    """Phase 4b: the frontier (tpu_frontier_k=FR_K) on the mega path at the
    HIGGS shape, its trees bit-identical to the K=1 graph loop's after
    every tree (leafmat, nodemat, both row buffers), then at the auto K;
    and on examples/binary_classification at 12 leaves, where the replay
    prunes, against K=1 on the card.  Every wrapper's count is set to 0
    just before the HIGGS run and read just after the examples run.  When
    ``profiled`` (``frontier_window``, a process of its own), both runs are
    under torch.profiler, whose kernel events give each device function's
    launches: per tree as fr_funcs says from the tree's steps and pruning,
    plus the run before each graph's capture, which launches every step
    and the undo.  The bookkeeping's states of that run are kept for the
    kernel's comparison with its plain version."""
    from torch.profiler import ProfilerActivity, profile
    want, t1 = k1_trees(lgt, ds, params, FR_TREES)
    states = []
    real = learner_mod.frontier_step

    def keep(mode, fr, **kw):
        if not torch.cuda.is_current_stream_capturing():
            states.append((mode, fr.to("cpu"), dict(kw, handles=(0, 0))))
        return real(mode, fr, **kw)

    X, y = d[:, 1:], d[:, 0]
    small = {"objective": "binary", "num_leaves": 12, "verbosity": -1}
    want_sm, _ = k1_trees(lgt, lgt.Dataset(X, label=y), small, 4)
    bst = lgt.Booster(params=dict(params, tpu_frontier_k=FR_K), train_set=ds)
    b_sm = lgt.Booster(dict(small, tpu_frontier_k=FR_K),
                       lgt.Dataset(X, label=y))
    for m in mods.values():
        m.launches = 0
    for k in fro.launches:
        fro.launches[k] = 0
    tk, trees, sm_trees = [], [], []
    torch.cuda.synchronize()
    window = (profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA])
              if profiled else contextlib.nullcontext())
    with window as prof:
        learner_mod.frontier_step = keep
        try:
            for it in range(FR_TREES):
                t0 = time.time()
                bst.update()
                torch.cuda.synchronize()
                tk.append(time.time() - t0)
                learner_mod.frontier_step = real
                lr = bst._gbdt.learner
                same_tree(lr, bst._gbdt._phys, want[it],
                          f"frontier K={FR_K} tree {it}")
                trees.append((lr.last_steps, lr.last_made
                              - (bst._gbdt.models[-1].num_leaves - 1)))
        finally:
            learner_mod.frontier_step = real
        for it in range(4):
            b_sm.update()
            lr_sm = b_sm._gbdt.learner
            same_tree(lr_sm, b_sm._gbdt._phys, want_sm[it],
                      f"frontier K={FR_K} examples tree {it}")
            sm_trees.append((lr_sm.last_steps, lr_sm.last_made
                             - (b_sm._gbdt.models[-1].num_leaves - 1)))
        torch.cuda.synchronize()
    calls = {k: m.launches for k, m in mods.items()}
    calls.update(fro.launches)
    lr = bst._gbdt.learner
    device = None
    if profiled:
        device = {}
        for key, ms, n in device_rows(prof):
            fn = func(key)
            if fn in fr_funcs(1, 0, 0):
                t, c = device.get(fn, (0.0, 0))
                device[fn] = (t + ms, c + n)
        del prof
        # the run before each capture launches every step of the sequence
        # and the undo, with no IF nodes
        runs = ([(lr.max_splits, 1)] + trees
                + [(b_sm._gbdt.learner.max_splits, 1)] + sm_trees)
        expect = {}
        for steps, pruned in runs:
            for fn, n in fr_funcs(FR_K, steps, pruned > 0).items():
                expect[fn] = expect.get(fn, 0) + n
        for fn, n in expect.items():
            check(device.get(fn, (0, 0))[1] == n,
                  f"frontier: {fn}: {device.get(fn, (0, 0))[1]} device "
                  f"launches in the run, expected {n} (steps, pruned a "
                  f"tree: {runs})")
    check(all(0 <= p <= FR_K - 1 for _, p in trees + sm_trees),
          f"frontier: more than K-1 pruned splits: {trees + sm_trees}")
    check(any(p > 0 for _, p in sm_trees),
          f"frontier: the examples case did not prune: {sm_trees}")
    check(lr.syncs == FR_TREES and lr.replays == FR_TREES,
          f"frontier: {lr.syncs} host syncs, {lr.replays} replays for "
          f"{FR_TREES} trees")
    for name in ("split_mega", "split_pair", "frontier_step",
                 "frontier_key", "frontier_undo"):
        check(calls.get(name, 0) > 0, f"frontier: wrapper {name} launched "
                                      f"no time")
    check(calls.get("tree_step", 0) == 0, "frontier: tree_step launched")
    syncs = lr.syncs
    torch.cuda.set_sync_debug_mode("error")
    bst.update()
    torch.cuda.set_sync_debug_mode(0)
    check(lr.syncs == syncs + 1, "frontier: an iteration made more than "
                                 "one counted sync")
    say(f"frontier K={FR_K}: {FR_TREES} HIGGS trees bit-identical to the "
        f"K=1 graph loop's (leafmat, nodemat, both row buffers), (steps, "
        f"pruned) a tree {trees}; examples/binary_classification at 12 "
        f"leaves bit-identical to K=1 on the card with (steps, pruned) "
        f"{sm_trees}; wrapper calls {calls}; "
        + (f"device launches by function "
           f"{ {k: v[1] for k, v in device.items()} } = fr_funcs over the "
           f"trees and the runs before the captures (every step); "
           if profiled else "")
        + "one host sync a tree, none implicit under "
        "set_sync_debug_mode('error')")
    # the auto K on the card
    ba = lgt.Booster(params=params, train_set=ds)
    ta = []
    for it in range(FR_TREES):
        t0 = time.time()
        ba.update()
        torch.cuda.synchronize()
        ta.append(time.time() - t0)
        same_tree(ba._gbdt.learner, ba._gbdt._phys, want[it],
                  f"frontier auto tree {it}")
    k_auto = ba._gbdt.learner.K
    del ba
    med = {n: 1e3 * float(np.median(t[1:])) for n, t in
           (("K=1", t1), (f"K={FR_K}", tk), (f"auto (K={k_auto})", ta))}
    say(f"frontier auto: K={k_auto} ({learner_mod.AUTO_FRONTIER_K} in "
        f"models/learner.py), {FR_TREES} trees bit-identical to K=1's; ms "
        f"an iteration (median of trees 1-{FR_TREES - 1}, wall) "
        + ", ".join(f"{k} {v:.2f}" for k, v in med.items()))
    del want
    return bst, states, calls, device, trees, med


def check_frontier_kernels(fro, sp, tpart, lr, bst, states, steps):
    """The frontier's kernels against their plain versions at the shapes of
    the HIGGS run, and their times: the bookkeeping on every kept state
    of a real tree (every buffer bit for bit), and its device time a
    launch over the launches the graph takes on that tree (``steps``
    steps run), timed by CUDA events on copies of their states queued back
    to back (queued_ms); the key row written and
    cleared; the undo of a pruned split made on purpose -- the last
    tree's largest leaf partitioned on feature 0 at bin 127, then undone:
    kernel and plain version equal each other and the rows before the
    partition; split_pair over the step's 2K children.  Returns the JSON
    rows' numbers, each kernel's max_abs_err the largest difference of the
    bit views (as integers) of what it wrote and what its plain version
    wrote."""
    dev = lr.device
    out = {}
    # bookkeeping
    plain_s, err = [], 0.0
    for i, (mode, fr, kw) in enumerate(states):
        want = fr.to("cpu")
        t0 = time.perf_counter()
        fro.frontier_step_plain(mode, want, **{n: v for n, v in kw.items()
                                               if n != "handles"})
        plain_s.append(time.perf_counter() - t0)
        got = fr.to(dev)
        fro.frontier_step(mode, got, **kw)
        for name in fro.Frontier.TENSORS:
            a, b = getattr(got, name).cpu(), getattr(want, name)
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            err = max(err, bits_err(a, b))
            check(torch.equal(a, b), f"frontier_step state {i} (mode "
                                     f"{mode}): {name} differs from the "
                                     f"plain version")
    # the launches the graph takes: the reset, the root's selection, each
    # step while the tree runs (the step before it selected a batch), the
    # renumber; the other states are the sizing run's steps after the stop
    taken = [(fr.to(dev), mode, kw) for i, (mode, fr, kw) in enumerate(states)
             if mode != fro.MODE_STEP or i == 1 or int(fr.fs[fro.FS_RUN])]
    check(len(taken) == steps + 3, f"frontier_step: {len(taken)} states "
                                   f"the graph launches, expected {steps + 3}")
    ms_all, n_all = queued_ms([lambda fr=fr, mode=mode, kw=kw:
                               fro.frontier_step(mode, fr, **kw)
                               for fr, mode, kw in taken])
    K, F, L = lr.K, lr.F, lr.L
    n_items = L           # about 2 made + 1, made ~ L / 2 on average
    step_bytes = 4 * (6 * n_items + 2 * K * 13 + 2 * K * 25 + K * (25 + 17)
                      + K * 24 + 2 * K * F * 5)
    out["frontier_step"] = dict(
        err=err, ms=ms_all / n_all, plain_ms=1e3 * float(np.median(plain_s)),
        bound=bound(step_bytes, 0), lib=None)
    say(f"frontier_step: the kernel bit-identical to frontier_step_plain on "
        f"all {len(states)} states of the first HIGGS tree's sizing run "
        f"(reset, the root's selection, every step, those after the tree "
        f"stopped, the renumber); "
        f"{out['frontier_step']['ms']:.5f} ms a launch (device time over "
        f"the {n_all} launches the graph takes, CUDA events, queued back to "
        f"back), plain "
        f"{out['frontier_step']['plain_ms']:.4f} ms on the host")
    # the key row
    pb, pg = (t.clone() for t in bst._gbdt._phys)
    row0, N = lr.row0, lr.N
    g2 = pg.clone()
    err = 0.0
    for clear in (False, True):
        fro.frontier_key(pg, row0=row0, N=N, clear=clear)
        fro.frontier_key_plain(g2, row0=row0, N=N, clear=clear)
        err = max(err, bits_err(pg[fro.KEY_ROW], g2[fro.KEY_ROW]))
        check(torch.equal(pg.view(torch.int32), g2.view(torch.int32)),
              f"frontier_key (clear={clear}) differs from its plain version")
    del g2
    words = pg.view(torch.int32)[fro.KEY_ROW, row0:row0 + N]
    out["frontier_key"] = dict(
        err=err, ms=graph_ms(lambda: fro.frontier_key(pg, row0=row0, N=N),
                             20),
        plain_ms=cuda_ms(lambda: fro.frontier_key_plain(
            pg, row0=row0, N=N, clear=False), 10),
        bound=bound(4 * N, 0),
        lib=graph_ms(lambda: torch.arange(N, dtype=torch.int32, device=dev,
                                          out=words), 20))
    # the undo of a pruned split made on purpose
    lm = lr.leafmat[:, :L]
    cnts = lm[1].view(torch.int32)
    leaf = int(torch.argmax(cnts))
    start, cnt = int(lm[0].view(torch.int32)[leaf]), int(cnts[leaf])
    sc = tpart.make_scalars(start, cnt, 0, 0, 0, 255, 0, 0, 127, 0)
    fro.frontier_key(pg, row0=row0, N=N)
    before = (pb.clone(), pg.clone())
    nl = int(tpart.partition_leaf(pb, pg, sc))
    fr = lr.fr.to(dev)
    off, _ = fr.lay["undo"]
    fr.fs[fro.FS_NPRUNED] = 1
    fr.fs[off:off + 3] = torch.tensor([start, cnt, nl], dtype=torch.int32)
    moved = (pb.clone(), pg.clone())
    b2, g2 = pb.clone(), pg.clone()
    fro.frontier_undo(pb, pg, fr, bound=N, ws=lr.ws)
    fro.frontier_undo_plain(b2, g2, fr)
    err = max(bits_err(pb, b2), bits_err(pg, g2))
    for (x, u), what in (((pb, b2), "plain version"),
                         ((pb, before[0]), "rows before the partition")):
        check(torch.equal(x, u), f"frontier_undo: bins differ from the "
                                 f"{what}")
    for u, what in ((g2, "plain version"), (before[1],
                                            "rows before the partition")):
        check(torch.equal(pg.view(torch.int32), u.view(torch.int32)),
              f"frontier_undo: payload differs from the {what}")

    def timed(fn, reps=5):
        ts = []
        for _ in range(reps):
            pb.copy_(moved[0])
            pg.copy_(moved[1])
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            ts.append(e0.elapsed_time(e1))
        return float(np.median(ts))

    R = pb.shape[0]
    out["frontier_undo"] = dict(
        err=err, ms=timed(lambda: fro.frontier_undo(pb, pg, fr, bound=N,
                                                    ws=lr.ws)),
        plain_ms=timed(lambda: fro.frontier_undo_plain(pb, pg, fr), 3),
        bound=bound(2 * cnt * (R + 32), 0), lib=None, rows=cnt)
    del pb, pg, b2, g2, before, moved
    say(f"frontier_key: kernel equal to its plain version (write, clear), "
        f"{out['frontier_key']['ms']:.4f} ms for {N} rows, plain "
        f"{out['frontier_key']['plain_ms']:.4f}, torch.arange "
        f"{out['frontier_key']['lib']:.4f}; frontier_undo of a {cnt}-row "
        f"leaf partitioned on purpose ({nl} left): kernel equal to its plain "
        f"version and to the rows before the partition, "
        f"{out['frontier_undo']['ms']:.4f} ms, plain "
        f"{out['frontier_undo']['plain_ms']:.4f} ms")
    # split_pair over the 2K children, on the learner's last step's planes
    Bp = lr.children.shape[-1]
    hg, hh = lr.children[0].reshape(-1, Bp), lr.children[1].reshape(-1, Bp)
    kw = dict(l1=lr.l1, l2=lr.l2, max_delta_step=lr.max_delta_step,
              min_gain_to_split=lr.min_gain_to_split,
              min_data_in_leaf=lr.min_data_in_leaf,
              min_sum_hessian=lr.min_sum_hessian, max_depth=lr.max_depth,
              children=2 * K)
    got = sp.split_pair(hg, hh, lr.fmeta_pair, lr.info, **kw)
    want = sp.split_pair_plain(hg, hh, lr.fmeta_pair, lr.info, **kw)
    check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
          "split_pair over 2K children differs from its plain version")
    pair_bytes = 2 * (2 * K * F) * Bp * 4 + 2 * (2 * K * F) * 8 * 4 + \
        2 * K * 13 * 4
    out["split_pair_2k"] = dict(
        ms=graph_ms(lambda: sp.split_pair(hg, hh, lr.fmeta_pair, lr.info,
                                          out=lr.pair_out, **kw), 200),
        plain_ms=cuda_ms(lambda: sp.split_pair_plain(
            hg, hh, lr.fmeta_pair, lr.info, **kw), 3, 1),
        bound=bound(pair_bytes, 2 * K * F * Bp * 60))
    say(f"split_pair over {2 * K} children: bit-identical to its plain "
        f"version, {out['split_pair_2k']['ms']:.4f} ms a launch (graph "
        f"replay), plain {out['split_pair_2k']['plain_ms']:.3f} ms")
    return out


# ---- phase 4e: EFB bundles (one-hot data through the bundled body) -------
EFB_ROWS, EFB_CATS, EFB_LEVELS, EFB_ITERS = 2_000_000, 8, 32, 4


def make_efb_data(rows):
    """HIGGS' 28 standard-normal features (bench.py's draws, seed 7) and 8
    categorical columns of 32 levels, one-hot encoded (F = 284); the label
    from the features' logit plus a per-level effect of each category."""
    rng = np.random.RandomState(7)
    X = rng.normal(size=(rows, FEATURES)).astype(np.float32)
    w = rng.normal(size=FEATURES)
    logit = X.dot(w) * 0.5
    noise = rng.normal(size=rows)
    crng = np.random.RandomState(8)
    cats = crng.randint(0, EFB_LEVELS, size=(rows, EFB_CATS))
    effect = crng.normal(size=(EFB_CATS, EFB_LEVELS))
    logit = logit + effect[np.arange(EFB_CATS), cats].sum(axis=1)
    out = np.zeros((rows, FEATURES + EFB_CATS * EFB_LEVELS), np.float32)
    out[:, :FEATURES] = X
    cols = FEATURES + np.arange(EFB_CATS) * EFB_LEVELS + cats
    out[np.arange(rows)[:, None], cols] = 1.0
    y = (logit + noise > 0).astype(np.float32)
    return out, y


def split_sets(tree, lv):
    """Per split of ``tree``: (the rows under it, the rows under its left
    child), as masks over ``lv``, the rows' leaf indices in ``tree``."""
    ns = tree.num_leaves - 1
    lc, rc = tree.left_child[:ns], tree.right_child[:ns]

    def below(c):
        return {~c} if c < 0 else below(lc[c]) | below(rc[c])
    return [(np.isin(lv, list(below(s))), np.isin(lv, list(below(lc[s]))))
            for s in range(ns)]


def first_tie(a, b, X, y, scores_before, what):
    """The first split where trees ``a`` and ``b`` partition the rows
    differently, checked to be an exact tie: both choices' gains recounted
    in f64 from the binary gradients of ``scores_before`` equal (1e-9 of
    the split's |leaf gains|).  Returns the split's index or None."""
    import lightgbm_tpu_torch as lgt
    la = lgt.Booster(model_str=a).predict(X, pred_leaf=True)[:, -1]
    lb = lgt.Booster(model_str=b).predict(X, pred_leaf=True)[:, -1]
    ta = lgt.Booster(model_str=a)._gbdt.models[-1]
    tb = lgt.Booster(model_str=b)._gbdt.models[-1]
    p = 1.0 / (1.0 + np.exp(-scores_before))
    g, h = p - y, p * (1.0 - p)

    def gain(rows, left):
        out = []
        for m in (left, rows & ~left, rows):
            sg, sh = g[m].sum(), h[m].sum()
            out.append(sg * sg / sh if sh > 0 else 0.0)
        return out[0] + out[1] - out[2], sum(abs(v) for v in out)

    sa, sb = split_sets(ta, la), split_sets(tb, lb)
    for s in range(min(len(sa), len(sb))):
        if np.array_equal(sa[s][0], sb[s][0]) and np.array_equal(
                sa[s][1], sb[s][1]):
            continue
        (va, ma), (vb, mb) = gain(*sa[s]), gain(*sb[s])
        check(abs(va - vb) <= 1e-9 * max(1.0, ma, mb),
              f"{what}: split {s} partitions differently with f64 gains "
              f"{va!r} and {vb!r}")
        return s
    check(len(sa) == len(sb), f"{what}: {len(sa)} and {len(sb)} splits")
    return None


def check_efb_kernels(fv, sp, lr, pb, pg, steps):
    """feat_view on the card against feat_view_fixed_plain on the CPU, and
    split_pair over the view (2 x 284 feature rows) against
    split_pair_plain on the CPU, bit for bit, on the states of a real
    tree: the root and ``steps`` steps of the learner's own sequence on
    copies of its row buffers.  Returns the largest bit-view differences
    and the two kernels' ms (graph replay) beside their plain versions'
    (CUDA events, on the card's tensors)."""
    pb, pg = pb.clone(), pg.clone()
    view = lr.view.to("cpu")
    err = {"feat_view": 0.0, "split_pair": 0.0}

    def compare(step):
        lr._pair(step)
        want = fv.feat_view_fixed_plain(lr.state.cpu(), step.cpu(),
                                        lr._absmax.cpu(), lr.N, view)
        got = lr.fchildren.cpu()
        err["feat_view"] = max(err["feat_view"], bits_err(
            got.view(torch.int32), want.view(torch.int32)))
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              "feat_view: kernel and feat_view_fixed_plain differ")
        F, Bp = lr.F, got.shape[-1]
        plain = sp.split_pair_plain(
            got[0].reshape(2 * F, Bp), got[1].reshape(2 * F, Bp),
            lr.fmeta_pair.cpu(), lr.info.cpu(), l1=lr.l1, l2=lr.l2,
            max_delta_step=lr.max_delta_step,
            min_gain_to_split=lr.min_gain_to_split,
            min_data_in_leaf=lr.min_data_in_leaf,
            min_sum_hessian=lr.min_sum_hessian, max_depth=lr.max_depth)
        kern = lr.pair_out.cpu()
        err["split_pair"] = max(err["split_pair"], bits_err(
            kern.view(torch.int32), plain.view(torch.int32)))
        check(torch.equal(kern.view(torch.int32), plain.view(torch.int32)),
              f"split_pair at F = {F}: kernel and split_pair_plain differ")

    from lightgbm_tpu_torch.ops import tree_step as ts
    torch.amax(pg[:2].abs(), dim=1, out=lr._absmax)
    lr._body(pb, pg, lr.root_step)
    torch.stack([lr.children[0, 0, 0].sum(), lr.children[1, 0, 0].sum()],
                out=lr.sums)
    lr._step(ts.MODE_ROOT)
    compare(lr.root_step)
    for _ in range(steps):
        lr._step(ts.MODE_STEP)
        lr._body(pb, pg, lr.step)
        compare(lr.step)
    step = lr.step
    kw = dict(kcnt=lr.N, view=lr.view, out=lr.fchildren)
    F, Bp = lr.F, lr.fchildren.shape[-1]
    ms = {"feat_view": graph_ms(lambda: fv.feat_view(
              None, None, lr.state, step, lr._absmax, **kw), 200),
          "split_pair": graph_ms(lambda: lr._search(
              lr.fchildren[0].view(-1, Bp), lr.fchildren[1].view(-1, Bp),
              lr.info, out=lr.pair_out), 200)}
    ch = lr.fchildren
    plain = {"feat_view": cuda_ms(lambda: fv.feat_view_fixed_plain(
                 lr.state, step, lr._absmax, lr.N, lr.view), 5),
             "split_pair": cuda_ms(lambda: sp.split_pair_plain(
                 ch[0].reshape(2 * F, Bp), ch[1].reshape(2 * F, Bp),
                 lr.fmeta_pair, lr.info, l1=lr.l1, l2=lr.l2,
                 max_delta_step=lr.max_delta_step,
                 min_gain_to_split=lr.min_gain_to_split,
                 min_data_in_leaf=lr.min_data_in_leaf,
                 min_sum_hessian=lr.min_sum_hessian,
                 max_depth=lr.max_depth), 5)}
    del pb, pg
    return err, ms, plain


def efb_path(lgt, learner_mod, mods):
    """Phase 4e: EFB bundles at 2,000,000 rows (the host's dense f32
    matrix and binning cut HIGGS' 10.5M), 28 + 256 one-hot columns:
    default params bundle each categorical, the learner takes the
    subtraction body at K=1 with feat_view between the state update and
    the pair search.  The eager oracle's first tree bit-identical to the
    graph's; every wrapper's count set to 0 before the graph run under
    torch.profiler and read after it; one capture, one tree read a tree;
    logloss falls; the trees against enable_bundle=False (equal, or the
    first difference an exact tie in f64); feat_view and split_pair at
    F = 284 bit-identical to their plain versions; s/iteration, device
    ms, per-kernel ms."""
    from lightgbm_tpu_torch.ops import feat_view as fv
    from lightgbm_tpu_torch.ops import split_pair as sp
    from torch.profiler import ProfilerActivity, profile
    t0 = time.time()
    X, y = make_efb_data(EFB_ROWS)
    F = X.shape[1]
    say(f"efb data: {X.shape} (rows cut from HIGGS' 10.5M for the host's "
        f"dense f32 matrix and binning) in {time.time() - t0:.1f} s")
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
              "learning_rate": 0.1, "verbosity": -1}
    t0 = time.time()
    ds = lgt.Dataset(X, label=y)
    ds.construct(params)
    inner = ds._inner
    groups = [(g.feature_indices, g.bin_offsets, g.num_total_bin)
              for g in inner.groups]
    dense = [([f], [0]) for f in range(FEATURES)]
    bundles = {tuple(range(FEATURES + c * EFB_LEVELS,
                           FEATURES + (c + 1) * EFB_LEVELS))
               for c in range(EFB_CATS)}
    check([(f, o) for f, o, _ in groups[:FEATURES]] == dense
          and {tuple(f) for f, _, _ in groups[FEATURES:]} == bundles
          and all(o == list(range(1, EFB_LEVELS + 1)) and n == EFB_LEVELS + 1
                  for _, o, n in groups[FEATURES:]),
          f"efb: groups {groups[FEATURES:FEATURES + 2]}... are not the 28 "
          f"dense features and 8 bundles of 32 indicators")
    say(f"efb dataset construct: {time.time() - t0:.1f} s; {len(groups)} "
        f"groups: the 28 dense features alone, then each categorical's 32 "
        f"indicators in one bundle (offsets 1..32, 33 bins)")
    ref = lgt.Booster(params=params, train_set=ds)
    ref._gbdt.learner.build_tree = ref._gbdt.learner.build_tree_eager
    ref.update()
    bst = lgt.Booster(params=params, train_set=ds)
    lr = bst._gbdt.learner
    check(lr.bundled and lr.subtract and lr.K == 1 and lr.F == F
          and lr.G == FEATURES + EFB_CATS,
          f"efb: learner bundled {lr.bundled} subtract {lr.subtract} K "
          f"{lr.K} F {lr.F} G {lr.G}")
    for m in mods.values():
        m.launches = 0
    iter_s, losses = [], []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for it in range(EFB_ITERS):
            t0 = time.time()
            bst.update()
            torch.cuda.synchronize()
            iter_s.append(time.time() - t0)
            losses.append(bst.eval_train()[0][2])
            if it == 0:
                lb = ref._gbdt.learner
                for t in ("leafmat", "nodemat"):
                    check(torch.equal(getattr(lr, t).view(torch.int32),
                                      getattr(lb, t).view(torch.int32)),
                          f"efb: the graph's first tree's {t} differs from "
                          f"the eager oracle's")
                (pa, ga), (pr, gr) = bst._gbdt._phys, ref._gbdt._phys
                check(torch.equal(pa, pr) and torch.equal(
                    ga.view(torch.int32), gr.view(torch.int32)),
                      "efb: the row order after the first tree differs "
                      "from the eager oracle's")
                del ref, lb, pr, gr
    calls = {k: m.launches for k, m in mods.items()}
    device = {}
    for key, _, n in device_rows(prof):
        fn = func(key)
        if fn in KERNEL_FUNCS["efb"]:
            device[fn] = device.get(fn, 0) + n
    del prof
    want = dict(per_tree("subtraction"), feat_view=SPLITS + 1)
    for k in mods:
        check(calls[k] == 2 * want.get(k, 0),
              f"efb: {k}: {calls[k]} wrapper calls, expected "
              f"{2 * want.get(k, 0)}")
    fn_want = dict(funcs_per_tree("subtraction"), feat_view=SPLITS + 1)
    for fn, n in fn_want.items():
        check(device.get(fn, 0) == (EFB_ITERS + 1) * n,
              f"efb: {fn}: {device.get(fn, 0)} device launches, expected "
              f"{(EFB_ITERS + 1) * n}")
    check(lr.syncs == lr.replays == EFB_ITERS and lr.captures == 1,
          f"efb: {lr.syncs} tree reads, {lr.replays} replays, "
          f"{lr.captures} captures for {EFB_ITERS} trees")
    check(all(a > b for a, b in zip(losses, losses[1:])),
          f"efb: training logloss does not fall: {losses}")
    say(f"efb train: s/iteration {[round(s, 4) for s in iter_s]} (under "
        f"the profiler); wrapper calls {calls}; device launches {device}; "
        f"one capture, one tree read a tree; binary_logloss {losses}; "
        f"first tree bit-identical to the eager oracle's")
    med = float(np.median(iter_s[1:]))
    per, busy = profile_iteration(bst, med, "efb")
    for k, (ms, n) in sorted(per.items()):
        print(f"  efb {k}: {ms:.3f} ms device time per iteration, {n} "
              f"device launches", flush=True)
    pb_, pg_ = bst._gbdt._phys
    err, ms, plain = check_efb_kernels(fv, sp, lr, pb_, pg_, 12)
    say(f"efb kernels: feat_view bit-identical to feat_view_fixed_plain and "
        f"split_pair at F = {F} bit-identical to split_pair_plain on the "
        f"root and 12 steps of a real tree; feat_view {ms['feat_view']:.4f} "
        f"ms a launch (plain {plain['feat_view']:.3f}), split_pair "
        f"{ms['split_pair']:.4f} ms (plain {plain['split_pair']:.3f})")
    del pb_, pg_
    Bp = lr.children.shape[-1]
    # the same data without bundles, on the subtraction path
    t0 = time.time()
    ds2 = lgt.Dataset(X, label=y, params={"enable_bundle": False})
    ds2.construct(params)
    b2 = lgt.Booster(dict(params, tpu_megakernel="off",
                          enable_bundle=False), ds2)
    for _ in range(EFB_ITERS):
        b2.update()
    check(not b2._gbdt.learner.bundled and b2._gbdt.learner.G == F,
          "efb: enable_bundle=False still bundled")
    a_models, b_models = bst._gbdt.models, b2._gbdt.models
    tie = None
    for t in range(EFB_ITERS):
        if same_trees(a_models[t:t + 1], b_models[t:t + 1]):
            continue
        sa = lgt.Booster(model_str=bst.model_to_string(num_iteration=t + 1))
        before = (sa.predict(X, raw_score=True, num_iteration=t) if t
                  else np.full(len(y), bst._gbdt.init_scores[0]))
        s = first_tie(bst.model_to_string(num_iteration=t + 1),
                      b2.model_to_string(num_iteration=t + 1), X, y,
                      before.astype(np.float64), f"efb tree {t}")
        tie = (t, s)
        break
    say(f"efb against enable_bundle=False (G = {F}, subtraction): "
        + ("every tree equal, leaf values bit for bit" if tie is None else
           f"equal up to tree {tie[0]} split {tie[1]}, an exact tie in f64")
        + f"; unbundled construct and train {time.time() - t0:.1f} s")
    out = {"iter_s": med, "device_ms": busy, "per": per, "err": err,
           "ms": ms, "plain": plain, "launches": device,
           "bytes": {"feat_view": 2 * 2 * (lr.G * 8 + F * 4) * Bp}}
    del bst, b2, ds, ds2, X, y, lr
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---- phase 4f: categorical features (categorical_feature) ---------------
CAT_ITERS, CAT_SMALL, CAT_WIDE = 4, 3, 200
CAT_PART_CHECKS = 8             # categorical splits whose partition is held
CAT_CUT = 500_000               # rows of the card-vs-CPU first tree


def make_cat_data(rows):
    """Phase 4e's rows (make_efb_data's draws) with its 8 categoricals of
    32 levels as integer columns instead of one-hot, and two more from a
    RandomState of their own, so that 4e's draws do not move: one of 3
    levels (the one-vs-rest arm; its per-level effects three times the
    others') and one of 200 levels (the sorted arm past
    max_cat_threshold = 32), each with a per-level effect; F = 38."""
    rng = np.random.RandomState(7)
    X = rng.normal(size=(rows, FEATURES)).astype(np.float32)
    w = rng.normal(size=FEATURES)
    logit = X.dot(w) * 0.5
    noise = rng.normal(size=rows)
    crng = np.random.RandomState(8)
    cats = crng.randint(0, EFB_LEVELS, size=(rows, EFB_CATS))
    effect = crng.normal(size=(EFB_CATS, EFB_LEVELS))
    logit = logit + effect[np.arange(EFB_CATS), cats].sum(axis=1)
    xrng = np.random.RandomState(9)
    # the effects first, so that they do not move with the row count
    small_eff = 3.0 * xrng.normal(size=CAT_SMALL)
    wide_eff = xrng.normal(size=CAT_WIDE)
    small = xrng.randint(0, CAT_SMALL, size=rows)
    wide = xrng.randint(0, CAT_WIDE, size=rows)
    logit = logit + small_eff[small] + wide_eff[wide]
    out = np.empty((rows, FEATURES + EFB_CATS + 2), np.float32)
    out[:, :FEATURES] = X
    out[:, FEATURES:FEATURES + EFB_CATS] = cats
    out[:, -2] = small
    out[:, -1] = wide
    y = (logit + noise > 0).astype(np.float32)
    return out, y


def cat_arms(tree, mappers, onehot_max):
    """(one-vs-rest, sorted) categorical node counts of a tree."""
    n = tree.num_nodes()
    feats = tree.split_feature[:n][tree.is_categorical_node()]
    nb = np.asarray([mappers[int(f)].num_bin for f in feats])
    return int((nb <= onehot_max).sum()), int((nb > onehot_max).sum())


def tie_gain(tree, s, rows, left, g, h, mappers, cat_l2):
    """A split's f64 gain from binary gradients, its children with the
    arm's l2 (cat_l2 on the sorted categorical arm), and the sum of the
    |leaf gains| it is held against."""
    l2c = 0.0
    if s < tree.num_leaves - 1 and int(tree.decision_type[s]) & 1 and \
            mappers[int(tree.split_feature[s])].num_bin > 4:
        l2c = cat_l2
    out = []
    for m, l2 in ((left, l2c), (rows & ~left, l2c), (rows, 0.0)):
        sg, sh = g[m].sum(), h[m].sum()
        out.append(sg * sg / (sh + l2) if sh + l2 > 0 else 0.0)
    return out[0] + out[1] - out[2], sum(abs(v) for v in out)


def first_cat_tie(ta, tb, X, y, score, mappers, what):
    """The first split where trees ``ta`` and ``tb`` (host Trees of one
    iteration, grown from the scores ``score``) partition the rows
    differently, checked to be an exact tie in f64 (1e-9 of the split's
    |leaf gains|); None when they partition every row alike."""
    la, lb = ta.predict_leaf(X), tb.predict_leaf(X)
    p = 1.0 / (1.0 + np.exp(-score))
    g, h = p - y, p * (1.0 - p)

    sa, sb = split_sets(ta, la), split_sets(tb, lb)
    for s in range(min(len(sa), len(sb))):
        if np.array_equal(sa[s][0], sb[s][0]) and np.array_equal(
                sa[s][1], sb[s][1]):
            continue
        va, ma = tie_gain(ta, s, *sa[s], g, h, mappers, 10.0)
        vb, mb = tie_gain(tb, s, *sb[s], g, h, mappers, 10.0)
        check(abs(va - vb) <= 1e-9 * max(1.0, ma, mb),
              f"{what}: split {s} partitions differently with f64 gains "
              f"{va!r} and {vb!r}")
        return s
    check(len(sa) == len(sb), f"{what}: {len(sa)} and {len(sb)} splits")
    return None


def check_cat_kernels(scat, sp, tpart, lr, pb, pg):
    """On every launch of one tree, as the learner's own sequence runs
    on copies of its row buffers: split_pair then split_cat on the card
    against split_pair_plain then split_cat_plain on the CPU, bit for bit
    (rows and sets); the partition of the first CAT_PART_CHECKS
    categorical steps against partition_leaf_plain on the CPU (bins,
    payload words, left count).  Returns the largest bit differences,
    the launches compared, the arms the partitions took and the last
    state's inputs (for the timing)."""
    from lightgbm_tpu_torch.ops import tree_step as ts
    pb, pg = pb.clone(), pg.clone()
    err = {"split_cat": 0.0, "partition": 0.0}
    kw = dict(l1=lr.l1, l2=lr.l2, max_delta_step=lr.max_delta_step,
              min_gain_to_split=lr.min_gain_to_split,
              min_data_in_leaf=lr.min_data_in_leaf,
              min_sum_hessian=lr.min_sum_hessian, max_depth=lr.max_depth)
    F, Bp = lr.F, lr.children.shape[-1]
    fm, cats = lr.fmeta_pair, lr.cat_feats
    fm_c, cats_c = fm.cpu(), cats.cpu()
    n = {"split_cat": 0, "partition": 0}
    state = {}

    def search():
        ch = lr.children
        hg, hh = ch[0].view(-1, Bp), ch[1].view(-1, Bp)
        rows = sp.split_pair(hg, hh, fm, lr.info, **kw)
        pre = rows.to("cpu", copy=True)
        sets = torch.zeros((2, lr.W), dtype=torch.int32, device=lr.device)
        scat.split_cat(hg, hh, fm, lr.info, cats, rows, sets,
                       work=lr.cat_work, **kw, **lr.cat_kw)
        want, wset = pre.clone(), torch.zeros((2, lr.W), dtype=torch.int32)
        scat.split_cat_plain(hg.cpu(), hh.cpu(), fm_c, lr.info.cpu(), cats_c,
                             want, wset, **kw, **lr.cat_kw)
        got = rows.cpu()
        err["split_cat"] = max(err["split_cat"], bits_err(
            got.view(torch.int32), want.view(torch.int32)),
            bits_err(sets.cpu(), wset))
        check(torch.equal(got.view(torch.int32), want.view(torch.int32))
              and torch.equal(sets.cpu(), wset),
              f"split_cat: kernel and split_cat_plain differ at launch "
              f"{n['split_cat']}")
        lr.pair_out.copy_(rows)
        lr.paircat.copy_(sets)
        n["split_cat"] += 1
        state.update(hg=hg.clone(), hh=hh.clone(), info=lr.info.clone(),
                     pre=pre.to(lr.device))

    torch.amax(pg[:2].abs(), dim=1, out=lr._absmax)
    lr._body(pb, pg, lr.root_step)
    torch.stack([lr.children[0, 0, 0].sum(), lr.children[1, 0, 0].sum()],
                out=lr.sums)
    lr._step(ts.MODE_ROOT)
    search()
    arms = []
    while True:
        lr._step(ts.MODE_STEP)
        w = lr.step.cpu()
        if int(w[tpart.SB_DONE]):
            break
        held = int(w[tpart.SB_ISCAT]) and n["partition"] < CAT_PART_CHECKS
        if held:
            b0, g0 = pb.to("cpu", copy=True), pg.to("cpu", copy=True)
        lr._body(pb, pg, lr.step)
        if held:
            nl = tpart.partition_leaf_plain(b0, g0, w)
            gb, gg = pb.cpu(), pg.cpu()
            err["partition"] = max(err["partition"], bits_err(gb, b0),
                                   bits_err(gg.view(torch.int32),
                                            g0.view(torch.int32)))
            check(int(lr.nl[0]) == int(nl) and torch.equal(gb, b0)
                  and torch.equal(gg.view(torch.int32),
                                  g0.view(torch.int32)),
                  f"partition: a categorical step (leaf "
                  f"{int(w[tpart.SB_LEAF])}) "
                  f"differs from partition_leaf_plain")
            arms.append(int(w[tpart.SB_NB]))
            n["partition"] += 1
            del b0, g0, gb, gg
        search()
    lr._step(ts.MODE_FINAL)
    del pb, pg
    return err, n, arms, state


def cat_path(lgt, mods, efb):
    """Phase 4f: categorical features on phase 4e's 2,000,000 rows, the
    8 categoricals as integer columns with ``categorical_feature`` plus a
    3-level and a 200-level one (F = 38): the learner takes the
    subtraction body at K=1 with split_cat after the pair search.  The
    first tree on the card bit-identical to the eager oracle's, with
    categorical nodes on both arms; on the first CAT_CUT rows the card's
    first tree equal to the CPU plain loop's (or its first difference an
    exact tie in f64); every wrapper's count set
    to 0 before 4 profiled iterations and read after, the device launches
    by function, one capture, one tree read a tree, logloss falling;
    split_cat bit-identical to split_cat_plain on every launch of a tree
    and the partition of categorical steps to partition_leaf_plain;
    100,000 rows with NaN, negative, unseen and non-integer categories
    predicted as the host Tree.predict, and again after a save and
    reload; s/iteration beside phase 4e's one-hot run."""
    from lightgbm_tpu_torch.ops import split_cat as scat
    from lightgbm_tpu_torch.ops import partition as tpart
    from lightgbm_tpu_torch.ops import split_pair as sp
    from torch.profiler import ProfilerActivity, profile
    t0 = time.time()
    X, y = make_cat_data(EFB_ROWS)
    F = X.shape[1]
    cat_cols = list(range(FEATURES, F))
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
              "learning_rate": 0.1, "verbosity": -1}
    ds = lgt.Dataset(X, label=y, categorical_feature=cat_cols)
    ds.construct(params)
    mappers = ds._inner.bin_mappers
    nbins = [mappers[f].num_bin for f in cat_cols]
    check(nbins[:-1] == [EFB_LEVELS + 1] * EFB_CATS + [CAT_SMALL + 1]
          and nbins[-1] > EFB_LEVELS + 1,
          f"cat: categorical num_bin {nbins}")
    say(f"cat data and construct: {X.shape}, categorical columns "
        f"{cat_cols[0]}..{cat_cols[-1]} of {nbins[0]}, {nbins[-2]} and "
        f"{nbins[-1]} bins, {ds._inner.num_groups} groups, "
        f"{time.time() - t0:.1f} s")
    ref = lgt.Booster(params=params, train_set=ds)
    ref._gbdt.learner.build_tree = ref._gbdt.learner.build_tree_eager
    ref.update()
    bst = lgt.Booster(params=params, train_set=ds)
    lr = bst._gbdt.learner
    check(lr.has_cat and lr.subtract and lr.K == 1 and not lr.bundled
          and lr.F == F and len(lr.cat_feats) == len(cat_cols),
          f"cat: learner has_cat {lr.has_cat} subtract {lr.subtract} K "
          f"{lr.K} bundled {lr.bundled} F {lr.F}")
    for m in mods.values():
        m.launches = 0
    iter_s, losses = [], []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for it in range(CAT_ITERS):
            t0 = time.time()
            bst.update()
            torch.cuda.synchronize()
            iter_s.append(time.time() - t0)
            losses.append(bst.eval_train()[0][2])
            if it == 0:
                lb = ref._gbdt.learner
                for t in ("leafmat", "nodemat", "nodecat", "leafcat"):
                    check(torch.equal(getattr(lr, t).view(torch.int32),
                                      getattr(lb, t).view(torch.int32)),
                          f"cat: the graph's first tree's {t} differs from "
                          f"the eager oracle's")
                (pa, ga), (pr, gr) = bst._gbdt._phys, ref._gbdt._phys
                check(torch.equal(pa, pr) and torch.equal(
                    ga.view(torch.int32), gr.view(torch.int32)),
                      "cat: the row order after the first tree differs "
                      "from the eager oracle's")
                del ref, lb, pr, gr
    calls = {k: m.launches for k, m in mods.items()}
    device = {}
    for key, _, n in device_rows(prof):
        fn = func(key)
        if fn in KERNEL_FUNCS["cat"]:
            device[fn] = device.get(fn, 0) + n
    del prof
    want = dict(per_tree("subtraction"), split_cat=SPLITS + 1)
    for k in mods:
        check(calls[k] == 2 * want.get(k, 0),
              f"cat: {k}: {calls[k]} wrapper calls, expected "
              f"{2 * want.get(k, 0)}")
    fn_want = dict(funcs_per_tree("subtraction"), cat_search=SPLITS + 1)
    for fn, n in fn_want.items():
        check(device.get(fn, 0) == (CAT_ITERS + 1) * n,
              f"cat: {fn}: {device.get(fn, 0)} device launches, expected "
              f"{(CAT_ITERS + 1) * n}")
    check(lr.syncs == lr.replays == CAT_ITERS and lr.captures == 1,
          f"cat: {lr.syncs} tree reads, {lr.replays} replays, "
          f"{lr.captures} captures for {CAT_ITERS} trees")
    check(all(a > b for a, b in zip(losses, losses[1:])),
          f"cat: training logloss does not fall: {losses}")
    first = bst._gbdt.models[0]
    arms = cat_arms(first, mappers, 4)
    check(arms[0] > 0 and arms[1] > 0, f"cat: the first tree's categorical "
                                       f"nodes by arm (one-vs-rest, sorted) "
                                       f"{arms}")
    med = float(np.median(iter_s[1:]))
    say(f"cat train: s/iteration {[round(s, 4) for s in iter_s]} (under "
        f"the profiler; median of iterations 2-4 {med:.4f} against phase "
        f"4e's one-hot {efb['iter_s']:.4f} on the same rows); wrapper "
        f"calls {calls}; device launches {device}; one capture, one tree "
        f"read a tree; binary_logloss {losses}; first tree bit-identical "
        f"to the eager oracle's (leafmat, nodemat, category sets, row "
        f"order), {arms[0]} one-vs-rest and {arms[1]} sorted categorical "
        f"nodes of {first.num_leaves - 1}")
    per, busy = profile_iteration(bst, med, "cat")
    for k, (ms, n) in sorted(per.items()):
        print(f"  cat {k}: {ms:.3f} ms device time per iteration, {n} "
              f"device launches", flush=True)
    # the first tree on the card and on the CPU (the plain versions), on
    # the first CAT_CUT rows
    t0 = time.time()
    d_cut = relabeled(lgt, ds, X, y, CAT_CUT)
    cuts = []
    for dev_kw in ({}, {"device_type": "cpu"}):
        cb = lgt.Booster(params=dict(params, **dev_kw), train_set=d_cut)
        cb.update()
        cuts.append((cb._gbdt.models[0], cb._gbdt.init_scores[0]))
    (tk, init), (tc, _) = cuts
    tie = None
    if not (same_trees([tk], [tc], exact=False)
            and tk.cat_threshold == tc.cat_threshold):
        tie = first_cat_tie(tk, tc, X[:CAT_CUT].astype(np.float64),
                            y[:CAT_CUT], np.full(CAT_CUT, init), mappers,
                            "cat card vs CPU tree 0")
    say(f"cat first tree on a {CAT_CUT}-row cut against the CPU plain "
        f"loop: "
        + ("equal (structure, leaf values within rtol 1e-4 / atol 1e-5)"
           if tie is None else f"equal up to split {tie}, an exact tie in "
                               f"f64")
        + f"; nodes by arm: the card's tree {cat_arms(tk, mappers, 4)}, "
          f"the CPU's {cat_arms(tc, mappers, 4)}; {time.time() - t0:.1f} s")
    del d_cut, cuts, cb
    pb_, pg_ = bst._gbdt._phys
    err, nk, part_nb, st = check_cat_kernels(scat, sp, tpart, lr, pb_, pg_)
    say(f"cat kernels: split_cat bit-identical to split_cat_plain on all "
        f"{nk['split_cat']} launches of a tree (rows and sets), the "
        f"partition of {nk['partition']} categorical steps (num_bin "
        f"{part_nb}) bit-identical to partition_leaf_plain")
    del pb_, pg_
    # ms a launch on the last state: CUDA events around a replayed graph
    # of 200 launches (the device time, as the tree's graph launches it)
    # and around 200 launches from Python; the plain version beside it
    kw = dict(l1=lr.l1, l2=lr.l2, max_delta_step=lr.max_delta_step,
              min_gain_to_split=lr.min_gain_to_split,
              min_data_in_leaf=lr.min_data_in_leaf,
              min_sum_hessian=lr.min_sum_hessian, max_depth=lr.max_depth)
    rows, sets = st["pre"].clone(), torch.zeros((2, lr.W), dtype=torch.int32,
                                                device=lr.device)
    args = (st["hg"], st["hh"], lr.fmeta_pair, st["info"], lr.cat_feats)

    def launch():
        scat.split_cat(*args, rows, sets, work=lr.cat_work, **kw,
                       **lr.cat_kw)
    ms = graph_ms(launch, 200)
    py_ms = cuda_ms(launch, 200)
    plain_ms = cuda_ms(lambda: scat.split_cat_plain(
        *args, rows, sets, **kw, **lr.cat_kw), 5)
    # the bytes the search must move: each child's grad and hess bins of
    # the categorical features up to their own num_bin (not the padded
    # width), their metadata and info rows, the feature list, the pair
    # rows read and written and the sets written
    NC, Bp = len(lr.cat_feats), st["hg"].shape[1]
    nbs = lr.fmeta_pair[lr.cat_feats.long(), sp.FM_NUM_BIN].cpu().numpy()
    nbs = nbs.astype(np.float64)
    nbytes = (2 * 2 * nbs.sum() * 4
              + 2 * NC * (lr.fmeta_pair.shape[1] + st["info"].shape[1]) * 4
              + NC * 4 + 2 * 2 * 13 * 4 + 2 * 8 * 4)
    # a sort's compares, the scans and the gains of each child's bins
    ops = 2 * float((nbs * (np.ceil(np.log2(np.maximum(nbs, 2))) + 60))
                    .sum())
    cat_bound = bound(nbytes, ops)
    say(f"split_cat @ 2 children x {NC} categorical features of "
        f"{int(nbs.sum())} bins in all ({Bp} padded): "
        f"{ms:.4f} ms a launch (CUDA events, graph replay of 200; "
        f"{py_ms:.4f} ms a launch from Python), plain {plain_ms:.3f} ms, "
        f"bound {cat_bound[0]:.6f} ms ({cat_bound[1]}); no single PyTorch "
        f"call computes it, library_ms null")
    # raw prediction of edge categories against the host Tree.predict
    Xp = X[:100_000].astype(np.float64)
    rng = np.random.RandomState(10)
    for c in cat_cols:
        r = rng.rand(len(Xp))
        Xp[r < 0.03, c] = np.nan
        Xp[(r >= 0.03) & (r < 0.06), c] = -1.0 - rng.randint(0, 5)
        Xp[(r >= 0.06) & (r < 0.09), c] = CAT_WIDE + rng.randint(0, 50)
        Xp[(r >= 0.09) & (r < 0.12), c] += 0.7
    t0 = time.time()
    raw = bst.predict(Xp, raw_score=True)
    host = sum(t.predict(Xp) for t in bst._gbdt.models)
    check(np.array_equal(raw, host), f"cat predict: the card and the host "
                                     f"Tree.predict differ by "
                                     f"{np.abs(raw - host).max()!r}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cat.txt")
        bst.save_model(path)
        again = lgt.Booster(model_file=path).predict(Xp, raw_score=True)
    check(np.array_equal(raw, again), "cat predict: the reloaded model "
                                      "predicts other raw scores")
    say(f"cat predict: 100,000 rows with NaN, negative, unseen (>= "
        f"{CAT_WIDE}) and non-integer categories equal to the host "
        f"Tree.predict bit for bit, and after save and reload; "
        f"{time.time() - t0:.1f} s")
    out = {"iter_s": med, "iter_all": iter_s, "device_ms": busy, "per": per,
           "err": err["split_cat"], "part_err": err["partition"], "ms": ms,
           "py_ms": py_ms, "plain_ms": plain_ms, "bound": cat_bound,
           "iter_bound": cat_bound[0] * (SPLITS + 1),
           "launches": device.get("cat_search", 0), "arms": arms}
    del bst, ds, X, y, lr, st, args, rows, sets, launch
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---- phase 4d: row and feature sampling at the HIGGS shape -------------
SAMPLE_ITERS = 4
SAMPLE_CONFIGS = {"none": {},
                  "bagging": {"bagging_fraction": 0.8, "bagging_freq": 1},
                  "goss": {"data_sample_strategy": "goss"},
                  "feature_fraction": {"feature_fraction": 0.8}}


def sampling_path(lgt, mods, ds, params):
    """Phase 4d: bagging, GOSS and feature_fraction at the HIGGS shape on
    the mega path (auto: the frontier at K=4) and the subtraction path,
    beside the unsampled run.  sample.cu bit-identical to sample_plain at
    full size in each mode (the payload words and the in-bag count); per
    learner one graph capture for every draw and one tree read a tree; the
    root of each tree counts the rows the card sampled; logloss falls;
    s/iteration and sample's ms an iteration."""
    from lightgbm_tpu_torch.ops import sample as smp
    from lightgbm_tpu_torch.utils import random as jr
    out = {"iter_s": {}, "launches": 0}
    for body, extra in (("mega", {}), ("subtraction",
                                       {"tpu_megakernel": "off"})):
        for name, cfg in SAMPLE_CONFIGS.items():
            bst = lgt.Booster(dict(params, **cfg, **extra), ds)
            g = bst._gbdt
            lr = g.learner
            for m in mods.values():
                m.launches = 0
            times, losses = [], []
            for _ in range(SAMPLE_ITERS):
                t0 = time.time()
                bst.update()
                torch.cuda.synchronize()
                times.append(time.time() - t0)
                losses.append(bst.eval_train()[0][2])
                bag = int(lr.bag[0])
                root = int(g.models[-1].internal_count[0])
                h = g._phys[1][1]
                nz = int((h != 0).sum())
                check(bag == root == nz,
                      f"sampling {body} {name}: bag word {bag}, root count "
                      f"{root}, sampled rows in the payload {nz}")
                check((bag < lr.N) == (name in ("bagging", "goss")),
                      f"sampling {body} {name}: {bag} of {lr.N} rows")
            n_sample = mods["sample"].launches
            check(n_sample == (SAMPLE_ITERS if name in ("bagging", "goss")
                               else 0),
                  f"sampling {body} {name}: sample launched {n_sample} "
                  f"times in {SAMPLE_ITERS} iterations")
            out["launches"] += n_sample
            check(lr.captures == 1 and lr.replays == lr.syncs == SAMPLE_ITERS,
                  f"sampling {body} {name}: {lr.captures} captures, "
                  f"{lr.replays} replays, {lr.syncs} tree reads for "
                  f"{SAMPLE_ITERS} trees")
            check(all(a > b for a, b in zip(losses, losses[1:])),
                  f"sampling {body} {name}: logloss does not fall: {losses}")
            med = float(np.median(times[1:]))
            out["iter_s"][f"{body} {name}"] = med
            say(f"sampling {body} {name} (K={lr.K}): s/iteration "
                f"{[round(s, 4) for s in times]} (median of 2-"
                f"{SAMPLE_ITERS} {med:.4f}); last bag {bag} of {lr.N}; one "
                f"capture, one tree read a tree; binary_logloss {losses}")
            if body == "mega" and name == "goss":
                ghi = g._phys[1]
                top_k, other_k = g._goss_k
                pre = ghi.clone()
                out["goss_threshold_ms"] = cuda_ms(
                    lambda: smp.goss_threshold(pre, lr.N, top_k), 5)
            if body == "subtraction" and name == "none":
                payload = g._phys[1].clone()
                N = lr.N
            del bst, g, lr
            torch.cuda.empty_cache()
    # the kernel against its plain version at full size, in each mode, on
    # the payload of a real iteration
    key = jr.fold_in(jr.PRNGKey(3), 7)
    top_k, other_k = max(int(N * 0.2), 1), max(int(N * 0.1), 1)
    thr, n_top = smp.goss_threshold(payload, N, top_k)
    kw = dict(N=N, key=key, frac=0.8, pos_frac=0.5, neg_frac=0.9,
              sign_row=4, thr=thr, n_top=n_top, other_k=other_k,
              mult=(N - top_k) / other_k)
    err, counts = 0.0, {}
    for mode in (smp.MODE_BAG, smp.MODE_BALANCED, smp.MODE_GOSS):
        a, b = payload.clone(), payload.clone()
        ba = torch.zeros(1, dtype=torch.int32, device=a.device)
        bb = torch.zeros(1, dtype=torch.int32, device=a.device)
        smp.sample_cuda(a, ba, mode, **kw)
        smp.sample_plain(b, bb, mode, **kw)
        err = max(err, bits_err(a.view(torch.int32), b.view(torch.int32)))
        check(torch.equal(a.view(torch.int32), b.view(torch.int32))
              and int(ba[0]) == int(bb[0]),
              f"sample mode {mode}: kernel and sample_plain differ (counts "
              f"{int(ba[0])} and {int(bb[0])})")
        counts[mode] = int(ba[0])
    Np = payload.shape[1]
    work = payload.clone()
    bag = torch.zeros(1, dtype=torch.int32, device=work.device)
    out.update(
        err=err, counts=counts, Np=Np,
        ms=cuda_ms(lambda: smp.sample_cuda(work, bag, smp.MODE_BAG, **kw),
                   20),
        plain_ms=cuda_ms(lambda: smp.sample_plain(work, bag, smp.MODE_BAG,
                                                  **kw), 3),
        lib_ms=cuda_ms(lambda: torch.rand(Np, device=work.device), 20),
        nbytes=Np * 4 * 5)
    say(f"sample: the kernel bit-identical to sample_plain at {Np} rows in "
        f"each mode, in-bag counts {counts} equal; {out['ms']:.4f} ms a "
        f"launch (bagging), plain {out['plain_ms']:.3f} ms, torch.rand of "
        f"the same length {out['lib_ms']:.4f} ms; GOSS threshold "
        f"(torch.topk) {out['goss_threshold_ms']:.3f} ms")
    del payload, work, a, b
    torch.cuda.empty_cache()
    return out


# ---- phase 4g: the other objectives and multiclass at the HIGGS shape ----
OBJ_CUT = 200_000               # rows of the card-vs-CPU first iteration
OBJ_RUNS = (("quantile", {"objective": "quantile", "alpha": 0.9,
                          "metric": "quantile"}, 4, ("mega", "subtraction")),
            ("multiclass", {"objective": "multiclass", "num_class": 5,
                            "metric": "multi_logloss"}, 3,
             ("mega", "subtraction")),
            ("multiclassova", {"objective": "multiclassova", "num_class": 5,
                               "metric": "multi_logloss"}, 2, ("mega",)))
BODIES = {"mega": {}, "subtraction": {"tpu_megakernel": "off"}}
BODY_KERNELS = {"mega": ("split_mega", "split_pair"),
                "subtraction": ("partition", "leaf_hist", "hist_rmw",
                                "split_pair", "tree_step")}


def objective_labels(X):
    """A continuous label (a fixed linear combination of the features
    plus seeded noise) and a 5-class one, its quintiles."""
    rng = np.random.RandomState(11)
    w = rng.normal(size=X.shape[1]).astype(np.float32)
    yc = X.dot(w) + rng.normal(size=len(X)).astype(np.float32)
    cuts = np.quantile(yc, [0.2, 0.4, 0.6, 0.8])
    return yc.astype(np.float32), np.searchsorted(
        cuts, yc, side="right").astype(np.float32)


def relabeled(lgt, ds, X, label, rows=None):
    """``ds`` (constructed) with another label, cut to its first ``rows``
    rows when given: the same bins and mappers, no second binning."""
    import copy as copy_mod
    from lightgbm_tpu_torch.dataset import Metadata
    inner = copy_mod.copy(ds._inner)
    if rows is not None:
        inner.binned, inner.num_data = inner.binned[:rows], rows
        X, label = X[:rows], label[:rows]
    inner.metadata = Metadata(inner.num_data)
    inner.metadata.set_label(label)
    out = lgt.Dataset(X, label=label)
    out._inner = inner
    return out


def first_grads(name, params, y, init):
    """(K, N) f64 gradients of the first iteration at the init scores."""
    K = len(init)
    if name == "quantile":
        a = params["alpha"]
        return (np.where(init[0] - y >= 0, 1.0 - a, -a)[None],
                np.ones((1, len(y))))
    Y = (np.arange(K)[:, None] == y[None]).astype(np.float64)
    if name == "multiclass":
        e = np.exp(np.asarray(init) - max(init))
        p = (e / e.sum())[:, None] * np.ones(len(y))
        return p - Y, K / (K - 1.0) * p * (1.0 - p)
    p = 1.0 / (1.0 + np.exp(-np.asarray(init)))[:, None] * np.ones(len(y))
    return p - Y, p * (1.0 - p)


def tree_tie(ta, tb, X, g, h, what, exact=False):
    """The first split where host trees ``ta`` (the card's) and ``tb``
    (the CPU's) partition the rows of ``X`` differently, checked to be a
    tie: both choices' f64 gains from ``g`` / ``h`` differ by less than
    the CPU's f32 resolution, or with ``exact`` by less than 1e-9 of
    their mass (integer carriers, which both devices sum exactly; both
    gains are printed then).  The card's histograms are exact integers;
    the CPU sums f32 values, whose sum of n terms is off by at most n
    2^-24 times the sum of their magnitudes, so a gain G^2 / H is off by
    at most 2 |G| / H eG + G^2 / H^2 eH (eG, eH those bounds of G and H)
    -- gains closer than that the CPU cannot part.  None when every split
    agrees, else (split, the card's gain, the CPU's, the bound)."""
    def gain(rows, left):
        total = err = mass = 0.0
        for sign, m in ((1, left), (1, rows & ~left), (-1, rows)):
            n, sg, sh = int(m.sum()), g[m].sum(), h[m].sum()
            if sh <= 0:
                continue
            eg, eh = (n * 2.0 ** -24 * np.abs(v[m]).sum() for v in (g, h))
            total += sign * sg * sg / sh
            err += 2 * abs(sg) / sh * eg + sg * sg / (sh * sh) * eh
            mass += sg * sg / sh
        return total, 1e-9 * max(1.0, mass) if exact else err

    sa, sb = (split_sets(t, t.predict_leaf(X)) for t in (ta, tb))
    for s in range(max(len(sa), len(sb))):
        if s < min(len(sa), len(sb)) and np.array_equal(
                sa[s][0], sb[s][0]) and np.array_equal(sa[s][1], sb[s][1]):
            continue
        (va, ea), (vb, eb) = (gain(*x[s]) if s < len(x) else (0.0, 0.0)
                              for x in (sa, sb))
        tol = max(ea, eb) if exact else ea + eb
        if exact:
            print(f"  {what}: split {s} partitions differently; f64 gains "
                  f"card {va!r}, CPU {vb!r}", flush=True)
        check(abs(va - vb) <= tol,
              f"{what}: split {s} partitions differently with f64 gains "
              f"{va!r} and {vb!r}, further apart than {tol:.3g}")
        return s, float(va), float(vb), float(tol)
    return None


def objectives_path(lgt, mods, ds, X, params):
    """Phase 4g: quantile (alpha 0.9, leaves renewed), multiclass (5
    classes, the quintiles of a continuous label) and multiclassova on
    the HIGGS rows and bins of ``ds``, beside binary on each body.  Per
    run: the metric falls every iteration, one capture and one tree read
    a tree, the body's kernels launched (counts set to 0 before the run),
    save / reload / predict bit-identical ((100k, 5) for K classes), the
    card's renewed leaf values bit-identical to the plain renewal of the
    same inputs copied to the host, the first iteration's trees equal to
    the CPU plain loop's on a 200,000-row cut (or their first difference
    a tie at the CPU's f32 resolution, ``tree_tie``), with quantile's
    renewed values equal and the card's class-tree leaf values -G / H of
    their rows in f64 (rtol 1e-5); s/
    iteration and device ms an iteration (torch.profiler), the renewal's
    device ms a tree and the per-class gather and scatter's."""
    from lightgbm_tpu_torch.models import boosting as bmod
    from torch.profiler import ProfilerActivity, profile
    t_phase = time.time()
    yc, yk = objective_labels(X)
    labels = {"quantile": yc, "multiclass": yk, "multiclassova": yk}
    renew = {"ms": [], "checked": 0}
    real = bmod.renew_leaves
    check_next = [False]

    def renew_checked(*args):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = real(*args)
        e1.record()
        if check_next[0]:
            host = real(*(a.cpu() if isinstance(a, torch.Tensor) else a
                          for a in args))
            check(torch.equal(out.cpu().view(torch.int32),
                              host.view(torch.int32)),
                  "quantile: the card's renewed leaf values differ from the "
                  "plain renewal of the same inputs on the host")
            renew["checked"] += 1
            check_next[0] = False
        torch.cuda.synchronize()
        renew["ms"].append(e0.elapsed_time(e1))
        return out
    bmod.renew_leaves = renew_checked

    def timed(bst, iters, losses=None):
        times = []
        for _ in range(iters):
            t0 = time.time()
            bst.update()
            torch.cuda.synchronize()
            times.append(time.time() - t0)
            if losses is not None:
                losses.append(bst.eval_train()[0][2])
        return times

    def device_ms(bst):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            bst.update()
            torch.cuda.synchronize()
        return sum(ms for _, ms, _ in device_rows(prof))

    out = {"binary": {}, "runs": {}}
    for body in ("mega", "subtraction"):
        b = lgt.Booster(dict(params, **BODIES[body]), ds)
        times = timed(b, 4)
        out["binary"][body] = (float(np.median(times[1:])), device_ms(b))
        del b
        torch.cuda.empty_cache()
    Xp = X[:100_000].astype(np.float64)
    cut = X[:OBJ_CUT]
    for name, extra, iters, bodies in OBJ_RUNS:
        y = labels[name]
        d_name = relabeled(lgt, ds, X, y)
        d_cut = relabeled(lgt, ds, X, y, OBJ_CUT)
        for body in bodies:
            p = dict(params, **extra, **BODIES[body])
            bst = lgt.Booster(p, d_name)
            g, lr = bst._gbdt, bst._gbdt.learner
            K = g.num_tree_per_iteration
            for m in mods.values():
                m.launches = 0
            check_next[0] = name == "quantile"
            losses = []
            times = timed(bst, iters, losses)
            calls = {k: m.launches for k, m in mods.items()}
            check(all(calls[k] > 0 for k in BODY_KERNELS[body]),
                  f"{name} {body}: a kernel of the body was not launched: "
                  f"{calls}")
            check(lr.captures == 1 and lr.syncs == lr.replays == iters * K,
                  f"{name} {body}: {lr.captures} captures, {lr.replays} "
                  f"replays, {lr.syncs} tree reads for {iters * K} trees")
            check(all(a > b_ for a, b_ in zip(losses, losses[1:])),
                  f"{name} {body}: the training metric does not fall: "
                  f"{losses}")
            med = float(np.median(times[1:]))
            dev = device_ms(bst)
            raw = bst.predict(Xp, raw_score=True)
            check(raw.shape == ((len(Xp), K) if K > 1 else (len(Xp),))
                  and np.isfinite(raw).all(),
                  f"{name} {body}: raw predictions of shape {raw.shape}")
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "m.txt")
                bst.save_model(path)
                again = lgt.Booster(model_file=path)
                check(np.array_equal(again.predict(Xp, raw_score=True), raw)
                      and np.array_equal(again.predict(Xp),
                                         bst.predict(Xp)),
                      f"{name} {body}: the reloaded model predicts other "
                      f"scores")
            run = {"iter_s": med, "iter_all": times, "device_ms": dev,
                   "losses": losses, "trees": [t.num_leaves for t in
                                               g.models[:K]]}
            if K > 1:
                # one class tree's gather of grad and hess into the
                # payload and scatter of its leaf values into its scores
                pb_, ghi = g._phys
                C, N = lr.row0, g.num_data
                gk = g._class_scores[0].clone()
                scores = g._class_scores.clone()
                rowid = ghi[2, C:C + N].view(torch.int32).long()
                delta = g._row_deltas()
                run["gather_ms"] = cuda_ms(lambda: (
                    bmod.rows_to_phys(ghi, gk, N),
                    bmod.rows_to_phys(ghi, gk, N)), 10)

                def scatter():
                    scores[0, rowid] += delta
                run["scatter_ms"] = cuda_ms(scatter, 10)
                run["grad_ms"] = cuda_ms(
                    lambda: g.objective.class_gradients(scores), 10)
                del pb_, ghi, gk, scores, rowid, delta
            # the first iteration on the card and on the CPU, on the cut
            cut_p = dict(p, verbosity=-1)
            firsts = []
            for dev_kw in ({}, {"device_type": "cpu"}):
                cb = lgt.Booster(dict(cut_p, **dev_kw), d_cut)
                cb.update()
                firsts.append(cb._gbdt)
            gc_, gcpu = firsts
            ties = []
            init = gc_.init_scores
            gg, hh = first_grads(name, extra, y[:OBJ_CUT].astype(np.float64),
                                 init)
            cut64 = cut.astype(np.float64)
            for k in range(K):
                ta, tb = gc_.models[k], gcpu.models[k]
                s = tree_tie(ta, tb, cut64, gg[k], hh[k],
                             f"{name} {body} card vs CPU class tree {k}")
                if s is not None:
                    ties.append((k,) + s)
                    continue
                if name == "quantile":
                    # renewed: percentiles of the same residuals
                    check(np.array_equal(ta.leaf_value, tb.leaf_value),
                          f"{name} {body}: card and CPU renewed leaf values "
                          f"differ")
                    continue
                # the card's exact sums against f64 ones of the leaves'
                # rows (the CPU's f32 subtraction chain is not held here)
                leaf = ta.predict_leaf(cut64)
                G = np.bincount(leaf, gg[k], ta.num_leaves)
                H = np.bincount(leaf, hh[k], ta.num_leaves)
                want = init[k] - params["learning_rate"] * G / H
                check(np.allclose(ta.leaf_value, want, rtol=1e-5, atol=1e-6),
                      f"{name} {body}: the card's class tree {k} leaf values "
                      f"differ from -G / H of their rows by "
                      f"{np.abs(ta.leaf_value - want).max()!r}")
            run["card_vs_cpu_ties"] = ties
            del firsts, gc_, gcpu
            out["runs"][f"{name} {body}"] = run
            bin_s, bin_dev = out["binary"][body]
            say(f"objective {name} {body} (K={lr.K}): s/iteration "
                f"{[round(t, 4) for t in times]} (median of 2-{iters} "
                f"{med:.4f}, binary {bin_s:.4f}); device ms an iteration "
                f"{dev:.2f} (binary {bin_dev:.2f}); {iters * K} trees, one "
                f"capture, one tree read a tree; metric {losses}; the "
                f"first iteration's trees partition the rows as the CPU's "
                f"on {OBJ_CUT} rows" + (f" up to ties at the CPU's f32 resolution "
                           f"(class tree, split, gain difference, bound) "
                           f"{ties}" if ties else "")
                + ("; gather {:.4f} ms (grad and hess), scatter {:.4f} ms, "
                   "gradients {:.3f} ms an iteration".format(
                       run["gather_ms"], run["scatter_ms"], run["grad_ms"])
                   if K > 1 else ""))
            del bst, g, lr
            torch.cuda.empty_cache()
        del d_name, d_cut
    bmod.renew_leaves = real
    check(renew["checked"] == 2, f"quantile: {renew['checked']} renewal "
                                 f"checks")
    out["renew_ms"] = float(np.median(renew["ms"]))
    out["renew_all"] = renew["ms"]
    say(f"objectives (phase 4g): the renewal {out['renew_ms']:.3f} ms a "
        f"tree at {ROWS} rows (median of {len(renew['ms'])}; bit-identical "
        f"to the plain renewal on the host on the first tree of each "
        f"body); {time.time() - t_phase:.1f} s")
    return out


# ---- phase 4l: DART, random forest, the eager iteration, rollback -------
BOOST_ITERS = 10
BOOST_CUT = 200_000             # rows of the card-vs-CPU runs
BOOST_CUT_LEAVES = 63           # their leaves: the CPU's plain loop
                                # grows 255 in ~12 s a run
DART_P = {"boosting": "dart", "drop_rate": 0.3, "skip_drop": 0.0,
          "max_drop": 50}
RF_P = {"boosting": "rf", "bagging_fraction": 0.632, "bagging_freq": 1,
        "feature_fraction": 0.8}
BAG7 = {"bagging_fraction": 0.7, "bagging_freq": 1}
EAGER_P = dict(BAG7, tpu_fused_iteration=False)
GOSS_L1_P = {"objective": "regression_l1", "data_sample_strategy": "goss",
             "metric": "l1"}
AUTO = {"tpu_frontier_k": "auto"}


def busy_share(bst):
    """One more iteration under torch.profiler: (device busy ms, wall
    ms)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        bst.update()
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
    return sum(ms for _, ms, _ in device_rows(prof)), wall


def first_grads_of(bst):
    """Wrap ``bst``'s learner so each tree's (grad, hess) -- payload rows
    0 and 1 as the tree starts, f64 in original row order, quantized
    carriers times their scale -- is kept."""
    from lightgbm_tpu_torch.models.boosting import scores_from_phys
    lr, out = bst._gbdt.learner, []
    build = lr.build_tree

    def rec(pb, pg, before_read=None):
        sc = lr.qscale.double().cpu()
        out.append(tuple((scores_from_phys(pg, lr.N, r).double().cpu()
                          * sc[r]).numpy() for r in (0, 1)))
        return build(pb, pg, before_read)
    lr.build_tree = rec
    return out


def boost_path(lgt, mods, ds, X, y, params):
    """Phase 4l (``--boost``): DART, random forest, the eager iteration
    and rollback at the HIGGS shape (see the module doc); returns the
    summary printed by ``--boost``."""
    from lightgbm_tpu_torch.models import boosting as bmod
    t_phase = time.time()
    walks = []                  # (run's iteration, train?, start, end)
    cur = [0]
    real_walk = bmod.GBDT._tree_to_scores

    def timed_walk(self, t, factor, train=True, valid=True):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        real_walk(self, t, factor, train, valid)
        e1.record()
        walks.append((cur[0], train, e0, e1))
    bmod.GBDT._tree_to_scores = timed_walk
    renews = []
    real_renew = bmod.renew_leaves

    def timed_renew(*args):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = real_renew(*args)
        e1.record()
        renews.append((e0, e1))
        return out
    bmod.renew_leaves = timed_renew
    Xp = X[:100_000].astype(np.float64)
    out = {}

    def run(label, p, data, iters, body, auc=False):
        """``iters`` iterations of a fresh booster, counts set to 0 before
        and read after; its per-iteration wall s (a device sync ends
        each), the dropped count (DART) and training AUC each iteration."""
        bst = lgt.Booster(p, data)
        g, lr = bst._gbdt, bst._gbdt.learner
        for m in mods.values():
            m.launches = 0
        del walks[:]
        times, drops, aucs = [], [], []
        for i in range(iters):
            cur[0] = i
            t0 = time.time()
            bst.update()
            torch.cuda.synchronize()
            times.append(time.time() - t0)
            if isinstance(g, bmod.DART):
                drops.append(len(g.last_drops))
            if auc:
                aucs.append(bst.eval_train()[0][2])
        calls = {k: m.launches for k, m in mods.items()}
        check(all(calls[k] > 0 for k in BODY_KERNELS[body]),
              f"{label}: a kernel of the {body} body was not launched: "
              f"{calls}")
        check(lr.captures == 1 and lr.syncs == lr.replays == iters
              and len(g.models) == iters,
              f"{label}: {lr.captures} captures, {lr.replays} replays, "
              f"{lr.syncs} tree reads, {len(g.models)} trees for {iters}")
        sc = g.scores.cpu().numpy()
        check(sc.shape == (len(y),) and np.isfinite(sc).all(),
              f"{label}: train scores not finite")
        return bst, times, drops, aucs

    # ---- DART on both bodies, beside GBDT --------------------------------
    for body, extra in (("mega", AUTO), ("subtraction", BODIES["subtraction"])):
        _, gt, _, _ = run(f"gbdt {body}", dict(params, **extra), ds,
                          BOOST_ITERS, body)
        label = f"dart {body}"
        bst, times, drops, _ = run(label, dict(params, **DART_P, **extra),
                                   ds, BOOST_ITERS, body)
        torch.cuda.synchronize()
        per_walk = [e0.elapsed_time(e1) for _, tr, e0, e1 in walks if tr]
        per_iter = {}
        for it, tr, e0, e1 in walks:
            if tr:
                per_iter[it] = per_iter.get(it, 0.0) + e0.elapsed_time(e1)
        check(sum(drops) > 0 and len(per_walk) == 2 * sum(drops),
              f"{label}: {drops} dropped, {len(per_walk)} train walks")
        g = bst._gbdt
        # the init score sits in host tree 0 only (ROADMAP section C): the
        # model predicts the train scores plus init * (F0 - 1), F0 tree
        # 0's factors
        init = g.init_scores[0]
        d0 = g.device_trees[0]["delta"].double().cpu().numpy()
        F0 = ((g.models[0].leaf_value[0] - d0[0]) / init
              if abs(init) > 1e-15 else 1.0)
        gap = (bst.predict(Xp, raw_score=True)
               - g.scores.cpu().numpy()[:len(Xp)] - init * (F0 - 1.0))
        check(np.abs(gap).max() <= 1e-4,
              f"{label}: raw predictions part from the train scores by "
              f"{np.abs(gap).max()!r} beyond the init fold")
        busy, wall = busy_share(bst)
        iter_s, gbdt_s = float(np.median(times[1:9])), float(
            np.median(gt[1:9]))
        walk_ms = float(np.median(per_walk))
        walk_iter = float(np.median([per_iter.get(i, 0.0)
                                     for i in range(1, 9)]))
        out[label] = {"drops": drops, "iter_s": iter_s, "gbdt_s": gbdt_s,
                      "walk_ms": walk_ms, "walk_ms_iter": walk_iter,
                      "busy_ms": busy, "wall_ms": wall, "F0": F0}
        say(f"dart {body} (K={g.learner.K}): dropped per iteration {drops}; "
            f"s/iteration {iter_s:.4f} (median of 2-9) against GBDT "
            f"{gbdt_s:.4f}; a walk of a past tree {walk_ms:.3f} ms "
            f"(median of {len(per_walk)}), {walk_iter:.3f} ms an iteration "
            f"(median of 2-9); a profiled iteration {wall:.1f} ms wall, "
            f"device busy {busy:.1f} ms ({100 * busy / wall:.1f}%); the "
            f"model predicts the scores + init * (F0 - 1), F0 {F0:.4f}")
        if body == "mega":
            dart_bst = bst
        else:
            del bst, g
        torch.cuda.empty_cache()

    # ---- RF ----------------------------------------------------------------
    rf_bst, times, _, aucs = run("rf", dict(params, metric="auc", **RF_P,
                                            **AUTO), ds, BOOST_ITERS, "mega",
                                 auc=True)
    g = rf_bst._gbdt
    n_bag = int(len(y) * RF_P["bagging_fraction"])
    check(all(t.internal_count[0] == n_bag for t in g.models),
          f"rf: in-bag counts {[t.internal_count[0] for t in g.models]}, "
          f"want {n_bag}")
    raw = rf_bst.predict(Xp, raw_score=True)
    err = float(np.abs(raw * BOOST_ITERS
                       - g.scores.cpu().numpy()[:len(Xp)]).max())
    check(err <= 1e-4, f"rf: the averaged prediction times {BOOST_ITERS} "
                       f"parts from the running sum by {err!r}")
    out["rf"] = {"iter_s": float(np.median(times[1:9])), "auc": aucs}
    say(f"rf (bagging 0.632, feature_fraction 0.8): s/iteration "
        f"{out['rf']['iter_s']:.4f} (median of 2-9); training AUC of the "
        f"running sum each iteration {[round(a, 5) for a in aucs]}; the "
        f"averaged prediction is the sum over {BOOST_ITERS}")

    # ---- a saved DART and a saved RF model reload bit for bit -----------
    with tempfile.TemporaryDirectory() as tmp:
        for label, b in (("dart", dart_bst), ("rf", rf_bst)):
            path = os.path.join(tmp, f"{label}.txt")
            b.save_model(path)
            again = lgt.Booster(model_file=path)
            check(np.array_equal(again.predict(Xp, raw_score=True),
                                 b.predict(Xp, raw_score=True))
                  and np.array_equal(again.predict(Xp), b.predict(Xp)),
                  f"{label}: the reloaded model predicts other scores")
    say("dart and rf: saved models reload and predict 100,000 rows bit for "
        "bit (raw and converted)")
    del dart_bst, rf_bst, g
    torch.cuda.empty_cache()

    # ---- the eager iteration beside the fused one -------------------------
    res = {}
    draws = []
    real_draw = bmod.GBDT._sample_eager

    def timed_draw(self, grad, hess):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        g_, h_ = real_draw(self, grad, hess)
        e1.record()
        draws.append((e0, e1))
        return g_, h_
    bmod.GBDT._sample_eager = timed_draw
    for label, extra in (("fused", BAG7), ("eager", EAGER_P)):
        b, times, _, _ = run(f"{label} bagging", dict(params, **extra,
                                                      **AUTO), ds,
                             BOOST_ITERS, "mega")
        res[label] = float(np.median(times[1:9]))
        if label == "eager":
            n_bag = int(len(y) * 0.7)
            check(b._gbdt._eager and all(t.internal_count[0] == n_bag
                                         for t in b._gbdt.models),
                  f"eager bagging: in-bag counts "
                  f"{[t.internal_count[0] for t in b._gbdt.models]}")
            busy, wall = busy_share(b)
        del b
    bmod.GBDT._sample_eager = real_draw
    torch.cuda.synchronize()
    draw_ms = float(np.median([e0.elapsed_time(e1) for e0, e1 in draws]))
    from lightgbm_tpu_torch.utils import random as jrandom
    perm_ms = cuda_ms(lambda: jrandom.torch_permutation(
        jrandom.PRNGKey(3), len(y), torch.device("cuda")), 3)
    res.update(draw_ms=draw_ms, perm_ms=perm_ms, busy_ms=busy, wall_ms=wall)
    out["eager"] = res
    say(f"tpu_fused_iteration=false, bagging 0.7: s/iteration "
        f"{res['eager']:.4f} against the fused draw's {res['fused']:.4f} "
        f"(median of 2-9; the eager bag an exact count by a permutation); "
        f"the eager draw {draw_ms:.3f} ms an iteration (CUDA events, "
        f"median of {len(draws)}), of it the permutation of {len(y)} ids "
        f"{perm_ms:.3f} ms (plain PyTorch: Threefry bits and stable sorts); "
        f"a profiled iteration {wall:.1f} ms wall, device busy {busy:.1f} "
        f"ms ({100 * busy / wall:.1f}%)")

    # ---- GOSS with regression_l1 on 4g's continuous label ---------------
    yc, _ = objective_labels(X)
    d_l1 = relabeled(lgt, ds, X, yc)
    del renews[:]
    b, times, _, _ = run("goss l1", dict(params, **GOSS_L1_P, **AUTO), d_l1,
                         5, "mega")
    torch.cuda.synchronize()
    renew_ms = [e0.elapsed_time(e1) for e0, e1 in renews]
    check(len(renew_ms) == 5 and b._gbdt._eager,
          f"goss l1: {len(renew_ms)} renewals for 5 trees")
    out["goss_l1"] = {"iter_s": float(np.median(times[1:])),
                      "renew_ms": float(np.median(renew_ms))}
    say(f"goss regression_l1: s/iteration {out['goss_l1']['iter_s']:.4f} "
        f"(median of 2-5); the renewal over GOSS's rows "
        f"{out['goss_l1']['renew_ms']:.3f} ms a tree (median of 5)")
    del b, d_l1
    torch.cuda.empty_cache()

    # ---- rollback ----------------------------------------------------------
    pa = dict(params, **AUTO)
    a = lgt.Booster(pa, ds)
    for _ in range(3):
        a.update()
    b = lgt.Booster(pa, ds)
    for _ in range(5):
        b.update()
    b.rollback_one_iter()
    b.rollback_one_iter()
    sa, sb = (x._gbdt.scores.cpu().numpy() for x in (a, b))
    err = float(np.abs(sa - sb).max())
    check(b.current_iteration == 3 and same_trees(a._gbdt.models,
                                                  b._gbdt.models)
          and err <= 1e-6, f"rollback: {b.current_iteration} iterations, "
                           f"scores {err!r} from the 3-iteration run's")
    out["rollback_err"] = err
    say(f"rollback: 5 iterations less 2 against 3: the trees equal, the "
        f"scores within {err:.2e}")
    del a, b
    torch.cuda.empty_cache()
    bmod.GBDT._tree_to_scores = real_walk
    bmod.renew_leaves = real_renew

    # ---- the card against the CPU on a quantized 200,000-row cut: both
    # sum integer carriers exactly, so trees part only at exact ties (the
    # CPU's f32 float sums part from the card's exact ones beyond
    # tree_tie's bound at 255 leaves; PERF.md section 6) ----------------
    cut64 = X[:BOOST_CUT].astype(np.float64)
    cuts = {"dart": (dict(DART_P, drop_rate=0.5), y, 4),
            "rf": (RF_P, y, 2), "eager bagging": (EAGER_P, y, 2),
            "goss l1": (GOSS_L1_P, yc, 2)}
    out["cut"] = {}
    for label, (extra, lab, iters) in cuts.items():
        d_cut = relabeled(lgt, ds, X, lab, BOOST_CUT)
        p = dict(params, use_quantized_grad=True,
                 num_leaves=BOOST_CUT_LEAVES, **extra, **AUTO)
        card, cpu = (lgt.Booster(dict(p, **kw), d_cut)
                     for kw in ({}, {"device_type": "cpu"}))
        grads = first_grads_of(card)
        drops = {"card": [], "cpu": []}
        for _ in range(iters):
            for key, bb in (("card", card), ("cpu", cpu)):
                bb.update()
                drops[key].append(list(getattr(bb._gbdt, "last_drops", [])))
        check(drops["card"] == drops["cpu"],
              f"{label} cut: the card dropped {drops['card']}, the CPU "
              f"{drops['cpu']}")
        tie = None
        for t, (ta, tb) in enumerate(zip(card._gbdt.models,
                                         cpu._gbdt.models)):
            s = tree_tie(ta, tb, cut64, *grads[t],
                         f"{label} card vs CPU tree {t}", exact=True)
            if s is not None:
                tie = (t,) + s
                break
            check(np.allclose(ta.leaf_value, tb.leaf_value, rtol=1e-4,
                              atol=1e-5),
                  f"{label} cut: tree {t}'s leaf values differ")
        err = None
        if tie is None:
            sc, sp = (bb._gbdt.scores.cpu().numpy() for bb in (card, cpu))
            err = float(np.abs(sc - sp).max())
            check(err <= 1e-5, f"{label} cut: card and CPU scores differ "
                               f"by {err!r}")
        out["cut"][label] = {"drops": drops["card"], "tie": tie,
                             "scores_err": err}
        say(f"{label} on a quantized {BOOST_CUT}-row cut, "
            f"{BOOST_CUT_LEAVES} leaves, {iters} iterations, card against "
            f"the CPU plain loop: "
            + (f"drops {drops['card']} equal; " if label == "dart" else "")
            + (f"the trees equal up to tree {tie[0]}, where they part at a "
               f"tie (split, gains card / CPU, bound) {tie[1:]}"
               if tie else f"the trees equal, scores within {err:.2e}"))
        del card, cpu, d_cut
    say(f"phase 4l: {time.time() - t_phase:.1f} s")
    return out


# ---- phase 4m: linear trees ----------------------------------------------
LIN_ITERS = 10
LIN_CUT = 200_000               # rows of the card-vs-CPU runs
LIN_CUT_LEAVES = 63
LIN_NAN_FEATURES = (0, 1, 2)    # 1% of the rows NaN in each
LIN_P = {"objective": "regression", "metric": "l2", "linear_tree": True}
LEAFWISE_P = dict(LIN_P, linear_tree_mode="leafwise_gain",
                  tpu_megakernel="off")


def linear_data(lgt, ds, X, label):
    """``ds``'s bins with ``label`` and 1% of the rows NaN in each of
    LIN_NAN_FEATURES (those rows rebinned by the feature's mapper, as a
    Dataset built with ``reference=ds`` bins them), the raw f32 rows kept
    for the linear leaves: (Dataset, the rows with their NaNs)."""
    rng = np.random.RandomState(13)
    inner = ds._inner
    meta = inner.feature_meta_arrays()
    Xn = X.copy()
    binned = inner.binned.copy()
    for f in LIN_NAN_FEATURES:
        g = int(meta["group"][list(meta["feature"]).index(f)])
        check(inner.groups[g].feature_indices == [f],
              f"linear data: feature {f} is bundled")
        rows = rng.rand(len(X)) < 0.01
        Xn[rows, f] = np.nan
        binned[rows, g] = inner.bin_mappers[f].values_to_bins(Xn[rows, f])
    out = relabeled(lgt, ds, Xn, label)
    out._inner.binned = binned
    out._inner.raw_data = Xn
    return out, Xn


def linear_cut(lgt, dsn, Xn, label, rows):
    """``dsn`` cut to its first ``rows`` rows, raw rows and NaNs kept."""
    out = relabeled(lgt, dsn, Xn, label, rows)
    out._inner.raw_data = np.ascontiguousarray(Xn[:rows])
    return out


def search_times(lr, reps):
    """The leafwise learner's search of a split's two children and the
    store of their own models (``lr._pair`` on its last step's buffers),
    ``reps`` times in one captured graph: (ms a search by CUDA events,
    device ms a search and device launches a search by torch.profiler
    over one replay)."""
    from torch.profiler import ProfilerActivity, profile
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        lr._pair()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            lr._pair()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    return (t0.elapsed_time(t1) / reps, sum(ms for _, ms, _ in rows) / reps,
            sum(n for _, _, n in rows) // reps)


def linear_path(lgt, mods, ds, X, params):
    """Phase 4m (``--linear``): linear trees at the HIGGS shape (see the
    module doc); returns the summary printed by ``--linear``."""
    from lightgbm_tpu_torch.models import boosting as bmod
    from lightgbm_tpu_torch.models import linear as linmod
    t_phase = time.time()
    yc, _ = objective_labels(X)
    dsn, Xn = linear_data(lgt, ds, X, yc)
    N = len(yc)
    base = dict(params, objective="regression", metric="l2")
    Xp = Xn[:100_000].astype(np.float64)
    n_nan = int(np.isnan(Xp).any(1).sum())
    check(n_nan > 0.02 * len(Xp),
          f"linear: {n_nan} rows with a NaN in {len(Xp)}")
    spans = {"rows": [], "fit": [], "update": []}
    live = [False]
    real = {"rows": linmod.physical_rows, "fit": linmod.fit_leaves,
            "update": linmod.tile_output}

    def timed(key):
        def run(*a, **k):
            if not live[0]:
                return real[key](*a, **k)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = real[key](*a, **k)
            e1.record()
            spans[key].append((e0, e1))
            return out
        return run
    linmod.physical_rows, linmod.fit_leaves, linmod.tile_output = (
        timed("rows"), timed("fit"), timed("update"))
    # the fit and the linear update run on the card without a host sync
    # (the tree's one read carries their results)
    real_leaves = bmod.GBDT._linear_leaves

    def strict_leaves(self, ghi):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real_leaves(self, ghi)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    bmod.GBDT._linear_leaves = strict_leaves
    out = {"rows": N, "nan_rows_predicted": n_nan}

    def run(label, p, body, iters=LIN_ITERS):
        """``iters`` iterations of a fresh booster, counts set to 0 before
        and read after: its per-iteration wall s, training L2 after each
        iteration and the leaves' fit statuses."""
        bst = lgt.Booster(p, dsn)
        g, lr = bst._gbdt, bst._gbdt.learner
        for m in mods.values():
            m.launches = 0
        for v in spans.values():
            del v[:]
        times, l2, status = [], [], np.zeros(5, np.int64)
        live[0] = True
        for _ in range(iters):
            t0 = time.time()
            bst.update()
            torch.cuda.synchronize()
            times.append(time.time() - t0)
            l2.append(bst.eval_train()[0][2])
            if g.last_linear_status is not None:
                status += np.bincount(g.last_linear_status, minlength=5)
        live[0] = False
        calls = {k: m.launches for k, m in mods.items()}
        need = [k for k in BODY_KERNELS[body]
                if not (lr.linear_gain and k == "split_pair")]
        check(all(calls[k] > 0 for k in need),
              f"{label}: a kernel of the {body} body was not launched: "
              f"{calls}")
        check(lr.captures == 1 and lr.syncs == lr.replays == iters
              and len(g.models) == iters,
              f"{label}: {lr.captures} captures, {lr.replays} replays, "
              f"{lr.syncs} tree reads, {len(g.models)} trees for {iters}")
        check(all(b < a for a, b in zip(l2, l2[1:])),
              f"{label}: training L2 does not fall: {l2}")
        sc = g.scores.cpu().numpy()
        check(sc.shape == (N,) and np.isfinite(sc).all(),
              f"{label}: train scores not finite")
        return bst, times, l2, status

    def span_ms(key):
        torch.cuda.synchronize()
        v = [e0.elapsed_time(e1) for e0, e1 in spans[key]]
        return float(np.median(v)) if v else None

    def check_model(label, bst):
        """The train scores against the raw predictions of 100,000 rows
        (NaN rows included), those against the host trees' f64 oracle;
        the model saved and reloaded predicts bit for bit."""
        g = bst._gbdt
        raw = bst.predict(Xp, raw_score=True)
        err = float(np.abs(raw - g.scores.cpu().numpy()[:len(Xp)]).max())
        check(err <= 1e-5, f"{label}: raw predictions part from the train "
                           f"scores by {err!r}")
        host = sum(t.predict(Xp) for t in g.models)
        herr = float(np.abs(host - raw).max())
        check(herr <= 1e-9, f"{label}: the device's linear outputs part "
                            f"from the host trees' by {herr!r}")
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "linear.txt")
            bst.save_model(path)
            again = lgt.Booster(model_file=path)
            check(np.array_equal(again.predict(Xp, raw_score=True), raw),
                  f"{label}: the reloaded model predicts other scores")
        return err, herr

    # ---- refit on both bodies, beside GBDT on the same body ------------
    for body, extra in (("mega", AUTO), ("subtraction", BODIES["subtraction"])):
        _, gt, gl2, _ = run(f"gbdt {body}", dict(base, **extra), body)
        label = f"refit {body}"
        bst, times, l2, status = run(label, dict(base, **LIN_P, **extra),
                                     body)
        rows_ms, fit_ms, upd_ms = (span_ms(k) for k in ("rows", "fit",
                                                        "update"))
        check(len(spans["fit"]) == LIN_ITERS
              and len(spans["update"]) == LIN_ITERS,
              f"{label}: {len(spans['fit'])} fits, "
              f"{len(spans['update'])} updates for {LIN_ITERS} trees")
        check(status[linmod.LIN_OK] > 0.5 * status.sum(),
              f"{label}: leaves by fit status {status.tolist()}")
        err, herr = check_model(label, bst)
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        live[0] = True
        bst.update()
        live[0] = False
        peak = (torch.cuda.max_memory_allocated() - before) / 2 ** 30
        busy, wall = busy_share(bst)
        iter_s, gbdt_s = (float(np.median(v[1:9])) for v in (times, gt))
        out[label] = {"iter_s": iter_s, "gbdt_s": gbdt_s, "rows_ms": rows_ms,
                      "fit_ms": fit_ms, "update_ms": upd_ms,
                      "busy_ms": busy, "wall_ms": wall,
                      "l2": l2, "gbdt_l2": gl2, "status": status.tolist(),
                      "peak_gib": peak, "pred_err": err, "host_err": herr,
                      "K": bst._gbdt.learner.K}
        say(f"linear refit {body} (K={bst._gbdt.learner.K}): s/iteration "
            f"{iter_s:.4f} against GBDT's {gbdt_s:.4f} (median of 2-9); "
            f"the raw rows' gather into the physical order {rows_ms:.3f} "
            f"ms, the fit {fit_ms:.3f} ms, the linear update "
            f"{upd_ms:.3f} ms a tree (CUDA events, medians of "
            f"{LIN_ITERS}); a profiled iteration {wall:.1f} ms wall, "
            f"device busy {busy:.1f} ms ({100 * busy / wall:.1f}%); the "
            f"iteration's peak above the resident state {peak:.2f} GiB; "
            f"leaves by fit status (linear, no features, few rows, "
            f"singular, not finite) {status.tolist()}; training L2 "
            f"{[round(v, 5) for v in l2]} (GBDT {[round(v, 5) for v in gl2]}); "
            f"predictions of 100,000 rows ({n_nan} with a NaN) within "
            f"{err:.2e} of the train scores, {herr:.2e} of the host trees, "
            f"bit for bit after a reload")
        del bst
        torch.cuda.empty_cache()

    # ---- leafwise_gain on the subtraction body ----------------------------
    bst, times, l2, _ = run("leafwise", dict(base, **LEAFWISE_P),
                            "subtraction")
    lr = bst._gbdt.learner
    check(lr.linear_gain and lr.subtract and lr.K == 1,
          "leafwise: not the linear search on the subtraction body at K=1")
    n_search = SPLITS + 1
    search_ms, prof_ms, launches = search_times(lr, 20)
    err, herr = check_model("leafwise", bst)
    iter_s = float(np.median(times[1:9]))
    out["leafwise"] = {"iter_s": iter_s, "search_ms": search_ms,
                       "search_ms_iter": search_ms * n_search,
                       "search_prof_ms": prof_ms,
                       "search_prof_ms_iter": prof_ms * n_search,
                       "search_launches": launches, "l2": l2,
                       "pred_err": err, "host_err": herr}
    say(f"linear leafwise_gain (subtraction, K=1): s/iteration "
        f"{iter_s:.4f} (median of 2-9); the linear search and its stores "
        f"{search_ms:.4f} ms a search (graph replay, CUDA events), "
        f"{prof_ms:.4f} ms of device time ({launches} launches; "
        f"torch.profiler), so {search_ms * n_search:.2f} ms / "
        f"{prof_ms * n_search:.2f} ms an iteration of {n_search} searches; "
        f"training L2 {[round(v, 5) for v in l2]}; predictions of 100,000 "
        f"rows within {err:.2e} of the train scores, {herr:.2e} of the "
        f"host trees, bit for bit after a reload")
    del bst, lr
    torch.cuda.empty_cache()
    linmod.physical_rows, linmod.fit_leaves, linmod.tile_output = (
        real["rows"], real["fit"], real["update"])
    bmod.GBDT._linear_leaves = real_leaves

    # ---- the card against the CPU on a quantized 200,000-row cut ------
    cut64 = Xn[:LIN_CUT].astype(np.float64)
    d_cut = linear_cut(lgt, dsn, Xn, yc, LIN_CUT)
    out["cut"] = {}
    for mode, extra in (("refit", dict(LIN_P, **AUTO)),
                        ("leafwise_gain", LEAFWISE_P)):
        p = dict(base, use_quantized_grad=True, num_leaves=LIN_CUT_LEAVES,
                 **extra)
        card, cpu = (lgt.Booster(dict(p, **kw), d_cut)
                     for kw in ({}, {"device_type": "cpu"}))
        grads = first_grads_of(card)
        for _ in range(2):
            card.update()
            cpu.update()
        tie, lin_err = None, 0.0
        for t, (ta, tb) in enumerate(zip(card._gbdt.models,
                                         cpu._gbdt.models)):
            s = tree_tie(ta, tb, cut64, *grads[t],
                         f"linear {mode} card vs CPU tree {t}", exact=True)
            if s is not None:
                tie = (t,) + s
                break
            check(ta.leaf_features == tb.leaf_features,
                  f"linear {mode} cut: tree {t}'s leaf features differ")
            for a, b in ((ta.leaf_const, tb.leaf_const),
                         (np.concatenate([np.asarray(c, np.float64) for c
                                          in ta.leaf_coeff]),
                          np.concatenate([np.asarray(c, np.float64) for c
                                          in tb.leaf_coeff]))):
                check(np.allclose(a, b, rtol=1e-4, atol=1e-5),
                      f"linear {mode} cut: tree {t}'s linear leaves differ")
                if len(a):
                    lin_err = max(lin_err, float(np.abs(a - b).max()))
        out["cut"][mode] = {"tie": tie, "linear_err": lin_err}
        say(f"linear {mode} on a quantized {LIN_CUT}-row cut, "
            f"{LIN_CUT_LEAVES} leaves, 2 iterations, card against the CPU "
            f"plain loop: " + (f"the trees part at tree {tie[0]}, a tie "
                               f"(split, gains card / CPU, bound) {tie[1:]}"
                               if tie else "the trees equal")
            + f", the linear leaves within {lin_err:.2e}")
        del card, cpu
    say(f"phase 4m: {time.time() - t_phase:.1f} s")
    return out


# ---- phase 4h: wide bins (uint16 bin matrices) --------------------------
WIDE_MAX_BIN = 1023             # the HIGGS shape at max_bin 1023
WIDE_LEVELS = 1000              # the high-cardinality categorical
WIDE_ONEHOT = 4                 # one-hot columns that bundle (EFB)
WIDE_STEPS = 8                  # steps of a tree held kernel by kernel
ARM_ROWS, ARM_FEATURES, ARM_MAX_BIN = 500_000, 4, 16383


def make_wide_cat_data(rows):
    """Phase 4f's rows (make_cat_data's draws) with a categorical of
    WIDE_LEVELS levels and WIDE_ONEHOT one-hot columns (EFB bundles them:
    the uint16 matrix then holds bundles) from a RandomState of their
    own, each with a per-level effect on the label."""
    X, y = make_cat_data(rows)
    rng = np.random.RandomState(12)
    wide_eff = rng.normal(size=WIDE_LEVELS)
    hot_eff = rng.normal(size=WIDE_ONEHOT + 1)
    wide = rng.randint(0, WIDE_LEVELS, size=rows)
    hot = rng.randint(0, WIDE_ONEHOT + 1, size=rows)
    noise = rng.normal(size=rows)
    logit = (wide_eff[wide] + hot_eff[hot]) * 1.5 + noise
    out = np.zeros((rows, X.shape[1] + 1 + WIDE_ONEHOT), np.float32)
    out[:, :X.shape[1]] = X
    out[:, X.shape[1]] = wide
    on = hot > 0
    out[np.nonzero(on)[0], X.shape[1] + hot[on]] = 1.0
    y = ((2 * y - 1) + logit > 0).astype(np.float32)
    return out, y


def bins_equal(a, b):
    """Bit equality of two bin (or word) tensors of any dtype."""
    w = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
         8: torch.int64}[a.element_size()]
    return torch.equal(a.view(w), b.view(w))


def check_wide_steps(lr, pb, pg, steps, what):
    """The root and ``steps`` steps of one tree, as the learner's own
    sequence runs on copies of its row buffers, kernel by kernel, each
    against its plain version on the same inputs on the card, bit for
    bit: the uint16 partition (bins, payload words, left count; the set
    decision on a categorical step), leaf_hist's state launch (the int64
    state and the f32 children), with bundles feat_view, split_pair at the
    learner's width and, with categorical features, split_cat (rows and
    sets).  Returns the largest bit differences, the launches compared
    and the last step's inputs (for the timings)."""
    from lightgbm_tpu_torch.ops import feat_view as fv
    from lightgbm_tpu_torch.ops import hist_state as hs
    from lightgbm_tpu_torch.ops import partition as tpart
    from lightgbm_tpu_torch.ops import split_cat as scat
    from lightgbm_tpu_torch.ops import split_pair as sp
    from lightgbm_tpu_torch.ops import tree_step as ts
    pb, pg = pb.clone(), pg.clone()
    G, B, N, F, W = lr.G, lr.B, lr.N, lr.F, lr.W
    kw = dict(l1=lr.l1, l2=lr.l2, max_delta_step=lr.max_delta_step,
              min_gain_to_split=lr.min_gain_to_split,
              min_data_in_leaf=lr.min_data_in_leaf,
              min_sum_hessian=lr.min_sum_hessian, max_depth=lr.max_depth)
    fm = lr.fmeta_pair[:2 * F]
    err = {k: 0.0 for k in ("partition", "leaf_hist", "feat_view",
                            "split_pair", "split_cat")}
    n = {k: 0 for k in err}
    last = {}

    def held(name, got, want, msg):
        err[name] = max(err[name], bits_err(got, want))
        check(bins_equal(got, want), f"{what}: {name} {msg}")
        n[name] += 1

    def body(step, root):
        w = step.cpu()
        sc, idx, side = tpart.step_fields(w)
        start, cnt = tpart.scalars_start(sc), sc[tpart.S_CNT]
        if not root:
            b0, g0 = pb.clone(), pg.clone()
            tpart.partition_step(pb, pg, step, lr.nl, bound=N, ws=lr.ws)
            nl0 = tpart.partition_leaf_plain(b0, g0, w)
            held("partition", pb, b0, "bins differ from the plain version")
            check(bins_equal(pg, g0) and int(lr.nl[0]) == int(nl0),
                  f"{what}: partition payload or left count differs")
            last["part"] = (b0, g0, w.to(lr.device))
        st0 = lr.state.clone()
        hs.leaf_hist_rmw_step(pb, pg, step, None if root else lr.nl,
                              state=lr.state, absmax=lr._absmax, kcnt=N,
                              out=lr.children, num_bins=B, num_groups=G,
                              bound=N, ws=lr.ws)
        child = None if side == 0 else (lr.nl.clone(), side - 1)
        nlv = 0 if root else int(lr.nl[0])
        last["lhr_rows"] = {0: (start, cnt), 1: (start, nlv),
                            2: (start + nlv, cnt - nlv)}[side]
        want = hs.leaf_hist_rmw_fixed_plain(
            pb, pg, start, cnt, num_bins=B, num_groups=G, state=st0,
            idx=idx, absmax=lr._absmax, kcnt=N, child=child)
        held("leaf_hist", lr.state, st0, "state differs")
        held("leaf_hist", lr.children, want, "children differ")
        last["lhr"] = (pb.clone(), pg.clone(), step.clone(),
                       lr.nl.clone(), st0)

    def pair(step):
        ch = lr.children
        if lr.bundled:
            fv.feat_view(ch, lr.info, lr.state, step, lr._absmax, kcnt=N,
                         view=lr.view, out=lr.fchildren)
            want = fv.feat_view_fixed_plain(lr.state, step, lr._absmax, N,
                                            lr.view)
            held("feat_view", lr.fchildren, want, "view differs")
            ch = lr.fchildren
            last["view"] = (lr.state.clone(), step.clone())
        Bp = ch.shape[-1]
        hg, hh = ch[0].reshape(-1, Bp), ch[1].reshape(-1, Bp)
        rows = sp.split_pair(hg, hh, fm, lr.info, out=lr.pair_out, **kw)
        want = sp.split_pair_plain(hg, hh, fm, lr.info, **kw)
        held("split_pair", rows, want, "rows differ")
        last["pair"] = (hg.clone(), hh.clone(), lr.info.clone())
        if lr.has_cat:
            pre = rows.clone()
            scat.split_cat(hg, hh, fm, lr.info, lr.cat_feats, rows,
                           lr.paircat, work=lr.cat_work, **kw, **lr.cat_kw)
            wset = torch.zeros_like(lr.paircat)
            scat.split_cat_plain(hg, hh, fm, lr.info, lr.cat_feats, pre,
                                 wset, **kw, **lr.cat_kw)
            held("split_cat", rows, pre, "rows differ")
            held("split_cat", lr.paircat, wset, "sets differ")
            last["cat"] = (hg.clone(), hh.clone(), lr.info.clone(),
                           rows.clone())

    torch.amax(pg[:2].abs(), dim=1, out=lr._absmax)
    body(lr.root_step, True)
    torch.stack([lr.children[0, 0, 0].sum(), lr.children[1, 0, 0].sum()],
                out=lr.sums)
    lr._step(ts.MODE_ROOT)
    pair(lr.root_step)
    cat_steps = 0
    for _ in range(steps):
        lr._step(ts.MODE_STEP)
        if int(lr.step[tpart.SB_DONE]):
            break
        cat_steps += int(lr.step[tpart.SB_ISCAT])
        body(lr.step, False)
        pair(lr.step)
    del pb, pg
    return err, n, cat_steps, last


def wide_kernel_times(lr, last, kw):
    """(ms, plain ms) a launch of each uint16 / wide kernel on the last
    held step's inputs (graph replay, as the tree's graph launches them;
    the plain version by CUDA events, on the card's tensors); leaf_hist's
    also the library yardstick, one index_add_ of the rows' histogram
    (its indices prepared outside the timing), and the rows summed."""
    from lightgbm_tpu_torch.ops import feat_view as fv
    from lightgbm_tpu_torch.ops import hist_state as hs
    from lightgbm_tpu_torch.ops import partition as tpart
    from lightgbm_tpu_torch.ops import split_cat as scat
    from lightgbm_tpu_torch.ops import split_pair as sp
    G, B, N, F = lr.G, lr.B, lr.N, lr.F
    fm = lr.fmeta_pair[:2 * F]
    out = {}
    if "part" in last:
        b0, g0, w = last["part"]
        b, g = b0.clone(), g0.clone()
        nl = torch.zeros(1, dtype=torch.int32, device=lr.device)
        out["partition"] = (
            graph_ms(lambda: tpart.partition_step(b, g, w, nl, bound=N,
                                                  ws=lr.ws), 10),
            cuda_ms(lambda: tpart.partition_leaf_plain(b0, g0, w), 2, 1))
    pb, pg, step, nl, st0 = last["lhr"]
    st, st1 = st0.clone(), st0.clone()
    sc, idx, side = tpart.step_fields(step.cpu())
    start, cnt = tpart.scalars_start(sc), sc[tpart.S_CNT]
    ch = torch.empty_like(lr.children)
    s0, c = last["lhr_rows"]
    Bp = lr.children.shape[-1]
    seg = tpart.bin_values(pb[:G, s0:s0 + c]).long()
    lidx = (seg + (torch.arange(G, device=lr.device) * Bp)[:, None]
            ).reshape(-1)
    lidx = torch.cat([lidx, lidx + G * Bp])
    vals = torch.cat([pg[0, s0:s0 + c].expand(G, -1).reshape(-1),
                      pg[1, s0:s0 + c].expand(G, -1).reshape(-1)])
    hist = torch.zeros(2 * G * Bp, device=lr.device)
    lib = cuda_ms(lambda: hist.index_add_(0, lidx, vals), 5)
    del seg, lidx, vals, hist
    out["leaf_hist"] = (
        graph_ms(lambda: hs.leaf_hist_rmw_step(
            pb, pg, step, nl, state=st, absmax=lr._absmax, kcnt=N, out=ch,
            num_bins=B, num_groups=G, bound=N, ws=lr.ws), 10),
        cuda_ms(lambda: hs.leaf_hist_rmw_fixed_plain(
            pb, pg, start, cnt, num_bins=B, num_groups=G, state=st1,
            idx=idx, absmax=lr._absmax, kcnt=N,
            child=None if side == 0 else (nl, side - 1)), 2, 1), lib, c)
    if "view" in last:
        state, vstep = last["view"]
        fch = torch.empty_like(lr.fchildren)
        out["feat_view"] = (
            graph_ms(lambda: fv.feat_view(None, None, state, vstep,
                                          lr._absmax, kcnt=N, view=lr.view,
                                          out=fch), 200),
            cuda_ms(lambda: fv.feat_view_fixed_plain(state, vstep,
                                                     lr._absmax, N, lr.view),
                    5))
    hg, hh, info = last["pair"]
    rows = torch.empty_like(lr.pair_out)
    out["split_pair"] = (
        graph_ms(lambda: sp.split_pair(hg, hh, fm, info, out=rows, **kw),
                 200),
        cuda_ms(lambda: sp.split_pair_plain(hg, hh, fm, info, **kw), 5))
    if "cat" in last:
        chg, chh, cinfo, pre = last["cat"]
        crow, cset = pre.clone(), torch.empty_like(lr.paircat)
        out["split_cat"] = (
            graph_ms(lambda: scat.split_cat(
                chg, chh, fm, cinfo, lr.cat_feats, crow, cset,
                work=lr.cat_work, **kw, **lr.cat_kw), 200),
            cuda_ms(lambda: scat.split_cat_plain(
                chg, chh, fm, cinfo, lr.cat_feats, pre.clone(),
                torch.empty_like(lr.paircat), **kw, **lr.cat_kw), 3, 1))
    return out


def timed_run(lgt, mods, ds, params, label, iters):
    """``iters`` iterations of the graph loop with every wrapper's count
    set to 0 just before and read just after (the run that sizes
    everything and the capture: each wrapper twice a tree's calls), then
    one profiled iteration.  Returns the booster, the s/iteration, the
    losses, the wrapper counts, {kernel: (device ms, launches)} of the
    profiled iteration and its device busy ms."""
    bst = lgt.Booster(params=params, train_set=ds)
    for m in mods.values():
        m.launches = 0
    iter_s, losses = [], []
    torch.cuda.synchronize()
    for _ in range(iters):
        t0 = time.time()
        bst.update()
        torch.cuda.synchronize()
        iter_s.append(time.time() - t0)
        losses.append(bst.eval_train()[0][2])
    calls = {k: m.launches for k, m in mods.items()}
    lr = bst._gbdt.learner
    check(lr.syncs == lr.replays == iters and lr.captures == 1,
          f"{label}: {lr.syncs} tree reads, {lr.replays} replays, "
          f"{lr.captures} captures for {iters} trees")
    check(all(a > b for a, b in zip(losses, losses[1:])),
          f"{label}: training logloss does not fall: {losses}")
    med = float(np.median(iter_s[1:]))
    per, busy = profile_iteration(bst, med, "u16cat" if lr.has_cat
                                  else "u16")
    return bst, med, iter_s, losses, calls, per, busy


def wide_arm(th, hs, dev):
    """The wide histogram arm (one group's planes past a block's shared
    memory) on ARM_ROWS x ARM_FEATURES at max_bin ARM_MAX_BIN: leaf_hist
    and its state launch against their plain versions, bit for bit, and
    their times; then a short training at that max_bin, whose tree loop
    runs the arm, every wrapper's count set to 0 before and read after."""
    rng = np.random.RandomState(13)
    n_pad = ARM_ROWS + 4096
    B = ARM_MAX_BIN
    pb = torch.as_tensor(rng.randint(0, B, (ARM_FEATURES, n_pad)).astype(
        np.uint16), device=dev)
    pg = torch.as_tensor(rng.randn(8, n_pad).astype(np.float32), device=dev)
    pg[1] = pg[1].abs()
    start, cnt = 1024 + 5, ARM_ROWS
    kw = dict(num_bins=B, num_groups=ARM_FEATURES)
    absmax = pg[:2].abs().amax(dim=1)
    got = th.leaf_hist(pb, pg, start, cnt, absmax=absmax, **kw)
    want = th.leaf_hist_fixed_plain(pb, pg, start, cnt, absmax=absmax, **kw)
    err = bits_err(got.view(torch.int32), want.view(torch.int32))
    check(err == 0, f"wide arm: leaf_hist differs from its plain version "
                    f"by {err}")
    state = hs.new_state(2, ARM_FEATURES, B, dev)
    st0 = state.clone()
    got = hs.leaf_hist_rmw(pb, pg, start, cnt, state=state,
                           idx=(-1, 1, 1, 0), absmax=absmax,
                           kcnt=1 << 20, **kw)
    want = hs.leaf_hist_rmw_fixed_plain(pb, pg, start, cnt, state=st0,
                                        idx=(-1, 1, 1, 0), absmax=absmax,
                                        kcnt=1 << 20, **kw)
    err = max(err, bits_err(got.view(torch.int32), want.view(torch.int32)),
              bits_err(state, st0))
    check(err == 0, "wide arm: the state launch differs from its plain "
                    "version")
    _, Bp = th.hist_geometry(B)
    planes = torch.empty((2, ARM_FEATURES, Bp), device=dev)
    from lightgbm_tpu_torch.ops import partition as tpart
    step = tpart.step_block(tpart.make_scalars(start, cnt, 0, 0, 0, 0, 0, 0,
                                               0, 0), dev)
    ms = graph_ms(lambda: th.launch(pb, pg, step, nl=None, out=planes,
                                    kcnt=0, absmax=absmax, bound=cnt,
                                    **kw), 10)
    plain_ms = cuda_ms(lambda: th.leaf_hist_fixed_plain(
        pb, pg, start, cnt, absmax=absmax, **kw), 2, 1)
    seg = pb[:, start:start + cnt].view(torch.int16).long() & 0xFFFF
    idx = (seg + (torch.arange(ARM_FEATURES, device=dev) * Bp)[:, None]
           ).reshape(-1)
    idx = torch.cat([idx, idx + ARM_FEATURES * Bp])
    vals = torch.cat([pg[0, start:start + cnt].expand(ARM_FEATURES, -1)
                      .reshape(-1),
                      pg[1, start:start + cnt].expand(ARM_FEATURES, -1)
                      .reshape(-1)])
    hist = torch.zeros(2 * ARM_FEATURES * Bp, device=dev)
    lib_ms = cuda_ms(lambda: hist.index_add_(0, idx, vals), 5)
    nbytes = cnt * (ARM_FEATURES * 2 + 8) + 2 * ARM_FEATURES * Bp * 4
    del seg, idx, vals, hist, pb, pg, state, st0
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "lib_ms": lib_ms,
            "bound": bound(nbytes, 2 * cnt * ARM_FEATURES), "Bp": Bp}


def wide_path(lgt, mods, ds255, X, y, params):
    """Phase 4h: wide bins.  (1) The HIGGS shape at max_bin 1023: the
    learner on the subtraction body at K=1 with a uint16 matrix, 4
    iterations and a profiled one beside the same run at max_bin 255 (one
    process, the subtraction body both), every wrapper's count set to 0
    before a run and read after it, each uint16 kernel's ms an iteration
    beside its bound (bytes over 3.35 TB/s, the bin bytes doubled) and
    launches, logloss falling; the uint16 partition, the state launch and
    split_pair at BF = 1024 against their plain versions on a real tree.
    (2) Phase 4f's 2,000,000 rows plus a categorical of 1,000 levels
    (the uint16 matrix comes from that column) and 4 one-hot columns that
    bundle: split_cat at more than 256 bins with sets of more than 8
    words, feat_view at Bp > 256; the first tree bit-identical to the
    eager oracle's, and on a 200,000-row cut the card's first tree equal
    to the CPU's (or its first difference an exact tie in f64); save,
    reload and predict bit for bit; every kernel of that body against its
    plain version on a real tree.  (3) The wide histogram arm past a
    block's shared memory (max_bin 16383) against its plain version and
    through a short training."""
    from lightgbm_tpu_torch.ops import hist_state as hs
    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops import partition as tpart
    from lightgbm_tpu_torch.ops import tree_step as ts
    out = {"runs": {}}
    sub = dict(params, tpu_megakernel="off")
    # (1) max_bin 1023 against 255 on the subtraction body
    t0 = time.time()
    ds = lgt.Dataset(X, label=y)
    ds.construct(dict(params, max_bin=WIDE_MAX_BIN))
    inner = ds._inner
    check(inner.binned.dtype == np.uint16 and inner.max_group_bins > 256,
          f"wide: max_bin {WIDE_MAX_BIN} gave {inner.binned.dtype} bins of "
          f"{inner.max_group_bins}")
    say(f"wide data: construct at max_bin {WIDE_MAX_BIN} "
        f"{time.time() - t0:.1f} s, a {inner.binned.dtype.name} matrix "
        f"of {inner.binned.nbytes / 1e6:.0f} MB, groups of up to "
        f"{inner.max_group_bins} bins")
    for mb, dsx, p in ((255, ds255, sub),
                       (WIDE_MAX_BIN, ds, dict(params,
                                               max_bin=WIDE_MAX_BIN))):
        bst, med, iter_s, losses, calls, per, busy = timed_run(
            lgt, mods, dsx, p, f"wide max_bin {mb}", ITERS)
        lr = bst._gbdt.learner
        check(lr.subtract and lr.K == 1 and lr.bin_dtype ==
              (np.uint8 if mb == 255 else np.uint16),
              f"wide max_bin {mb}: subtract {lr.subtract} K {lr.K} "
              f"{lr.bin_dtype}")
        for k in mods:
            want = 2 * per_tree("subtraction").get(k, 0)
            check(calls[k] == want, f"wide max_bin {mb}: {k}: {calls[k]} "
                                    f"wrapper calls, expected {want}")
        tree = bst._gbdt.models[-1]
        Bp = lr.children.shape[-1]
        bsize = np.dtype(lr.bin_dtype).itemsize
        pair_bytes = 2 * (2 * lr.G) * Bp * 4 + 2 * (2 * lr.G) * 8 * 4 + 104
        step_bytes = (2 * 25 + 17 + 2 * lr.G * 8 + 2 * (25 + lr.W) + 2 * 13
                      + 6 * lr.W + 255) * 4
        bnd = iteration_bounds(tree, "subtraction", lr.G, lr.G, Bp, lr.N,
                               pair_bytes, step_bytes, SPLITS + 2, bsize)
        it = report_iteration(per, bnd, tree, f"wide max_bin {mb}",
                              per_tree("subtraction"))
        out["runs"][mb] = {"iter_s": med, "iter_all": iter_s,
                           "device_ms": busy, "losses": losses, "Bp": Bp,
                           "calls": calls,
                           "iter": {k: list(v) for k, v in it.items()},
                           "launches": {k: n for k, (_, n) in per.items()}}
        say(f"wide max_bin {mb} (subtraction body, {lr.bin_dtype.__name__}"
            f" bins, Bp {Bp}): s/iteration {med:.4f} (iterations "
            f"{[round(s, 4) for s in iter_s]}), device {busy:.2f} ms an "
            f"iteration; binary_logloss {losses}")
        if mb == WIDE_MAX_BIN:
            pb_, pg_ = bst._gbdt._phys
            err, n, _, last = check_wide_steps(lr, pb_, pg_, WIDE_STEPS,
                                               "wide max_bin 1023")
            kw = dict(l1=lr.l1, l2=lr.l2, max_delta_step=lr.max_delta_step,
                      min_gain_to_split=lr.min_gain_to_split,
                      min_data_in_leaf=lr.min_data_in_leaf,
                      min_sum_hessian=lr.min_sum_hessian,
                      max_depth=lr.max_depth)
            times = wide_kernel_times(lr, last, kw)
            # tree_step at W words: the kernel against tree_step_plain;
            # its ms a step from the profiled iteration
            err["tree_step"], ts_plain = check_tree_steps(ts, lr, pb_, pg_,
                                                          WIDE_STEPS)
            times["tree_step"] = (per["tree_step"][0] / per["tree_step"][1],
                                  ts_plain)
            out["higgs"] = {"err": err, "n": n, "times": times, "Bp": Bp,
                            "W": lr.W, "cnt": {}}
            # the bytes of each timed launch: the partition's and the
            # state launch's leaf, the pair search's planes
            w = last["part"][2].cpu()
            pc = int(w[tpart.SB_CNT])
            out["higgs"]["bytes"] = {
                "partition": 2 * pc * (lr.G * 2 + 32),
                "leaf_hist": None, "split_pair": pair_bytes}
            out["higgs"]["part_rows"] = pc
            say(f"wide max_bin 1023 kernels on the root and "
                f"{n['split_pair'] - 1} steps of a real tree: partition "
                f"(uint16), the state launch and split_pair at BF = {Bp} "
                f"bit-identical to their plain versions {n}, tree_step at "
                f"W = {lr.W} to tree_step_plain on the root, {WIDE_STEPS} "
                f"steps and the final commit; ms a launch (kernel, plain) "
                f"{times}")
            del pb_, pg_, last
        del bst, lr
        torch.cuda.empty_cache()
    del ds, inner
    gc.collect()
    r255, r1023 = out["runs"][255], out["runs"][WIDE_MAX_BIN]
    say(f"wide: max_bin {WIDE_MAX_BIN} against 255 on the subtraction "
        f"body: s/iteration {r1023['iter_s']:.4f} / {r255['iter_s']:.4f} "
        f"({r1023['iter_s'] / r255['iter_s']:.2f}x), device ms "
        f"{r1023['device_ms']:.2f} / {r255['device_ms']:.2f}")

    # (2) the high-cardinality categorical
    t0 = time.time()
    Xc, yc = make_wide_cat_data(EFB_ROWS)
    F = Xc.shape[1]
    cat_cols = list(range(FEATURES, FEATURES + EFB_CATS + 3))
    cparams = {"objective": "binary", "num_leaves": 255,
               "learning_rate": 0.1, "verbosity": -1}
    cds = lgt.Dataset(Xc, label=yc, categorical_feature=cat_cols)
    cds.construct(cparams)
    ci = cds._inner
    wide_nb = ci.bin_mappers[FEATURES + EFB_CATS + 2].num_bin
    check(ci.binned.dtype == np.uint16 and wide_nb > 256,
          f"wide cat: {ci.binned.dtype} bins, the wide column's num_bin "
          f"{wide_nb}")
    say(f"wide cat data and construct: {Xc.shape}, the {WIDE_LEVELS}-level "
        f"column in {wide_nb} bins, {ci.num_groups} groups (bundles: "
        f"{sum(len(g.feature_indices) > 1 for g in ci.groups)}), "
        f"{time.time() - t0:.1f} s")
    ref = lgt.Booster(params=cparams, train_set=cds)
    ref._gbdt.learner.build_tree = ref._gbdt.learner.build_tree_eager
    ref.update()
    bst, med, iter_s, losses, calls, per, busy = timed_run(
        lgt, mods, cds, cparams, "wide cat", CAT_ITERS)
    lr = bst._gbdt.learner
    check(lr.has_cat and lr.bundled and lr.subtract and lr.K == 1
          and lr.W > 8 and lr.bin_dtype == np.uint16,
          f"wide cat: learner has_cat {lr.has_cat} bundled {lr.bundled} K "
          f"{lr.K} W {lr.W} {lr.bin_dtype}")
    first = bst._gbdt.models[0]
    check(first.num_cat > 0 and max(
        (len(t.cat_threshold) for t in bst._gbdt.models), default=0) > 0,
          "wide cat: no categorical split")
    lb = ref._gbdt.learner
    (pa, ga), (pr, gr) = bst._gbdt._phys, ref._gbdt._phys
    # the eager oracle grew one tree: held to the graph's first by the
    # host record (the graph's learner has grown CAT_ITERS + 1 since)
    tr = ref._gbdt.models[0]
    check(same_trees([first], [tr]) and first.cat_threshold ==
          tr.cat_threshold, "wide cat: the graph's first tree differs from "
                            "the eager oracle's")
    del ref, lb, pr, gr, pa, ga
    want = dict(per_tree("subtraction"), split_cat=SPLITS + 1,
                feat_view=SPLITS + 1)
    for k in mods:
        check(calls[k] == 2 * want.get(k, 0),
              f"wide cat: {k}: {calls[k]} wrapper calls, expected "
              f"{2 * want.get(k, 0)}")
    say(f"wide cat train: s/iteration {med:.4f} "
        f"({[round(s, 4) for s in iter_s]}), device {busy:.2f} ms an "
        f"iteration; wrapper calls {calls}; binary_logloss {losses}; first "
        f"tree equal to the eager oracle's; {first.num_cat} categorical "
        f"nodes in the first tree, sets of {lr.W} words of bins")
    pb_, pg_ = bst._gbdt._phys
    cerr, cn, cat_steps, clast = check_wide_steps(lr, pb_, pg_, WIDE_STEPS,
                                                  "wide cat")
    kw = dict(l1=lr.l1, l2=lr.l2, max_delta_step=lr.max_delta_step,
              min_gain_to_split=lr.min_gain_to_split,
              min_data_in_leaf=lr.min_data_in_leaf,
              min_sum_hessian=lr.min_sum_hessian, max_depth=lr.max_depth)
    ctimes = wide_kernel_times(lr, clast, kw)
    cerr["tree_step"], cts_plain = check_tree_steps(ts, lr, pb_, pg_,
                                                    WIDE_STEPS)
    ctimes["tree_step"] = (per["tree_step"][0] / per["tree_step"][1],
                           cts_plain)
    del pb_, pg_, clast
    say(f"wide cat kernels on the root and {cn['split_pair'] - 1} steps "
        f"({cat_steps} categorical): bit-identical to their plain "
        f"versions {cn}, tree_step at W = {lr.W} to tree_step_plain on the "
        f"root, {WIDE_STEPS} steps and the final commit; ms a launch "
        f"(kernel, plain) {ctimes}")
    # save, reload, predict
    Xp = Xc[:100_000]
    raw = bst.predict(Xp, raw_score=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "wide.txt")
        bst.save_model(path)
        again = lgt.Booster(model_file=path).predict(Xp, raw_score=True)
    check(np.array_equal(raw, again), "wide cat: the reloaded model "
                                      "predicts other raw scores")
    host = sum(t.predict(Xp) for t in bst._gbdt.models)
    check(np.array_equal(raw, host), "wide cat: predict differs from the "
                                     "host Tree.predict")
    # card against CPU on a 200,000-row cut of the same bins
    t0 = time.time()
    cut = relabeled(lgt, cds, Xc, yc, rows=OBJ_CUT)
    card = lgt.Booster(params=cparams, train_set=cut)
    card.update()
    cpu = lgt.Booster(params=dict(cparams, device_type="cpu"),
                      train_set=cut)
    cpu.update()
    ta, tc = card._gbdt.models[0], cpu._gbdt.models[0]
    tie = None
    if not (same_trees([ta], [tc], exact=False)
            and ta.cat_threshold == tc.cat_threshold):
        tie = first_cat_tie(ta, tc, Xc[:OBJ_CUT].astype(np.float64),
                            yc[:OBJ_CUT],
                            np.full(OBJ_CUT, card._gbdt.init_scores[0]),
                            ci.bin_mappers, "wide cat card vs CPU tree 0")
    say(f"wide cat predict: 100,000 rows, save / reload bit for bit; the "
        f"first tree on a {OBJ_CUT}-row cut against the CPU plain loop: "
        + ("equal" if tie is None else f"equal up to split {tie}, an exact "
                                       f"tie in f64")
        + f"; {time.time() - t0:.1f} s")
    nbs = lr.fmeta_pair[lr.cat_feats.long(), 0].cpu().numpy().astype(
        np.float64)
    NC = len(nbs)
    out["cat"] = {"iter_s": med, "device_ms": busy, "per": per,
                  "calls": calls,
                  "err": cerr, "n": cn, "times": ctimes, "W": lr.W,
                  "Bp": lr.children.shape[-1], "tie": tie,
                  "cat_steps": cat_steps,
                  "cat_bytes": (2 * 2 * nbs.sum() * 4 + 2 * NC * 64 + NC * 4
                                + 2 * 2 * 13 * 4 + 2 * lr.W * 4),
                  "cat_ops": 2 * float((nbs * (np.ceil(np.log2(nbs)) + 60))
                                       .sum()),
                  "step_bytes": (2 * 25 + 17 + 2 * lr.G * 8 + 2 * (25 + lr.W)
                                 + 2 * 13 + 6 * lr.W + 255) * 4,
                  "view_bytes": 2 * 2 * lr.G * lr.children.shape[-1] * 8
                  + 2 * 2 * lr.F * lr.children.shape[-1] * 4}
    del bst, lr, cds, ci, card, cpu, cut, Xc, yc
    gc.collect()
    torch.cuda.empty_cache()

    # (3) the wide histogram arm
    arm = wide_arm(th, hs, torch.device("cuda", 0))
    rng = np.random.RandomState(14)
    Xa = rng.normal(size=(ARM_ROWS, ARM_FEATURES)).astype(np.float32)
    ya = (Xa[:, 0] + 0.5 * Xa[:, 1] + rng.normal(size=ARM_ROWS) > 0).astype(
        np.float32)
    aparams = {"objective": "binary", "num_leaves": 31, "verbosity": -1,
               "max_bin": ARM_MAX_BIN, "min_data_in_bin": 1}
    ads = lgt.Dataset(Xa, label=ya)
    ads.construct(aparams)
    check(ads._inner.max_group_bins > 14_500, f"wide arm: groups of "
          f"{ads._inner.max_group_bins} bins")
    bst = lgt.Booster(params=aparams, train_set=ads)
    for m in mods.values():
        m.launches = 0
    losses = []
    for _ in range(2):
        bst.update()
        losses.append(bst.eval_train()[0][2])
    arm["launches"] = mods["leaf_hist"].launches
    check(arm["launches"] == 2 * 31 and losses[1] < losses[0],
          f"wide arm training: {arm['launches']} leaf_hist wrapper calls, "
          f"losses {losses}")
    say(f"wide arm (max_bin {ARM_MAX_BIN}: Bp {arm['Bp']}, one group's "
        f"planes {2 * arm['Bp'] * 8} B past a block's shared memory): "
        f"leaf_hist and its state launch bit-identical to their plain "
        f"versions on {ARM_ROWS} x {ARM_FEATURES}; {arm['ms']:.3f} ms a "
        f"launch, plain {arm['plain_ms']:.3f} ms, index_add_ "
        f"{arm['lib_ms']:.3f} ms, bound {arm['bound'][0]:.4f} ms "
        f"({arm['bound'][1]}); a training of 2 trees at that max_bin "
        f"through it, logloss {losses}")
    out["arm"] = arm
    del bst, ads, Xa, ya
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---- phase 4i: quantized-gradient training (use_quantized_grad) ---------
QUANT_ITERS = 4
QUANT_CUT = 200_000             # rows of the card-vs-CPU trees
QUANT_MIX_ROWS = 500_000        # the frame with bundles and a category
QUANT_RUNS = (("float", {}),
              ("quant", {"use_quantized_grad": True}),
              ("quant_renew", {"use_quantized_grad": True,
                               "quant_train_renew_leaf": True}))


@contextlib.contextmanager
def quant_carriers(bmod):
    """Each tree's (grad, hess) as its histograms sum them -- the integer
    carriers times the scale, f64 in original row order, on the host --
    recorded as the port discretizes."""
    out = []
    orig = bmod.GBDT._quantize

    def record(self, ghi, eager):
        orig(self, ghi, eager)
        s = self.learner.qscale.double()
        out.append(tuple((bmod.scores_from_phys(ghi, self.num_data, r)
                          .double() * s[r]).cpu().numpy() for r in (0, 1)))

    bmod.GBDT._quantize = record
    yield out
    bmod.GBDT._quantize = orig


def quant_mix_frame(X, y):
    """QUANT_MIX_ROWS rows of X as a pandas DataFrame: the 28 features, 8
    one-hot columns of a seeded 8-level draw (they bundle), a 12-level
    category column and a bool column, with a label they move."""
    import pandas as pd
    n = QUANT_MIX_ROWS
    rng = np.random.RandomState(13)
    lev = rng.randint(0, 8, n)
    cat = rng.randint(0, 12, n)
    df = pd.DataFrame(X[:n], columns=[f"f{i}" for i in range(FEATURES)])
    for k in range(8):
        df[f"onehot{k}"] = (lev == k).astype(np.float32)
    names = [f"c{i}" for i in range(12)]
    df["cat"] = pd.Categorical([names[i] for i in cat], categories=names)
    df["flag"] = rng.rand(n) < 0.3
    yy = y[:n].copy()
    flip = ((cat % 4 == 1) | (lev == 3)) & (rng.rand(n) < 0.5)
    yy[flip] = 1.0 - yy[flip]
    return df, yy


def quant_path(lgt, mods, ds, X, y, params):
    """Phase 4i: quantized-gradient training.

    At the HIGGS shape (``ds``; binary, 255 leaves) on the mega body
    (auto: the frontier at K=4) and the subtraction body, each of three
    runs of QUANT_ITERS iterations -- float, quantized (4 bins), and
    quantized with ``quant_train_renew_leaf`` -- with every wrapper's
    count set to 0 before and read after: the body's kernels and, when
    quantized, ``quantize`` once an iteration launched, one capture and
    one tree read a tree, the training logloss falling every iteration;
    s/iteration, device ms an iteration (torch.profiler, one more
    iteration) and the training AUC (a report).  The discretizer's first
    call of each quantized run is held to ``quantize_plain`` on the same
    inputs bit for bit (payload words and the scale word); on the real
    payload after the quantized runs, split_mega's and leaf_hist's scale
    arms (the histogram and the state launch) are held to their plain
    twins bit for bit and timed beside their unscaled launches.  On a
    QUANT_CUT-row cut the card's first two iterations' trees (renewal
    on, each body) equal the CPU plain loop's split for split, or part
    at an exact tie of the carriers' f64 gains, printed.  Multiclass (3
    classes, bagged: the eager draws) trains 3 iterations; a pandas
    frame of QUANT_MIX_ROWS rows with bundling one-hot columns, a
    category and a bool column trains 3 quantized iterations through
    feat_view (whose scale arm is held to its twin on the run's state)
    and split_cat, and its model text carries ``pandas_categorical``."""
    from lightgbm_tpu_torch.models import boosting as bmod
    from lightgbm_tpu_torch.ops import quantize as qz
    from lightgbm_tpu_torch.ops import partition as tpart
    from torch.profiler import ProfilerActivity, profile
    t_phase = time.time()
    fv, hs, sm = mods["feat_view"], mods["hist_rmw"], mods["split_mega"]
    mods = dict(mods, quantize=qz)
    p0 = dict(params, metric="binary_logloss,auc")

    # the discretizer's first call of each run against its plain twin
    real_q = bmod.quantize
    held = {"err": 0.0, "checked": 0, "inputs": None}
    check_next = [False]

    def quant_checked(ghi, absmax, scale, **kw):
        if not check_next[0]:
            return real_q(ghi, absmax, scale, **kw)
        check_next[0] = False
        g0, a0 = ghi.clone(), absmax.clone()
        if held["inputs"] is None:
            held["inputs"] = (ghi.clone(), a0.clone(), dict(kw))
        real_q(ghi, absmax, scale, **kw)
        s0 = torch.zeros_like(scale)
        qz.quantize_plain(g0, a0, s0, **kw)
        check(torch.equal(ghi.view(torch.int32), g0.view(torch.int32))
              and torch.equal(scale.view(torch.int32), s0.view(torch.int32)),
              f"quantize: the kernel differs from quantize_plain on the "
              f"run's inputs ({kw})")
        held["err"] = max(held["err"], float((ghi[:2] - g0[:2]).abs().max()),
                          float((scale - s0).abs().max()))
        held["checked"] += 1
    bmod.quantize = quant_checked

    def timed(bst, iters, losses):
        times = []
        for _ in range(iters):
            t0 = time.time()
            bst.update()
            torch.cuda.synchronize()
            times.append(time.time() - t0)
            losses.append(bst.eval_train()[0][2])
        return times

    def device_ms(bst):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            bst.update()
            torch.cuda.synchronize()
        return sum(ms for _, ms, _ in device_rows(prof))

    out = {"runs": {}, "arms": {}}
    for body in ("mega", "subtraction"):
        for run, extra in QUANT_RUNS:
            quant = run != "float"
            bst = lgt.Booster(dict(p0, **BODIES[body], **extra), ds)
            g, lr = bst._gbdt, bst._gbdt.learner
            for m in mods.values():
                m.launches = 0
            check_next[0] = quant
            losses = []
            times = timed(bst, QUANT_ITERS, losses)
            calls = {k: m.launches for k, m in mods.items()}
            check(all(calls[k] > 0 for k in BODY_KERNELS[body]),
                  f"quantized {body} {run}: a kernel of the body was not "
                  f"launched: {calls}")
            check(calls["quantize"] == (QUANT_ITERS if quant else 0),
                  f"quantized {body} {run}: quantize launched "
                  f"{calls['quantize']} times in {QUANT_ITERS} iterations")
            check(lr.captures == 1 and lr.syncs == lr.replays == QUANT_ITERS,
                  f"quantized {body} {run}: {lr.captures} captures, "
                  f"{lr.replays} replays, {lr.syncs} tree reads")
            check(all(a > b_ for a, b_ in zip(losses, losses[1:])),
                  f"quantized {body} {run}: the training logloss does not "
                  f"fall: {losses}")
            check((lr.qscale is not None) == quant and (
                g._renew_rows is not None) == (run == "quant_renew"),
                  f"quantized {body} {run}: the learner's scale word or the "
                  f"renewal rows do not match the params")
            auc = [v for _, n, v, _ in bst.eval_train() if n == "auc"][0]
            dms = device_ms(bst)
            out["runs"][f"{body} {run}"] = {
                "iter_s": float(np.median(times[1:])), "iter_all": times,
                "device_ms": dms, "auc": auc, "losses": losses,
                "K": lr.K, "calls": calls}
            say(f"quantized {body} {run} (K={lr.K}): s/iteration "
                f"{[round(t, 4) for t in times]}, device ms an iteration "
                f"{dms:.2f}, training AUC after {QUANT_ITERS} iterations "
                f"{auc:.6f}, logloss {losses}; launches {calls}")
            if run == "quant":
                out["arms"][body] = quant_arms(bst, sm, hs, tpart)
            del bst, g, lr
            gc.collect()
            torch.cuda.empty_cache()
    check(held["checked"] == 4, f"quantize: {held['checked']} checked calls")
    bmod.quantize = real_q

    # the discretizer's ms a launch on the first run's true inputs (the
    # gradients as they came in): each launch rewrites its payload, so
    # each gets a fresh copy, made before the launches are queued
    ghi_in, amax, kw = held["inputs"]
    Np, dev = ghi_in.shape[1], ghi_in.device
    scale = torch.zeros(2, device=dev)

    def fresh_ms(fn, n, queued=True):
        copies = [ghi_in.clone() for _ in range(n)]
        if queued:
            ms, k = queued_ms([lambda c=c: fn(c) for c in copies])
            return ms / k
        # the plain version waits on the host (its constants reach the
        # card by a blocking copy), so it runs between two events as
        # cuda_ms times it
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for c in copies:
            fn(c)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / n
    q_ms = fresh_ms(lambda c: qz.quantize(c, amax, scale, **kw), 10)
    # with quant_train_renew_leaf: the true rows copied too (8 bytes more)
    q_renew_ms = fresh_ms(lambda c: qz.quantize(
        c, amax, scale, **dict(kw, renew_rows=(5, 6))), 10)
    q_plain_ms = fresh_ms(lambda c: qz.quantize_plain(c, amax, scale, **kw),
                          3, queued=False)
    g_in, h_in = ghi_in[0], ghi_in[1]
    gq, hq = torch.empty_like(g_in), torch.empty_like(h_in)

    def library():
        # torch.rand for the two draws and the discretizer's elementwise
        # operations: the nearest library calls
        r = torch.rand((2, Np), device=dev)
        gs = torch.clamp_min(amax[0] / 2.0, 1e-30)
        hs_ = torch.clamp_min(amax[1] / 4.0, 1e-30)
        torch.trunc(g_in / gs + torch.where(g_in >= 0, r[0], -r[0]), out=gq)
        torch.trunc(h_in / hs_ + r[1], out=hq)
    q_lib_ms = cuda_ms(library, 10)
    q_rows = 12 + 8 + (8 if kw.get("renew_rows") else 0)
    q_bound = bound(Np * q_rows, Np * 10)
    q_renew_bound = bound(Np * (q_rows + 8), Np * 10)
    out["quantize"] = {"ms": q_ms, "plain_ms": q_plain_ms,
                       "library_ms": q_lib_ms, "bound": q_bound,
                       "err": held["err"], "rows": Np, "bytes_a_row": q_rows,
                       "ms_renew": q_renew_ms,
                       "bound_ms_renew": q_renew_bound[0]}
    say(f"quantize @ {Np} payload rows: {q_ms:.4f} ms a launch, plain "
        f"{q_plain_ms:.3f} ms, "
        f"bound {q_bound[0]:.4f} ms ({q_bound[1]}: {q_rows} bytes a row; "
        f"the draws' ~170 int32 operations a row are not in the bound's "
        f"table); with the renewal's rows {q_renew_ms:.4f} ms, bound "
        f"{q_renew_bound[0]:.4f} ms ({q_rows + 8} bytes a row); "
        f"torch.rand and the elementwise operations "
        f"{q_lib_ms:.3f} ms; bit-identical to quantize_plain on the first "
        f"call of each of the {held['checked']} quantized runs")
    del ghi_in, g_in, h_in, gq, hq
    torch.cuda.empty_cache()

    # the card's trees against the CPU's on a cut: L2 on the continuous
    # label from a zero score, whose gradients are f32 subtractions with
    # the same bits on both devices, so the carriers are too
    yc, _ = objective_labels(X)
    d_cut = relabeled(lgt, ds, X, yc, QUANT_CUT)
    cut64 = X[:QUANT_CUT].astype(np.float64)
    out["card_vs_cpu"] = {}
    for body in ("mega", "subtraction"):
        for renew, iters in ((False, 2), (True, 1)):
            p = dict(params, **BODIES[body], objective="regression",
                     boost_from_average=False, use_quantized_grad=True,
                     quant_train_renew_leaf=renew)
            models = []
            for dev_kw in ({}, {"device_type": "cpu"}):
                with quant_carriers(bmod) as rec:
                    cb = lgt.Booster(dict(p, **dev_kw), d_cut)
                    for _ in range(iters):
                        cb.update()
                models.append((cb._gbdt.models, rec))
            (ma, reca), (mb, recb) = models
            what = f"quantized {body}{' renew' if renew else ''} card vs CPU"
            ties = []
            for t, (ta, tb) in enumerate(zip(ma, mb)):
                check(all(np.array_equal(a, b) for a, b in zip(reca[t],
                                                               recb[t])),
                      f"{what}: tree {t}'s carriers differ")
                s = tree_tie(ta, tb, cut64, *reca[t], f"{what} tree {t}",
                             exact=True)
                if s is not None:
                    ties.append((t,) + s)
                    break
                # the renewal's f64 sums run in another order on each
                # device; without it the values come from the same search
                check(np.allclose(ta.leaf_value, tb.leaf_value, rtol=1e-6,
                                  atol=0) if renew else np.array_equal(
                                      ta.leaf_value, tb.leaf_value),
                      f"{what} tree {t}: leaf values differ by "
                      f"{np.abs(ta.leaf_value - tb.leaf_value).max()!r}")
            out["card_vs_cpu"][f"{body} renew={renew}"] = ties
            say(f"{what} on {QUANT_CUT} rows (L2 from a zero score): the "
                f"carriers bit-identical, the card's {len(ma)} trees "
                + ("equal the CPU plain loop's split for split (leaf values "
                   + ("within rtol 1e-6)" if renew else "bit for bit)")
                   if not ties else f"part from the CPU's at exact ties "
                                    f"{ties}"))
    del d_cut

    # multiclass: 3 classes, bagged (the eager draws)
    y3 = np.searchsorted(np.quantile(yc, [1 / 3, 2 / 3]), yc,
                         side="right").astype(np.float32)
    d3 = relabeled(lgt, ds, X, y3)
    bst = lgt.Booster(dict(params, **BODIES["mega"], objective="multiclass",
                           num_class=3, metric="multi_logloss",
                           use_quantized_grad=True, bagging_fraction=0.8,
                           bagging_freq=1), d3)
    for m in mods.values():
        m.launches = 0
    losses = []
    times = timed(bst, 3, losses)
    lr = bst._gbdt.learner
    check(bst._gbdt._eager_quant and mods["quantize"].launches == 9
          and lr.captures == 1 and lr.syncs == 9
          and all(a > b_ for a, b_ in zip(losses, losses[1:])),
          f"quantized multiclass: eager {bst._gbdt._eager_quant}, quantize "
          f"{mods['quantize'].launches}, captures {lr.captures}, tree reads "
          f"{lr.syncs}, multi_logloss {losses}")
    out["multiclass"] = {"iter_s": times, "losses": losses, "K": lr.K}
    say(f"quantized multiclass (3 classes, bagged, K={lr.K}): s/iteration "
        f"{[round(t, 4) for t in times]}, multi_logloss {losses}, 9 class "
        f"trees, one capture, quantize launched once a class tree")
    del bst, d3, lr
    gc.collect()
    torch.cuda.empty_cache()

    # a pandas frame: bundling one-hot columns, a category, a bool
    df, ym = quant_mix_frame(X, y)
    pm = dict(params, use_quantized_grad=True, quant_train_renew_leaf=True,
              min_data_per_group=50)
    # the constructed frame stays for phase 4j's run on it
    out["frame_ds"] = lgt.Dataset(df, label=ym)
    bst = lgt.Booster(pm, out["frame_ds"])
    lr = bst._gbdt.learner
    pc = bst.pandas_categorical
    check(lr.bundled and lr.has_cat and lr.subtract and len(pc) == 2
          and pc[0] == [f"c{i}" for i in range(12)]
          and sorted(pc[1]) == [False, True],
          f"quantized frame: bundled {lr.bundled}, categorical {lr.has_cat}, "
          f"pandas_categorical {bst.pandas_categorical}")
    for m in mods.values():
        m.launches = 0
    losses = []
    times = timed(bst, 3, losses)
    fv_launches = mods["feat_view"].launches
    check(all(mods[k].launches > 0 for k in ("feat_view", "split_cat",
                                             "quantize", "leaf_hist"))
          and all(a > b_ for a, b_ in zip(losses, losses[1:])),
          f"quantized frame: launches "
          f"{ {k: m.launches for k, m in mods.items()} }, logloss {losses}")
    # feat_view's scale arm on the run's state: two slots of the last tree
    step = torch.zeros(tpart.step_len(lr.W), dtype=torch.int32,
                       device=lr.device)
    step[tpart.SB_CNT], step[tpart.SB_WA], step[tpart.SB_WB] = lr.N, 0, 1
    fout = torch.empty_like(lr.fchildren)
    kv = dict(kcnt=lr.N, view=lr.view, out=fout)
    fv.feat_view(None, None, lr.state, step, lr._absmax, scale=lr.qscale, **kv)
    want = fv.feat_view_fixed_plain(lr.state, step, lr._absmax, lr.N,
                                    lr.view, scale=lr.qscale)
    check(torch.equal(fout.view(torch.int32), want.view(torch.int32)),
          "feat_view: the scale arm differs from feat_view_fixed_plain")
    fv_err = float((fout - want).abs().max())
    fv_ms = graph_ms(lambda: fv.feat_view(None, None, lr.state, step,
                                          lr._absmax, scale=lr.qscale, **kv),
                     100)
    fv_unscaled_ms = graph_ms(lambda: fv.feat_view(
        None, None, lr.state, step, lr._absmax, **kv), 100)
    fv_plain_ms = cuda_ms(lambda: fv.feat_view_fixed_plain(
        lr.state, step, lr._absmax, lr.N, lr.view, scale=lr.qscale), 5)
    F, Bp = lr.view.F, lr.view.Bp
    out["arms"]["feat_view"] = {
        "ms": fv_ms, "ms_unscaled": fv_unscaled_ms, "plain_ms": fv_plain_ms,
        "err": fv_err,
        "bound": bound(2 * 2 * lr.G * Bp * 8 + 2 * 2 * F * Bp * 4, 0),
        "launches": fv_launches, "F": F, "Bp": Bp}
    dfp, _ = quant_mix_frame(X[-QUANT_MIX_ROWS:], y[-QUANT_MIX_ROWS:])
    dfp.loc[dfp.index[:1000], "cat"] = np.nan
    raw = bst.predict(dfp.iloc[:100_000], raw_score=True)
    text = bst.model_to_string()
    again = lgt.Booster(model_str=text, params={
        k: v for k, v in pm.items() if k == "device_type"})
    check(text.rstrip().split("\n")[-1].startswith("pandas_categorical:")
          and np.isfinite(raw).all() and np.array_equal(
              again.predict(dfp.iloc[:100_000], raw_score=True), raw),
          "quantized frame: the model text's pandas_categorical line, or "
          "the reloaded model's predictions")
    out["frame"] = {"iter_s": times, "losses": losses}
    say(f"quantized frame ({QUANT_MIX_ROWS} rows, 8 one-hot columns in a "
        f"bundle, a 12-level category and a bool column; subtraction body): "
        f"s/iteration {[round(t, 4) for t in times]}, logloss {losses}; "
        f"feat_view's scale arm bit-identical to its twin on the run's "
        f"state, {fv_ms:.4f} ms a launch (unscaled {fv_unscaled_ms:.4f}); "
        f"the model text's pandas_categorical reloads and predicts a frame "
        f"bit for bit")
    del bst, again, lr, df, dfp
    gc.collect()
    torch.cuda.empty_cache()
    say(f"quantized (phase 4i): {time.time() - t_phase:.1f} s")
    return out


def quant_arms(bst, sm, hs, tpart):
    """split_mega's (mega body) or leaf_hist's state launch's
    (subtraction body) scale arm on the quantized run's real payload --
    the last tree's integer carriers, its scale word and bound: bit-
    identical to the plain twin on the root's rows and, for the state
    launch, a child of them; times by graph replay, scaled and unscaled,
    and the plain twin's."""
    lr = bst._gbdt.learner
    pb, pg = bst._gbdt._phys
    N, C, G, B, dev = lr.N, lr.row0, lr.G, lr.B, lr.device
    Bp = sm.hist_geometry(B)[1]
    amax, scale = lr._absmax.clone(), lr.qscale.clone()
    nl = torch.zeros(1, dtype=torch.int32, device=dev)
    if not lr.subtract:
        # the root's rows, a decision on group 0 at bin 128
        sc = tpart.make_scalars(C, N, 0, 0, 0, 255, 0, 0, 128, 0)
        want = sm.hist_fixed_plain(pb, pg, sc, num_bins=B, num_groups=G,
                                   absmax=amax, scale=scale)
        got = sm.split_mega(pb, pg, sc, num_bins=B, num_groups=G,
                            move=False, absmax=amax, scale=scale)[1]
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              "split_mega: the scale arm differs from hist_fixed_plain")
        step = tpart.step_block(sc, dev)
        h4 = torch.empty_like(got)
        sk = dict(num_bins=B, num_groups=G, absmax=amax, bound=N, move=False)
        ms = graph_ms(lambda: sm.split_mega_step(pb, pg, step, nl, h4,
                                                 scale=scale, **sk), 10)
        ms0 = graph_ms(lambda: sm.split_mega_step(pb, pg, step, nl, h4, **sk),
                       10)
        plain = cuda_ms(lambda: sm.hist_fixed_plain(
            pb, pg, sc, num_bins=B, num_groups=G, absmax=amax, scale=scale),
            2, 1)
        res = {"name": "split_mega", "err": float((got - want).abs().max()),
               "ms": ms, "ms_unscaled": ms0, "plain_ms": plain,
               "bound": bound(N * (G + 8) + G * 4 * Bp * 4, 2 * N * G),
               "rows": N}
    else:
        st = torch.zeros((3, 2, G, Bp), dtype=torch.int64, device=dev)
        kw = dict(num_bins=B, num_groups=G, absmax=amax, kcnt=N, scale=scale)
        res = {"name": "leaf_hist", "err": 0.0, "rows": N}
        for idx, cnt in (((-1, 0, 0, 0), N), ((0, 0, 1, 1), N // 3)):
            s_card, s_plain = st.clone(), st.clone()
            got = hs.leaf_hist_rmw(pb, pg, C, cnt, state=s_card, idx=idx,
                                   **kw)
            want = hs.leaf_hist_rmw_fixed_plain(pb, pg, C, cnt, state=s_plain,
                                                idx=idx, **kw)
            check(torch.equal(got.view(torch.int32), want.view(torch.int32))
                  and torch.equal(s_card, s_plain),
                  f"leaf_hist: the state launch's scale arm differs from "
                  f"leaf_hist_rmw_fixed_plain (idx {idx})")
            res["err"] = max(res["err"], float((got - want).abs().max()))
            st = s_card
        sc = tpart.make_scalars(C, N, 0, 0, 0, 0, 0, 0, 0, 0)
        step = tpart.step_block(sc, dev, (-1, 2, 2, 0))
        children = torch.empty((2, 2, G, Bp), device=dev)
        lk = dict(num_bins=B, num_groups=G, absmax=amax, kcnt=N, bound=N,
                  state=st, out=children)
        ms = graph_ms(lambda: hs.leaf_hist_rmw_step(pb, pg, step, None,
                                                    scale=scale, **lk), 10)
        ms0 = graph_ms(lambda: hs.leaf_hist_rmw_step(pb, pg, step, None,
                                                     **lk), 10)
        plain = cuda_ms(lambda: hs.leaf_hist_rmw_fixed_plain(
            pb, pg, C, N, state=st.clone(), idx=(-1, 2, 2, 0), **kw), 2, 1)
        res.update(ms=ms, ms_unscaled=ms0, plain_ms=plain,
                   bound=bound(N * (G + 8) + 2 * G * Bp * (8 + 16 + 8),
                               2 * N * G))
    say(f"{res['name']}'s scale arm on the quantized run's payload "
        f"({N} rows): bit-identical to its plain twin; {res['ms']:.3f} ms "
        f"(unscaled {res['ms_unscaled']:.3f} ms, graph replay), plain "
        f"{res['plain_ms']:.3f} ms, bound {res['bound'][0]:.3f} ms "
        f"({res['bound'][1]})")
    return res


def quant_summary(quant):
    """Phase 4i's numbers for the log: per body, s/iteration, device ms
    an iteration and training AUC of the float and quantized runs."""
    return {"runs": {k: {n: r[n] for n in ("iter_s", "device_ms", "auc",
                                           "K")}
                     for k, r in quant["runs"].items()},
            "card_vs_cpu_ties": quant["card_vs_cpu"],
            "multiclass_iter_s": quant["multiclass"]["iter_s"],
            "frame_iter_s": quant["frame"]["iter_s"]}


def quant_rows(quant):
    """The kernels line's rows of phase 4i: the discretizer and the three
    scale arms (each its kernel's launch with the scale word, against the
    plain twin; ``ms_unscaled`` the same launch without it), launches the
    wrapper's count over the quantized run of the path (set to 0 just
    before it)."""
    qd, qa, runs = quant["quantize"], quant["arms"], quant["runs"]
    rows = [{"name": "quantize", "route": "cuda",
             "source": "lightgbm_tpu_torch/csrc/quantize.cu",
             "replaces": "lightgbm_tpu/models/boosting.py:921",
             "launches": runs["mega quant"]["calls"]["quantize"],
             "max_abs_err": qd["err"], "ms": qd["ms"],
             "plain_ms": qd["plain_ms"], "bound_ms": qd["bound"][0],
             "bound_by": qd["bound"][1], "library_ms": qd["library_ms"],
             "library_call": "torch.rand of (2, N_pad) and the "
                             "discretizer's elementwise operations",
             "rows": qd["rows"], "bytes_a_row": qd["bytes_a_row"],
             "ms_renew": qd["ms_renew"],
             "bound_ms_renew": qd["bound_ms_renew"]}]
    for name, arm, source, replaces, launches in (
            ("split_mega_scale", qa["mega"], "split_mega.cu",
             "lightgbm_tpu/models/learner.py:1303",
             runs["mega quant"]["calls"]["split_mega"]),
            ("leaf_hist_scale", qa["subtraction"], "leaf_hist.cu",
             "lightgbm_tpu/models/learner.py:970",
             runs["subtraction quant"]["calls"]["leaf_hist"]),
            ("feat_view_scale", qa["feat_view"], "feat_view.cu",
             "lightgbm_tpu/models/learner.py:970", qa["feat_view"][
                 "launches"])):
        rows.append({"name": name, "route": "cuda",
                     "source": f"lightgbm_tpu_torch/csrc/{source}",
                     "replaces": replaces, "launches": launches,
                     "max_abs_err": arm["err"], "ms": arm["ms"],
                     "plain_ms": arm["plain_ms"], "bound_ms": arm["bound"][0],
                     "bound_by": arm["bound"][1], "library_ms": None,
                     "ms_unscaled": arm["ms_unscaled"]})
    return rows



MONO_ITERS = 4
MONO_STEPS = 6                  # refreshes of a tree held kernel by kernel
MONO_CUT = 200_000              # rows of the card-vs-CPU trees
MONO_CUT_LEAVES = 63
MONO_SWEEP_ROWS = 1000
MONO_COPIES = 20                # fresh states a one-shot launch is timed on
MONO_RUNS = (("unconstrained", {}),
             ("basic", {"monotone_constraints_method": "basic"}),
             ("intermediate",
              {"monotone_constraints_method": "intermediate"}),
             ("basic_penalty", {"monotone_constraints_method": "basic",
                                "monotone_penalty": 1.0}))
# the device functions of the monotone bodies (the subtraction body's,
# and intermediate's refresh) and their launches a tree: the refresh runs
# between every commit of a split and the next election (SPLITS - 1 times)
MONO_FUNCS = ("part_tiles", "part_copyback", "leaf_hist_state",
              "pair_search", "tree_step", "mono_refresh", "mono_planes",
              "mono_overlay")


def mono_zero(mods, tmono):
    """Every wrapper's launch count set to 0, mono.cu's three included."""
    for m in mods.values():
        m.launches = 0
    for k in tmono.launches:
        tmono.launches[k] = 0


def mono_calls(mods, tmono):
    """Every wrapper's launch count, mono.cu's three by kernel."""
    return dict({k: m.launches for k, m in mods.items()}, **tmono.launches)


def mono_constraints(w):
    """``monotone_constraints`` of phase 4j: the sign of make_data's
    weight on each of the first 8 features, 0 on the rest (a user
    constraining the features whose direction is known)."""
    return [int(np.sign(v)) for v in w[:8]] + [0] * (len(w) - 8)


def mono_per_tree(intermediate):
    """Each device function's launches a tree of the subtraction body,
    with intermediate's refresh."""
    r = SPLITS - 1 if intermediate else 0
    return {"part_tiles": SPLITS, "part_copyback": SPLITS,
            "leaf_hist_state": SPLITS + 1, "pair_search": SPLITS + 1 + r,
            "tree_step": SPLITS + 2 + r, "mono_refresh": r,
            "mono_planes": r, "mono_overlay": r}


def mono_sweep(bst, X, mc, rows):
    """The card's raw predictions for ``rows`` seeded base rows of ``X``,
    each constrained feature set to every bin threshold of its mapper
    (and past the last): never falling along a +1 feature, never rising
    along a -1 one.  Returns the constrained steps checked."""
    rng = np.random.RandomState(17)
    base = X[rng.choice(len(X), rows, replace=False)].astype(np.float64)
    mappers = bst._gbdt.train_data.bin_mappers
    steps = 0
    for f, sign in enumerate(mc):
        if not sign:
            continue
        ub = np.asarray(mappers[f].bin_upper_bound, np.float64)
        grid = np.append(ub[np.isfinite(ub)], ub[np.isfinite(ub)][-1] + 1)
        Z = np.repeat(base, len(grid), axis=0)
        Z[:, f] = np.tile(grid, rows)
        p = np.asarray(bst.predict(Z, raw_score=True)).reshape(rows, -1)
        d = np.diff(p, axis=1) * sign
        check(d.min() >= 0.0, f"monotone sweep: feature {f} ({sign:+d}) "
                              f"moves the prediction against its direction "
                              f"by {d.min()!r}")
        steps += d.size
    return steps


def check_mono_steps(lr, pb, pg, steps, sp, scat, ts, tmono, tpart):
    """Every kernel of the monotone body against its plain twin, bit for
    bit, on the states of a real tree: the learner's own sequence on
    copies of its row buffers -- the root, the first step, then ``steps``
    times the commit, the refresh (mono_refresh, mono_planes, the pair
    search over the L leaves with split_cat's clamp arm when there are
    categorical features, mono_overlay) and the election, each split's
    pair search -- each launch's inputs copied to the host before it runs
    and its plain twin run there; then the rest of the tree unchecked.
    Returns the largest bit difference a kernel, the plain twins' host
    ms, the inputs kept for the timings (of the refresh with the most
    live leaves among those that changed the most leaves, of the last
    commit and election) and the changed leaves of each held refresh."""
    pb, pg = pb.clone(), pg.clone()
    kw = dict(row0=lr.row0, N=lr.N)
    kp = dict(l1=lr.l1, l2=lr.l2, max_delta_step=lr.max_delta_step,
              min_gain_to_split=lr.min_gain_to_split,
              min_data_in_leaf=lr.min_data_in_leaf,
              min_sum_hessian=lr.min_sum_hessian, max_depth=lr.max_depth)
    pen = None if lr.mc_pen is None else lr.mc_pen.cpu()
    err = {k: 0 for k in ("tree_step", "split_pair", "split_cat",
                          "mono_refresh", "mono_planes", "mono_overlay")}
    plain = {k: [] for k in err}
    last = {}

    def same(k, got, want, what):
        got = got.cpu()
        if got.dtype == torch.float32:
            got, want = got.view(torch.int32), want.view(torch.int32)
        if got.numel():
            err[k] = max(err[k], int((got.long() - want.long()).abs().max()))
        check(torch.equal(got, want), f"{what}: the kernel differs from its "
                                      f"plain twin")

    def host_ms(k, fn):
        t0 = time.perf_counter()
        out = fn()
        plain[k].append(1e3 * (time.perf_counter() - t0))
        return out

    def step(mode, what):
        host = [t.cpu() for t in tree_args(lr)] + [lr.boxes.cpu()]
        if mode in (ts.MODE_COMMIT, ts.MODE_ELECT):
            last[mode] = [t.clone() for t in tree_args(lr)] + [
                lr.boxes.clone()]
        ts.tree_step(mode, *tree_args(lr), boxes=lr.boxes, **kw)
        host_ms("tree_step", lambda: ts.tree_step_plain(
            mode, *host[:-1], boxes=host[-1], **kw))
        for got, want in zip(list(tree_args(lr)) + [lr.boxes], host):
            same("tree_step", got, want, f"tree_step {what}")

    def search(hg, hh, info, out, cat_out, cat_work, what):
        c = hg.shape[0] // lr.F
        fm = lr.fmeta_pair[:c * lr.F]
        args = [t.cpu() for t in (hg, hh, fm, info)]
        lr._search(hg, hh, info, out=out, cat_out=cat_out, cat_work=cat_work)
        want = host_ms("split_pair", lambda: sp.split_pair_plain(
            *args, children=c, mono=True, pen=pen, **kp))
        if lr.has_cat:
            cats = torch.zeros((c, lr.W), dtype=torch.int32)
            host_ms("split_cat", lambda: scat.split_cat_plain(
                *args, lr.cat_feats.cpu(), want, cats, children=c,
                mono=True, **kp, **lr.cat_kw))
            same("split_cat", cat_out if cat_out is not None else lr.paircat,
                 cats, f"split_cat {what}")
        same("split_pair", out, want, f"split_pair {what}")

    def pair(what, root=False):
        ch = lr.children
        if lr.bundled:
            from lightgbm_tpu_torch.ops.feat_view import feat_view
            feat_view(ch, lr.info, lr.state, lr.root_step if root
                      else lr.step, lr._absmax, kcnt=lr.N, view=lr.view,
                      out=lr.fchildren, scale=lr.qscale)
            ch = lr.fchildren
        Bp = ch.shape[-1]
        search(ch[0].reshape(-1, Bp), ch[1].reshape(-1, Bp), lr.info,
               lr.pair_out, None, None, what)

    def refresh(what):
        ins = [lr.leafmat, lr.boxes, lr.fmeta, lr.step, lr.fmask]
        host = [t.cpu() for t in ins]
        hch = torch.zeros_like(lr.mc_changed, device="cpu")
        hinfo = torch.zeros_like(lr.mc_info, device="cpu")
        tmono.mono_refresh(*ins, lr.mc_changed, lr.mc_info)
        host_ms("mono_refresh", lambda: tmono.mono_refresh_plain(
            *host, hch, hinfo))
        for got, want in ((lr.leafmat, host[0]), (lr.mc_changed, hch),
                          (lr.mc_info, hinfo)):
            same("mono_refresh", got, want, f"mono_refresh {what}")
        view = None if lr.view is None else lr.view.to("cpu")
        scale = None if lr.qscale is None else lr.qscale.cpu()
        tmono.mono_planes(lr.state, lr.mc_changed, lr._absmax, lr.mc_info,
                          kcnt=lr.N, out=lr.mc_planes, view=lr.view,
                          scale=lr.qscale)
        want = host_ms("mono_planes", lambda: tmono.mono_planes_fixed_plain(
            lr.state.cpu(), hch, lr._absmax.cpu(), kcnt=lr.N, view=view,
            scale=scale))
        keep = hch.bool()
        same("mono_planes", lr.mc_planes[:, keep.to(lr.device)],
             want[:, keep], f"mono_planes {what}")
        Bp = lr.mc_planes.shape[-1]
        search(lr.mc_planes[0].view(-1, Bp), lr.mc_planes[1].view(-1, Bp),
               lr.mc_info, lr.mc_rows, lr.mc_cats, lr.mc_cat_work,
               f"{what} (the L leaves)")
        hl, hc = lr.leafmat.cpu(), lr.leafcat.cpu()
        cats = lr.mc_cats if lr.has_cat else None
        tmono.mono_overlay(lr.leafmat, lr.leafcat, lr.mc_changed, lr.mc_rows,
                           cats)
        host_ms("mono_overlay", lambda: tmono.mono_overlay_plain(
            hl, hc, hch, lr.mc_rows.cpu(),
            None if cats is None else cats.cpu()))
        same("mono_overlay", lr.leafmat, hl, f"mono_overlay {what}")
        same("mono_overlay", lr.leafcat, hc, f"mono_overlay {what}")
        return int(hch.sum())

    torch.amax(pg[:2].abs(), dim=1, out=lr._absmax)
    lr._body(pb, pg, lr.root_step)
    lr._root_sums(pg, lr.children[0, 0, 0], lr.children[1, 0, 0], lr.sums)
    step(ts.MODE_ROOT, "root")
    pair("root", root=True)
    step(ts.MODE_STEP, "step 0")
    lr._body(pb, pg, lr.step)
    pair("step 0")
    changed = []
    for i in range(1, steps + 1):
        step(ts.MODE_COMMIT, f"commit {i}")
        changed.append(refresh(f"refresh {i}"))
        step(ts.MODE_ELECT, f"elect {i}")
        lr._body(pb, pg, lr.step)
        pair(f"step {i}")
    # the rest of the tree, unchecked, keeping for the timings the inputs
    # of the refresh with the most live leaves that changed some, and of
    # the last commit and election
    most = -1
    while not int(lr.step[tpart.SB_DONE]) and int(lr.step[
            tpart.SB_S]) < lr.max_splits:
        last[ts.MODE_COMMIT] = [t.clone() for t in tree_args(lr)] + [
            lr.boxes.clone()]
        lr._step(ts.MODE_COMMIT)
        ins = [t.clone() for t in (lr.leafmat, lr.boxes, lr.fmeta, lr.step,
                                   lr.fmask)]
        lr._refresh()
        n = int(lr.mc_changed.sum())
        if n and n >= most:
            most = n
            last["refresh"] = ins
            last["planes"] = lr.mc_changed.clone()
        last[ts.MODE_ELECT] = [t.clone() for t in tree_args(lr)] + [
            lr.boxes.clone()]
        lr._step(ts.MODE_ELECT)
        if int(lr.step[tpart.SB_DONE]):
            break
        lr._body(pb, pg, lr.step)
        lr._pair()
    check(most > 0, "mono: no refresh of the tree changed a leaf's bounds")
    return err, {k: float(np.median(v)) for k, v in plain.items() if v}, \
        last, changed


def mono_times(lr, last, sp, ts, tmono, SB_S):
    """ms a launch of each new kernel and arm on the inputs of the last
    refresh held (graph replay; the commit and the election by CUDA
    events on fresh copies of their states, queued back to back), with
    its bound from the run's own sizes: the L-leaf pair search's and the
    changed leaves' planes.  Returns {name: (ms, (bound ms, by))}."""
    L, F, W, dev = lr.L, lr.F, lr.W, lr.device
    ins = [t.clone() for t in last["refresh"]]
    live = int(ins[3][SB_S]) + 1
    changed = last["planes"]
    n_ch = int(changed.sum())
    info, planes = lr.mc_info.clone(), lr.mc_planes.clone()
    rows, cats = lr.mc_rows.clone(), lr.mc_cats.clone()
    lm, lc = lr.leafmat.clone(), lr.leafcat.clone()
    out = {}
    ch = torch.zeros_like(changed)
    out["mono_refresh"] = (graph_ms(lambda: tmono.mono_refresh(
        *ins, ch, info), 50), bound(
            (2 * (L + 1) * F + 6 * L + L * F * 8 + L) * 4,
            2 * L * live * F))
    Bp = planes.shape[-1]
    out["mono_planes"] = (graph_ms(lambda: tmono.mono_planes(
        lr.state, changed, lr._absmax, info, kcnt=lr.N, out=planes,
        view=lr.view, scale=lr.qscale), 50), bound(
            n_ch * 2 * F * Bp * (8 + 4) + L * 4, 0))
    fm = lr.fmeta_pair[:L * F]
    kp = dict(l1=lr.l1, l2=lr.l2, max_delta_step=lr.max_delta_step,
              min_gain_to_split=lr.min_gain_to_split,
              min_data_in_leaf=lr.min_data_in_leaf,
              min_sum_hessian=lr.min_sum_hessian, max_depth=lr.max_depth,
              children=L, mono=True, pen=lr.mc_pen)
    pout = torch.empty((L, 13), device=dev)
    hg, hh = planes[0].view(-1, Bp), planes[1].view(-1, Bp)
    out["split_pair_mono"] = (graph_ms(lambda: sp.split_pair(
        hg, hh, fm, info, out=pout, **kp), 50), bound(
            2 * L * F * Bp * 4 + 2 * L * F * 8 * 4 + L * 13 * 4,
            L * F * Bp * 80))
    out["split_pair_mono_plain_ms"] = cuda_ms(
        lambda: sp.split_pair_plain(hg, hh, fm, info, **kp), 3)
    ov = 13 + (W if lr.has_cat else 0)
    out["mono_overlay"] = (graph_ms(lambda: tmono.mono_overlay(
        lm, lc, changed, rows, cats if lr.has_cat else None), 50), bound(
            L * 4 + n_ch * ov * 4 * 2, 0))
    kw = dict(row0=lr.row0, N=lr.N)
    for mode, name in ((ts.MODE_COMMIT, "tree_step_commit"),
                       (ts.MODE_ELECT, "tree_step_elect")):
        copies = [[t.clone() for t in last[mode]]
                  for _ in range(MONO_COPIES)]
        ms, k = queued_ms([lambda c=c: ts.tree_step(
            mode, *c[:-1], boxes=c[-1], **kw) for c in copies])
        nbytes = ((25 + 2 * 25 + 2 * 13 + 1 + 3 * 2 * F + 2 * W) * 4
                  if mode == ts.MODE_COMMIT else
                  (L + 25 + 17 + 2 * F * 8 + 33 + 2 * W) * 4)
        out[name] = (ms / k, bound(nbytes, 0))
    out["live"], out["changed"] = live, n_ch
    return out


def mono_path(lgt, mods, ds, X, y, w, params):
    """Phase 4j: monotone constraints at the HIGGS shape.

    ``monotone_constraints`` = the sign of make_data's weight on the
    first 8 features (``mono_constraints``).  On the subtraction body
    (the JAX package's body for monotone constraints), MONO_ITERS
    iterations each of the unconstrained run, ``basic``,
    ``intermediate`` and ``basic`` with ``monotone_penalty`` 1 from
    ``ds``, every wrapper's count set to 0 before a run and read after
    (twice a tree's calls: the run that sizes everything, then the
    capture), one capture and one tree read a tree, the logloss falling;
    s/iteration (median of iterations 2-4) and, one more iteration
    under torch.profiler, device ms and the device launches by function,
    equal to what the graph holds a tree.  On the intermediate run's
    learner, every new arm and kernel against its plain twin bit for bit
    on MONO_STEPS refreshes of a real tree (``check_mono_steps``) and
    its ms a launch (``mono_times``); the monotonicity sweep on
    MONO_SWEEP_ROWS rows of the basic and intermediate models.  On a
    MONO_CUT-row cut (L2 on 4g's continuous label from a zero score,
    quantized: integer carriers both devices sum exactly; MONO_CUT_LEAVES
    leaves, intermediate, penalty 1) the card's first tree equals the
    CPU plain loop's bit for bit.  Phase 4i's frame is ``mono_frame``'s,
    after 4i."""
    from lightgbm_tpu_torch.models import boosting as bmod
    from lightgbm_tpu_torch.ops import mono as tmono
    from torch.profiler import ProfilerActivity, profile
    t_phase = time.time()
    sp, scat, ts = mods["split_pair"], mods["split_cat"], mods["tree_step"]
    mc = mono_constraints(w)
    out = {"mc": mc, "runs": {}}

    keep = {}
    for run, extra in MONO_RUNS:
        p = dict(params, tpu_megakernel="off", **extra)
        if run != "unconstrained":
            p["monotone_constraints"] = mc
        bst = lgt.Booster(p, ds)
        lr = bst._gbdt.learner
        inter = run == "intermediate"
        check(lr.subtract and lr.K == 1 and lr.use_mc == (
            run != "unconstrained") and (lr.mc_mode == "intermediate")
              == inter and (lr.mc_pen is not None) == ("penalty" in run),
              f"mono {run}: subtract {lr.subtract} K {lr.K} use_mc "
              f"{lr.use_mc} mode {lr.mc_mode}")
        mono_zero(mods, tmono)
        times, losses = [], []
        for _ in range(MONO_ITERS):
            t0 = time.time()
            bst.update()
            torch.cuda.synchronize()
            times.append(time.time() - t0)
            losses.append(bst.eval_train()[0][2])
        got = mono_calls(mods, tmono)
        want = {"partition": SPLITS, "leaf_hist": SPLITS + 1,
                "hist_rmw": SPLITS + 1,
                "split_pair": SPLITS + 1 + (SPLITS - 1 if inter else 0),
                "tree_step": SPLITS + 2 + (SPLITS - 1 if inter else 0),
                "mono_refresh": SPLITS - 1 if inter else 0,
                "mono_planes": SPLITS - 1 if inter else 0,
                "mono_overlay": SPLITS - 1 if inter else 0}
        for k, n in want.items():
            check(got.get(k, 0) == 2 * n, f"mono {run}: {k}: {got.get(k)} "
                                          f"wrapper calls, expected {2 * n}")
        check(lr.captures == 1 and lr.syncs == lr.replays == MONO_ITERS,
              f"mono {run}: {lr.captures} captures, {lr.replays} replays, "
              f"{lr.syncs} tree reads")
        check(all(a > b for a, b in zip(losses, losses[1:])),
              f"mono {run}: the training logloss does not fall: {losses}")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            bst.update()
            torch.cuda.synchronize()
        rows = device_rows(prof)
        del prof
        dms = sum(ms for _, ms, _ in rows)
        by_fn = {}
        for key, ms, n in rows:
            fn = func(key)
            if fn in MONO_FUNCS:
                t, c = by_fn.get(fn, (0.0, 0))
                by_fn[fn] = (t + ms, c + n)
        for fn, n in mono_per_tree(inter).items():
            check(by_fn.get(fn, (0, 0))[1] == n,
                  f"mono {run}: {fn}: {by_fn.get(fn, (0, 0))[1]} device "
                  f"launches in the profiled tree, expected {n}")
        med = float(np.median(times[1:]))
        out["runs"][run] = {"iter_s": med, "iter_all": times,
                            "device_ms": dms, "losses": losses,
                            "calls": got, "by_fn": by_fn}
        say(f"mono {run} (subtraction, K=1): s/iteration "
            f"{[round(t, 4) for t in times]} (median of 2-{MONO_ITERS} "
            f"{med:.4f}), device ms an iteration {dms:.2f}, logloss "
            f"{losses}; wrapper calls {got}; device launches a tree "
            f"{ {k: v[1] for k, v in by_fn.items()} } (as the graph holds)")
        if run in ("basic", "intermediate"):
            n = mono_sweep(bst, X, mc, MONO_SWEEP_ROWS)
            out["runs"][run]["sweep_steps"] = n
            say(f"mono {run}: the card's model monotone along each "
                f"constrained feature over its bin thresholds on "
                f"{MONO_SWEEP_ROWS} rows ({n} steps)")
        if inter:
            keep["bst"] = bst
        else:
            del bst
        del lr
        gc.collect()
        torch.cuda.empty_cache()

    # every new arm and kernel on a real tree's states, and their times
    bst = keep.pop("bst")
    lr = bst._gbdt.learner
    pb_, pg_ = bst._gbdt._phys
    err, plain, last, changed = check_mono_steps(lr, pb_, pg_, MONO_STEPS, sp,
                                                 scat, ts, tmono,
                                                 mods["partition"])
    times = mono_times(lr, last, sp, ts, tmono, mods["partition"].SB_S)
    out.update(err=err, plain=plain, times=times, changed=changed)
    say(f"mono kernels: tree_step (commit, election, boxes), split_pair's "
        f"monotone arm (the pair and the {lr.L} leaves), mono_refresh, "
        f"mono_planes and mono_overlay bit-identical to their plain twins "
        f"on {MONO_STEPS} refreshes of a real tree (changed leaves "
        f"{changed}); ms a launch " + ", ".join(
            f"{k} {v[0]:.4f} (bound {v[1][0]:.4f}, {v[1][1]})"
            for k, v in times.items() if isinstance(v, tuple))
        + f"; plain host ms {plain}")
    del bst, lr, pb_, pg_
    gc.collect()
    torch.cuda.empty_cache()

    # card against CPU on a cut: quantized L2 from a zero score
    yc, _ = objective_labels(X)
    d_cut = relabeled(lgt, ds, X, yc, MONO_CUT)
    p = dict(params, tpu_megakernel="off", objective="regression",
             boost_from_average=False, use_quantized_grad=True,
             num_leaves=MONO_CUT_LEAVES, monotone_constraints=mc,
             monotone_constraints_method="intermediate",
             monotone_penalty=1.0)
    models = []
    for dev_kw in ({}, {"device_type": "cpu"}):
        with quant_carriers(bmod) as rec:
            cb = lgt.Booster(dict(p, **dev_kw), d_cut)
            cb.update()
        models.append((cb._gbdt.models, rec))
    (ma, reca), (mb, recb) = models
    for t, (ta, tb) in enumerate(zip(ma, mb)):
        check(all(np.array_equal(a, b) for a, b in zip(reca[t], recb[t])),
              f"mono card vs CPU: tree {t}'s carriers differ")
        for f in ("split_feature", "threshold", "left_child", "right_child",
                  "leaf_value", "internal_value", "leaf_count"):
            check(np.array_equal(getattr(ta, f), getattr(tb, f)),
                  f"mono card vs CPU: tree {t}'s {f} differs")
    out["card_vs_cpu"] = [int(t.num_leaves) for t in ma]
    say(f"mono card vs CPU on {MONO_CUT} rows (quantized L2 from a zero "
        f"score, intermediate, penalty 1, {MONO_CUT_LEAVES} leaves): the "
        f"carriers and the card's first tree ({out['card_vs_cpu']} leaves) "
        f"equal the CPU plain loop's bit for bit")
    del d_cut, models, ma, mb

    say(f"monotone (phase 4j, the HIGGS shape): {time.time() - t_phase:.1f} "
        f"s")
    return out


def mono_frame(lgt, mods, dsf, mc, params):
    """Phase 4j on phase 4i's frame (``dsf``, constructed: 500,000 rows
    of the HIGGS features, one-hot columns that bundle, a category and a
    bool): intermediate constraints (``mc`` on the HIGGS features) and
    quantized gradients, 3 iterations, the wrappers' counts set to 0
    before and read after (split_cat, feat_view and the refresh's
    kernels launched), the logloss falling; split_cat's clamp arm and
    the bundled planes held to their twins on 4 refreshes of a real tree
    (``check_mono_steps``), split_cat over the L leaves timed."""
    from lightgbm_tpu_torch.ops import mono as tmono
    t_phase = time.time()
    sp, scat, ts = mods["split_pair"], mods["split_cat"], mods["tree_step"]

    pm = dict(params, use_quantized_grad=True, min_data_per_group=50,
              monotone_constraints=mc,
              monotone_constraints_method="intermediate")
    bst = lgt.Booster(pm, dsf)
    lr = bst._gbdt.learner
    check(lr.bundled and lr.has_cat and lr.use_mc and lr.subtract
          and lr.qscale is not None and lr.mc_mode == "intermediate",
          f"mono frame: bundled {lr.bundled} categorical {lr.has_cat} "
          f"use_mc {lr.use_mc}")
    mono_zero(mods, tmono)
    losses, ftimes = [], []
    for _ in range(3):
        t0 = time.time()
        bst.update()
        torch.cuda.synchronize()
        ftimes.append(time.time() - t0)
        losses.append(bst.eval_train()[0][2])
    fcalls = mono_calls(mods, tmono)
    check(all(fcalls[k] > 0 for k in ("split_cat", "feat_view",
                                      "mono_refresh", "mono_planes"))
          and all(a > b for a, b in zip(losses, losses[1:])),
          f"mono frame: launches {fcalls}, logloss {losses}")
    pb_, pg_ = bst._gbdt._phys
    ferr, fplain, _, fchanged = check_mono_steps(lr, pb_, pg_, 4, sp, scat,
                                                 ts, tmono,
                                                 mods["partition"])
    # split_cat's clamp arm on the L-leaf search's inputs of the last
    # refresh held
    L, F, Bp = lr.L, lr.F, lr.mc_planes.shape[-1]
    kp = dict(l1=lr.l1, l2=lr.l2, max_delta_step=lr.max_delta_step,
              min_gain_to_split=lr.min_gain_to_split,
              min_data_in_leaf=lr.min_data_in_leaf,
              min_sum_hessian=lr.min_sum_hessian, max_depth=lr.max_depth)
    fm = lr.fmeta_pair[:L * F]
    hg, hh = lr.mc_planes[0].view(-1, Bp), lr.mc_planes[1].view(-1, Bp)
    rows = lr.mc_rows.clone()
    sets = lr.mc_cats.clone()
    ck = dict(children=L, mono=True, **kp, **lr.cat_kw)
    cat_ms = graph_ms(lambda: scat.split_cat(
        hg, hh, fm, lr.mc_info, lr.cat_feats, rows, sets,
        work=lr.mc_cat_work, **ck), 20)
    cat_plain = cuda_ms(lambda: scat.split_cat_plain(
        hg, hh, fm, lr.mc_info, lr.cat_feats, rows.clone(), sets.clone(),
        **ck), 2, 1)
    NC = int(lr.cat_feats.numel())
    nbs = lr.fmeta_pair[lr.cat_feats.long(), 0].cpu().numpy().astype(
        np.float64)
    out = {"iter_s": ftimes, "losses": losses, "calls": fcalls,
           "err": ferr, "plain": fplain, "changed": fchanged,
           "split_cat": (cat_ms, bound(
               L * (2 * nbs.sum() * 4 + NC * 64 + NC * 4 + 2 * 13 * 4
                    + lr.W * 4),
               L * float((nbs * (np.ceil(np.log2(nbs)) + 60)).sum()))),
           "split_cat_plain_ms": cat_plain, "NC": NC}
    say(f"mono frame ({QUANT_MIX_ROWS} rows: one-hot columns that bundle, "
        f"a category, a bool; intermediate, quantized): s/iteration "
        f"{[round(t, 4) for t in ftimes]}, logloss {losses}; split_cat's "
        f"clamp arm and the bundled planes bit-identical to their twins on "
        f"4 refreshes of a real tree (changed leaves {fchanged}); split_cat "
        f"over the {L} leaves {cat_ms:.4f} ms a launch (plain "
        f"{cat_plain:.3f})")
    del bst, lr, pb_, pg_
    gc.collect()
    torch.cuda.empty_cache()
    say(f"monotone (phase 4j, the frame): {time.time() - t_phase:.1f} s")
    return out


def mono_summary(mono):
    """Phase 4j's numbers for the log: per run s/iteration and device
    ms; the kernels' times; the frame's."""
    return {"mc": mono["mc"],
            "runs": {k: {n: r[n] for n in ("iter_s", "device_ms")}
                     for k, r in mono["runs"].items()},
            "changed": mono["changed"], "live": mono["times"]["live"],
            "frame_iter_s": mono["frame"]["iter_s"]}


def mono_rows(mono):
    """The kernels line's rows of phase 4j: each new kernel and arm, its
    launches the wrapper's count over the intermediate run (set to 0 just
    before it; split_cat's over the frame's run), its ms a launch against
    its bound, its plain twin's host ms (the device's for the L-leaf pair
    search and split_cat), and its device ms an iteration from the
    profiled tree."""
    tm, runs = mono["times"], mono["runs"]
    calls, by_fn = runs["intermediate"]["calls"], runs["intermediate"][
        "by_fn"]
    rows = []
    tree_ms = by_fn["tree_step"][0] / max(by_fn["tree_step"][1], 1)
    for name, src, replaces, kern, launches, iter_ms, extra in (
            ("split_pair_mono", "split_pair.cu",
             "lightgbm_tpu/ops/split.py:715", "split_pair",
             calls["split_pair"], by_fn["pair_search"][0],
             {"children": "L = 255 (the refresh's search); the pair "
                          "search's launches (2 children) run the same "
                          "arm", "plain_on": "the card"}),
            ("tree_step_commit", "tree_step.cu",
             "lightgbm_tpu/models/learner.py:2361", "tree_step",
             calls["tree_step"], by_fn["tree_step"][0],
             {"launches_note": "tree_step's wrapper calls of every mode; "
                               "iter_ms all its launches"}),
            ("tree_step_elect", "tree_step.cu",
             "lightgbm_tpu/models/learner.py:2115", "tree_step",
             calls["tree_step"], by_fn["tree_step"][0],
             {"tree_step_mean_ms": tree_ms}),
            ("mono_refresh", "mono.cu",
             "lightgbm_tpu/models/learner.py:1570", "mono_refresh",
             calls["mono_refresh"], by_fn["mono_refresh"][0],
             {"live_leaves": tm["live"]}),
            ("mono_planes", "mono.cu",
             "lightgbm_tpu/models/learner.py:1643", "mono_planes",
             calls["mono_planes"], by_fn["mono_planes"][0],
             {"changed_leaves": tm["changed"]}),
            ("mono_overlay", "mono.cu",
             "lightgbm_tpu/models/learner.py:1657", "mono_overlay",
             calls["mono_overlay"], by_fn["mono_overlay"][0], {})):
        ms, (bms, by) = tm[name]
        plain = (tm["split_pair_mono_plain_ms"] if kern == "split_pair"
                 else mono["plain"][kern])
        rows.append(dict({"name": name, "route": "cuda",
                          "source": f"lightgbm_tpu_torch/csrc/{src}",
                          "replaces": replaces, "launches": launches,
                          "max_abs_err": float(mono["err"][kern]),
                          "ms": ms, "plain_ms": plain, "bound_ms": bms,
                          "bound_by": by, "library_ms": None,
                          "iter_ms": iter_ms}, **extra))
    fr = mono["frame"]
    cms, (cb, cby) = fr["split_cat"]
    rows.append({"name": "split_cat_clamp", "route": "cuda",
                 "source": "lightgbm_tpu_torch/csrc/split_cat.cu",
                 "replaces": "lightgbm_tpu/ops/split.py:129",
                 "launches": fr["calls"]["split_cat"],
                 "max_abs_err": float(fr["err"]["split_cat"]), "ms": cms,
                 "plain_ms": fr["split_cat_plain_ms"], "bound_ms": cb,
                 "bound_by": cby, "library_ms": None,
                 "children": 255, "categorical_features": fr["NC"]})
    return rows

# ---- phase 4k: learning to rank at the MSLR-WEB30K shape -------------------
RANK_ROWS, RANK_QUERIES, RANK_FEATURES = 3_771_125, 31_531, 136
# the queries past 1,024 documents (MSLR-WEB30K's longest has 1,251): the
# 2,048-wide bucket, whose pairwise lambdas run in chunks of queries
RANK_LONG = (2048, 1800, 1500, 1300, 1251, 1200, 1100, 1030)
RANK_ITERS, RANK_CUT = 4, 200_000
RANK_PARAMS = {"objective": "lambdarank", "num_leaves": 255,
               "learning_rate": 0.1, "metric": "ndcg", "eval_at": 10,
               "verbosity": -1}
# the reference CPU on the real MSLR-WEB30K: 70.417 s for 500 iterations
# at 255 leaves (BASELINE.md); printed beside this run, not compared
RANK_REFERENCE_S = 70.417 / 500
KERNEL_FUNCS["rank_mega"] = {
    "mega_hist": "split_mega", "part_tiles": "split_mega",
    "part_copyback": "split_mega", "pair_search": "split_pair",
    "frontier_step": "frontier_step"}


def make_rank_data():
    """A seeded synthetic set at the MSLR-WEB30K shape: RANK_ROWS rows of
    RANK_FEATURES dense numerical f32 features (normal, written to two
    decimals as MSLR's feature files write theirs) in RANK_QUERIES
    queries of a mean of ~120 documents (lognormal sizes, the long tail
    RANK_LONG first), graded labels 0-4, mostly 0, from the quantiles of
    a relevance that five features, a per-query effect and noise make."""
    rng = np.random.default_rng(16)
    n, q, k = RANK_ROWS, RANK_QUERIES, len(RANK_LONG)
    rest = np.clip(np.round(rng.lognormal(4.55, 0.65, q - k)), 1, 1000)
    target = n - sum(RANK_LONG)
    rest = np.maximum(1, np.round(rest * target / rest.sum())).astype(
        np.int64)
    diff = int(target - rest.sum())
    fix = rng.choice(np.flatnonzero(rest > 1), size=abs(diff), replace=False)
    rest[fix] += int(np.sign(diff))
    sizes = np.concatenate([np.asarray(RANK_LONG, np.int64), rest])
    X = rng.standard_normal((n, RANK_FEATURES), dtype=np.float32)
    X = np.round(X * 100) / np.float32(100)
    rel = (X[:, :5] @ np.array([1.0, 0.7, -0.6, 0.5, 0.3], np.float32)
           + np.repeat(rng.normal(0, 0.5, q), sizes) + rng.normal(0, 1, n))
    cuts = np.quantile(rel, [0.55, 0.8, 0.93, 0.98])
    y = np.searchsorted(cuts, rel, side="right").astype(np.float32)
    return X, y, sizes


def np_ndcg(score, y, sizes, k):
    """Mean NDCG@k over the queries in float64: each query's documents by
    descending score, ties in document order, gains 2^label - 1, NDCG 1
    where the ideal DCG is 0."""
    n, q = len(y), len(sizes)
    qid = np.repeat(np.arange(q), sizes)
    rank = np.arange(n) - np.repeat(np.cumsum(sizes) - sizes, sizes)
    disc = np.where(rank < k, 1.0 / np.log2(rank + 2.0), 0.0)
    gain = 2.0 ** np.asarray(y, np.float64) - 1.0
    order = np.lexsort((np.arange(n), -np.asarray(score, np.float64), qid))
    dcg = np.bincount(qid, gain[order] * disc, q)
    idcg = np.bincount(qid, gain[np.lexsort((-gain, qid))] * disc, q)
    return float(np.mean(np.where(idcg > 0, dcg / np.where(idcg > 0, idcg,
                                                            1.0), 1.0)))


def rank_cut(lgt, ds, X, y, sizes, position=None):
    """``ds`` (constructed) cut to its first queries ``sizes``: the same
    bins and mappers, no second binning."""
    import copy as copy_mod
    from lightgbm_tpu_torch.dataset import Metadata
    rows = int(np.sum(sizes))
    inner = copy_mod.copy(ds._inner)
    inner.binned, inner.num_data = inner.binned[:rows], rows
    inner.metadata = Metadata(rows)
    inner.metadata.set_label(y[:rows])
    inner.metadata.set_group(sizes)
    inner.metadata.set_position(position)
    out = lgt.Dataset(X[:rows], label=y[:rows], group=sizes)
    out._inner = inner
    return out


def rank_ndcg(bst):
    return {n: v for _, n, v, _ in bst.eval_train()}["ndcg@10"]


RANK_BODIES = (("mega", {}), ("subtraction", {"tpu_megakernel": "off"}))


def rank_cpu(lgt, ds, X, y, sizes):
    """Phase 4k's CPU side, computed before the card is touched (so it
    overlaps earlier phases when main starts the process): the cut of
    RANK_CUT rows of whole queries, the CPU's lambdas from a zero and a
    seeded normal score, and its first tree on each body, on two torch
    threads (the phases it overlaps time the host too)."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.models.objective import create_objective
    t0, threads = time.time(), torch.get_num_threads()
    torch.set_num_threads(2)
    q = int(np.searchsorted(np.cumsum(sizes), RANK_CUT)) + 1
    cut = rank_cut(lgt, ds, X, y, sizes[:q])
    rows = cut._inner.num_data
    o = create_objective(Config(RANK_PARAMS))
    o.init(cut._inner.metadata, "cpu")
    scores = (np.zeros(rows, np.float32),
              np.random.RandomState(3).randn(rows).astype(np.float32))
    lambdas = [tuple(v.numpy() for v in o.get_gradients(torch.as_tensor(s)))
               for s in scores]
    trees = {label: lgt.train(dict(RANK_PARAMS, device_type="cpu", **extra),
                              cut, 1)._gbdt.models[0]
             for label, extra in RANK_BODIES}
    torch.set_num_threads(threads)
    say(f"ranking cut on the CPU ({rows} rows, {q} queries): lambdas and "
        f"first trees in {time.time() - t0:.1f} s")
    return {"queries": q, "cut": cut, "rows": rows, "scores": scores,
            "lambdas": lambdas, "trees": trees}


def rank_path(lgt, mods, fro, X, y, sizes, ds, dev, cpu):
    """Phase 4k (``--rank``): lambdarank at the MSLR-WEB30K shape
    (make_rank_data; 255 leaves, learning rate 0.1, ndcg@10) through
    the training API on the mega body (auto: the frontier at K=4, G =
    136) and the subtraction body: every wrapper's count set to 0 before
    RANK_ITERS iterations and read after (each kernel of the body
    launched), one capture and one tree read a tree, training NDCG@10
    after each iteration rising, the lambdas' ms an iteration by CUDA
    events, one profiled iteration (each kernel's device ms beside its
    bound, the busy share), the metric against np_ndcg of the card's
    scores (abs 1e-6); on a cut of RANK_CUT rows of whole queries (the
    2,048-wide bucket included) the card's lambdas from given scores
    against the CPU's (rtol 1e-5 / atol 1e-6; ``cpu``, rank_cpu's), the
    card's first tree against the CPU's (``tree_tie``), and 3 iterations
    of rank_xendcg and of lambdarank with positions, NDCG rising."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.models.objective import create_objective
    from lightgbm_tpu_torch.ops import partition as tpart
    G = ds._inner.num_groups
    check(G == RANK_FEATURES and not any(
        len(g.feature_indices) > 1 for g in ds._inner.groups),
          f"ranking: {G} groups, or a bundle (want {RANK_FEATURES} dense "
          f"groups)")
    pair_bytes = 2 * (2 * G) * 256 * 4 + 2 * (2 * G) * 8 * 4 + 2 * 13 * 4
    step_bytes = (2 * 25 + 17 + 2 * G * 8 + 2 * tpart.STEP_WORDS + 2 * 13
                  + 6 * tpart.CAT_WORDS + 255) * 4
    out = {"rows": RANK_ROWS, "queries": len(sizes), "groups": G,
           "longest_query": int(max(sizes)), "bodies": {}}
    bodies = (("rank_mega", {}, ("split_mega", "split_pair",
                                 "frontier_step")),
              ("subtraction", {"tpu_megakernel": "off"},
               ("partition", "leaf_hist", "hist_rmw", "split_pair",
                "tree_step")))
    for label, extra, kernels in bodies:
        for m in mods.values():
            m.launches = 0
        for k in fro.launches:
            fro.launches[k] = 0
        bst = lgt.Booster(params=dict(RANK_PARAMS, **extra), train_set=ds)
        g = bst._gbdt
        lr = g.learner
        sub = label == "subtraction"
        check(lr.subtract == sub and lr.K == (1 if sub else 4),
              f"ranking {label}: the learner runs subtract={lr.subtract} "
              f"at K={lr.K}")
        iter_s, ndcg = [], []
        for _ in range(RANK_ITERS):
            t0 = time.time()
            bst.update()
            torch.cuda.synchronize()
            iter_s.append(time.time() - t0)
            ndcg.append(rank_ndcg(bst))
        calls = dict({k: m.launches for k, m in mods.items()},
                     **fro.launches)
        for k in kernels:
            check(calls[k] > 0, f"ranking {label}: {k} was not launched "
                                f"({calls})")
        check(lr.syncs == RANK_ITERS and lr.captures == 1,
              f"ranking {label}: {lr.syncs} host syncs, {lr.captures} "
              f"captures for {RANK_ITERS} trees")
        check(ndcg[-1] > ndcg[0], f"ranking {label}: NDCG@10 does not "
                                  f"rise: {ndcg}")
        med = float(np.median(iter_s[1:]))
        obj, sc = g.objective, g.scores
        lam_ms = cuda_ms(lambda: obj.get_gradients(sc), 3, warmup=1)
        del sc
        per, busy = profile_iteration(bst, med, label)
        ndcg.append(rank_ndcg(bst))
        want = np_ndcg(g.scores.cpu().numpy(), y, sizes, 10)
        check(abs(ndcg[-1] - want) <= 1e-6,
              f"ranking {label}: ndcg@10 {ndcg[-1]!r} against numpy f64 "
              f"{want!r}")
        tree = g.models[-1]
        bounds = iteration_bounds(tree, "mega" if not sub else label, G, G,
                                  256, RANK_ROWS, pair_bytes, step_bytes,
                                  tree.num_leaves + 1)
        device_ms = sum(v[0] for v in per.values())
        say(f"ranking {label}: s/iteration {[round(v, 4) for v in iter_s]} "
            f"(median of 2-{RANK_ITERS}: {med:.4f} s; the reference CPU "
            f"{RANK_REFERENCE_S:.4f} s on the real MSLR-WEB30K, a report), "
            f"lambdas {lam_ms:.2f} ms an iteration by CUDA events "
            f"({100 * lam_ms / (med * 1e3):.1f}% of the iteration), "
            f"profiled iteration device busy {busy:.2f} ms, the graph's "
            f"kernels {device_ms:.2f} ms; NDCG@10 {ndcg} (numpy f64 "
            f"{want!r}); wrapper calls {calls}")
        for k, (ms, n) in sorted(per.items()):
            b = bounds.get(k)
            print(f"  ranking {label} {k} @ G={G}: {ms:.3f} ms an iteration, "
                  f"{n} device launches" + (f", bound {b:.4f} ms" if b
                                            else ""), flush=True)
        out["bodies"][label] = {
            "iter_s": iter_s, "median_s": med, "lambda_ms": lam_ms,
            "lambda_share": lam_ms / (med * 1e3), "busy_ms": busy,
            "kernels_ms": device_ms, "ndcg": ndcg, "ndcg_np": want,
            "per": {k: list(v) for k, v in per.items()},
            "bounds": bounds, "calls": calls,
            "leaves": int(tree.num_leaves)}
        del bst, g, lr, obj, tree
        gc.collect()
        torch.cuda.empty_cache()

    # ---- the cut: whole queries, the long ones first; the CPU's side
    # of it was computed before the card was ours (rank_cpu) ------------
    q, cut, rows = cpu["queries"], cpu["cut"], cpu["rows"]
    o = create_objective(Config(RANK_PARAMS))
    o.init(cut._inner.metadata, dev)
    buckets = [b.P for b in o.buckets]
    big = [len(b.chunks) for b in o.buckets if b.P == 2048]
    check(big and big[0] > 1, "ranking cut: no 2,048-wide bucket in "
                              "chunks")
    lam_err, zero_grads = 0.0, None
    for i, (s, want) in enumerate(zip(cpu["scores"], cpu["lambdas"])):
        got = o.get_gradients(torch.as_tensor(s, device=dev))
        for a, b in zip(got, want):
            a = a.cpu().numpy()
            check(np.allclose(a, b, rtol=1e-5, atol=1e-6),
                  f"ranking cut: the card's lambdas differ from the CPU's "
                  f"by {np.abs(a - b).max()!r}")
            lam_err = max(lam_err, float(np.abs(a - b).max()))
        if i == 0:
            zero_grads = [v.cpu().numpy().astype(np.float64) for v in got]
    del o
    trees = {}
    for label, extra in RANK_BODIES:
        b_card = lgt.train(dict(RANK_PARAMS, **extra), cut, 1)
        trees[label] = tree_tie(b_card._gbdt.models[0], cpu["trees"][label],
                                X[:rows], *zero_grads,
                                f"ranking cut {label}")
        del b_card
    say(f"ranking cut ({rows} rows, {q} queries, buckets {buckets}, the "
        f"2,048-wide one in {big[0]} chunks): the card's lambdas "
        f"against the CPU's, max |err| {lam_err!r}; first tree card vs CPU "
        f"{trees} (None: every split equal)")
    pos = np.concatenate([np.arange(n) % 10 for n in sizes[:q]])
    runs = {}
    for name, extra, ds_ in (
            ("rank_xendcg", {"objective": "rank_xendcg"}, cut),
            ("positions", {}, rank_cut(lgt, ds, X, y, sizes[:q], pos))):
        bst = lgt.Booster(params=dict(RANK_PARAMS, **extra), train_set=ds_)
        nd = []
        for _ in range(3):
            bst.update()
            nd.append(rank_ndcg(bst))
        check(nd[-1] > nd[0], f"ranking cut {name}: NDCG@10 does not rise: "
                              f"{nd}")
        runs[name] = nd
        if name == "positions":
            runs["position_biases"] = bst._gbdt.objective.pos_biases.cpu(
            ).tolist()
        del bst
    say(f"ranking cut: rank_xendcg NDCG@10 {runs['rank_xendcg']}, lambdarank "
        f"with positions {runs['positions']} (biases "
        f"{[round(v, 4) for v in runs['position_biases']]})")
    out["cut"] = {"rows": rows, "queries": q, "lambda_err": lam_err,
                  "first_tree": trees, **runs}
    return out


def rank_prepare(lgt):
    """Phase 4k's data made and binned on the host: (X, y, sizes, the
    constructed Dataset, seconds to make, seconds to bin)."""
    t0 = time.time()
    X, y, sizes = make_rank_data()
    data_s = time.time() - t0
    t0 = time.time()
    ds = lgt.Dataset(X, label=y, group=sizes)
    ds.construct(RANK_PARAMS)
    bin_s = time.time() - t0
    say(f"ranking data: {X.shape} in {len(sizes)} queries (mean "
        f"{np.mean(sizes):.1f}, longest {max(sizes)}), labels "
        f"{np.bincount(y.astype(int)).tolist()}, made in {data_s:.1f} s, "
        f"binned on the host in {bin_s:.1f} s")
    return X, y, sizes, ds, data_s, bin_s


def rank_only(wait):
    """``python3 chip_smoke.py --rank``: phase 4k alone, its checks and
    numbers printed; the last line rank_path's result, a JSON object.
    With ``--wait`` (main starts it so, at its own start) the data are
    made and binned and the CPU's side computed first, on the host, and
    the card is touched only after a line ``go`` on standard input."""
    check(torch.cuda.is_available(), "--rank needs a card")
    sys.path.insert(0, ROOT)
    import lightgbm_tpu_torch as lgt
    X, y, sizes, ds, data_s, bin_s = rank_prepare(lgt)
    cpu = rank_cpu(lgt, ds, X, y, sizes)
    if wait:
        check(sys.stdin.readline().strip() == "go",
              "the ranking phase was not released")
    lgt, mods = standalone("--rank")
    from lightgbm_tpu_torch.ops import frontier as fro
    out = rank_path(lgt, mods, fro, X, y, sizes, ds, torch.device("cuda", 0),
                    cpu)
    out.update(data_s=data_s, bin_s=bin_s)
    print(json.dumps(out), flush=True)


def start_rank():
    """Phase 4k in a process of its own, started at once: it makes and
    bins its data on the host while this process runs the phases before
    it, and waits for ``finish_rank`` before it touches the card (so no
    two phases share the card)."""
    logs = [tempfile.TemporaryFile("w+") for _ in range(2)]
    p = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                          "--rank", "--wait"], cwd=ROOT,
                         stdin=subprocess.PIPE, stdout=logs[0],
                         stderr=logs[1], text=True)
    atexit.register(lambda: p.poll() is None and p.kill())
    return p, logs


def finish_rank(child):
    """Release the ranking process onto the card and wait for it; its
    output lines printed here; its last line, a JSON object."""
    p, (out, err) = child
    t0 = time.time()
    p.stdin.write("go\n")
    p.stdin.close()
    p.wait(timeout=900)
    out.seek(0)
    err.seek(0)
    lines = out.read().splitlines()
    for line in lines[:-1]:
        print(f"  (ranking phase) {line}", flush=True)
    check(p.returncode == 0 and lines,
          f"ranking phase failed:\n{chr(10).join(lines[-20:])}\n"
          f"{err.read()[-3000:]}")
    say(f"ranking phase (a process of its own): {time.time() - t0:.1f} s "
        f"on the card after its host binning")
    return json.loads(lines[-1])


def rank_summary(rank):
    """Phase 4k's numbers for the summary line."""
    return {"rows": rank["rows"], "queries": rank["queries"],
            "groups": rank["groups"], "data_s": rank["data_s"],
            "bin_s": rank["bin_s"], "reference_cpu_s": RANK_REFERENCE_S,
            "bodies": {k: {n: v[n] for n in (
                "median_s", "iter_s", "lambda_ms", "lambda_share", "busy_ms",
                "kernels_ms", "ndcg")} for k, v in rank["bodies"].items()},
            "cut": rank["cut"]}


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    dev = torch.device("cuda", 0)
    # phase 4k's process makes and bins its data on the host meanwhile
    rank_child = start_rank()

    sys.path.insert(0, ROOT)
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.models import learner as learner_mod
    from lightgbm_tpu_torch.ops import hist_state as hs
    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops import kernels
    from lightgbm_tpu_torch.ops import partition as tpart
    from lightgbm_tpu_torch.ops import split_mega as sm
    from lightgbm_tpu_torch.ops import split_pair as sp
    from lightgbm_tpu_torch.ops import tree_step as ts
    from lightgbm_tpu_torch.ops import feat_view as fv
    from lightgbm_tpu_torch.ops import sample as smp
    from lightgbm_tpu_torch.ops import split_cat as scat
    from lightgbm_tpu_torch.ops.partition import (S_CNT, S_COL, decide_left,
                                                  make_scalars, scalars_start)
    mods = {"split_mega": sm, "split_pair": sp, "partition": tpart,
            "leaf_hist": th, "hist_rmw": hs, "tree_step": ts,
            "feat_view": fv, "sample": smp, "split_cat": scat}

    # ---- 2. build ----------------------------------------------------
    t0 = time.time()
    built = kernels.build_all()
    say(f"build: {time.time() - t0:.2f} s wall, per kernel "
        f"{ {k: round(v, 2) for k, v in built.items()} }")
    for name, text in kernels.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # ---- 3. synthetic checks -----------------------------------------
    G, B = FEATURES, 255
    rng = np.random.RandomState(0)
    n_pad = 1 << 20
    pb = torch.as_tensor(rng.randint(0, 255, (G, n_pad)).astype(np.uint8),
                         device=dev)
    pg = torch.as_tensor(rng.randn(8, n_pad).astype(np.float32), device=dev)
    pg[2] = torch.arange(n_pad, device=dev, dtype=torch.int32).view(
        torch.float32)
    pg[5, ::7] = torch.tensor([NAN_WORD], dtype=torch.int32,
                              device=dev).view(torch.float32)
    cases = {
        "cnt0": (5000, 0, 3, 0, 0, 255, 0, 0, 100, 0),
        "unaligned": (4096 + 77, 300_001, 5, 0, 0, 255, 0, 0, 128, 1),
        "all_left": (4096, 500_000, 1, 0, 0, 255, 0, 0, 255, 0),
        "all_right": (4096, 500_000, 1, 0, 0, 255, 0, 0, -1, 0),
        "zero_missing": (9000, 700_000, 7, 0, 0, 255, 40, 1, 90, 1),
        "nan_missing": (9000, 700_000, 8, 0, 0, 255, 0, 2, 200, 1),
        "bundled": (123, 33_333, 2, 10, 1, 60, 0, 1, 30, 0),
        "small": (4096 + 5, 700, 2, 0, 0, 255, 0, 0, 100, 0),
    }
    for what, c in cases.items():
        sc = make_scalars(*c)
        check_mega(sm, pb, pg, sc, B, G, f"split_mega {what}")
        b, g, nl, _ = check_partition(tpart, pb, pg, sc, f"partition {what}")
        check_leaf_hist(th, pb, pg, c[0], c[1], None, B, G,
                        f"leaf_hist {what}")
        for side in (0, 1):
            check_leaf_hist(th, b, g, c[0], c[1], (nl, side), B, G,
                            f"leaf_hist {what} child {side}")
    say(f"split_mega, partition, leaf_hist synthetic: {len(cases)} cases "
        f"ok (leaf_hist on the whole range and on both children)")
    risk = risk_cases(tpart.tile_rows(G), n_pad)
    for what, (c, variant) in risk.items():
        vb, vg = variant_buffers(variant, pb, pg)
        sc = make_scalars(*c)
        check_mega(sm, vb, vg, sc, B, G, f"split_mega {what}", runs=1)
        b, g, nl, _ = check_partition(tpart, vb, vg, sc, f"partition {what}")
        check_leaf_hist(th, vb, vg, c[0], c[1], None, B, G,
                        f"leaf_hist {what}", runs=1)
        for side in (0, 1):
            check_leaf_hist(th, b, g, c[0], c[1], (nl, side), B, G,
                            f"leaf_hist {what} child {side}", runs=1)
        del vb, vg, b, g
    sc = make_scalars(4096 + 3, 400_000, 6, 0, 0, 255, 0, 0, 131, 0)
    check_mega(sm, pb, pg, sc, B, G, "split_mega 20 launches", runs=20)
    first = check_partition(tpart, pb, pg, sc, "partition 20 launches")
    for side in (0, 1):
        check_leaf_hist(th, first[0], first[1], 4096 + 3, 400_000,
                        (first[2], side), B, G,
                        f"leaf_hist 20 launches child {side}", runs=20)
    for _ in range(19):
        again = check_partition(tpart, pb, pg, sc, "partition 20 launches")
        check(torch.equal(first[0], again[0]) and torch.equal(
            first[1].view(torch.int32), again[1].view(torch.int32))
              and int(first[2]) == int(again[2]),
              "partition: 20 launches differ")
    say(f"split_mega, partition, leaf_hist risk cases: {len(risk)} cases ok "
        f"(start at every offset mod 16, counts around a "
        f"{tpart.tile_rows(G)}-row tile, one row, ending at N_pad, one bin, "
        f"|grad| ~ 1e4, all left / right: a child of no rows); 20 launches "
        f"of each bit-identical")
    n_fused, _ = fused_cases(hs, th, tpart, make_scalars, pb, pg, B, G)
    say(f"leaf_hist_rmw (hist_rmw folded into leaf_hist) synthetic: "
        f"{n_fused} cases ok (root, small left / right, wa == wb, a child "
        f"of no rows, a child at each offset mod 16): int64 state and f32 "
        f"children bit-identical to leaf_hist_rmw_fixed_plain, every slot "
        f"written equal to the direct fixed-point sums of its rows")

    F, BF = FEATURES, 255
    half = np.zeros((F, 8), np.int32)
    half[:, 0] = rng.randint(3, BF + 1, F)
    half[:, 1] = rng.randint(0, 3, F)
    half[:, 2] = np.where(half[:, 1] == 1, rng.randint(0, 3, F), 0)
    fmeta = torch.as_tensor(np.concatenate([half, half]), device=dev)
    pair_params = [
        dict(l1=0.0, l2=0.0, max_delta_step=0.0, min_gain_to_split=0.0,
             min_data_in_leaf=20, min_sum_hessian=1e-3, max_depth=-1),
        dict(l1=0.5, l2=2.0, max_delta_step=0.7, min_gain_to_split=0.1,
             min_data_in_leaf=100, min_sum_hessian=1.0, max_depth=4),
    ]
    for i, kw in enumerate(pair_params):
        hg = torch.as_tensor(rng.randn(2 * F, BF).astype(np.float32) * 50,
                             device=dev)
        hh = torch.as_tensor(rng.uniform(1, 100, (2 * F, BF)).astype(
            np.float32), device=dev)
        info = torch.zeros((2 * F, 8), device=dev)
        info[:F, 0], info[F:, 0] = hg[0].sum(), hg[F].sum()
        info[:F, 1], info[F:, 1] = hh[0].sum(), hh[F].sum()
        info[:, 2] = 500_000.0
        info[:F, 3], info[F:, 3] = 3.0, 4.0
        info[:, 4] = 1.0
        check_pair(sp, (hg, hh, fmeta, info), kw, f"split_pair synthetic {i}")
    say("split_pair synthetic: ok")
    del pb, pg

    # ---- 4. the main paths -------------------------------------------
    # split_pair's bytes per call: the (2F, Bp) grad and hess planes, the
    # (2F, 8) metadata and info blocks, the two 13-word results
    pair_bytes = 2 * (2 * G) * 256 * 4 + 2 * (2 * G) * 8 * 4 + 2 * 13 * 4
    t0 = time.time()
    X, y, w = make_data(ROWS, weights=True)
    say(f"data: {X.shape} in {time.time() - t0:.1f} s")
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
              "learning_rate": 0.1, "verbosity": -1}
    t0 = time.time()
    ds = lgt.Dataset(X, label=y)
    ds.construct(params)
    say(f"dataset construct: {time.time() - t0:.1f} s")
    Xp = X[:100_000]
    d = np.loadtxt(os.path.join(ROOT, "examples", "binary_classification",
                                "binary.train"))

    cap = {"mega": [], "pair": [], "partition": [], "lhr": [],
           "sub_pair": []}

    def keep(key, n, item):
        if len(cap[key]) < n:
            cap[key].append(item())

    def capture_mega(pb_, pg_, sc, **k):
        if sc[S_CNT] > 0 and k.get("move", True):
            keep("mega", 3, lambda: (pb_.clone(), pg_.clone(), sc, dict(k)))

    def pair_capture(key):
        def fn(*a, **k):
            keep(key, 3, lambda: (tuple(t.clone() for t in a),
                                  {n: v for n, v in k.items() if n != "out"}))
        return fn

    def capture_partition(pb_, pg_, sc):
        keep("partition", 2, lambda: (pb_.clone(), pg_.clone(), sc))

    exact_calls = []

    def capture_lhr(pb_, pg_, start, cnt, state, **k):
        # the root and the first three splits' inputs, the state before
        # the call included; after every call of the first tree, the
        # slots it wrote against direct sums of their rows
        child = k.get("child")
        kc = dict(k, child=None if child is None
                  else (child[0].clone(), child[1]))
        keep("lhr", 4, lambda: (pb_.clone(), pg_.clone(), start, cnt, kc,
                                state.clone()))

        def after(_):
            check_exact(th, pb_, pg_, start, cnt, k, state,
                        f"subtraction tree 0 call {len(exact_calls)}")
            exact_calls.append(k["idx"])
        return after

    # two leafmat columns, a nodemat column, the info block, the step
    # block read and written, the pair rows, the sets (two children's
    # read and written, the elected leaf's copied to its node) and the
    # L gains
    step_bytes = (2 * 25 + 17 + 2 * G * 8 + 2 * tpart.STEP_WORDS + 2 * 13
                  + 6 * tpart.CAT_WORDS + 255) * 4
    iter_by_path, launches_by_path, costs, steps_err = {}, {}, {}, 0.0
    busy_by_path, losses_by = {}, {}
    # the K=1 graph loop on the mega path (the frontier, K > 1, is phase
    # 4b's)
    paths = (("mega", dict(params, tpu_frontier_k=1),
              {"split_mega": capture_mega, "split_pair": pair_capture("pair")}),
             ("subtraction", dict(params, tpu_megakernel="off"),
              {"partition_leaf": capture_partition,
               "leaf_hist_rmw": capture_lhr,
               "split_pair": pair_capture("sub_pair")}))
    for label, p, capture in paths:
        bst, iter_s, losses, splits, launches = train_path(
            lgt, learner_mod, mods, ds, p, label, capture)
        lr = bst._gbdt.learner
        check(lr.subtract == (label == "subtraction"),
              f"{label}: the learner runs the other split body")
        check(splits == SPLITS * ITERS, f"{label}: {splits} splits")
        calls = per_tree(label)
        if label == "subtraction":
            say(f"subtraction tree 0 (eager oracle): {len(exact_calls)} "
                f"state launches (the root and {len(exact_calls) - 1} "
                f"splits), every slot written equal to the direct "
                f"fixed-point sums of its rows at the tree's scale (each "
                f"larger child exact as parent minus smaller)")
        launches_by_path[label] = launches
        losses_by[label] = losses
        check_predict(lgt, bst, Xp, label)
        per, busy = profile_iteration(bst, float(np.median(iter_s[1:])),
                                      label)
        busy_by_path[label] = busy
        tree = bst._gbdt.models[-1]
        iter_by_path[label] = report_iteration(per, iteration_bounds(
            tree, label, G, G, 256, ROWS, pair_bytes, step_bytes,
            SPLITS + 2), tree, label, calls)
        pb_, pg_ = bst._gbdt._phys
        err, ts_plain_ms = check_tree_steps(ts, lr, pb_, pg_, 12)
        steps_err = max(steps_err, err)
        say(f"tree_step {label}: the kernel bit-identical to tree_step_plain "
            f"on the root, 12 steps of a real tree and the final commit")
        costs[label] = step_costs(lr, pb_, pg_, label, ts, tpart, hs, sm)
        card_vs_cpu(lgt, d, {"tpu_frontier_k": 1} if label == "mega"
                    else {"tpu_megakernel": "off"}, label)
        del bst, lr, pb_, pg_
        torch.cuda.empty_cache()
    # ---- 4j. monotone constraints: early in the process, whose first
    # profiled graphs the profiler names and counts right (PERF.md
    # section 7)
    mono = mono_path(lgt, mods, ds, X, y, w, params)
    # ---- 4b. the frontier (K > 1) on the mega path ------------------
    from lightgbm_tpu_torch.ops import frontier as fro
    fr_device = frontier_window_launches()
    fbst, states, fr_calls, _, fr_trees, fr_med = frontier_path(
        lgt, learner_mod, mods, fro, ds, params, d, profiled=False)
    launches_by_path["frontier"] = {
        "split_mega": fr_device["mega_hist"][1],
        "split_pair": fr_device["pair_search"][1],
        "frontier_step": fr_device["frontier_step"][1],
        "frontier_key": fr_device["frontier_key"][1],
        "frontier_undo": fr_device["undo_merge"][1]}
    flr = fbst._gbdt.learner
    fr_out = check_frontier_kernels(fro, sp, tpart, flr, fbst, states,
                                    fr_trees[0][0])
    # a frontier step whose IF node is not taken (64 such nodes, each
    # holding one step, in a graph of their own)
    pb_, pg_ = fbst._gbdt._phys
    fr_stopped = fro.stopped_step_ms(
        lambda: flr.fr_step(pb_, pg_), flr.device)
    del pb_, pg_
    say(f"frontier: a stopped step (its IF node not taken) "
        f"{fr_stopped:.5f} ms, against a stopped K=1 step "
        f"{costs['mega']['empty_step']:.4f} ms (mega)")
    del fbst, flr, states
    torch.cuda.empty_cache()
    print(f"binary_logloss per iteration: mega {losses_by['mega']}, "
          f"subtraction {losses_by['subtraction']} (the two paths sum in "
          f"other orders, so their trees are only numerically equal)",
          flush=True)
    regression_ties(lgt)
    # ---- 4d. row and feature sampling at the HIGGS shape --------------
    samp = sampling_path(lgt, mods, ds, params)
    # ---- 4g. the other objectives and multiclass ------------------------
    objs = objectives_path(lgt, mods, ds, X, params)
    gc.collect()
    torch.cuda.empty_cache()
    # ---- 4e. EFB bundles ------------------------------------------------
    efb = efb_path(lgt, learner_mod, mods)
    # ---- 4f. categorical features, in a process of its own ---------------
    cat = child_phase("--cat", "categorical phase", str(float(efb["iter_s"])))
    # ---- 4k. learning to rank at the MSLR-WEB30K shape, in a process of
    # its own (started above; it binned its data and ran its CPU side on
    # the host meanwhile): after 4e and 4f, whose launch counts the
    # profiler gives right only before other processes' windows
    rank = finish_rank(rank_child)
    # ---- 4h. wide bins (uint16 bin matrices): after 4e, whose checks
    # count device launches by the profiler's kernel names, which hold
    # only for a process's first few profiled graphs (PERF.md section 7);
    # 4h's own checks count wrapper calls
    wide = wide_path(lgt, mods, ds, X, y, params)
    # ---- 4i. quantized-gradient training --------------------------------
    quant = quant_path(lgt, mods, ds, X, y, params)
    # ---- 4j on 4i's frame (constructed there) ---------------------------
    mono["frame"] = mono_frame(lgt, mods, quant.pop("frame_ds"), mono["mc"],
                               params)
    # ---- 4l. DART, random forest, the eager iteration and rollback -------
    boost_path(lgt, mods, ds, X, y, params)
    # ---- 4m. linear trees -----------------------------------------------
    linear = linear_path(lgt, mods, ds, X, params)
    del X, y, ds
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 4c. the training API on the card -----------------------------
    api_path(lgt, mods, fro, card)

    # ---- 5. captured inputs and timings ------------------------------
    for key in cap:
        check(cap[key], f"nothing captured for {key}")
    mega_err = 0.0
    for i, (cpb, cpg, sc, k) in enumerate(cap["mega"]):
        errs = check_mega(sm, cpb, cpg, sc, k["num_bins"], k["num_groups"],
                          f"split_mega captured {i}", absmax=k["absmax"])
        print(f"  split_mega captured {i} ({sc[S_CNT]} rows): max |err| "
              f"kernel vs plain {errs['vs_plain']!r}, kernel vs f64 "
              f"{errs['kernel_vs_f64']!r}, plain vs f64 "
              f"{errs['plain_vs_f64']!r}; largest |bin sum| "
              f"{errs['max_abs_bin']!r}, largest bin mass "
              f"{errs['max_bin_mass']!r}", flush=True)
        mega_err = max(mega_err, errs["vs_plain"])
    pair_err = 0.0
    for key in ("pair", "sub_pair"):
        for i, (a, k) in enumerate(cap[key]):
            pair_err = max(pair_err, check_pair(sp, a, k,
                                                f"split_pair {key} {i}"))
    part_err = 0.0
    for i, (cpb, cpg, sc) in enumerate(cap["partition"]):
        part_err = max(part_err, check_partition(
            tpart, cpb, cpg, sc, f"partition captured {i}")[3])
    lh_err = rmw_err = 0.0
    for i, (cpb, cpg, start, cnt, k, cst) in enumerate(cap["lhr"]):
        errs = check_leaf_hist(th, cpb, cpg, start, cnt, k["child"],
                               k["num_bins"], k["num_groups"],
                               f"leaf_hist captured {i}", k["absmax"])
        print(f"  leaf_hist captured {i} (range of {cnt} rows, child "
              f"{None if k['child'] is None else k['child'][1]}): max |err| "
              f"kernel vs plain {errs['vs_plain']!r}, kernel vs f64 "
              f"{errs['kernel_vs_f64']!r}, plain vs f64 "
              f"{errs['plain_vs_f64']!r}; largest |bin sum| "
              f"{errs['max_abs_bin']!r}, largest bin mass "
              f"{errs['max_bin_mass']!r}", flush=True)
        lh_err = max(lh_err, errs["vs_plain"])
        rmw_err = max(rmw_err, check_fused(
            hs, th, cpb, cpg, start, cnt, k, cst.clone(),
            f"leaf_hist_rmw captured {i} (idx {k['idx']})"))
    step_err = check_step_entries(tpart, sm, hs, cap, ROWS, dev)
    say(f"captured inputs: kernels agree with plain versions, through the "
        f"host-int entries and through the step entries at the graph "
        f"loop's bound of {ROWS} rows (largest bit differences {step_err})")

    # split_mega at the first split of the first tree (the root's rows)
    cpb, cpg, sc, k = cap["mega"][0]
    cnt, R = sc[S_CNT], cpb.shape[0]
    Gk = k["num_groups"]
    hist_bytes = Gk * 4 * 256 * 4
    mega_bound, mega_by = bound(2 * cnt * (R + 32) + hist_bytes, 2 * cnt * Gk)
    b, g = cpb.clone(), cpg.clone()
    # as the graph loop launches it: the step entry on a step block made
    # beforehand, sized for the root's rows, by graph replay; then its
    # histogram alone (the same launch without the move), and so the
    # partition's share of the split
    step = tpart.step_block(sc, dev)
    nl = torch.zeros(1, dtype=torch.int32, device=dev)
    h4 = torch.empty((Gk, 4 * sm.hist_geometry(k["num_bins"])[0], 16),
                     device=dev)
    sk = dict(num_bins=k["num_bins"], num_groups=Gk, absmax=k["absmax"],
              bound=ROWS)
    mega_ms = graph_ms(lambda: sm.split_mega_step(b, g, step, nl, h4, **sk),
                       10)
    mega_hist_ms = graph_ms(lambda: sm.split_mega_step(
        b, g, step, nl, h4, move=False, **sk), 10)
    # the host-int entry (a fresh step block copied from the host each
    # call: that copy waits for the card), events around 10 calls
    mega_host_ms = cuda_ms(lambda: sm.split_mega(b, g, sc, **k), 10)
    mega_hist_host_ms = cuda_ms(lambda: sm.split_mega(
        b, g, sc, **dict(k, move=False)), 10)
    b, g = cpb.clone(), cpg.clone()
    kp = dict(num_bins=k["num_bins"], num_groups=Gk)
    mega_plain_ms = cuda_ms(lambda: sm.split_mega_plain(b, g, sc, **kp), 3,
                            1)
    # no single PyTorch call partitions and builds both histograms, so
    # library_ms is null; one index_add_ over the leaf's (group, side,
    # bin) indices (prepared outside the timing) is printed as a
    # yardstick for the histogram half alone
    s0 = scalars_start(sc)
    seg = cpb[:Gk, s0:s0 + cnt].long()
    gl = decide_left(cpb[sc[S_COL], s0:s0 + cnt], *sc[S_COL + 1:])
    Bp = 256
    idx = (seg + (torch.arange(Gk, device=dev) * 4 * Bp)[:, None]
           + torch.where(gl, 0, 2 * Bp)[None, :]).reshape(-1)
    idx = torch.cat([idx, idx + Bp])
    vals = torch.cat([cpg[0, s0:s0 + cnt].expand(Gk, -1).reshape(-1),
                      cpg[1, s0:s0 + cnt].expand(Gk, -1).reshape(-1)])
    hist = torch.zeros(Gk * 4 * Bp, device=dev)
    mega_lib_ms = cuda_ms(lambda: hist.index_add_(0, idx, vals), 5)
    del seg, idx, vals, b, g
    say(f"split_mega @ {cnt} rows x {R} groups: {mega_ms:.3f} ms (its "
        f"histogram alone {mega_hist_ms:.3f} ms, so the partition "
        f"{mega_ms - mega_hist_ms:.3f} ms; step entry at bound {ROWS}, "
        f"graph replay; the host-int entry {mega_host_ms:.3f} ms, its "
        f"histogram alone {mega_hist_host_ms:.3f} ms), plain "
        f"{mega_plain_ms:.3f} ms, bound {mega_bound:.3f} ms ({mega_by}); "
        f"no single PyTorch call computes the split, library_ms null; "
        f"index_add_ of the histogram half alone {mega_lib_ms:.3f} ms")
    cap["mega"].clear()

    # partition at the first split of the first subtraction tree
    cpb, cpg, sc = cap["partition"][0]
    cnt, R = sc[S_CNT], cpb.shape[0]
    part_bound, part_by = bound(2 * cnt * (R + 32), cnt)
    b, g = cpb.clone(), cpg.clone()
    step = tpart.step_block(sc, dev)
    part_ms = graph_ms(lambda: tpart.partition_step(b, g, step, nl,
                                                    bound=ROWS), 10)
    part_host_ms = cuda_ms(lambda: tpart.partition_leaf(b, g, sc), 10)
    b, g = cpb.clone(), cpg.clone()
    part_plain_ms = cuda_ms(lambda: tpart.partition_leaf_plain(b, g, sc), 3,
                            1)
    del b, g
    say(f"partition @ {cnt} rows x {R} groups + 8 payload rows: "
        f"{part_ms:.3f} ms (step entry at bound {ROWS}, graph replay; the "
        f"host-int entry {part_host_ms:.3f} ms), plain "
        f"{part_plain_ms:.3f} ms, bound "
        f"{part_bound:.3f} ms ({part_by}); no single PyTorch call "
        f"partitions in place, library_ms null")
    cap["partition"].clear()

    # leaf_hist at the root of the first subtraction tree: the plain
    # launch and the learner's state launch
    cpb, cpg, start, cnt, k, cst = cap["lhr"][0]
    check(k["child"] is None and cnt == ROWS, "first leaf_hist_rmw call is "
                                              "not the root's")
    Gk = k["num_groups"]
    _, Bp = sm.hist_geometry(k["num_bins"])
    kp = dict(num_bins=k["num_bins"], num_groups=Gk, planes=True)
    lh_host_ms = cuda_ms(lambda: th.leaf_hist(cpb, cpg, start, cnt,
                                              absmax=k["absmax"], **kp), 10)
    st = cst.clone()
    lh_state_host_ms = cuda_ms(lambda: hs.leaf_hist_rmw(
        cpb, cpg, start, cnt, state=st, **k), 10)
    # the step launches the graph loop makes, by graph replay
    sc = make_scalars(start, cnt, 0, 0, 0, 0, 0, 0, 0, 0)
    step = tpart.step_block(sc, dev)
    step_state = tpart.step_block(sc, dev, k["idx"])
    planes = torch.empty((2, Gk, Bp), device=dev)
    children = torch.empty((2, 2, Gk, Bp), device=dev)
    lk = dict(num_bins=k["num_bins"], num_groups=Gk, absmax=k["absmax"],
              bound=ROWS)
    lh_ms = graph_ms(lambda: th.launch(cpb, cpg, step, nl=None, out=planes,
                                       kcnt=0, **lk), 10)
    lh_state_ms = graph_ms(lambda: hs.leaf_hist_rmw_step(
        cpb, cpg, step_state, None, state=st, kcnt=k["kcnt"], out=children,
        **lk), 10)
    lh_bound, lh_by = bound(cnt * (Gk + 8) + 2 * Gk * Bp * 4, 2 * cnt * Gk)
    lh_plain_ms = cuda_ms(lambda: th.leaf_hist_plain(cpb, cpg, start, cnt,
                                                     **kp), 3, 1)
    lh_fixed_ms = cuda_ms(lambda: th.leaf_hist_fixed_plain(
        cpb, cpg, start, cnt, absmax=k["absmax"], **kp), 3, 1)
    # library yardstick: one index_add_ over precomputed (plane, group,
    # bin) indices, prepared outside the timing
    seg = cpb[:Gk, start:start + cnt].long()
    idx = (seg + (torch.arange(Gk, device=dev) * Bp)[:, None]).reshape(-1)
    idx = torch.cat([idx, idx + Gk * Bp])
    vals = torch.cat([cpg[0, start:start + cnt].expand(Gk, -1).reshape(-1),
                      cpg[1, start:start + cnt].expand(Gk, -1).reshape(-1)])
    hist = torch.zeros(2 * Gk * Bp, device=dev)
    lh_lib_ms = cuda_ms(lambda: hist.index_add_(0, idx, vals), 5)
    del seg, idx, vals, st

    # hist_rmw at the first split of the first subtraction tree: leaf_hist's
    # plain launch and its state launch on the smaller child, in turns by
    # graph replay; the epilogue's time is their difference
    cpb, cpg, start, cnt, k, cst = cap["lhr"][1]
    st = cst.clone()
    # (a graph cannot hold the host-int entries' copy of a fresh step
    # block, so both launches are fed step blocks made beforehand)
    side = k["child"][1] + 1
    sc = make_scalars(start, cnt, 0, 0, 0, 0, 0, 0, 0, 0)
    step_plain = tpart.step_block(sc, dev, side=side)
    step_state = tpart.step_block(sc, dev, k["idx"], side)
    planes = torch.empty((2, Gk, Bp), device=dev)
    children = torch.empty((2, 2, Gk, Bp), device=dev)
    lk = dict(num_bins=k["num_bins"], num_groups=Gk, absmax=k["absmax"],
              kcnt=k["kcnt"], bound=cnt)
    turns = [(graph_ms(lambda: th.launch(cpb, cpg, step_plain,
                                         nl=k["child"][0], out=planes, **lk),
                       100),
              graph_ms(lambda: hs.leaf_hist_rmw_step(
                  cpb, cpg, step_state, k["child"][0], state=st,
                  out=children, **lk), 100))
             for _ in range(3)]
    child_ms = float(np.mean([t[0] for t in turns]))
    child_state_ms = float(np.mean([t[1] for t in turns]))
    rmw_ms = child_state_ms - child_ms
    small, inv = th.leaf_hist_fixed_sums(
        cpb, cpg, start, cnt, num_bins=k["num_bins"], num_groups=Gk,
        child=k["child"], absmax=k["absmax"], kcnt=k["kcnt"])
    st = cst.clone()
    rmw_plain_ms = cuda_ms(lambda: hs.hist_rmw_fixed_plain(st, small,
                                                           k["idx"], inv), 50)
    parent = k["idx"][0]
    sub_ms = graph_ms(lambda: torch.sub(st[parent], small), 200)
    st32, small32 = st[parent].float(), small.float()
    sub32_ms = graph_ms(lambda: torch.sub(st32, small32), 200)
    rmw_bound, rmw_by = bound(2 * Gk * Bp * (8 + 16 + 8), 2 * Gk * Bp)
    say(f"leaf_hist @ root, {cnt} rows x {Gk} groups: {lh_ms:.3f} ms "
        f"(the learner's state launch: {lh_state_ms:.3f} ms; step entries "
        f"at bound {ROWS}, graph replay; the host-int entries "
        f"{lh_host_ms:.3f} / {lh_state_host_ms:.3f} ms), plain "
        f"{lh_plain_ms:.3f} ms (its fixed-point twin {lh_fixed_ms:.3f} ms), "
        f"bound {lh_bound:.3f} ms ({lh_by}), index_add_ {lh_lib_ms:.3f} ms; "
        f"at the first split's smaller child (grid for the parent's {cnt} "
        f"rows), by graph replay in turns: {child_ms:.4f} ms, its state "
        f"launch {child_state_ms:.4f} ms (turns {turns})")
    say(f"hist_rmw (leaf_hist's state epilogue) @ slot (2, {Gk}, {Bp}): "
        f"{rmw_ms:.4f} ms (state launch minus plain launch), plain "
        f"hist_rmw_fixed_plain {rmw_plain_ms:.4f} ms, bound "
        f"{rmw_bound:.6f} ms ({rmw_by}); library: torch.sub of the two int64 "
        f"slots {sub_ms:.4f} ms (graph replay; of f32 copies "
        f"{sub32_ms:.4f} ms)")
    del st, st32, small32, small
    cap["lhr"].clear()

    pa, pk = cap["pair"][1]
    pair_ms = graph_ms(lambda: sp.split_pair(*pa, **pk), 200)
    pair_py_ms = cuda_ms(lambda: sp.split_pair(*pa, **pk), 200)
    pair_plain_ms = cuda_ms(lambda: sp.split_pair_plain(*pa, **pk), 5)
    F2, BFp = pa[0].shape
    pair_bound, pair_by = bound(
        pair_bytes, F2 * BFp * 60)    # masks, scans and two gains per bin
    say(f"split_pair @ ({F2}, {BFp}): {pair_ms:.4f} ms (graph replay; "
        f"{pair_py_ms:.4f} ms a call launched from Python), plain "
        f"{pair_plain_ms:.3f} ms, bound {pair_bound:.6f} ms ({pair_by}); "
        f"no single PyTorch call computes the pair search, library_ms "
        f"null")

    # tree_step: device ms a step from the profiled iterations, bound from
    # the bytes it must move
    ts_calls = per_tree("mega")["tree_step"]
    ts_ms = iter_by_path["mega"]["tree_step"][0] / ts_calls
    ts_bound, ts_by = bound(step_bytes, 0)
    say(f"tree_step: {ts_ms:.5f} ms a step (profiled iteration, "
        f"{ts_calls} launches a tree), plain {ts_plain_ms:.4f} ms on the "
        f"host, bound {ts_bound:.7f} ms ({ts_by}); a whole step of a stopped "
        f"tree {costs['mega']['empty_step']:.4f} ms (mega) / "
        f"{costs['subtraction']['empty_step']:.4f} ms (subtraction)")

    # ---- 6. lightgbm_tpu_torch.bench at a cut depth -----------------
    gc.collect()
    torch.cuda.empty_cache()
    env = dict(os.environ, BENCH_ROWS="2000000", BENCH_REPEATS="2",
               BENCH_ITERS="5")
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m", "lightgbm_tpu_torch.bench"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=600)
    check(r.returncode == 0, f"lightgbm_tpu_torch.bench failed:\n"
                             f"{r.stderr[-3000:]}")
    lines = [json.loads(x) for x in r.stdout.splitlines()
             if x.startswith("{")]
    check(len(lines) == 5, f"bench printed {len(lines)} JSON lines (the "
                           f"mega path at K 1, 2, 4, 8 and the subtraction "
                           f"path)")
    for line in lines:
        print(f"bench: {json.dumps(line)}", flush=True)
        check(line["syncs_per_tree"] == 1.0 and np.isfinite(
            line["binary_logloss"]), f"bench {line['body']}: {line}")
    say(f"bench (BENCH_ROWS=2000000 BENCH_REPEATS=2 BENCH_ITERS=5): "
        f"{time.time() - t0:.1f} s")

    def total(name):
        return sum(v.get(name, 0) for v in launches_by_path.values())

    def row(name, source, replaces, err, ms, plain_ms, bnd, by, lib):
        # per iteration: the mega path's numbers for split_pair, which
        # both paths run (each path's under iter_ms_by_path)
        it = {p: v[name] for p, v in iter_by_path.items() if name in v}
        first = next(iter(it.values()))
        return {"name": name, "route": "cuda",
                "source": f"lightgbm_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": total(name),
                "launches_by_path": {p: v[name] for p, v in
                                     launches_by_path.items() if name in v},
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd, "bound_by": by, "library_ms": lib,
                "iter_ms": first[0], "iter_bound_ms": first[1],
                "iter_ms_by_path": {p: v[0] for p, v in it.items()}}

    def fr_row(name, key, replaces, **extra):
        # the frontier's kernels: no TPU kernel (XLA code in the JAX
        # frontier's while body and tree-end undo)
        o = fr_out[key]
        return dict({"name": name, "route": "cuda",
                     "source": "lightgbm_tpu_torch/csrc/frontier.cu",
                     "replaces": replaces, "launches": total(name),
                     "launches_by_path": {"frontier": total(name)},
                     "max_abs_err": o["err"], "ms": o["ms"],
                     "plain_ms": o["plain_ms"], "bound_ms": o["bound"][0],
                     "bound_by": o["bound"][1], "library_ms": o["lib"]},
                    **extra)

    pair2k = fr_out["split_pair_2k"]
    print(f"frontier ms an iteration (wall, median): "
          + ", ".join(f"{k} {v:.2f}" for k, v in fr_med.items()), flush=True)
    print(f"efb (phase 4e, {card}): s/iteration {efb['iter_s']:.4f}, "
          f"device ms an iteration {efb['device_ms']:.2f}; sampling (phase "
          f"4d): s/iteration " + json.dumps(samp["iter_s"]), flush=True)
    print(f"categorical (phase 4f, {card}): s/iteration {cat['iter_s']:.4f} "
          f"against one-hot (4e) {efb['iter_s']:.4f} on the same rows, both "
          f"under the profiler; device ms an iteration {cat['device_ms']:.2f} "
          f"against {efb['device_ms']:.2f}; split_cat "
          f"{cat['per']['split_cat'][0]:.3f} ms an iteration", flush=True)
    print(f"objectives (phase 4g, {card}): " + json.dumps(
        {"binary": objs["binary"], "renew_ms": objs["renew_ms"],
         "runs": {k: {n: v for n, v in r.items() if n != "iter_all"}
                  for k, r in objs["runs"].items()}}), flush=True)
    hw, cw, arm = wide["higgs"], wide["cat"], wide["arm"]
    r255, r1023 = wide["runs"][255], wide["runs"][WIDE_MAX_BIN]
    print(f"wide (phase 4h, {card}): " + json.dumps(
        {"max_bin_255": {k: r255[k] for k in ("iter_s", "device_ms")},
         "max_bin_1023": {k: r1023[k] for k in ("iter_s", "device_ms",
                                                "iter", "launches")},
         "cat": {k: cw[k] for k in ("iter_s", "device_ms", "W", "Bp",
                                    "tie", "cat_steps")}}), flush=True)
    Gw, Bw = FEATURES, hw["Bp"]

    def wide_row(name, source, replaces, src, kernel, err_key, nbytes, ops,
                 lib=None, **extra):
        # a uint16 / wide arm: its ms a launch and its plain version's on
        # phase 4h's real inputs; launches: its wrapper's count over 4h's
        # run (the 1023 run, or the categorical run), the counts set to 0
        # just before; its ms and device launches an iteration
        t = src["times"][kernel]
        run = r1023 if src is hw else cw
        per = run["iter"] if src is hw else {
            k: list(v) for k, v in cw["per"].items()}
        dev = (run["launches"] if src is hw else
               {k: v[1] for k, v in cw["per"].items()}).get(kernel, 0)
        bnd, by = bound(nbytes, ops)
        return dict({"name": name, "route": "cuda",
                     "source": f"lightgbm_tpu_torch/csrc/{source}",
                     "replaces": replaces,
                     "launches": run["calls"][kernel],
                     "max_abs_err": src["err"][err_key], "ms": t[0],
                     "plain_ms": t[1], "bound_ms": bnd, "bound_by": by,
                     "library_ms": lib,
                     "iter_ms": per.get(kernel, [None])[0],
                     "device_launches_per_iter": dev}, **extra)

    part_rows, lh_rows = hw["part_rows"], hw["times"]["leaf_hist"][3]
    pair_f2 = 2 * Gw
    wide_rows = [
        wide_row("partition_u16", "partition.cu",
                 "lightgbm_tpu/ops/partition_pallas.py:258", hw,
                 "partition", "partition",
                 2 * part_rows * (Gw * 2 + 32), part_rows,
                 rows=part_rows),
        wide_row("leaf_hist_u16", "leaf_hist.cu",
                 "lightgbm_tpu/ops/histogram.py:204", hw, "leaf_hist",
                 "leaf_hist",
                 lh_rows * (Gw * 2 + 8) + 2 * Gw * Bw * (8 + 16 + 8),
                 2 * lh_rows * Gw, hw["times"]["leaf_hist"][2],
                 rows=lh_rows, note="the state launch (hist_rmw's "
                                    "epilogue included)"),
        wide_row("split_pair_wide", "split_pair.cu",
                 "lightgbm_tpu/ops/split_pallas.py:61", hw, "split_pair",
                 "split_pair",
                 2 * pair_f2 * Bw * 4 + 2 * pair_f2 * 8 * 4 + 2 * 13 * 4,
                 pair_f2 * Bw * 60, BF=Bw),
        wide_row("split_cat_wide", "split_cat.cu",
                 "lightgbm_tpu/ops/split.py:121", cw, "split_cat",
                 "split_cat", cw["cat_bytes"], cw["cat_ops"], BF=cw["Bp"],
                 set_words=cw["W"]),
        wide_row("feat_view_wide", "feat_view.cu",
                 "lightgbm_tpu/models/learner.py:1509", cw, "feat_view",
                 "feat_view", cw["view_bytes"], 0, Bp=cw["Bp"]),
        # held on both wide learners (W = 31 here, 32 at max_bin 1023);
        # timed on the categorical run
        wide_row("tree_step_wide", "tree_step.cu",
                 "lightgbm_tpu/models/learner.py:2106", cw, "tree_step",
                 "tree_step", cw["step_bytes"], 0, set_words=cw["W"],
                 max_abs_err_max_bin_1023=hw["err"]["tree_step"],
                 ms_max_bin_1023=hw["times"]["tree_step"][0],
                 plain_ms_max_bin_1023=hw["times"]["tree_step"][1],
                 set_words_max_bin_1023=hw["W"]),
        {"name": "leaf_hist_wide_arm", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/leaf_hist.cu",
         "replaces": "lightgbm_tpu/ops/histogram.py:204",
         "launches": arm["launches"], "max_abs_err": arm["err"],
         "ms": arm["ms"], "plain_ms": arm["plain_ms"],
         "bound_ms": arm["bound"][0], "bound_by": arm["bound"][1],
         "library_ms": arm["lib_ms"], "Bp": arm["Bp"],
         "rows": ARM_ROWS, "groups": ARM_FEATURES,
         "launches_note": "wrapper calls of phase 4h's training at max_bin "
                          f"{ARM_MAX_BIN} (the sizing run and the capture)"},
    ]
    print(f"quantized (phase 4i, {card}): " + json.dumps(quant_summary(quant)),
          flush=True)
    print(f"monotone (phase 4j, {card}): " + json.dumps(mono_summary(mono)),
          flush=True)
    print(f"ranking (phase 4k, {card}): " + json.dumps(rank_summary(rank)),
          flush=True)
    print(f"linear (phase 4m, {card}): " + json.dumps(linear), flush=True)
    for label, higgs in (("rank_mega", "mega"),
                         ("subtraction", "subtraction")):
        for k, (ms, n) in sorted(rank["bodies"][label]["per"].items()):
            h = iter_by_path[higgs].get(k, (None,))[0]
            print(f"  {k} ms an iteration ({card}): MSLR shape G = "
                  f"{rank['groups']} {label} {ms:.3f}, HIGGS G = {FEATURES} "
                  f"{higgs} K=1 "
                  + ("-" if h is None else f"{h:.3f}"), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": [
        row("split_mega", "split_mega.cu",
            "lightgbm_tpu/ops/split_megakernel_pallas.py:202", mega_err,
            mega_ms, mega_plain_ms, mega_bound, mega_by, None),
        dict(row("split_pair", "split_pair.cu",
                 "lightgbm_tpu/ops/split_pallas.py:61", pair_err, pair_ms,
                 pair_plain_ms, pair_bound, pair_by, None),
             ms_2k_children=pair2k["ms"],
             plain_ms_2k_children=pair2k["plain_ms"],
             bound_ms_2k_children=pair2k["bound"][0]),
        row("partition", "partition.cu",
            "lightgbm_tpu/ops/partition_pallas.py:258", part_err, part_ms,
            part_plain_ms, part_bound, part_by, None),
        row("leaf_hist", "leaf_hist.cu", "lightgbm_tpu/ops/histogram.py:204",
            lh_err, lh_ms, lh_plain_ms, lh_bound, lh_by, lh_lib_ms),
        row("hist_rmw", "leaf_hist.cu",
            "lightgbm_tpu/ops/hist_state_pallas.py:48", rmw_err, rmw_ms,
            rmw_plain_ms, rmw_bound, rmw_by, sub_ms),
        row("tree_step", "tree_step.cu",
            "lightgbm_tpu/models/learner.py:2106", steps_err, ts_ms,
            ts_plain_ms, ts_bound, ts_by, None),
        fr_row("frontier_step", "frontier_step",
               "lightgbm_tpu/models/learner.py:2688",
               stopped_step_ms=fr_stopped,
               steps_a_tree=[t[0] for t in fr_trees]),
        fr_row("frontier_key", "frontier_key",
               "lightgbm_tpu/models/learner.py:3177"),
        fr_row("frontier_undo", "frontier_undo",
               "lightgbm_tpu/models/learner.py:3177",
               rows=fr_out["frontier_undo"]["rows"]),
        # no TPU kernel: XLA code of the JAX package (the per-feature view
        # of bundled data; the fused iteration's sampling)
        dict({"name": "feat_view", "route": "cuda",
              "source": "lightgbm_tpu_torch/csrc/feat_view.cu",
              "replaces": "lightgbm_tpu/models/learner.py:1509",
              "launches": efb["launches"]["feat_view"],
              "max_abs_err": efb["err"]["feat_view"],
              "ms": efb["ms"]["feat_view"],
              "plain_ms": efb["plain"]["feat_view"],
              "library_ms": None,
              "iter_ms": efb["per"]["feat_view"][0]},
             **dict(zip(("bound_ms", "bound_by"),
                        bound(efb["bytes"]["feat_view"], 0)))),
        dict({"name": "sample", "route": "cuda",
              "source": "lightgbm_tpu_torch/csrc/sample.cu",
              "replaces": "lightgbm_tpu/models/boosting.py:866",
              "launches": samp["launches"], "max_abs_err": samp["err"],
              "ms": samp["ms"], "plain_ms": samp["plain_ms"],
              "library_ms": samp["lib_ms"],
              "library_call": "torch.rand of the same length (a lower "
                              "reference: it draws, it does not mask)",
              "goss_threshold_ms": samp["goss_threshold_ms"],
              "split_pair_f284_ms": efb["ms"]["split_pair"],
              "split_pair_f284_plain_ms": efb["plain"]["split_pair"]},
             **dict(zip(("bound_ms", "bound_by"),
                        bound(samp["nbytes"], 0)))),
        # no TPU kernel: the categorical search is XLA code of the JAX
        # package's general search
        {"name": "split_cat", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/split_cat.cu",
         "replaces": "lightgbm_tpu/ops/split.py:121",
         "launches": cat["launches"], "max_abs_err": cat["err"],
         "ms": cat["ms"], "plain_ms": cat["plain_ms"],
         "bound_ms": cat["bound"][0], "bound_by": cat["bound"][1],
         "library_ms": None, "iter_ms": cat["per"]["split_cat"][0],
         "iter_bound_ms": cat["iter_bound"], "ms_from_python": cat["py_ms"],
         "partition_cat_max_abs_err": cat["part_err"]},
    ] + wide_rows + quant_rows(quant) + mono_rows(mono)}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def frontier_window():
    """``python3 chip_smoke.py --frontier-window``: phase 4b under
    torch.profiler in a process of its own, which makes no profile before
    it, its device launches by function checked as frontier_path says;
    prints them as the last line, a JSON object.  The profiler names the
    kernels of conditional graphs right in a process's first such window,
    and not after earlier windows and graphs (PERF.md section 7)."""
    sys.path.insert(0, ROOT)
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.models import learner as learner_mod
    from lightgbm_tpu_torch.ops import (frontier, hist_state, histogram,
                                        kernels, partition, split_mega,
                                        split_pair, tree_step)
    kernels.build_all()
    mods = {"split_mega": split_mega, "split_pair": split_pair,
            "partition": partition, "leaf_hist": histogram,
            "hist_rmw": hist_state, "tree_step": tree_step}
    X, y = make_data(ROWS)
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
              "learning_rate": 0.1, "verbosity": -1}
    ds = lgt.Dataset(X, label=y)
    ds.construct(params)
    d = np.loadtxt(os.path.join(ROOT, "examples", "binary_classification",
                                "binary.train"))
    device = frontier_path(lgt, learner_mod, mods, frontier, ds, params, d,
                           profiled=True)[3]
    print(json.dumps(device), flush=True)


def child_phase(flag, what, *args):
    """Run ``chip_smoke.py flag args`` in a child process on the card,
    its output lines printed here; its last line, a JSON object."""
    t0 = time.time()
    r = subprocess.run([sys.executable, os.path.abspath(__file__), flag,
                        *args], cwd=ROOT, capture_output=True, text=True,
                       timeout=900)
    for line in r.stdout.splitlines()[:-1]:
        print(f"  ({what}) {line}", flush=True)
    check(r.returncode == 0, f"{what} failed:\n{r.stdout[-3000:]}\n"
                             f"{r.stderr[-3000:]}")
    out = json.loads(r.stdout.splitlines()[-1])
    say(f"{what} (a process of its own): {time.time() - t0:.1f} s")
    return out


def frontier_window_launches():
    """``frontier_window`` in a child process on the card; its device
    launches by function: {function: [ms, launches]}."""
    return child_phase("--frontier-window", "frontier window")


def cat_only(efb_iter_s):
    """``python3 chip_smoke.py --cat [s]``: phase 4f in a process of its
    own (``s``: phase 4e's s/iteration, for its comparison); prints
    cat_path's result as the last line, a JSON object.  Its checks count
    device launches by the profiler's kernel names, which the profiler
    gets right in a fresh process and has missed by one after the
    earlier phases' windows and graphs (PERF.md section 7)."""
    lgt, mods = standalone("--cat")
    cat = cat_path(lgt, mods, {"iter_s": float(efb_iter_s)})
    print(json.dumps(cat, default=lambda o: o.tolist()), flush=True)


def digest():
    """``python3 chip_smoke.py --digest``: the HIGGS shape trained 2
    iterations on each body (mega K=1, mega at the auto K, subtraction)
    from one constructed Dataset; after each tree a sha256 of leafmat,
    nodemat and both row buffers, one line a body.  It uses only the
    training API and those three learner buffers, so a copy of this file
    run from another checkout of the port digests that checkout's trees:
    equal lines mean bit-identical trees, search rows (leafmat holds
    them) and row order."""
    import hashlib
    check(torch.cuda.is_available(), "--digest needs a card")
    sys.path.insert(0, ROOT)
    import lightgbm_tpu_torch as lgt
    X, y = make_data(ROWS)
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
              "learning_rate": 0.1, "verbosity": -1}
    ds = lgt.Dataset(X, label=y)
    ds.construct(params)
    for label, extra in (("mega K=1", {"tpu_frontier_k": 1}),
                         ("mega auto", {}),
                         ("subtraction", {"tpu_megakernel": "off"})):
        bst = lgt.Booster(params=dict(params, **extra), train_set=ds)
        lr, h = bst._gbdt.learner, hashlib.sha256()
        for _ in range(2):
            bst.update()
            pb, pg = bst._gbdt._phys
            for t in (lr.leafmat, lr.nodemat, pb, pg):
                h.update(t.contiguous().view(torch.uint8).cpu().numpy())
        print(f"digest {label}: {h.hexdigest()}", flush=True)
        del bst, lr
        torch.cuda.empty_cache()


def standalone(flag):
    """The port imported, its kernels built and its wrapper modules by
    name, for a phase run alone."""
    check(torch.cuda.is_available(), f"{flag} needs a card")
    sys.path.insert(0, ROOT)
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import (feat_view, hist_state, histogram,
                                        kernels, partition, sample,
                                        split_cat, split_mega, split_pair,
                                        tree_step)
    kernels.build_all()
    return lgt, {"split_mega": split_mega, "split_pair": split_pair,
                 "partition": partition, "leaf_hist": histogram,
                 "hist_rmw": hist_state, "tree_step": tree_step,
                 "feat_view": feat_view, "sample": sample,
                 "split_cat": split_cat}


def efb_only():
    """``python3 chip_smoke.py --efb``: phase 4e alone, its checks and
    numbers printed; the last line feat_view's and split_pair's ms a
    launch, each kernel's device ms an iteration and the iteration's
    device ms, a JSON object."""
    lgt, mods = standalone("--efb")
    from lightgbm_tpu_torch.models import learner as learner_mod
    efb = efb_path(lgt, learner_mod, mods)
    print(json.dumps({k: efb[k] for k in ("ms", "plain", "per", "iter_s",
                                          "device_ms")}), flush=True)


def quant_only():
    """``python3 chip_smoke.py --quant``: phase 4i alone (the HIGGS shape
    made and constructed), its checks and numbers printed; the last line
    its kernel rows and summary, a JSON object."""
    lgt, mods = standalone("--quant")
    X, y = make_data(ROWS)
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
              "learning_rate": 0.1, "verbosity": -1}
    ds = lgt.Dataset(X, label=y)
    ds.construct(params)
    quant = quant_path(lgt, mods, ds, X, y, params)
    print(json.dumps({"summary": quant_summary(quant),
                      "kernels": quant_rows(quant)}), flush=True)


def mono_only():
    """``python3 chip_smoke.py --mono``: phase 4j alone (the HIGGS shape
    made and constructed), its checks and numbers printed; the last line
    its kernel rows and summary, a JSON object."""
    lgt, mods = standalone("--mono")
    X, y, w = make_data(ROWS, weights=True)
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
              "learning_rate": 0.1, "verbosity": -1}
    ds = lgt.Dataset(X, label=y)
    ds.construct(params)
    mono = mono_path(lgt, mods, ds, X, y, w, params)
    df, ym = quant_mix_frame(X, y)
    mono["frame"] = mono_frame(lgt, mods, lgt.Dataset(df, label=ym),
                               mono["mc"], params)
    print(json.dumps({"summary": mono_summary(mono),
                      "kernels": mono_rows(mono)}), flush=True)


def wide_only():
    """``python3 chip_smoke.py --wide``: phase 4h alone (the HIGGS shape
    made and constructed at max_bin 255 for the run beside max_bin 1023),
    its checks and numbers printed; the last line its JSON summary."""
    lgt, mods = standalone("--wide")
    X, y = make_data(ROWS)
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
              "learning_rate": 0.1, "verbosity": -1}
    ds = lgt.Dataset(X, label=y)
    ds.construct(params)
    wide = wide_path(lgt, mods, ds, X, y, params)
    print(json.dumps({"runs": wide["runs"], "higgs_err": wide["higgs"]["err"],
                      "higgs_times": wide["higgs"]["times"],
                      "cat_err": wide["cat"]["err"],
                      "cat_times": wide["cat"]["times"],
                      "arm": wide["arm"]}, default=str), flush=True)


def linear_only():
    """``python3 chip_smoke.py --linear``: phase 4m alone (the HIGGS shape
    made and constructed), its checks and numbers printed; the last line
    its summary, a JSON object."""
    lgt, mods = standalone("--linear")
    X, y = make_data(ROWS)
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
              "learning_rate": 0.1, "verbosity": -1}
    ds = lgt.Dataset(X, label=y)
    ds.construct(params)
    print(json.dumps(linear_path(lgt, mods, ds, X, params)), flush=True)


def boost_only():
    """``python3 chip_smoke.py --boost``: phase 4l alone (the HIGGS shape
    made and constructed), its checks and numbers printed; the last line
    its summary, a JSON object."""
    lgt, mods = standalone("--boost")
    X, y = make_data(ROWS)
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
              "learning_rate": 0.1, "verbosity": -1}
    ds = lgt.Dataset(X, label=y)
    ds.construct(params)
    print(json.dumps(boost_path(lgt, mods, ds, X, y, params)), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--frontier-window"]:
        frontier_window()
    elif sys.argv[1:] == ["--digest"]:
        digest()
    elif sys.argv[1:] == ["--wide"]:
        wide_only()
    elif sys.argv[1:] == ["--efb"]:
        efb_only()
    elif sys.argv[1:] == ["--quant"]:
        quant_only()
    elif sys.argv[1:] == ["--mono"]:
        mono_only()
    elif sys.argv[1:] == ["--boost"]:
        boost_only()
    elif sys.argv[1:] == ["--linear"]:
        linear_only()
    elif sys.argv[1:2] == ["--rank"] and len(sys.argv) <= 3:
        rank_only(sys.argv[2:] == ["--wait"])
    elif sys.argv[1:2] == ["--cat"] and len(sys.argv) <= 3:
        cat_only(sys.argv[2] if len(sys.argv) == 3 else "nan")
    else:
        main()
