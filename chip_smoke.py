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
     20 launches;
  4. train the HIGGS shape (10.5M x 28, seed 7, as bench.py makes it;
     binary, num_leaves=255, max_bin=255) for a few iterations through
     lightgbm_tpu_torch on the card, on each of the learner's two split
     paths in turn -- the mega path (split_mega + split_pair) and the
     histogram-subtraction path (tpu_megakernel=off: partition +
     leaf_hist + hist_rmw + split_pair) -- from one constructed Dataset,
     with every kernel's launch count reset just before each path and
     read just after; then, for each path, predict 100k rows, save,
     reload and predict again, profile one more iteration (each
     kernel's device time and launches beside its per-iteration bound,
     from the profiled tree's split counts; every device function of the
     path's kernels must show device time), and train the port on the
     card against the port on the CPU on
     examples/binary_classification;
  5. each kernel against its plain version on inputs captured from the
     first tree of its path, and its time at those shapes beside the
     least time the card could take for the same work.
The line before the last is a JSON object of per-kernel numbers; the
last line is {"ok": true, "device": {...}}.
"""

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


def make_data(rows):
    """bench.py _make_data: HIGGS-shaped synthetic binary data."""
    rng = np.random.RandomState(7)
    X = rng.normal(size=(rows, FEATURES)).astype(np.float32)
    w = rng.normal(size=FEATURES)
    logit = X.dot(w) * 0.5
    y = (logit + rng.normal(size=rows) > 0).astype(np.float32)
    return X, y


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


def check_rmw(hs, state, small, idx, what):
    """Kernel vs plain on the card: the state and both children
    bit-identical.  Returns the largest difference (0)."""
    st, st0 = state.clone(), state.clone()
    ch = hs.hist_rmw(st, small, idx)
    ch0 = hs.hist_rmw_plain(st0, small, idx)
    torch.cuda.synchronize()
    ok = (torch.equal(st.view(torch.int32), st0.view(torch.int32))
          and torch.equal(ch.view(torch.int32), ch0.view(torch.int32)))
    check(ok, f"{what}: state or children differ from the plain version")
    return float((ch - ch0).abs().max())


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
# functions run inside split_mega on the mega path); every one but
# OPTIONAL_FUNCS must show device time in the profiled iteration
KERNEL_FUNCS = {
    "mega": {"mega_hist": "split_mega", "part_tiles": "split_mega",
             "part_copyback": "split_mega", "part_set_count": "split_mega",
             "pair_search": "split_pair"},
    "subtraction": {"part_tiles": "partition", "part_copyback": "partition",
                    "part_set_count": "partition",
                    "leaf_hist_fixed": "leaf_hist", "rmw_pass": "hist_rmw",
                    "pair_search": "split_pair"},
}
OPTIONAL_FUNCS = {"part_set_count"}     # runs only for a leaf of no rows


def profile_iteration(bst, plain_s, label):
    """One more boosting iteration under torch.profiler: device time by
    device function, and the device's busy share of the profiled
    iteration's wall time and of ``plain_s``, an iteration's wall time
    without it.  Returns {port kernel: (device ms, device launches)} of
    the iteration (KERNEL_FUNCS); fails when a device function of the
    path's kernels shows no device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        bst.update()
        torch.cuda.synchronize()
        wall = time.time() - t0
    # device-side events only (kernels, copies, sets): the CPU-side op
    # events carry the same device time again
    rows = [(e.key, getattr(e, "device_time_total", 0) / 1e3, e.count)
            for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and getattr(e, "device_time_total", 0) > 0]
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
        fn = key.split("(")[0].split()[-1]
        kernel = KERNEL_FUNCS[label].get(fn)
        if kernel:
            seen.add(fn)
            t, c = per.get(kernel, (0.0, 0))
            per[kernel] = (t + ms, c + n)
    missing = set(KERNEL_FUNCS[label]) - OPTIONAL_FUNCS - seen
    check(not missing, f"profile {label}: no device time for {missing}")
    return per


def iteration_bounds(tree, label, G, R, Bp, N, pair_bytes):
    """Per-iteration bound (ms) of each port kernel on one path: the sum
    over the tree's splits of the kernel's bytes formula, each split's
    rows from the tree's internal counts (no bagging: the bag-aware count
    is the row count), plus the root's calls."""
    ns = tree.num_leaves - 1
    cnt = tree.internal_count[:ns].astype(np.float64)

    def child(c):
        return np.where(c >= 0, tree.internal_count[np.maximum(c, 0)],
                        tree.leaf_count[np.maximum(~c, 0)])
    small = np.minimum(child(tree.left_child[:ns]),
                       child(tree.right_child[:ns])).astype(np.float64)
    hist4, hist2 = G * 4 * Bp * 4, 2 * G * Bp * 4
    move = float((2 * cnt * (R + 32)).sum())
    nbytes = {"split_pair": (ns + 1) * pair_bytes}
    if label == "mega":
        nbytes["split_mega"] = N * (G + 8) + hist4 + move + ns * hist4
    else:
        nbytes["partition"] = move
        nbytes["leaf_hist"] = (N * (G + 8) + hist2
                               + float((small * (G + 8)).sum()) + ns * hist2)
        nbytes["hist_rmw"] = ns * 6 * hist2
    return {k: v / PEAK_BYTES_S * 1e3 for k, v in nbytes.items()}


def report_iteration(per, bounds, tree, label):
    """Print each kernel's device ms per iteration beside its bound, and
    its device launches per call (the root's calls included)."""
    ns = tree.num_leaves - 1
    calls = {"split_mega": ns + 1, "split_pair": ns + 1, "partition": ns,
             "leaf_hist": ns + 1, "hist_rmw": ns}
    out = {}
    for k, b in bounds.items():
        ms, n = per.get(k, (0.0, 0))
        check(ms > 0, f"{label} {k}: no device time in the profiled "
                      f"iteration")
        out[k] = (ms, b)
        print(f"  {label} {k}: {ms:.3f} ms device time per iteration, "
              f"bound {b:.3f} ms; {n} device launches for {calls[k]} calls "
              f"({n / calls[k]:.3f} a call)", flush=True)
    return out


def train_path(lgt, learner_mod, mods, ds, params, label, capture):
    """Train ITERS iterations of one split path with every kernel's launch
    count set to 0 just before and read just after.  ``capture`` maps a
    name of learner_mod to a function that records a call's inputs; it
    wraps that name during the first iteration only."""
    bst = lgt.Booster(params=params, train_set=ds)
    real = {name: getattr(learner_mod, name) for name in capture}

    def wrap(name):
        def call(*a, **k):
            capture[name](*a, **k)
            return real[name](*a, **k)
        return call

    for m in mods.values():
        m.launches = 0
    for name in capture:
        setattr(learner_mod, name, wrap(name))
    iter_s, losses, splits = [], [], 0
    for it in range(ITERS):
        t0 = time.time()
        bst.update()
        torch.cuda.synchronize()
        iter_s.append(time.time() - t0)
        splits += bst._gbdt.models[-1].num_leaves - 1
        losses.append(bst.eval_train()[0][2])
        if it == 0:
            for name, fn in real.items():
                setattr(learner_mod, name, fn)
    launches = {k: m.launches for k, m in mods.items()}
    say(f"train {label}: per-iteration s {[round(s, 3) for s in iter_s]}; "
        f"splits {splits} over {ITERS} trees; launches {launches}; host "
        f"syncs {bst._gbdt.learner.syncs}; binary_logloss {losses}")
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

    sys.path.insert(0, ROOT)
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.models import learner as learner_mod
    from lightgbm_tpu_torch.ops import hist_state as hs
    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops import kernels
    from lightgbm_tpu_torch.ops import partition as tpart
    from lightgbm_tpu_torch.ops import split_mega as sm
    from lightgbm_tpu_torch.ops import split_pair as sp
    from lightgbm_tpu_torch.ops.partition import (S_CNT, S_COL, decide_left,
                                                  make_scalars, scalars_start)
    mods = {"split_mega": sm, "split_pair": sp, "partition": tpart,
            "leaf_hist": th, "hist_rmw": hs}

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
    state = torch.as_tensor(rng.randn(256, 2, G, 256).astype(np.float32) * 50,
                            device=dev)
    small = torch.as_tensor(rng.randn(2, G, 256).astype(np.float32),
                            device=dev)
    for idx in ((5, 5, 9, 1), (5, 5, 9, 0), (3, 255, 255, 1),
                (3, 255, 255, 0), (0, 0, 1, 1)):
        check_rmw(hs, state, small, idx, f"hist_rmw {idx}")
    say("hist_rmw synthetic: 5 cases ok (wa == wb included)")

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
    del pb, pg, state, small

    # ---- 4. the main paths -------------------------------------------
    # split_pair's bytes per call: the (2F, Bp) grad and hess planes, the
    # (2F, 8) metadata and info blocks, the two 13-word results
    pair_bytes = 2 * (2 * G) * 256 * 4 + 2 * (2 * G) * 8 * 4 + 2 * 13 * 4
    t0 = time.time()
    X, y = make_data(ROWS)
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

    cap = {"mega": [], "pair": [], "partition": [], "leaf_hist": [],
           "rmw": [], "sub_pair": []}

    def keep(key, n, item):
        if len(cap[key]) < n:
            cap[key].append(item())

    def capture_mega(pb_, pg_, sc, **k):
        if sc[S_CNT] > 0 and k.get("move", True):
            keep("mega", 3, lambda: (pb_.clone(), pg_.clone(), sc, dict(k)))

    def pair_capture(key):
        def fn(*a, **k):
            keep(key, 3, lambda: (tuple(t.clone() for t in a), dict(k)))
        return fn

    def capture_partition(pb_, pg_, sc):
        keep("partition", 2, lambda: (pb_.clone(), pg_.clone(), sc))

    def capture_leaf_hist(pb_, pg_, start, cnt, **k):
        child = k.get("child")
        k = dict(k, child=None if child is None
                 else (child[0].clone(), child[1]))
        keep("leaf_hist", 2, lambda: (pb_.clone(), pg_.clone(), start, cnt,
                                      k))

    def capture_rmw(state_, small_, idx):
        keep("rmw", 2, lambda: (state_.clone(), small_.clone(), tuple(idx)))

    # the mega path (the default)
    bst, iter_s, losses_mega, splits, launches = train_path(
        lgt, learner_mod, mods, ds, params, "mega",
        {"split_mega": capture_mega, "split_pair": pair_capture("pair")})
    for k in ("split_mega", "split_pair"):
        check(launches[k] == splits + ITERS,
              f"mega: {k}: {launches[k]} launches, expected one per split "
              f"plus one per tree (root)")
    for k in ("partition", "leaf_hist", "hist_rmw"):
        check(launches[k] == 0, f"mega: {k} launched {launches[k]} times")
    launches_by_path = {"mega": launches}
    check_predict(lgt, bst, Xp, "mega")
    per = profile_iteration(bst, float(np.median(iter_s[1:])), "mega")
    tree = bst._gbdt.models[-1]
    iter_by_path = {"mega": report_iteration(per, iteration_bounds(
        tree, "mega", G, G, 256, ROWS, pair_bytes), tree, "mega")}
    card_vs_cpu(lgt, d, {}, "mega")
    del bst

    # the histogram-subtraction path, from the same Dataset
    bst, iter_s, losses_sub, splits, launches = train_path(
        lgt, learner_mod, mods, ds, dict(params, tpu_megakernel="off"),
        "subtraction",
        {"partition_leaf": capture_partition, "leaf_hist": capture_leaf_hist,
         "hist_rmw": capture_rmw, "split_pair": pair_capture("sub_pair")})
    check(bst._gbdt.learner.subtract, "tpu_megakernel=off did not select "
                                      "the subtraction path")
    for k, want in (("partition", splits), ("hist_rmw", splits),
                    ("leaf_hist", splits + ITERS),
                    ("split_pair", splits + ITERS), ("split_mega", 0)):
        check(launches[k] == want, f"subtraction: {k}: {launches[k]} "
                                   f"launches, expected {want}")
    launches_by_path["subtraction"] = launches
    print(f"binary_logloss per iteration: mega {losses_mega}, subtraction "
          f"{losses_sub} (the two paths sum in other orders, so their trees "
          f"are only numerically equal)", flush=True)
    check_predict(lgt, bst, Xp, "subtraction")
    per = profile_iteration(bst, float(np.median(iter_s[1:])), "subtraction")
    tree = bst._gbdt.models[-1]
    iter_by_path["subtraction"] = report_iteration(per, iteration_bounds(
        tree, "subtraction", G, G, 256, ROWS, pair_bytes), tree,
        "subtraction")
    card_vs_cpu(lgt, d, {"tpu_megakernel": "off"}, "subtraction")
    del bst, X, y, ds

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
    lh_err = 0.0
    for i, (cpb, cpg, start, cnt, k) in enumerate(cap["leaf_hist"]):
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
    rmw_err = 0.0
    for i, (cst, csm, idx) in enumerate(cap["rmw"]):
        rmw_err = max(rmw_err, check_rmw(hs, cst, csm, idx,
                                         f"hist_rmw captured {i}"))
    say("captured inputs: kernels agree with plain versions")

    # split_mega at the first split of the first tree (the root's rows)
    cpb, cpg, sc, k = cap["mega"][0]
    cnt, R = sc[S_CNT], cpb.shape[0]
    Gk = k["num_groups"]
    hist_bytes = Gk * 4 * 256 * 4
    mega_bound, mega_by = bound(2 * cnt * (R + 32) + hist_bytes, 2 * cnt * Gk)
    b, g = cpb.clone(), cpg.clone()
    mega_ms = cuda_ms(lambda: sm.split_mega(b, g, sc, **k), 10)
    # its histogram alone (the same call without the move), and so the
    # partition's share of the split
    mega_hist_ms = cuda_ms(lambda: sm.split_mega(b, g, sc,
                                                 **dict(k, move=False)), 10)
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
        f"{mega_ms - mega_hist_ms:.3f} ms), plain "
        f"{mega_plain_ms:.3f} ms, bound {mega_bound:.3f} ms ({mega_by}); "
        f"no single PyTorch call computes the split, library_ms null; "
        f"index_add_ of the histogram half alone {mega_lib_ms:.3f} ms")
    cap["mega"].clear()

    # partition at the first split of the first subtraction tree
    cpb, cpg, sc = cap["partition"][0]
    cnt, R = sc[S_CNT], cpb.shape[0]
    part_bound, part_by = bound(2 * cnt * (R + 32), cnt)
    b, g = cpb.clone(), cpg.clone()
    part_ms = cuda_ms(lambda: tpart.partition_leaf(b, g, sc), 10)
    b, g = cpb.clone(), cpg.clone()
    part_plain_ms = cuda_ms(lambda: tpart.partition_leaf_plain(b, g, sc), 3,
                            1)
    del b, g
    say(f"partition @ {cnt} rows x {R} groups + 8 payload rows: "
        f"{part_ms:.3f} ms, plain {part_plain_ms:.3f} ms, bound "
        f"{part_bound:.3f} ms ({part_by}); no single PyTorch call "
        f"partitions in place, library_ms null")
    cap["partition"].clear()

    # leaf_hist at the root of the first subtraction tree, and at its
    # first smaller child
    lh_ms = {}
    for i, (cpb, cpg, start, cnt, k) in enumerate(cap["leaf_hist"]):
        lh_ms[i] = cuda_ms(lambda: th.leaf_hist(cpb, cpg, start, cnt, **k),
                           10)
    cpb, cpg, start, cnt, k = cap["leaf_hist"][0]
    check(k["child"] is None and cnt == ROWS, "first leaf_hist call is not "
                                              "the root's")
    Gk = k["num_groups"]
    _, Bp = sm.hist_geometry(k["num_bins"])
    lh_bound, lh_by = bound(cnt * (Gk + 8) + 2 * Gk * Bp * 4, 2 * cnt * Gk)
    kp = {n: v for n, v in k.items() if n != "absmax"}
    lh_plain_ms = cuda_ms(lambda: th.leaf_hist_plain(cpb, cpg, start, cnt,
                                                     **kp), 3, 1)
    lh_fixed_ms = cuda_ms(lambda: th.leaf_hist_fixed_plain(
        cpb, cpg, start, cnt, **k), 3, 1)
    # library yardstick: one index_add_ over precomputed (plane, group,
    # bin) indices, prepared outside the timing
    seg = cpb[:Gk, start:start + cnt].long()
    idx = (seg + (torch.arange(Gk, device=dev) * Bp)[:, None]).reshape(-1)
    idx = torch.cat([idx, idx + Gk * Bp])
    vals = torch.cat([cpg[0, start:start + cnt].expand(Gk, -1).reshape(-1),
                      cpg[1, start:start + cnt].expand(Gk, -1).reshape(-1)])
    hist = torch.zeros(2 * Gk * Bp, device=dev)
    lh_lib_ms = cuda_ms(lambda: hist.index_add_(0, idx, vals), 5)
    del seg, idx, vals
    c1 = cap["leaf_hist"][1]
    say(f"leaf_hist @ root, {cnt} rows x {Gk} groups: {lh_ms[0]:.3f} ms, "
        f"plain {lh_plain_ms:.3f} ms (its fixed-point twin "
        f"{lh_fixed_ms:.3f} ms), bound {lh_bound:.3f} ms ({lh_by}), "
        f"index_add_ {lh_lib_ms:.3f} ms; at the first split's smaller child "
        f"(grid for the parent's {c1[3]} rows): {lh_ms[1]:.3f} ms")
    cap["leaf_hist"].clear()

    # hist_rmw at the first split of the first subtraction tree
    cst, csm, idx = cap["rmw"][0]
    slot = csm.numel() * 4
    rmw_bound, rmw_by = bound(6 * slot, csm.numel())
    st = cst.clone()
    rmw_ms = graph_ms(lambda: hs.hist_rmw(st, csm, idx), 200)
    rmw_py_ms = cuda_ms(lambda: hs.hist_rmw(st, csm, idx), 200)
    rmw_plain_ms = cuda_ms(lambda: hs.hist_rmw_plain(st, csm, idx), 50)
    sub_ms = graph_ms(lambda: torch.sub(st[idx[0]], csm), 200)
    say(f"hist_rmw @ slot {tuple(csm.shape)}: {rmw_ms:.4f} ms (graph "
        f"replay; {rmw_py_ms:.4f} ms a call launched from Python), plain "
        f"{rmw_plain_ms:.4f} ms, bound {rmw_bound:.6f} ms ({rmw_by}); no "
        f"single PyTorch call updates the state, library_ms null; "
        f"torch.sub of the two slots alone {sub_ms:.4f} ms (graph replay)")

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

    def total(name):
        return sum(v[name] for v in launches_by_path.values())

    def row(name, source, replaces, err, ms, plain_ms, bnd, by, lib):
        # per iteration: the mega path's numbers for split_pair, which
        # both paths run (each path's under iter_ms_by_path)
        it = {p: v[name] for p, v in iter_by_path.items() if name in v}
        return {"name": name, "route": "cuda",
                "source": f"lightgbm_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": total(name),
                "launches_by_path": {p: v[name] for p, v in
                                     launches_by_path.items()},
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd, "bound_by": by, "library_ms": lib,
                "iter_ms": next(iter(it.values()))[0],
                "iter_bound_ms": next(iter(it.values()))[1],
                "iter_ms_by_path": {p: v[0] for p, v in it.items()}}

    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": [
        row("split_mega", "split_mega.cu",
            "lightgbm_tpu/ops/split_megakernel_pallas.py:202", mega_err,
            mega_ms, mega_plain_ms, mega_bound, mega_by, None),
        row("split_pair", "split_pair.cu",
            "lightgbm_tpu/ops/split_pallas.py:61", pair_err, pair_ms,
            pair_plain_ms, pair_bound, pair_by, None),
        row("partition", "partition.cu",
            "lightgbm_tpu/ops/partition_pallas.py:258", part_err, part_ms,
            part_plain_ms, part_bound, part_by, None),
        row("leaf_hist", "leaf_hist.cu", "lightgbm_tpu/ops/histogram.py:204",
            lh_err, lh_ms[0], lh_plain_ms, lh_bound, lh_by, lh_lib_ms),
        row("hist_rmw", "hist_rmw.cu",
            "lightgbm_tpu/ops/hist_state_pallas.py:48", rmw_err, rmw_ms,
            rmw_plain_ms, rmw_bound, rmw_by, None),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
