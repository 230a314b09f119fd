"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. the card's name and power limit, torch and CUDA versions;
  2. build the CUDA kernels from csrc/ (one nvcc per source, together);
  3. each kernel against its plain PyTorch version on synthetic inputs,
     edge cases included;
  4. train the HIGGS shape (10.5M x 28, seed 7, as bench.py makes it;
     binary, num_leaves=255, max_bin=255) for a few iterations through
     lightgbm_tpu_torch on the card, with every kernel's launch count
     reset just before and read just after; then predict 100k rows,
     save, reload and predict again; then the port on the card against
     the port on the CPU on examples/binary_classification;
  5. each kernel against its plain version on inputs captured from the
     first tree, and its time at those shapes beside the least time the
     card could take for the same work.
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


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


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


def hist_excess(h, ref, mass, rtol, atol):
    """How far |h - ref| exceeds rtol*|ref| + atol*mass (<= 0 passes):
    f32 sums err in proportion to the bins' absolute mass, so the
    tolerance scales with it."""
    ref = ref.to(torch.float64)
    err = (h.to(torch.float64) - ref).abs()
    return float((err - rtol * ref.abs() - atol * mass).max())


def check_mega(sm, pb, pg, sc, B, G, what):
    """Kernel vs plain on the card: the partition (bins, payload words,
    left count) bit-identical; the kernel's histogram within rtol 1e-4 /
    atol 1e-5 x bin mass of the f64 sums, and within rtol 1e-4 / atol
    1e-4 x bin mass of the plain version's f32 sums (whose own rounding
    grows with the rows per bin); two kernel launches bit-identical."""
    runs = []
    for _ in range(2):
        b, g = pb.clone(), pg.clone()
        nl, acc = sm.split_mega(b, g, sc, num_bins=B, num_groups=G)
        runs.append((b, g, nl, acc))
    b0, g0 = pb.clone(), pg.clone()
    ref, mass = sm.hist_reference(b0, g0, sc, num_bins=B, num_groups=G)
    enl, eacc = sm.split_mega_plain(b0, g0, sc, num_bins=B, num_groups=G)
    torch.cuda.synchronize()
    for b, g, nl, acc in runs:
        check(int(nl) == int(enl), f"{what}: left count {int(nl)} vs "
                                   f"{int(enl)}")
        check(torch.equal(b, b0), f"{what}: bins differ")
        check(torch.equal(g.view(torch.int32), g0.view(torch.int32)),
              f"{what}: payload differs")
        ex = hist_excess(acc, ref, mass, 1e-4, 1e-5)
        check(ex <= 0, f"{what}: histogram off the f64 sums by {ex}")
        ex = hist_excess(acc, eacc, mass, 1e-4, 1e-4)
        check(ex <= 0, f"{what}: histogram off the plain version by {ex}")
    check(torch.equal(runs[0][3].view(torch.int32),
                      runs[1][3].view(torch.int32)),
          f"{what}: two launches differ")
    ref = ref.to(torch.float64)
    return {"vs_plain": float((runs[0][3] - eacc).abs().max()),
            "kernel_vs_f64": float((runs[0][3].double() - ref).abs().max()),
            "plain_vs_f64": float((eacc.double() - ref).abs().max()),
            "max_abs_bin": float(ref.abs().max()),
            "max_bin_mass": float(mass.max())}


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
    """Kernel vs plain.  The plain version on the CPU runs the kernel's
    exact f32 operation order, so every field must be bit-identical; the
    plain version on the card (its f64 prefix sums reassociated) must
    give identical int fields unless the winner is a near-tie, which is
    printed.  Returns the largest float difference to the card's plain
    version."""
    got = sp.split_pair(*args, **kw).cpu()
    cpu = sp.split_pair_plain(*(a.cpu() for a in args), **kw)
    dev = sp.split_pair_plain(*args, **kw).cpu()
    check(torch.equal(got.view(torch.int32), cpu.view(torch.int32)),
          f"{what}: kernel vs plain (CPU) differ:\n{got}\n{cpu}")
    ints = [1, 2, 3, 4, 5]
    ties = near_ties(sp, args, kw)
    for c, g1, g2 in ties:
        print(f"  near-tie {what} child {c}: gains {g1!r} vs {g2!r}")
    if not torch.equal(got[:, ints].view(torch.int32),
                       dev[:, ints].view(torch.int32)):
        check(bool(ties), f"{what}: int fields differ from the plain "
                          f"version on the card without a near-tie")
    flt = [0, 6, 7, 8, 9, 10, 11]
    diff = torch.where(got[:, flt] == dev[:, flt], 0.0,
                       (got[:, flt] - dev[:, flt]).abs())
    return float(diff.nan_to_num(0.0).max())


def profile_iteration(bst, plain_s):
    """One more boosting iteration under torch.profiler: device time by
    kernel, and the device's busy share of the profiled iteration's wall
    time and of ``plain_s``, an iteration's wall time without it."""
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
    if not rows:
        print(f"profile: iteration {wall * 1e3:.1f} ms; device time not "
              f"measured (the profiler saw no device events)")
        return
    print(f"profile: iteration {wall * 1e3:.1f} ms wall, device busy "
          f"{busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}%; "
          f"{100 * busy / (plain_s * 1e3):.1f}% of the "
          f"{plain_s * 1e3:.1f} ms median iteration without the profiler)")
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:12]:
        print(f"  {ms:9.3f} ms  x{n:<6d} {key[:90]}")


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
    from lightgbm_tpu_torch.ops import kernels
    from lightgbm_tpu_torch.ops import split_mega as sm
    from lightgbm_tpu_torch.ops import split_pair as sp
    from lightgbm_tpu_torch.ops.partition import (S_CNT, S_COL, decide_left,
                                                  make_scalars, scalars_start)

    # ---- 2. build ----------------------------------------------------
    t0 = time.time()
    built = kernels.build_all()
    print(f"build: {time.time() - t0:.2f} s wall, per kernel "
          f"{ {k: round(v, 2) for k, v in built.items()} }", flush=True)
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
    for what, sc in cases.items():
        check_mega(sm, pb, pg, make_scalars(*sc), B, G, f"split_mega {what}")
    print(f"split_mega synthetic: {len(cases)} cases ok", flush=True)

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
    print("split_pair synthetic: ok", flush=True)

    # ---- 4. the main path --------------------------------------------
    t0 = time.time()
    X, y = make_data(ROWS)
    print(f"data: {X.shape} in {time.time() - t0:.1f} s", flush=True)
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
              "learning_rate": 0.1, "verbosity": -1}
    t0 = time.time()
    ds = lgt.Dataset(X, label=y)
    ds.construct(params)
    print(f"dataset construct: {time.time() - t0:.1f} s", flush=True)

    captured = {"mega": [], "pair": []}
    real_mega, real_pair = learner_mod.split_mega, learner_mod.split_pair

    def capture_mega(pb_, pg_, *a, **k):
        if len(captured["mega"]) < 3 and a[0][S_CNT] > 0 \
                and k.get("move", True):
            captured["mega"].append((pb_.clone(), pg_.clone(), a, k))
        return real_mega(pb_, pg_, *a, **k)

    def capture_pair(*a, **k):
        if len(captured["pair"]) < 3:
            captured["pair"].append(
                (tuple(t.clone() for t in a), dict(k)))
        return real_pair(*a, **k)

    bst = lgt.Booster(params=params, train_set=ds)
    lr = bst._gbdt.learner
    sm.launches = 0
    sp.launches = 0
    learner_mod.split_mega, learner_mod.split_pair = capture_mega, capture_pair
    iter_s, losses, splits = [], [], 0
    for it in range(ITERS):
        t0 = time.time()
        bst.update()
        torch.cuda.synchronize()
        iter_s.append(time.time() - t0)
        splits += bst._gbdt.models[-1].num_leaves - 1
        losses.append(bst.eval_train()[0][2])
        if it == 0:
            learner_mod.split_mega, learner_mod.split_pair = (real_mega,
                                                              real_pair)
    launches = {"split_mega": sm.launches, "split_pair": sp.launches}
    print(f"train: per-iteration s {[round(s, 3) for s in iter_s]}; "
          f"splits {splits} over {ITERS} trees; launches {launches}; "
          f"host syncs {lr.syncs}; binary_logloss {losses}", flush=True)
    for k, v in launches.items():
        check(v == splits + ITERS, f"{k}: {v} launches, expected one per "
                                   f"split plus one per tree (root)")
    check(all(a > b for a, b in zip(losses, losses[1:])),
          f"training logloss does not fall: {losses}")

    Xp = X[:100_000]
    t0 = time.time()
    p1 = bst.predict(Xp, raw_score=True)
    pred_s = time.time() - t0
    check(p1.shape == (100_000,) and np.isfinite(p1).all(),
          "raw predictions not finite / wrong shape")
    out_dir = os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        path = os.path.join(tmp, "model.txt")
        bst.save_model(path)
        loaded = lgt.Booster(model_file=path)
        p2 = loaded.predict(Xp, raw_score=True)
    check(np.array_equal(p1, p2), f"reloaded predictions differ: max "
                                  f"{np.abs(p1 - p2).max()}")
    print(f"predict: 100000 rows in {pred_s:.3f} s; save/reload equal",
          flush=True)

    # the port on the card against the port on the CPU, small input
    d = np.loadtxt(os.path.join(ROOT, "examples", "binary_classification",
                                "binary.train"))
    small = {"objective": "binary", "num_leaves": 15, "verbosity": -1}
    b_gpu = lgt.train(small, lgt.Dataset(d[:, 1:], label=d[:, 0]), 5)
    b_cpu = lgt.train(dict(small, device_type="cpu"),
                      lgt.Dataset(d[:, 1:], label=d[:, 0]), 5)
    for a, b in zip(b_gpu._gbdt.models, b_cpu._gbdt.models):
        check(a.split_feature.tolist() == b.split_feature.tolist()
              and a.threshold_bin.tolist() == b.threshold_bin.tolist()
              and a.left_child.tolist() == b.left_child.tolist(),
              "card and CPU trees differ on examples/binary_classification")
        check(np.allclose(a.leaf_value, b.leaf_value, rtol=1e-4, atol=1e-5),
              "card and CPU leaf values differ")
    ref_err = float(np.abs(b_gpu.predict(d[:, 1:], raw_score=True)
                           - b_cpu.predict(d[:, 1:], raw_score=True)).max())
    check(ref_err < 1e-5, f"card vs CPU raw predictions differ by {ref_err}")
    print(f"reference: card vs CPU on binary.train, 5 trees identical, "
          f"max raw err {ref_err:.2e}", flush=True)

    # ---- 5. captured inputs and timings ------------------------------
    check(captured["mega"] and captured["pair"], "nothing captured")
    mega_err = 0.0
    for i, (cpb, cpg, a, k) in enumerate(captured["mega"]):
        errs = check_mega(sm, cpb, cpg, a[0], k["num_bins"], k["num_groups"],
                          f"split_mega captured {i}")
        print(f"  split_mega captured {i} ({a[0][S_CNT]} rows): max |err| "
              f"kernel vs plain {errs['vs_plain']!r}, kernel vs f64 "
              f"{errs['kernel_vs_f64']!r}, plain vs f64 "
              f"{errs['plain_vs_f64']!r}; largest |bin sum| "
              f"{errs['max_abs_bin']!r}, largest bin mass "
              f"{errs['max_bin_mass']!r}", flush=True)
        mega_err = max(mega_err, errs["vs_plain"])
    pair_err = 0.0
    for i, (a, k) in enumerate(captured["pair"]):
        pair_err = max(pair_err, check_pair(sp, a, k,
                                            f"split_pair captured {i}"))
    print("captured inputs: kernels agree with plain versions", flush=True)

    # split_mega at the first split of the first tree (the root's rows)
    cpb, cpg, a, k = captured["mega"][0]
    sc = a[0]
    cnt, R = sc[S_CNT], cpb.shape[0]
    hist_bytes = k["num_groups"] * 4 * 256 * 4
    mega_bytes = 2 * cnt * (R + 32) + hist_bytes
    b, g = cpb.clone(), cpg.clone()
    mega_ms = cuda_ms(lambda: sm.split_mega(b, g, sc, **k), 10)
    b, g = cpb.clone(), cpg.clone()
    mega_plain_ms = cuda_ms(lambda: sm.split_mega_plain(b, g, sc, **k), 3, 1)
    # no single PyTorch call partitions and builds both histograms, so
    # library_ms is null; one index_add_ over the leaf's (group, side,
    # bin) indices (prepared outside the timing) is printed as a
    # yardstick for the histogram half alone
    s0 = scalars_start(sc)
    seg = cpb[:k["num_groups"], s0:s0 + cnt].long()
    gl = decide_left(cpb[sc[S_COL], s0:s0 + cnt], *sc[S_COL + 1:])
    Bp = 256
    idx = (seg + (torch.arange(seg.shape[0], device=dev) * 4 * Bp)[:, None]
           + torch.where(gl, 0, 2 * Bp)[None, :]).reshape(-1)
    idx = torch.cat([idx, idx + Bp])
    vals = torch.cat([cpg[0, s0:s0 + cnt].expand(seg.shape[0], -1).reshape(-1),
                      cpg[1, s0:s0 + cnt].expand(seg.shape[0], -1).reshape(-1)])
    hist = torch.zeros(seg.shape[0] * 4 * Bp, device=dev)
    mega_lib_ms = cuda_ms(lambda: hist.index_add_(0, idx, vals), 5)
    del seg, idx, vals

    pa, pk = captured["pair"][1]
    pair_ms = graph_ms(lambda: sp.split_pair(*pa, **pk), 200)
    pair_py_ms = cuda_ms(lambda: sp.split_pair(*pa, **pk), 200)
    pair_plain_ms = cuda_ms(lambda: sp.split_pair_plain(*pa, **pk), 5)
    F2, BFp = pa[0].shape
    pair_bytes = 2 * F2 * BFp * 4 + 2 * F2 * 8 * 4 + 2 * 13 * 4
    pair_ops = F2 * BFp * 60          # masks, scans and two gains per bin
    pair_bound = max(pair_bytes / PEAK_BYTES_S, pair_ops / PEAK_F32_S) * 1e3
    pair_by = ("bytes" if pair_bytes / PEAK_BYTES_S
               >= pair_ops / PEAK_F32_S else "operations")
    mega_ops = 2 * cnt * k["num_groups"]    # one grad and one hess add
    mega_by = ("bytes" if mega_bytes / PEAK_BYTES_S
               >= mega_ops / PEAK_F32_S else "operations")
    mega_bound = max(mega_bytes / PEAK_BYTES_S, mega_ops / PEAK_F32_S) * 1e3
    print(f"split_mega @ {cnt} rows x {R} groups: {mega_ms:.3f} ms, plain "
          f"{mega_plain_ms:.3f} ms, bound {mega_bound:.3f} ms ({mega_by}); "
          f"no single PyTorch call computes the split, library_ms null; "
          f"index_add_ of the histogram half alone {mega_lib_ms:.3f} ms",
          flush=True)
    print(f"split_pair @ ({F2}, {BFp}): {pair_ms:.4f} ms (graph replay; "
          f"{pair_py_ms:.4f} ms a call launched from Python), plain "
          f"{pair_plain_ms:.3f} ms, bound {pair_bound:.6f} ms ({pair_by}); "
          f"no single PyTorch call computes the pair search, library_ms "
          f"null", flush=True)
    profile_iteration(bst, float(np.median(iter_s[1:])))
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": [
        {"name": "split_mega", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/split_mega.cu",
         "replaces": "lightgbm_tpu/ops/split_megakernel_pallas.py:202",
         "launches": launches["split_mega"], "max_abs_err": mega_err,
         "ms": mega_ms, "plain_ms": mega_plain_ms, "bound_ms": mega_bound,
         "bound_by": mega_by, "library_ms": None},
        {"name": "split_pair", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/split_pair.cu",
         "replaces": "lightgbm_tpu/ops/split_pallas.py:61",
         "launches": launches["split_pair"], "max_abs_err": pair_err,
         "ms": pair_ms, "plain_ms": pair_plain_ms, "bound_ms": pair_bound,
         "bound_by": pair_by, "library_ms": None},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
