"""Training throughput of the port at the HIGGS shape on one NVIDIA card.

    python -m lightgbm_tpu_torch.bench

The port's counterpart of the repo's ``bench.py``: the same synthetic
data (``_make_data``: 10.5M rows x 28 standard-normal features, label
from a random linear logit plus noise, RandomState(7)) and the same
params (binary, ``num_leaves=255``, ``max_bin=255``, lr 0.1), trained on
each split body of the learner in turn: the mega path at each
``tpu_frontier_k`` of BENCH_FRONTIER_K, then ``tpu_megakernel=off`` (K=1,
the frontier's fallback there).  Per body, after one warm-up iteration (which
captures the tree's CUDA graph), it times BENCH_REPEATS blocks of
BENCH_ITERS iterations with ``torch.cuda.synchronize()`` at each block's
ends, then profiles one more block with ``torch.profiler``, and prints
one JSON line: the median seconds per iteration and the spread of the
blocks, ``vs_baseline = 130.094 / (median * 500)`` as ``bench.py``
defines it (the reference CPU learner's 500 iterations), host syncs per
tree, the device's busy share of the profiled block (device time of the
events the profiler saw over the block's wall time), its device
milliseconds per iteration by kernel and each kernel's launches per
iteration (the profiler's event counts), the final training logloss, and
the card's name and power limit.  A frontier line (K > 1) adds the
steps per conditional block of its graph, the graph's steps run a tree
(mean over the timed trees), the splits made a tree with the speculative
ones pruned at the budget, and the device ms of a stopped step: a step's
IF node not taken, timed by replaying 64 such nodes, each holding one
frontier step, in a graph of their own (``ops/frontier.py:
stopped_step_ms``).  BENCH_FRONTIER_BLOCK, a list of
steps per conditional block, runs each K > 1 once per value in place of
the learner's own ceil(sqrt(L - 1)); L - 1 puts every step in one block,
so that a stopped tree skips its steps node by node.

Environment: BENCH_ROWS (10500000), BENCH_ITERS (20), BENCH_REPEATS (5),
BENCH_LEAVES (255), BENCH_FRONTIER_K (1,2,4,8), BENCH_FRONTIER_BLOCK
(empty: the learner's own).  It needs a card and fails without one; it
imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROWS = int(os.environ.get("BENCH_ROWS", 10_500_000))
FEATURES = 28
NUM_LEAVES = int(os.environ.get("BENCH_LEAVES", 255))
ITERS = int(os.environ.get("BENCH_ITERS", 20))
REPEATS = int(os.environ.get("BENCH_REPEATS", 5))
BASELINE_WALL_S = 130.094
BASELINE_ITERS = 500
FRONTIER_K = [int(k) for k in
              os.environ.get("BENCH_FRONTIER_K", "1,2,4,8").split(",")]
FRONTIER_BLOCK = [int(b) for b in
                  os.environ.get("BENCH_FRONTIER_BLOCK", "").split(",")
                  if b] or [None]


def _make_data(rows):
    rng = np.random.RandomState(7)
    X = rng.normal(size=(rows, FEATURES)).astype(np.float32)
    w = rng.normal(size=FEATURES)
    logit = X.dot(w) * 0.5
    y = (logit + rng.normal(size=rows) > 0).astype(np.float32)
    return X, y


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_events(prof):
    """(name, device ms, count) of the device-side events of a profile."""
    return [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and getattr(e, "device_time_total", 0) > 0]


def run_body(lgt, ds, params, label, card, block=None):
    bst = lgt.Booster(params=params, train_set=ds)
    learner = bst._gbdt.learner
    if block:
        learner.fr_block = block    # before the first tree's capture
    t0 = time.time()
    bst.update()
    torch.cuda.synchronize()
    warm = time.time() - t0
    blocks, steps, made = [], [], []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(ITERS):
            bst.update()
            if learner.K > 1:
                steps.append(learner.last_steps)
                made.append(learner.last_made)
        torch.cuda.synchronize()
        blocks.append((time.time() - t0) / ITERS)
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(ITERS):
            bst.update()
        torch.cuda.synchronize()
        prof_wall = time.time() - t0
    rows = device_events(prof)
    busy = sum(ms for _, ms, _ in rows)
    kernels, launches = {}, {}
    for key, ms, n in rows:
        # the function's name, without a template's arguments
        fn = key.split("(")[0].split("<")[0].split()[-1][:60]
        kernels[fn] = kernels.get(fn, 0.0) + ms / ITERS
        launches[fn] = launches.get(fn, 0) + n
    top = sorted(kernels, key=lambda fn: -kernels[fn])[:12]
    trees = bst._gbdt.num_trees()
    median = float(np.median(blocks))
    out = {
        "metric": f"higgs_synth_{ROWS}x{FEATURES}_L{NUM_LEAVES}_wall_per_iter",
        "body": label, "frontier_k": learner.K, "value": median,
        "unit": "s/iter",
        "vs_baseline": BASELINE_WALL_S / (median * BASELINE_ITERS),
        "blocks_s_per_iter": blocks,
        "spread_pct": 100.0 * (max(blocks) - min(blocks)) / median,
        "iters_per_block": ITERS, "repeats": REPEATS,
        "warmup_s": warm,
        "syncs_per_tree": learner.syncs / trees,
        "busy_share": busy / (prof_wall * 1e3),
        "profiled_block_s_per_iter": prof_wall / ITERS,
        "device_ms_per_iter": busy / ITERS,
        "kernels_ms_per_iter": {fn: kernels[fn] for fn in top},
        "kernels_launches_per_iter": {fn: launches[fn] / ITERS
                                      for fn in top},
        "binary_logloss": bst.eval_train()[0][2],
        "card": card,
    }
    if learner.K > 1:
        from lightgbm_tpu_torch.ops.frontier import stopped_step_ms
        pb, pg = bst._gbdt._phys
        out["frontier_block"] = learner.fr_block
        out["steps_per_tree"] = float(np.mean(steps))
        out["made_per_tree"] = float(np.mean(made))
        out["stopped_step_ms"] = stopped_step_ms(
            lambda: learner.fr_step(pb, pg), learner.device)
    del bst
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("lightgbm_tpu_torch.bench needs an NVIDIA card", file=sys.stderr)
        return 1
    import lightgbm_tpu_torch as lgt
    card = card_name()
    X, y = _make_data(ROWS)
    params = {"objective": "binary", "num_leaves": NUM_LEAVES,
              "learning_rate": 0.1, "max_bin": 255, "verbosity": -1}
    ds = lgt.Dataset(X, label=y)
    t0 = time.time()
    ds.construct(params)
    construct_s = time.time() - t0
    del X
    bodies = [(f"mega_k{k}" + (f"_b{b}" if b else ""),
               {"tpu_frontier_k": k}, b)
              for k in FRONTIER_K for b in (FRONTIER_BLOCK if k > 1
                                            else [None])]
    bodies.append(("subtraction", {"tpu_megakernel": "off"}, None))
    for label, extra, block in bodies:
        out = run_body(lgt, ds, dict(params, **extra), label, card, block)
        out["construct_s"] = construct_s
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
