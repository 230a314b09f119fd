"""Does the first booster of a fresh process grow the same tree as the next?

The port's CPU path computes the binary objective's gradients with
PyTorch's CPU ``torch.exp``.  This script trains two boosters of one tree
each on the same data in one process, on the CPU, and compares their
first gradients and their trees bit for bit; it repeats that in
``--procs`` fresh processes (the effect, if any, is a first-call one) and
prints how many of them differed.  Exit code 1 when any did.

    python tools/cpu_first_booster_check.py [--procs 20] [--rows 30000]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one(rows: int) -> int:
    """Two boosters in this process; 1 when they differ."""
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.models import objective as ob

    rng = np.random.RandomState(0)
    X = rng.randn(rows, 12).astype(np.float32)
    X[:, 11] = rng.randint(0, 40, rows)
    y = (X[:, 0] + 0.5 * X[:, 1] + (X[:, 11] % 3 == 0)
         + 0.5 * rng.randn(rows) > 0).astype(np.float32)
    params = {"objective": "binary", "num_leaves": 63, "verbosity": -1,
              "device_type": "cpu"}
    ds = lgt.Dataset(X, label=y, categorical_feature=[11])
    ds.construct(params)
    grads, real = [], ob.BinaryLogloss.gradients_from_payload

    def record(self, score, slw):
        inputs = (score.clone(), slw.clone())
        g, h = real(self, score, slw)
        grads.append((g.clone(), h.clone()) + inputs)
        return g, h

    ob.BinaryLogloss.gradients_from_payload = record
    trees = []
    for _ in range(2):
        b = lgt.Booster(params, ds)
        b.update()
        trees.append(b._gbdt.learner.leafmat.clone().view(torch.int32))
    def differing(a, b):
        return int((a.view(torch.int32) != b.view(torch.int32)).sum())

    nin = sum(differing(a, b) for a, b in zip(grads[0][2:], grads[1][2:]))
    ndiff = sum(differing(a, b) for a, b in zip(grads[0][:2], grads[1][:2]))
    same_tree = torch.equal(trees[0], trees[1])
    print(f"input words differing {nin}, gradient words differing {ndiff}, "
          f"same tree {same_tree}")
    return int(ndiff > 0 or not same_tree)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=20)
    ap.add_argument("--rows", type=int, default=30000)
    ap.add_argument("--one", action="store_true",
                    help="run one check in this process")
    a = ap.parse_args()
    if a.one:
        return one(a.rows)
    bad = 0
    for i in range(a.procs):
        r = subprocess.run([sys.executable, __file__, "--one", "--rows",
                            str(a.rows)], capture_output=True, text=True)
        last = (r.stdout.strip().splitlines() or [r.stderr.strip()])[-1]
        print(f"process {i}: {last}", flush=True)
        bad += r.returncode != 0
    print(f"{bad} of {a.procs} fresh processes differed")
    return int(bad > 0)


if __name__ == "__main__":
    sys.exit(main())
