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


def plain(import_port: bool) -> int:
    """One torch.exp after a warm thread pool; 1 when a value is off."""
    import numpy as np
    import torch
    if import_port:
        sys.path.insert(0, ROOT)
        import lightgbm_tpu_torch  # noqa: F401
    rng = np.random.RandomState(0)
    a = torch.from_numpy(rng.randn(4 << 20).astype(np.float32))
    b = (a * 2.0 + 1.0).abs()
    x = torch.from_numpy((rng.randn(45056) * 4).astype(np.float32))
    got = torch.exp(x).numpy().view(np.int32).astype(np.int64)
    want = np.exp(x.numpy().astype(np.float64)).astype(np.float32)
    ulps = np.abs(got - want.view(np.int32).astype(np.int64))
    bad = np.nonzero(ulps > 2)[0]
    where = f", rows {bad[0]}..{bad[-1]}" if len(bad) else ""
    print(f"max ulps {int(ulps.max())}, {len(bad)} values off{where} "
          f"(checksum {float(b.sum()):.1f})")
    return int(len(bad) > 0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=20)
    ap.add_argument("--rows", type=int, default=30000)
    ap.add_argument("--one", action="store_true",
                    help="run one check in this process")
    ap.add_argument("--plain-torch", action="store_true",
                    help="check torch.exp alone, without the port")
    ap.add_argument("--import-port", action="store_true",
                    help="with --plain-torch: import the port first")
    a = ap.parse_args()
    if a.one:
        return plain(a.import_port) if a.plain_torch else one(a.rows)
    mode = (["--plain-torch"] + (["--import-port"] if a.import_port
                                 else [])) if a.plain_torch else []
    bad = 0
    for i in range(a.procs):
        r = subprocess.run([sys.executable, __file__, "--one", "--rows",
                            str(a.rows)] + mode, capture_output=True,
                           text=True)
        last = (r.stdout.strip().splitlines() or [r.stderr.strip()])[-1]
        print(f"process {i}: {last}", flush=True)
        bad += r.returncode != 0
    print(f"{bad} of {a.procs} fresh processes differed")
    return int(bad > 0)


if __name__ == "__main__":
    sys.exit(main())
