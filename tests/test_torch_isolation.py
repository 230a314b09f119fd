"""Ground rules of the PyTorch/CUDA port, for every slice:

  * ``lightgbm_tpu_torch/`` and ``chip_smoke.py`` import neither ``jax``
    nor ``lightgbm_tpu`` (AST scan, and an import with ``jax`` poisoned);
  * entry points run on the card by default (``device_type='cuda'``),
    and a CUDA request without a card raises instead of running on the
    CPU;
  * the kernel wrappers have no fallback: no ``try`` around a build or a
    launch, and a CPU tensor is the only way to the plain version.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "lightgbm_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "lightgbm_tpu")


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import_in_port_sources(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_package_imports_with_jax_poisoned():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'lightgbm_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import lightgbm_tpu_torch, lightgbm_tpu_torch.convert\n"
        "import lightgbm_tpu_torch.ops.kernels\n"
        "import numpy as np\n"
        "X = np.random.RandomState(0).normal(size=(300, 4))\n"
        "y = (X[:, 0] > 0).astype(float)\n"
        "b = lightgbm_tpu_torch.train({'objective': 'binary', 'verbosity': -1,"
        " 'num_leaves': 4, 'device_type': 'cpu'},"
        " lightgbm_tpu_torch.Dataset(X, label=y), num_boost_round=2)\n"
        "assert b.num_trees() == 2\n"
        "assert not any(m.startswith('jax') and sys.modules[m] is not None"
        " for m in sys.modules)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


def test_config_defaults_to_cuda():
    from lightgbm_tpu_torch.config import Config
    assert Config().device_type == "cuda"
    assert Config({"device": "cpu"}).device_type == "cpu"


def test_cuda_request_without_card_raises(monkeypatch):
    import lightgbm_tpu_torch as lgt
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.random.RandomState(0).normal(size=(100, 3))
    y = (X[:, 0] > 0).astype(float)
    with pytest.raises(RuntimeError, match="cuda"):
        lgt.train({"objective": "binary"}, lgt.Dataset(X, label=y),
                  num_boost_round=1)


@pytest.mark.parametrize("mod", ["ops/kernels.py", "ops/split_pair.py",
                                 "ops/split_mega.py", "ops/partition.py",
                                 "ops/histogram.py", "ops/hist_state.py",
                                 "ops/tree_step.py", "ops/frontier.py",
                                 "ops/feat_view.py", "ops/sample.py",
                                 "ops/split_cat.py", "ops/predict.py",
                                 "ops/binning.py", "dataset.py", "basic.py",
                                 "models/tree.py", "models/learner.py",
                                 "models/boosting.py"])
def test_kernel_wrappers_have_no_fallback(mod):
    """No try/except in the build and launch paths: a kernel that does not
    build or launch raises to the caller."""
    tree = ast.parse(open(os.path.join(PKG, mod)).read())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


def test_no_triton_or_nvcc_needed_to_import():
    """Kernels build inside the call that launches them, never at import:
    importing every module works on a host without nvcc."""
    code = ("import importlib, pkgutil, lightgbm_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "from lightgbm_tpu_torch.ops import kernels\n"
            "assert not kernels._libs\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PATH="/usr/bin:/bin",
                                CUDA_HOME="/nonexistent"))
    assert r.returncode == 0, r.stderr[-2000:]
