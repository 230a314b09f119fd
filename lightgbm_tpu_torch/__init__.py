"""lightgbm_tpu_torch -- the PyTorch/CUDA port of lightgbm_tpu.

A second package beside the JAX one, which stays the reference: the
same params, the same model text, the same trees.  This first slice
trains all-numerical binary and L2-regression GBDT with the serial
leaf-wise learner, through two hand-written CUDA kernels for Hopper
(``ops/split_mega.py``, ``ops/split_pair.py``), and predicts raw and
converted scores.  Entry points run on the card (``device_type='cuda'``,
the default); ``device_type='cpu'`` runs the kernels' plain PyTorch
versions.  The package imports neither ``jax`` nor ``lightgbm_tpu``.
"""

from .basic import Booster, Dataset
from .config import Config
from .engine import train
from .utils.log import LightGBMError

__version__ = "0.1.0"

__all__ = ["Booster", "Config", "Dataset", "LightGBMError", "train"]
