"""lightgbm_tpu_torch -- the PyTorch/CUDA port of lightgbm_tpu.

A second package beside the JAX one, which stays the reference: the
same params, the same model text, the same trees.  It trains
all-numerical binary and L2-regression GBDT with the serial leaf-wise
learner through hand-written CUDA kernels for Hopper (``csrc/``), with
validation sets, early stopping and the callbacks of ``callback.py``,
custom objectives and metrics, continued training and text-file
datasets, and predicts raw and converted scores and leaf indices.
Entry points run on the card (``device_type='cuda'``, the default);
``device_type='cpu'`` runs the kernels' plain PyTorch versions.  The
package imports neither ``jax`` nor ``lightgbm_tpu``.
"""

from .basic import Booster, Dataset
from .callback import (EarlyStopException, early_stopping, log_evaluation,
                       record_evaluation, reset_parameter)
from .config import Config
from .engine import train
from .utils.log import LightGBMError

__version__ = "0.1.0"

__all__ = ["Booster", "Config", "Dataset", "EarlyStopException",
           "LightGBMError", "early_stopping", "log_evaluation",
           "record_evaluation", "reset_parameter", "train"]
