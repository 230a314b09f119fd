"""lightgbm_tpu_torch -- the PyTorch/CUDA port of lightgbm_tpu.

A second package beside the JAX one, which stays the reference: the
same params, the same model text, the same trees.  It trains GBDT with
the serial leaf-wise learner through hand-written CUDA kernels for
Hopper (``csrc/``) on every pointwise objective of the JAX package
(L1-family leaves renewed), multiclass softmax and one-vs-all, and
custom objectives, with validation sets, early stopping and the
callbacks of ``callback.py``, custom metrics, continued training and
text-file datasets, and predicts raw and converted scores and leaf
indices.
Entry points run on the card (``device_type='cuda'``, the default);
``device_type='cpu'`` runs the kernels' plain PyTorch versions.  The
package imports neither ``jax`` nor ``lightgbm_tpu``.
"""

import torch

# The first multi-threaded call into torch's CPU vector math (``exp``)
# of a process can return one thread's chunk wrong, by up to 754 ulps
# (torch 2.13.0+cpu with MKL 2024.2; reproduced without the package by
# ``tools/cpu_first_booster_check.py --plain-torch``), which made the
# first booster of a fresh process differ.  One call on a few elements,
# below the parallel grain size and so on one thread, sets the path up
# first.
torch.exp(torch.zeros(8))
torch.log(torch.ones(8))

from .basic import Booster, Dataset  # noqa: E402
from .callback import (EarlyStopException, early_stopping,  # noqa: E402
                       log_evaluation, record_evaluation, reset_parameter)
from .config import Config  # noqa: E402
from .engine import train  # noqa: E402
from .utils.log import LightGBMError  # noqa: E402

__version__ = "0.1.0"

__all__ = ["Booster", "Config", "Dataset", "EarlyStopException",
           "LightGBMError", "early_stopping", "log_evaluation",
           "record_evaluation", "reset_parameter", "train"]
