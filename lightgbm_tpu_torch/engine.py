"""``train``: the boosting loop of the port (reference: engine.py train).

Port of the slice's surface of lightgbm_tpu/engine.py.  ``valid_sets``
may name the training set itself, whose metrics are then logged every
iteration; other validation sets, early stopping, callbacks, custom
evaluation and continued training raise NotImplementedError.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from .basic import Booster, Dataset
from .config import Config, reset_unknown_param_warnings
from .utils import log


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          feval=None, init_model=None,
          callbacks: Optional[List[Callable]] = None) -> Booster:
    reset_unknown_param_warnings()
    params = dict(params or {})
    for name, val in (("feval", feval), ("init_model", init_model),
                      ("callbacks", callbacks)):
        if val:
            raise NotImplementedError(
                f"lightgbm_tpu_torch.train does not support {name} yet")
    if any(vs is not train_set for vs in (valid_sets or [])):
        raise NotImplementedError(
            "lightgbm_tpu_torch.train evaluates the training set only")
    cfg = Config(params)
    if "num_iterations" in {Config.canonical_name(k) for k in params}:
        num_boost_round = cfg.num_iterations
    booster = Booster(params=params, train_set=train_set)
    for i in range(num_boost_round):
        stop = booster.update()
        if valid_sets:
            for _, name, val, _ in booster.eval_train():
                log.info("[%d]\ttraining's %s: %g", i + 1, name, val)
        if stop:
            break
    return booster
