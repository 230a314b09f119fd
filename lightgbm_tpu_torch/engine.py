"""``train``: the boosting loop of the port (reference: engine.py train).

Port of lightgbm_tpu/engine.py ``train``: validation sets and their
names, early stopping (``early_stopping_round`` or the callback), the
callbacks of ``callback.py``, custom evaluation (``feval``), a callable
objective, and continued training (``init_model``).  The JAX package's
checkpoint, resume, fault-injection and telemetry hooks are runtime
planes the port does not have yet (``checkpoint_*`` params raise).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from . import callback as callback_mod
from .basic import Booster, Dataset
from .callback import EarlyStopException
from .config import Config, reset_unknown_param_warnings


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          feval=None, init_model=None, keep_training_booster: bool = False,
          callbacks: Optional[List[Callable]] = None) -> Booster:
    """Train a booster (reference: engine.py train:66)."""
    reset_unknown_param_warnings()
    params = dict(params or {})
    # a callable objective drives the custom-gradient path
    fobj = None
    if callable(params.get("objective")):
        fobj = params.pop("objective")
        params["objective"] = "none"
    cfg = Config(params)
    if "num_iterations" in {Config.canonical_name(k) for k in params}:
        num_boost_round = cfg.num_iterations

    booster = Booster(params=params, train_set=train_set)
    if init_model is not None:
        booster._continue_from(init_model)

    valid_contain_train = False
    if valid_sets is not None:
        user_named = valid_names is not None
        if valid_names is None:
            valid_names = [f"valid_{i}" for i in range(len(valid_sets))]
        for vs, name in zip(valid_sets, valid_names):
            if vs is train_set:
                # the train set keeps the name "training" unless the user
                # named it; early stopping skips its rows by that name
                valid_contain_train = True
                booster._train_data_name = name if user_named else "training"
                continue
            vs.reference = train_set
            booster.add_valid(vs, name)

    callbacks = list(callbacks) if callbacks else []
    if cfg.early_stopping_round and cfg.early_stopping_round > 0:
        callbacks.append(callback_mod.early_stopping(
            cfg.early_stopping_round, cfg.first_metric_only,
            verbose=cfg.verbosity >= 1,
            min_delta=cfg.early_stopping_min_delta))
    callbacks_before = sorted(
        (cb for cb in callbacks if getattr(cb, "before_iteration", False)),
        key=lambda cb: getattr(cb, "order", 0))
    callbacks_after = sorted(
        (cb for cb in callbacks if not getattr(cb, "before_iteration", False)),
        key=lambda cb: getattr(cb, "order", 0))

    booster.best_iteration = -1
    for i in range(num_boost_round):
        for cb in callbacks_before:
            cb(callback_mod.CallbackEnv(
                model=booster, params=params, iteration=i, begin_iteration=0,
                end_iteration=num_boost_round, evaluation_result_list=None))
        should_stop = booster.update(fobj=fobj)
        evaluation_result_list = []
        if valid_contain_train:
            evaluation_result_list.extend(booster.eval_train(feval))
        if booster._valid_names:
            evaluation_result_list.extend(booster.eval_valid(feval))
        try:
            for cb in callbacks_after:
                cb(callback_mod.CallbackEnv(
                    model=booster, params=params, iteration=i,
                    begin_iteration=0, end_iteration=num_boost_round,
                    evaluation_result_list=evaluation_result_list))
        except EarlyStopException as es:
            booster.best_iteration = es.best_iteration + 1
            for item in es.best_score:
                booster.best_score.setdefault(item[0], {})[item[1]] = item[2]
            break
        if should_stop:
            break
    return booster
