"""Training callbacks.

A copy of lightgbm_tpu/callback.py (the port imports nothing of the JAX
package), itself a re-implementation of python-package/lightgbm/callback.py:
early_stopping (:87), log_evaluation, record_evaluation, reset_parameter —
same semantics and CallbackEnv structure.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Optional

from .utils import log


class EarlyStopException(Exception):
    def __init__(self, best_iteration: int, best_score):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


def _format_eval_result(value, show_stdv: bool = True) -> str:
    if len(value) == 4:
        return f"{value[0]}'s {value[1]}: {value[2]:g}"
    if len(value) == 5:
        if show_stdv:
            return f"{value[0]}'s {value[1]}: {value[2]:g} + {value[4]:g}"
        return f"{value[0]}'s {value[1]}: {value[2]:g}"
    raise ValueError("Wrong metric value")


def log_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    def _callback(env: CallbackEnv) -> None:
        if period > 0 and env.evaluation_result_list and \
                (env.iteration + 1) % period == 0:
            result = "\t".join(
                _format_eval_result(x, show_stdv) for x in env.evaluation_result_list)
            log.info("[%d]\t%s", env.iteration + 1, result)
    _callback.order = 10
    return _callback


def record_evaluation(eval_result: Dict[str, Dict[str, List[float]]]) -> Callable:
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dictionary")

    def _init(env: CallbackEnv) -> None:
        eval_result.clear()
        for item in env.evaluation_result_list:
            data_name, eval_name = item[0], item[1]
            eval_result.setdefault(data_name, collections.OrderedDict())
            eval_result[data_name].setdefault(eval_name, [])

    def _callback(env: CallbackEnv) -> None:
        if env.iteration == env.begin_iteration:
            _init(env)
        for item in env.evaluation_result_list:
            data_name, eval_name, result = item[0], item[1], item[2]
            eval_result.setdefault(data_name, collections.OrderedDict())
            eval_result[data_name].setdefault(eval_name, [])
            eval_result[data_name][eval_name].append(result)
    _callback.order = 20
    return _callback


def reset_parameter(**kwargs) -> Callable:
    def _callback(env: CallbackEnv) -> None:
        new_parameters = {}
        for key, value in kwargs.items():
            if isinstance(value, list):
                if len(value) != env.end_iteration - env.begin_iteration:
                    raise ValueError(
                        f"Length of list {key!r} has to equal to 'num_boost_round'.")
                new_param = value[env.iteration - env.begin_iteration]
            else:
                new_param = value(env.iteration - env.begin_iteration)
            new_parameters[key] = new_param
        if new_parameters:
            env.model.reset_parameter(new_parameters)
    _callback.before_iteration = True
    _callback.order = 10
    return _callback


def _is_train_row(item, train_name: str = "training") -> bool:
    """True for training-set eval rows, incl. cv aggregate rows labeled
    ("cv_agg", "train <metric>", ...) (reference: callback.py
    _EarlyStoppingCallback._is_train_set compares against the model's
    ACTUAL train data name, not the literal "training" — a user who
    names the training eval set e.g. "train" must not have train-set
    scores drive early stopping)."""
    return item[0] == train_name or (
        item[0] == "cv_agg" and str(item[1]).startswith("train "))


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True, min_delta: float = 0.0) -> Callable:
    """reference: callback.py early_stopping:87 (_EarlyStoppingCallback)."""
    best_score: List[float] = []
    best_iter: List[int] = []
    best_score_list: List[Any] = []
    cmp_op: List[Callable] = []
    enabled = [True]
    first_metric = [""]
    train_name = ["training"]

    def _init(env: CallbackEnv) -> None:
        # the booster's actual train-data name (engine.train stamps it
        # from valid_names).  Read the instance __dict__: CVBooster's
        # __getattr__ manufactures a method for ANY name, so a plain
        # getattr would return a function instead of the default.
        train_name[0] = env.model.__dict__.get("_train_data_name",
                                               "training")
        if not env.evaluation_result_list:
            enabled[0] = False
            log.warning("For early stopping, at least one dataset and "
                        "eval metric is required for evaluation")
            return
        if verbose:
            log.info("Training until validation scores don't improve for %d rounds",
                     stopping_rounds)
        # first metric = first NON-train entry's metric (reference
        # _EarlyStoppingCallback: train sets never drive stopping; under
        # cv the rows are ("cv_agg", "train <m>"/"valid <m>", ...))
        non_train = [it for it in env.evaluation_result_list
                     if not _is_train_row(it, train_name[0])]
        first_metric[0] = (non_train[0][1].split(" ")[-1] if non_train
                           else env.evaluation_result_list[0][1])
        for item in env.evaluation_result_list:
            best_iter.append(0)
            best_score_list.append(None)
            if item[3]:  # is_max_better
                best_score.append(float("-inf"))
                cmp_op.append(lambda x, y: x > y + min_delta)
            else:
                best_score.append(float("inf"))
                cmp_op.append(lambda x, y: x < y - min_delta)

    def _callback(env: CallbackEnv) -> None:
        if env.iteration == env.begin_iteration:
            _init(env)
        if not enabled[0]:
            return
        for i, item in enumerate(env.evaluation_result_list):
            score = item[2]
            if best_score_list[i] is None or cmp_op[i](score, best_score[i]):
                best_score[i] = score
                best_iter[i] = env.iteration
                best_score_list[i] = env.evaluation_result_list
            if first_metric_only and first_metric[0] != item[1].split(" ")[-1]:
                continue
            if _is_train_row(item, train_name[0]):
                continue
            if env.iteration - best_iter[i] >= stopping_rounds:
                if verbose:
                    log.info("Early stopping, best iteration is:\n[%d]\t%s",
                             best_iter[i] + 1, "\t".join(
                                 _format_eval_result(x) for x in best_score_list[i]))
                raise EarlyStopException(best_iter[i], best_score_list[i])
            if env.iteration == env.end_iteration - 1:
                if verbose:
                    log.info("Did not meet early stopping. Best iteration is:\n[%d]\t%s",
                             best_iter[i] + 1, "\t".join(
                                 _format_eval_result(x) for x in best_score_list[i]))
                raise EarlyStopException(best_iter[i], best_score_list[i])
    _callback.order = 30
    return _callback
