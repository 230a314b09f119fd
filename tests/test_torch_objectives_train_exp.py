"""MAPE and the pointwise objectives of the exponential family and
cross-entropy (poisson, gamma, tweedie, cross_entropy,
cross_entropy_lambda), 5 trees
of the port against the JAX package, as test_torch_objectives_train.py
sets out (its tie rule, tolerances and cases)."""

import pytest

from test_torch_objectives_train import CASES, HERE, check_case
from torch_one_thread import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("case", sorted(set(CASES) - set(HERE)))
def test_objective_trains_as_jax(case):
    check_case(case)
