"""Multiclass with row sampling, the port against the JAX package:
bagging (3 classes, a period of 2: JAX's fused multiclass draw by row
id), GOSS (a row's importance is the sum over its classes) and balanced
bagging (JAX's eager draws), as test_torch_multiclass.py sets out (its
tie rule, tolerances and seeded init_score).  One bag serves the K trees
of an iteration."""

import pytest

from test_torch_multiclass import FILES, check_case
from torch_one_thread import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("case", FILES["sampling"])
def test_sampled_multiclass_trains_as_jax(case):
    check_case(case)
