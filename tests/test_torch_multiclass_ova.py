"""``multiclassova`` (one binary logloss a class), with and without
feature_fraction, the port against the JAX package as
test_torch_multiclass.py sets out (its tie rule, tolerances and seeded
init_score)."""

import pytest

from test_torch_multiclass import FILES, check_case
from torch_one_thread import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("case", FILES["ova"])
def test_ova_trains_as_jax(case):
    check_case(case)
