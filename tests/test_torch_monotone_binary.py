"""Trees under monotone constraints on ``examples/binary_classification``:
the binary cases of tests/test_torch_monotone_trees.py (``basic`` with
``monotone_penalty`` 2, ``intermediate``), held to the JAX package by its
``check`` (trees split for split or a recorded exact tie, leaf values
rtol 1e-4 / atol 1e-5, raw predictions atol 1e-5, model text both ways)
and the monotonicity sweep of the port's model.
"""

import pytest

from test_torch_monotone_trees import one_torch_thread  # noqa: F401
from test_torch_monotone_trees import CASES, run_case


@pytest.mark.parametrize("case", sorted(c for c in CASES
                                        if c.startswith("binary")))
def test_monotone_binary_trees_match_jax(case):
    run_case(case)
