"""The port's histogram-state read-modify-write
(lightgbm_tpu_torch/ops/hist_state.py) against the JAX kernel
``hist_rmw_pallas`` run in the Pallas interpreter.

The two keep different layouts: the port's (slots, 2, G, Bp) state
against the JAX kernel's lane-flattened (slots, 8, WL) one
(``flat_geometry``).  The test converts between them (zero padding, as
the JAX learner's ``_flatten_hist`` pads) and requires the state after
the update and both children to be bit-identical: one f32 subtraction
per element in both.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lightgbm_tpu.ops.hist_state_pallas import flat_geometry, hist_rmw_pallas
from lightgbm_tpu_torch.ops import hist_state as hs

SLOTS = 6


def _to_flat(x, G, B):
    """(..., 2, G, Bp) port planes -> (..., 8, WL) JAX slots."""
    Gf, Bf, WL = flat_geometry(G, B)
    lead = x.shape[:-3]
    pad = [(0, 0)] * len(lead) + [(0, 0), (0, Gf - G), (0, Bf - x.shape[-1])]
    return np.pad(x, pad).reshape(*lead, 8, WL)


def _from_flat(x, G, Bp, B):
    Gf, Bf, _ = flat_geometry(G, B)
    return x.reshape(*x.shape[:-2], 2, Gf, Bf)[..., :G, :Bp]


@pytest.mark.parametrize("G,B", [(28, 255), (5, 60)])
@pytest.mark.parametrize("idx", [(2, 2, 4, 1), (2, 2, 4, 0), (0, 5, 5, 1),
                                 (3, 5, 5, 0)],
                         ids=["small_left", "small_right", "trash_wa_eq_wb",
                              "trash_small_right"])
def test_hist_rmw_plain_matches_pallas_interpreted(G, B, idx):
    rng = np.random.RandomState(sum(idx) + G)
    state = hs.new_state(SLOTS, G, B, "cpu")
    Bp = state.shape[-1]
    state[..., :B] = torch.as_tensor(
        rng.randn(SLOTS, 2, G, B).astype(np.float32) * 100)
    small = torch.zeros((2, G, Bp))
    small[..., :B] = torch.as_tensor(rng.randn(2, G, B).astype(np.float32))
    jstate, jl, jr = hist_rmw_pallas(
        jnp.asarray(_to_flat(state.numpy(), G, B)),
        jnp.asarray(_to_flat(small.numpy(), G, B)),
        jnp.asarray(idx, jnp.int32), interpret=True)
    children = hs.hist_rmw(state, small, idx)
    assert tuple(children.shape) == (2, 2, G, Bp)

    def bits(a):
        return np.ascontiguousarray(a).view(np.int32)

    np.testing.assert_array_equal(
        bits(_from_flat(np.asarray(jstate), G, Bp, B)), bits(state.numpy()))
    np.testing.assert_array_equal(bits(_from_flat(np.asarray(jl), G, Bp, B)),
                                  bits(children[:, 0].numpy()))
    np.testing.assert_array_equal(bits(_from_flat(np.asarray(jr), G, Bp, B)),
                                  bits(children[:, 1].numpy()))


def test_hist_rmw_contract():
    """large = parent - small; left to wa, then right to wb; the children
    are the pair search's (2G, Bp) inputs, left rows first; other slots
    untouched."""
    rng = np.random.RandomState(1)
    G, B = 4, 32
    state = hs.new_state(SLOTS, G, B, "cpu")
    state[:] = torch.as_tensor(rng.randn(*state.shape).astype(np.float32))
    before = state.clone()
    small = torch.as_tensor(rng.randn(2, G, 32).astype(np.float32))
    ch = hs.hist_rmw(state, small, (1, 1, 3, 0))
    large = before[1] - small
    assert torch.equal(state[1], large) and torch.equal(state[3], small)
    for s in (0, 2, 4, 5):
        assert torch.equal(state[s], before[s])
    hg = ch[0].reshape(2 * G, -1)
    assert torch.equal(hg[:G], large[0]) and torch.equal(hg[G:], small[0])
    assert torch.equal(ch[1].reshape(2 * G, -1)[G:], small[1])


def test_hist_rmw_dispatches_cpu_to_plain_version():
    before = hs.launches
    state = hs.new_state(3, 2, 16, "cpu")
    hs.hist_rmw(state, torch.zeros((2, 2, 16)), (0, 0, 1, 1))
    assert hs.launches == before
