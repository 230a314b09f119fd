"""The JAX package's random draws, computed without JAX.

The port's own copy of the ``jax.random`` functions that the JAX
package's sampling calls (``PRNGKey``, ``split``, ``fold_in``,
``random_bits``, ``uniform``, ``permutation``, ``gumbel``), with the
default
implementation of jax 0.9.0: ``threefry2x32`` with
``jax_threefry_partitionable`` on.  Each gives the same bits as
``jax.random`` for the same key.

A key is two uint32 words ``(k1, k2)``.  Every draw is one Threefry-2x32
block (20 rounds) of the key over a 64-bit counter split into its high
and low words:

  * ``PRNGKey(seed)`` = ``(seed >> 32, seed & 0xFFFFFFFF)`` of the
    32-bit seed, so ``(0, seed mod 2^32)``;
  * ``split(key, n)[i]`` = ``threefry(key, (0, i))``; ``fold_in(key, d)``
    = ``threefry(key, (0, d))``;
  * ``random_bits(key, shape)[i]`` = ``x0 ^ x1`` of ``threefry(key,
    (i >> 32, i & 0xFFFFFFFF))``, ``i`` the row-major flat index;
  * ``uniform`` = ``bits >> 9 | 0x3F800000`` read as an f32, minus 1;
  * ``permutation(key, n)``: ``ceil(3 ln n / ln(2^32 - 1))`` rounds of
    ``key, sub = split(key)`` and a stable sort of the values by
    ``random_bits(sub, (n,))`` (JAX ``_shuffle``);
  * ``gumbel(key, shape)``: jax 0.9.0's default ``mode="low"``,
    ``-log(-log(u))`` of ``u = uniform(key, shape, minval=tiny,
    maxval=1)``, the f32 ``tiny`` the smallest normal.

The numpy functions serve the host (the feature mask); the ``torch_*``
ones compute the same in int64 tensors that carry uint32 values, on any
device, and are the plain version of ``csrc/sample.cu``'s draw.
"""

from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA


# -- numpy -----------------------------------------------------------------
def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """Threefry-2x32 (20 rounds) of ``key`` over the counter words
    ``x0``, ``x1`` (uint32 arrays of one shape)."""
    with np.errstate(over="ignore"):
        k0, k1 = np.uint32(key[0]), np.uint32(key[1])
        ks = (k0, k1, k0 ^ k1 ^ np.uint32(PARITY))
        x = [np.asarray(x0, np.uint32) + ks[0],
             np.asarray(x1, np.uint32) + ks[1]]
        for i in range(5):
            for r in ROT[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def PRNGKey(seed: int) -> np.ndarray:
    """The (2,) uint32 key of an integer seed (32 bits, as JAX takes it
    without x64)."""
    s = int(seed)
    if not -(1 << 31) <= s < (1 << 32):
        raise OverflowError(f"seed {s} does not fit 32 bits")
    return np.array([0, s & M32], np.uint32)


def _counts(n: int):
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), \
        (i & np.uint64(M32)).astype(np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """(num, 2) uint32 keys."""
    a, b = threefry2x32(key, *_counts(num))
    return np.stack([a, b], axis=1)


def fold_in(key, data: int) -> np.ndarray:
    a, b = threefry2x32(key, np.zeros(1, np.uint32),
                        np.array([int(data) & M32], np.uint32))
    return np.array([a[0], b[0]], np.uint32)


def random_bits(key, shape) -> np.ndarray:
    """uint32 bits of ``shape`` (a tuple)."""
    a, b = threefry2x32(key, *_counts(math.prod(shape)))
    return (a ^ b).reshape(shape)


def uniform(key, shape) -> np.ndarray:
    """f32 in [0, 1) of ``shape``, as ``jax.random.uniform``."""
    fb = (random_bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    return np.maximum(np.float32(0.0), fb.view(np.float32) - np.float32(1.0))


def shuffle_rounds(n: int) -> int:
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(M32)))


def permutation(key, n: int) -> np.ndarray:
    """int32 permutation of ``range(n)`` (JAX ``_shuffle``)."""
    x = np.arange(n, dtype=np.int32)
    for _ in range(shuffle_rounds(n)):
        key, sub = split(key)
        order = np.argsort(random_bits(sub, (n,)), kind="stable")
        x = x[order]
    return x


# -- torch (int64 lanes carrying uint32) -----------------------------------
def _trotl(x, r):
    return ((x << r) & M32) | (x >> (32 - r))


def torch_threefry2x32(key, x0: torch.Tensor, x1: torch.Tensor):
    """``threefry2x32`` on int64 tensors holding uint32 values; ``key``
    two host ints."""
    k0, k1 = int(key[0]) & M32, int(key[1]) & M32
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    a = (x0 + ks[0]) & M32
    b = (x1 + ks[1]) & M32
    for i in range(5):
        for r in ROT[i % 2]:
            a = (a + b) & M32
            b = _trotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & M32
        b = (b + ks[(i + 2) % 3] + i + 1) & M32
    return a, b


def torch_random_bits_at(key, index: torch.Tensor) -> torch.Tensor:
    """``random_bits(key, (n,))[index]`` for int64 indices below 2^32, as
    int64 values: the draw of each index alone."""
    a, b = torch_threefry2x32(key, torch.zeros_like(index), index)
    return a ^ b


def torch_uniform_at(key, index: torch.Tensor) -> torch.Tensor:
    """``uniform(key, (n,))[index]`` as f32 (see ``torch_random_bits_at``)."""
    fb = (torch_random_bits_at(key, index) >> 9) | 0x3F800000
    u = fb.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(u, 0.0)


def torch_permutation(key, n: int, device) -> torch.Tensor:
    """int64 ``permutation(key, n)`` on ``device``; the keys are drawn on
    the host, the sorts run on the device."""
    x = torch.arange(n, dtype=torch.int64, device=device)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    for _ in range(shuffle_rounds(n)):
        key, sub = split(key)
        order = torch.sort(torch_random_bits_at(sub, idx), stable=True)[1]
        x = x[order]
    return x


def torch_gumbel(key, shape, device) -> torch.Tensor:
    """f32 ``jax.random.gumbel(key, shape)`` (its default ``mode="low"``)
    on ``device``: the uniform over ``[tiny, 1)`` of the row-major flat
    index's bits, then ``-log(-log(u))``."""
    n = math.prod(shape)
    bits = torch_random_bits_at(key, torch.arange(n, dtype=torch.int64,
                                                  device=device))
    fb = (bits >> 9) | 0x3F800000
    f = fb.to(torch.int32).view(torch.float32) - 1.0
    tiny = float(np.finfo(np.float32).tiny)
    # JAX: max(minval, f * (maxval - minval) + minval), (1 - tiny) == 1 in f32
    u = torch.clamp_min(f + tiny, tiny)
    return (-torch.log(-torch.log(u))).reshape(shape)
