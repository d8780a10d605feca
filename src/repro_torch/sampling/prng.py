"""Threefry counter PRNG, bit-compatible with ``jax.random`` raw keys.

The rollout engine derives every sampled token's randomness from raw
``(..., 2)`` uint32 threefry keys: ``fold_in(fold_in(fold_in(stage_key,
group_id), sample_idx), token_index)``. Reproducing jax's bits exactly keeps
the port's token streams equal to the JAX engine's on the same logits.

Random bits use jax's *partitionable* layout (``jax_threefry_partitionable``
is on): for a length-V draw, ``bits[i] = y0 ^ y1`` of
``threefry2x32(key, (0, i))``. ``fold_in(key, d) = threefry2x32(key, (0, d))``
and ``split(key, n)[i] = threefry2x32(key, (0, i))``.

Keys are ``torch.uint32`` tensors at the interfaces. PyTorch has no uint32
arithmetic, so the rounds run on int64 tensors holding 32-bit values.
"""
from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)


def _add(a, b):
    return (a + b) & _M32


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """jax's threefry2x32 (20 rounds) on int64 tensors holding uint32 values;
    broadcasts its four operands. Returns (y0, y1)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = _add(x0, k0)
    x1 = _add(x1, k1)
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = _add(x0, x1)
            x1 = _rotl(x1, r) ^ x0
        x0 = _add(x0, ks[(i + 1) % 3])
        x1 = _add(_add(x1, ks[(i + 2) % 3]), i + 1)
    return x0, x1


def _wide(keys):
    k = keys.to(torch.int64)
    return k[..., 0], k[..., 1]


def _narrow(y0, y1):
    return torch.stack([y0, y1], dim=-1).to(torch.uint32)


def PRNGKey(seed: int, device=None):
    """Raw key of an integer seed, as ``jax.random.PRNGKey(seed)``."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([s >> 32, s & _M32], dtype=torch.int64,
                        device=device).to(torch.uint32)


def fold_in(keys, data):
    """keys: (..., 2) uint32; data: integer tensor broadcastable to keys'
    batch shape. Returns the folded (..., 2) uint32 keys."""
    k0, k1 = _wide(keys)
    d = torch.as_tensor(data, device=keys.device).to(torch.int64) & _M32
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(d), d)
    return _narrow(y0, y1)


def split(key, num: int = 2):
    """key: (2,) uint32 -> (num, 2) uint32 subkeys."""
    k0, k1 = _wide(key)
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(i), i)
    return _narrow(y0, y1)


def random_bits(keys, n: int):
    """keys: (..., 2) uint32 -> (..., n) 32-bit random words (int64 holding
    uint32 values), jax's partitionable layout for a length-n draw."""
    k0, k1 = _wide(keys)
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(k0[..., None], k1[..., None], torch.zeros_like(i), i)
    return y0 ^ y1


def uniform_from_bits(bits):
    """jax.random.uniform(minval=tiny, maxval=1) on float32, bit for bit:
    the top 23 bits become a mantissa in [1, 2), minus 1, then scaled by
    (1 - tiny), which is 1 in float32, and shifted by tiny."""
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
    f = fb.view(torch.float32) - 1.0
    return torch.clamp_min(f + _TINY, _TINY)


def gumbel_from_bits(bits):
    """jax.random.gumbel's transform: -log(-log(u))."""
    return -torch.log(-torch.log(uniform_from_bits(bits)))


def gumbel(keys, n: int):
    """(..., 2) keys -> (..., n) float32 Gumbel noise, as
    ``jax.random.gumbel(key, (n,))`` per key."""
    return gumbel_from_bits(random_bits(keys, n))
