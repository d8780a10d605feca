"""Shared building blocks: initializers, RMSNorm, RoPE, gated MLP."""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# init helpers (the port's own seeded init: weights are random, made from a
# torch.Generator; parity tests convert the JAX init instead, see convert.py)
# ---------------------------------------------------------------------------


def dense_init(shape, dtype, device, gen, *, fan_in: int | None = None):
    """Truncated-normal init with 1/sqrt(fan_in) scale (megatron-style)."""
    fan = fan_in if fan_in is not None else shape[-2] if len(shape) >= 2 else shape[-1]
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return (w * (1.0 / math.sqrt(fan))).to(dtype)


def embed_init(shape, dtype, device, gen):
    w = torch.empty(shape, dtype=torch.float32, device=device)
    w.normal_(0.0, 0.02, generator=gen)
    return w.to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def rms_norm(x, scale, *, eps: float = 1e-6, offset: float = 0.0):
    """RMSNorm computed in float32 and cast back to x's dtype."""
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (scale.float() + offset)).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_inv(head_dim: int, theta: float, device: torch.device):
    """The inverse frequencies on ``device``, copied there once (a per-call
    host-to-device copy would synchronise the host with the device every
    layer)."""
    return torch.from_numpy(rope_frequencies(head_dim, theta)).to(device)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (..., S) int. Rotates pairs
    (x[..., :hd/2], x[..., hd/2:]) — llama convention."""
    hd = x.shape[-1]
    inv = _rope_inv(hd, float(theta), x.device)
    ang = positions[..., None].float() * inv                 # (..., S, hd/2)
    sin = torch.sin(ang)[..., None, :]                        # (..., S, 1, hd/2)
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU)
# ---------------------------------------------------------------------------


def init_mlp(d_model, d_ff, dtype, device, gen):
    return {
        "wi": dense_init((d_model, d_ff), dtype, device, gen),
        "wg": dense_init((d_model, d_ff), dtype, device, gen),
        "wo": dense_init((d_ff, d_model), dtype, device, gen),
    }


def apply_mlp(params, x, *, activation: str = "silu"):
    act = F.silu if activation == "silu" else functools.partial(
        F.gelu, approximate="tanh")                 # jax.nn.gelu's default
    dt = x.dtype
    h = act(x @ params["wg"].to(dt)) * (x @ params["wi"].to(dt))
    return h @ params["wo"].to(dt)


def softcap(x, cap: float):
    """tanh soft-capping (gemma2)."""
    if cap and cap > 0.0:
        return torch.tanh(x / cap) * cap
    return x
