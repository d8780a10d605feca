"""Mamba-style selective SSM head of the hymba hybrid block.

    h_t = exp(Δ_t ⊙ A) ⊙ h_{t-1} + Δ_t ⊙ (B_t ⊗ x_t)
    y_t = C_t · h_t + D ⊙ x_t

with input-dependent Δ, B, C. Decode state per slot: the (d_inner, d_state)
SSM state, float32, and the (conv_dim - 1, d_inner) conv tail. The port of
``repro.models.ssm``; the scan runs through ``hopper/ssm_scan`` (the CUDA
kernel on the card, the plain version on the CPU).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.common.partitioning import reduce_over
from repro_torch.hopper import ssm_scan as ssm_op
from repro_torch.models.layers import dense_init


def d_inner_of(cfg):
    return cfg.ssm.expand * cfg.d_model


def dt_rank_of(cfg):
    return cfg.ssm.dt_rank or max(1, int(np.ceil(cfg.d_model / 16)))


def init_ssm(cfg, dtype, device, gen):
    """Random projections made from ``gen``; the reference's structured
    values for the rest: A_log = log(1..N) per channel, dt_bias =
    log(expm1(0.01)), D = 1 (those three float32)."""
    s = cfg.ssm
    d, di, dr = cfg.d_model, d_inner_of(cfg), dt_rank_of(cfg)
    A = torch.arange(1, s.state_dim + 1, dtype=torch.float32,
                     device=device)[None, :].repeat(di, 1)
    return {
        "in_proj": dense_init((d, 2 * di), dtype, device, gen),   # x and z
        "conv": dense_init((s.conv_dim, di), dtype, device, gen,
                           fan_in=s.conv_dim),
        "conv_b": torch.zeros(di, dtype=dtype, device=device),
        "x_proj": dense_init((di, dr + 2 * s.state_dim), dtype, device, gen),
        "dt_proj": dense_init((dr, di), dtype, device, gen),
        "dt_bias": torch.full((di,), math.log(math.expm1(0.01)),
                              dtype=torch.float32, device=device),
        "A_log": torch.log(A),
        "D": torch.ones(di, dtype=torch.float32, device=device),
        "out_proj": dense_init((di, d), dtype, device, gen),
    }


def causal_conv1d(x, w, b, conv_state=None, lengths=None):
    """Depthwise causal conv. x: (B, S, di); w: (K, di); conv_state:
    (B, K-1, di), the tail of the previous chunk (zeros at the start).
    Returns (y, new_conv_state). With ``lengths`` (right-padded rows) the
    new state is the K-1 inputs ending at each row's last valid position,
    not the fixed tail."""
    K = w.shape[0]
    B, S, di = x.shape
    if conv_state is None:
        conv_state = torch.zeros(B, K - 1, di, dtype=x.dtype, device=x.device)
    xp = torch.cat([conv_state, x], dim=1)                    # (B, S+K-1, di)
    y = sum(xp[:, i:i + S] * w[i][None, None, :] for i in range(K))
    if K > 1:
        if lengths is not None:
            # xp[j] is x[j - (K-1)]: row b's tail ends at x[l-1] = xp[l+K-2]
            start = lengths.to(torch.int64).clamp(0, S)[:, None]
            idx = start + torch.arange(K - 1, device=x.device)[None, :]
            new_state = xp[torch.arange(B, device=x.device)[:, None], idx]
        else:
            new_state = xp[:, -(K - 1):]
    else:
        new_state = conv_state
    return y + b[None, None, :], new_state


def apply_ssm(params, cfg, x, state=None, conv_state=None, *, lengths=None,
              seq_mask=None, part=None):
    """x: (B, S, d) -> (y (B, S, d), new_state, new_conv_state).

    Right-padded rows: pass ``seq_mask`` (freezes the SSM state across pads)
    and ``lengths`` (the conv tail gathered at each row's last valid token).
    On the card the scan kernel updates ``state`` in place and returns it.

    ``part`` (serving on a mesh: a ``partitioning.Part``): ``params`` are
    this rank's shards in the serve layout, its channels [part.start,
    part.start + di_l) of ``in_proj`` (the serve form (d, 2, di_l)),
    ``conv``, ``dt_proj``, ``A_log`` and the rows of ``x_proj`` and
    ``out_proj``, with ``conv_b``, ``dt_bias`` and ``D`` whole (sliced
    here), and ``state`` / ``conv_state`` the rank's shards of the cache
    leaves. x_proj's partial sums (dt_lo, B and C: dr + 2N a token) are
    summed over ``part.group`` before the scan, out_proj's after it."""
    s = cfg.ssm
    dt_ = x.dtype
    B = x.shape[0]
    dr = dt_rank_of(cfg)
    w_in = params["in_proj"]
    if w_in.dim() == 3:                         # the serve form (d, 2, di)
        w_in = w_in.flatten(1)
    di = w_in.shape[1] // 2                     # this rank's channels
    c0, group = (0, None) if part is None else part
    ch = slice(c0, c0 + di)

    xz = x @ w_in.to(dt_)
    xi, z = xz.chunk(2, dim=-1)                               # (B, S, di)
    xi, conv_state = causal_conv1d(xi, params["conv"].to(dt_),
                                   params["conv_b"][ch].to(dt_), conv_state,
                                   lengths=lengths)
    xi = F.silu(xi)

    proj = reduce_over(xi @ params["x_proj"].to(dt_), group)  # (B,S,dr+2N)
    dt_lo, Bc, Cc = proj.split([dr, s.state_dim, s.state_dim], dim=-1)
    dt = F.softplus(dt_lo.float() @ params["dt_proj"].float()
                    + params["dt_bias"][ch].float()[None, None])

    if state is None:
        state = torch.zeros(B, di, s.state_dim, dtype=torch.float32,
                            device=x.device)
    # dt is rounded to the compute dtype before the scan, as in the
    # reference
    y, state = ssm_op.selective_scan(xi, dt.to(dt_), params["A_log"], Bc, Cc,
                                     params["D"][ch], state,
                                     seq_mask=seq_mask)
    y = y * F.silu(z)
    return (reduce_over(y @ params["out_proj"].to(dt_), group), state,
            conv_state)
