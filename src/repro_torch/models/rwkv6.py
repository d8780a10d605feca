"""RWKV6 ("Finch") block: data-dependent-decay time-mix + channel-mix.

Attention-free: a per-head matrix-valued state S ∈ (hd, hd) evolves as

    S_t = diag(w_t) · S_{t-1} + k_tᵀ · v_t
    y_t = r_t · (diag(u) · k_tᵀ v_t + S_{t-1})

with the data-dependent decay w_t = exp(-exp(wd_t)) produced by a LoRA on
the token-shifted input. Decode state per slot: the (heads, hd, hd) float32
wkv state and two token-shift vectors. The port of ``repro.models.rwkv6``;
the recurrence runs through ``hopper/rwkv6_scan`` (the CUDA kernel on the
card, the plain version on the CPU).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common.partitioning import gather_over, reduce_over
from repro_torch.hopper import rwkv6_scan as wkv_op
from repro_torch.models.layers import dense_init


def init_rwkv_block(cfg, dtype, device, gen):
    """Random projections made from ``gen``; the reference's structured
    values for the rest: the token-shift mixes mu = 0.5, the decay base
    w_base = -6 and the group-norm scale ln_x = 1."""
    d, r = cfg.d_model, cfg.rwkv
    H = d // r.head_dim

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    tm = {
        "mu": full((5, d), 0.5),                 # r, k, v, g, w base mixes
        "mix_a": dense_init((d, r.mix_lora * 5), dtype, device, gen),
        "mix_b": dense_init((5, r.mix_lora, d), dtype, device, gen,
                            fan_in=r.mix_lora),
        "wr": dense_init((d, d), dtype, device, gen),
        "wk": dense_init((d, d), dtype, device, gen),
        "wv": dense_init((d, d), dtype, device, gen),
        "wg": dense_init((d, d), dtype, device, gen),
        "wo": dense_init((d, d), dtype, device, gen),
        "w_base": full((d,), -6.0),
        "dec_a": dense_init((d, r.decay_lora), dtype, device, gen),
        "dec_b": dense_init((r.decay_lora, d), dtype, device, gen,
                            fan_in=r.decay_lora),
        "u": dense_init((H, r.head_dim), dtype, device, gen),
        "ln_x": full((d,), 1.0),
    }
    cm = {
        "mu_k": full((d,), 0.5),
        "mu_r": full((d,), 0.5),
        "wk": dense_init((d, cfg.d_ff), dtype, device, gen),
        "wv": dense_init((cfg.d_ff, d), dtype, device, gen),
        "wr": dense_init((d, d), dtype, device, gen),
    }
    return {"tm": tm, "cm": cm}


def _token_shift(x, prev):
    """x: (B, S, d); prev: (B, d), the last token of the previous chunk.
    Returns the one-step-shifted sequence and the new carry (x's last
    token)."""
    shifted = torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)
    return shifted, x[:, -1, :]


def apply_time_mix(tm, cfg, x, prev_x, state, *, seq_mask=None, part=None):
    """x: (B, S, d). Returns (out, new_prev_x, new_state); on the card the
    WKV kernel updates ``state`` in place and returns it.

    ``part`` (serving on a mesh: a ``partitioning.Part``): ``tm`` holds
    this rank's shards in the serve layout, its heads' columns
    [part.start, part.start + d_l) of ``wr``/``wk``/``wv``/``wg`` and rows
    of ``wo``, every other leaf whole (``w_base``, ``dec_b`` 's output,
    ``u`` and ``ln_x`` sliced here to those heads), and ``state`` its heads
    of the wkv state; the per-head group norm is local, and wo's partial
    sums add over ``part.group``."""
    hd = cfg.rwkv.head_dim
    dt = x.dtype
    B, S, _ = x.shape
    d = tm["wr"].shape[1]                       # this rank's heads' channels
    H = d // hd
    c0, group = (0, None) if part is None else part
    ch = slice(c0, c0 + d)

    shifted, new_prev = _token_shift(x, prev_x)
    delta = shifted - x
    # data-dependent mixing: mu_t = mu + tanh(x @ A) @ B, per r/k/v/g/w
    lo = torch.tanh(x @ tm["mix_a"].to(dt)).reshape(B, S, 5,
                                                     cfg.rwkv.mix_lora)
    dyn = torch.einsum("bsfr,frd->bsfd", lo, tm["mix_b"].to(dt))
    mix = tm["mu"].to(dt)[None, None] + dyn                   # (B, S, 5, d)
    xr, xk, xv, xg, xw = (x + delta * mix[:, :, i] for i in range(5))

    r = (xr @ tm["wr"].to(dt)).reshape(B, S, H, hd)
    k = (xk @ tm["wk"].to(dt)).reshape(B, S, H, hd)
    v = (xv @ tm["wv"].to(dt)).reshape(B, S, H, hd)
    g = F.silu(xg @ tm["wg"].to(dt))
    # data-dependent decay in float32, rounded to the compute dtype before
    # the scan, as in the reference
    lora = torch.tanh(xw @ tm["dec_a"].to(dt)).float()
    wd = tm["w_base"][ch].float() + lora @ tm["dec_b"][:, ch].float()
    w = torch.exp(-torch.exp(wd)).reshape(B, S, H, hd)
    y, state = wkv_op.wkv6(r, k, v, w.to(dt), tm["u"][c0 // hd:c0 // hd + H],
                           state, seq_mask=seq_mask)

    # per-head group norm (population variance)
    y32 = y.float()
    mean = y32.mean(-1, keepdim=True)
    var = y32.var(-1, keepdim=True, correction=0)
    y = ((y32 - mean) * torch.rsqrt(var + 64e-5)).to(dt)
    y = (y.reshape(B, S, d) * tm["ln_x"][ch].to(dt)) * g
    return reduce_over(y @ tm["wo"].to(dt), group), new_prev, state


def apply_channel_mix(cm, cfg, x, prev_x, *, parts=(None, None)):
    """``parts`` (serving on a mesh): the ``partitioning.Part`` s of this
    rank's hidden units of ``wk`` and of its output channels of ``wv`` and
    ``wr`` (the serve layout splits both weights' output dims): k is
    gathered whole before ``wv``, and the output after it."""
    dt = x.dtype
    shifted, new_prev = _token_shift(x, prev_x)
    delta = shifted - x
    xk = x + delta * cm["mu_k"].to(dt)
    xr = x + delta * cm["mu_r"].to(dt)
    k_group, out_group = (None if p is None else p.group for p in parts)
    k = gather_over(torch.square(F.relu(xk @ cm["wk"].to(dt))), k_group, -1)
    return (gather_over(torch.sigmoid(xr @ cm["wr"].to(dt))
                        * (k @ cm["wv"].to(dt)), out_group, -1), new_prev)


def init_rwkv_state(cfg, batch, dtype, device):
    d = cfg.d_model
    hd = cfg.rwkv.head_dim
    return {
        "wkv": torch.zeros(batch, d // hd, hd, hd, dtype=torch.float32,
                           device=device),
        "tm_prev": torch.zeros(batch, d, dtype=dtype, device=device),
        "cm_prev": torch.zeros(batch, d, dtype=dtype, device=device),
    }
