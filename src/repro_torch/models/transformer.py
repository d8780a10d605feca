"""Decoder stack over the ported block kinds: the attention kinds (attn /
local / global), the hybrid ``hymba`` (parallel sliding-window attention and
SSM heads, fused by learned scalars, shared MLP) and the attention-free
``rwkv`` (RWKV6 time-mix + channel-mix).

The reference stacks its repeated layers on a leading axis and runs them
under ``lax.scan``; here the stack is a plain list of per-layer parameter
dicts in execution order (``prefix_pattern`` layers first, then the repeats
of ``block_pattern``) and a Python loop runs them. The reference's moe and
xattn kinds are not ported yet.

Cache leaves: attention K/V are the dict keys ``"k"``/``"v"`` (dense
(batch, max_len, KV, hd) or paged pools); every other leaf (hymba's
``ssm``/``conv``, rwkv's ``wkv``/``tm_prev``/``cm_prev``) is per slot, with
no length axis. All of them are updated in place by prefill and decode.
"""
from __future__ import annotations

from typing import List

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.config import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import apply_mlp, init_mlp, rms_norm

ATTN_KINDS = ("attn", "local", "global")
PORTED_KINDS = ATTN_KINDS + ("hymba", "rwkv")


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """Block kind of every layer, in execution order."""
    return list(cfg.prefix_pattern) + list(cfg.block_pattern) * cfg.num_repeats


def _check_kind(kind: str):
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ported: {PORTED_KINDS})")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_block(cfg: ModelConfig, kind: str, dtype, device, gen):
    _check_kind(kind)
    d = cfg.d_model

    def ones():
        return torch.ones(d, dtype=dtype, device=device)

    if kind == "rwkv":        # the reference's key order: ln2 after tm, cm
        return {"ln1": ones(), **rwkv_mod.init_rwkv_block(cfg, dtype, device,
                                                          gen),
                "ln2": ones()}
    p = {"ln1": ones(), "ln2": ones(),
         "attn": attn_mod.init_attention(cfg, dtype, device, gen)}
    if kind == "hymba":
        p["ssm"] = ssm_mod.init_ssm(cfg, dtype, device, gen)
        p["fuse_norm_a"] = ones()
        p["fuse_norm_s"] = ones()
        p["beta"] = torch.full((2,), 0.5, dtype=dtype, device=device)
    p["mlp"] = init_mlp(d, cfg.d_ff, dtype, device, gen)
    return p


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype, device, *, kv_pages=None):
    """``kv_pages=(num_pages, page_size)`` makes the K/V leaves physical page
    pools (num_pages, page_size, KV, hd) shared by all slots
    (``attention.paged_pool``) instead of (batch, max_len, KV, hd); the
    recurrent state leaves keep their per-slot batch axis."""
    _check_kind(kind)
    if kind == "rwkv":
        return rwkv_mod.init_rwkv_state(cfg, batch, dtype, device)
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    if kv_pages is not None:
        np_, ps = kv_pages
        c = {name: attn_mod.paged_pool(np_, ps, kv, hd, dtype, device)
             for name in ("k", "v")}
    else:
        shape = (batch, max_len, kv, hd)
        c = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
    if kind == "hymba":
        di = ssm_mod.d_inner_of(cfg)
        c["ssm"] = torch.zeros(batch, di, cfg.ssm.state_dim,
                               dtype=torch.float32, device=device)
        c["conv"] = torch.zeros(batch, cfg.ssm.conv_dim - 1, di, dtype=dtype,
                                device=device)
    return c


def init_stack_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                     device, *, kv_pages=None):
    return [init_block_cache(cfg, kind, batch, max_len, dtype, device,
                             kv_pages=kv_pages)
            for kind in layer_kinds(cfg)]


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------


def _gather_last(x, lengths):
    """x: (B, S, d), lengths: (B,) -> (B, d) = x[b, lengths[b]-1]."""
    idx = (lengths.to(torch.int64) - 1).clamp_min(0)
    return x[torch.arange(x.shape[0], device=x.device), idx]


def _store(cache, name, value):
    """Write a per-slot state leaf in place (a no-op where the scan kernel
    already updated the cache tensor itself)."""
    if cache[name] is not value:
        cache[name].copy_(value)


def _attention(params, cfg, kind, h, positions, cache, cache_len, mode,
               paged):
    """The attention sub-block of the attention kinds and hymba: decode
    writes the token's K/V in place, prefill writes the full-sequence K/V
    into the cache at positions [0, S)."""
    if mode == "decode":
        a, _ = attn_mod.attention_block(
            params["attn"], cfg, h, positions, kind=kind,
            kv_cache=(cache["k"], cache["v"]), cache_len=cache_len,
            paged=paged)
        return a
    a, (k, v) = attn_mod.attention_block(params["attn"], cfg, h, positions,
                                         kind=kind)
    if mode == "prefill":
        S = h.shape[1]
        cache["k"][:, :S] = k.to(cache["k"].dtype)
        cache["v"][:, :S] = v.to(cache["v"].dtype)
    return a


def apply_block(params, cfg: ModelConfig, kind: str, x, *, positions,
                cache=None, cache_len=None, seq_mask=None, lengths=None,
                mode: str = "train", paged=None):
    """Returns (x_out, new_cache).

    mode: "train" (no cache), "prefill" (seeds ``cache`` from right-padded
    rows: K/V at positions [0, S); the recurrent state frozen over the pads
    by ``seq_mask`` (B, S) and the conv tail and token-shift carries taken
    at each row's last real token, ``lengths`` (B,)), "decode" (x is
    (B, 1, d), ``cache_len`` (B,) tokens already in cache; K/V written in
    place at cache_len, the state advanced in place, for inactive slots
    too, as in the reference). ``paged=(block_table, page_size)`` selects
    the paged-KV decode path (decode mode only). The cache is updated in
    place and returned."""
    _check_kind(kind)
    if kind == "rwkv":
        st = cache if cache is not None else rwkv_mod.init_rwkv_state(
            cfg, x.shape[0], x.dtype, x.device)
        h = rms_norm(x, params["ln1"], eps=cfg.rms_eps)
        y, tm_prev, wkv = rwkv_mod.apply_time_mix(
            params["tm"], cfg, h, st["tm_prev"], st["wkv"],
            seq_mask=seq_mask)
        if lengths is not None:
            tm_prev = _gather_last(h, lengths)
        x = x + y
        h2 = rms_norm(x, params["ln2"], eps=cfg.rms_eps)
        y2, cm_prev = rwkv_mod.apply_channel_mix(params["cm"], cfg, h2,
                                                 st["cm_prev"])
        if lengths is not None:
            cm_prev = _gather_last(h2, lengths)
        if cache is not None:
            _store(cache, "wkv", wkv)
            _store(cache, "tm_prev", tm_prev)
            _store(cache, "cm_prev", cm_prev)
        return x + y2, cache

    h = rms_norm(x, params["ln1"], eps=cfg.rms_eps)
    a = _attention(params, cfg, "local" if kind == "hymba" else kind, h,
                   positions, cache, cache_len, mode, paged)
    if kind == "hymba":
        if mode == "decode":
            s, ssm_st, conv_st = ssm_mod.apply_ssm(
                params["ssm"], cfg, h, cache["ssm"], cache["conv"])
        else:
            s, ssm_st, conv_st = ssm_mod.apply_ssm(
                params["ssm"], cfg, h, None, None, seq_mask=seq_mask,
                lengths=lengths)
        if cache is not None:
            _store(cache, "ssm", ssm_st)
            _store(cache, "conv", conv_st)
        beta = params["beta"].to(x.dtype)
        a = (beta[0] * rms_norm(a, params["fuse_norm_a"], eps=cfg.rms_eps)
             + beta[1] * rms_norm(s, params["fuse_norm_s"], eps=cfg.rms_eps))
    x = x + a
    h2 = rms_norm(x, params["ln2"], eps=cfg.rms_eps)
    return x + apply_mlp(params["mlp"], h2), cache


def apply_stack(params, cfg: ModelConfig, x, *, positions, cache=None,
                cache_len=None, seq_mask=None, lengths=None,
                mode: str = "train", remat: bool = False, paged=None):
    """Run all layers. Returns (x, new_cache).

    ``remat`` (train mode, with autograd on): each layer runs under
    ``torch.utils.checkpoint``, keeping only its input and recomputing its
    activations in the backward — the reference's ``jax.checkpoint`` of the
    scanned layer body. ``paged`` (the block table and page size) is shared
    by every layer; each layer has its own page pools."""
    new_cache = None if cache is None else []
    ckpt = remat and mode == "train" and torch.is_grad_enabled()
    for i, kind in enumerate(layer_kinds(cfg)):
        c = cache[i] if cache is not None else None
        if ckpt:
            x = checkpoint(_train_block, params[i], cfg, kind, x, positions,
                           use_reentrant=False)
            nc = None
        else:
            x, nc = apply_block(params[i], cfg, kind, x, positions=positions,
                                cache=c, cache_len=cache_len,
                                seq_mask=seq_mask, lengths=lengths,
                                mode=mode, paged=paged)
        if new_cache is not None:
            new_cache.append(nc)
    return x, new_cache


def _train_block(params, cfg, kind, x, positions):
    return apply_block(params, cfg, kind, x, positions=positions)[0]
