"""Decoder stack over the dense attention block kinds (attn / local / global).

The reference stacks its repeated layers on a leading axis and runs them
under ``lax.scan``; here the stack is a plain list of per-layer parameter
dicts in execution order (``prefix_pattern`` layers first, then the repeats
of ``block_pattern``) and a Python loop runs them. The other block kinds of
the reference (moe, rwkv, hymba, xattn) are not ported yet.
"""
from __future__ import annotations

from typing import List

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.config import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import apply_mlp, init_mlp, rms_norm

ATTN_KINDS = ("attn", "local", "global")


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """Block kind of every layer, in execution order."""
    return list(cfg.prefix_pattern) + list(cfg.block_pattern) * cfg.num_repeats


def _check_kind(kind: str):
    if kind not in ATTN_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ported: {ATTN_KINDS})")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_block(cfg: ModelConfig, kind: str, dtype, device, gen):
    _check_kind(kind)
    d = cfg.d_model
    return {"ln1": torch.ones(d, dtype=dtype, device=device),
            "ln2": torch.ones(d, dtype=dtype, device=device),
            "attn": attn_mod.init_attention(cfg, dtype, device, gen),
            "mlp": init_mlp(d, cfg.d_ff, dtype, device, gen)}


def init_stack(cfg: ModelConfig, dtype, device, gen):
    return [init_block(cfg, kind, dtype, device, gen)
            for kind in layer_kinds(cfg)]


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype, device, *, kv_pages=None):
    """``kv_pages=(num_pages, page_size)`` makes the K/V leaves physical page
    pools (num_pages, page_size, KV, hd) shared by all slots
    (``attention.paged_pool``) instead of (batch, max_len, KV, hd)."""
    _check_kind(kind)
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    if kv_pages is not None:
        np_, ps = kv_pages
        return {name: attn_mod.paged_pool(np_, ps, kv, hd, dtype, device)
                for name in ("k", "v")}
    shape = (batch, max_len, kv, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


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


def apply_block(params, cfg: ModelConfig, kind: str, x, *, positions,
                cache=None, cache_len=None, mode: str = "train", paged=None):
    """Returns (x_out, new_cache).

    mode: "train" (no cache), "prefill" (writes the full-sequence K/V into
    ``cache`` at positions [0, S)), "decode" (x is (B, 1, d), ``cache_len``
    (B,) tokens already in cache; K/V written in place at cache_len).
    ``paged=(block_table, page_size)`` selects the paged-KV decode path
    (decode mode only)."""
    _check_kind(kind)
    h = rms_norm(x, params["ln1"], eps=cfg.rms_eps)
    new_cache = cache
    if mode == "decode":
        a, (kc, vc) = attn_mod.attention_block(
            params["attn"], cfg, h, positions, kind=kind,
            kv_cache=(cache["k"], cache["v"]), cache_len=cache_len,
            paged=paged)
        new_cache = dict(cache, k=kc, v=vc)
    else:
        a, (k, v) = attn_mod.attention_block(params["attn"], cfg, h,
                                             positions, kind=kind)
        if mode == "prefill":
            S = x.shape[1]
            cache["k"][:, :S] = k.to(cache["k"].dtype)
            cache["v"][:, :S] = v.to(cache["v"].dtype)
    x = x + a
    h2 = rms_norm(x, params["ln2"], eps=cfg.rms_eps)
    return x + apply_mlp(params["mlp"], h2), new_cache


def apply_stack(params, cfg: ModelConfig, x, *, positions, cache=None,
                cache_len=None, mode: str = "train", remat: bool = False,
                paged=None):
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
                                cache=c, cache_len=cache_len, mode=mode,
                                paged=paged)
        if new_cache is not None:
            new_cache.append(nc)
    return x, new_cache


def _train_block(params, cfg, kind, x, positions):
    return apply_block(params, cfg, kind, x, positions=positions)[0]
