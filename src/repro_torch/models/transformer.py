"""Decoder stack over the reference's block kinds: the attention kinds (attn
/ local / global), ``moe`` (self-attention + a mixture-of-experts FFN), the
VLM's ``xattn`` (tanh-gated cross-attention to media tokens + a tanh-gated
MLP), the hybrid ``hymba`` (parallel sliding-window attention and SSM heads,
fused by learned scalars, shared MLP) and the attention-free ``rwkv``
(RWKV6 time-mix + channel-mix).

The reference stacks its repeated layers on a leading axis and runs them
under ``lax.scan``; here the stack is a plain list of per-layer parameter
dicts in execution order (``prefix_pattern`` layers first, then the repeats
of ``block_pattern``) and a Python loop runs them. Every block returns its
router loss (zero but for ``moe``), and the stack sums them.

Cache leaves: attention K/V are the dict keys ``"k"``/``"v"`` (dense
(batch, max_len, KV, hd) or paged pools); every other leaf (xattn's media
K/V ``mk``/``mv`` (batch, M, KV, hd), hymba's ``ssm``/``conv``, rwkv's
``wkv``/``tm_prev``/``cm_prev``) is per slot, with no length axis. All of
them are updated in place by prefill (``mk``/``mv`` only there) and decode.
"""
from __future__ import annotations

from typing import List

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.config import VALID_BLOCK_KINDS, ModelConfig
from repro_torch.common.partitioning import (gather_over,
                                             get_activation_mesh,
                                             is_sharded, on_rows,
                                             over_channels, part_of,
                                             shard_activation, store)
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.moe_shardmap import apply_moe_shardmap
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import apply_mlp, init_mlp, rms_norm


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """Block kind of every layer, in execution order."""
    return list(cfg.prefix_pattern) + list(cfg.block_pattern) * cfg.num_repeats


def _check_kind(kind: str):
    if kind not in VALID_BLOCK_KINDS:
        raise ValueError(f"unknown block kind {kind!r} (known: "
                         f"{VALID_BLOCK_KINDS})")


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
    if kind == "xattn":
        return {"ln1": ones(), "ln2": ones(),
                "xattn": attn_mod.init_attention(cfg, dtype, device, gen,
                                                 cross=True),
                "mlp": init_mlp(d, cfg.d_ff, dtype, device, gen),
                "mlp_gate": torch.zeros((), dtype=dtype, device=device)}
    p = {"ln1": ones(), "ln2": ones(),
         "attn": attn_mod.init_attention(cfg, dtype, device, gen)}
    if kind == "moe":
        p["moe"] = moe_mod.init_moe(cfg, dtype, device, gen)
        return p
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
    recurrent state and media K/V leaves keep their per-slot batch axis."""
    _check_kind(kind)
    if kind == "rwkv":
        return rwkv_mod.init_rwkv_state(cfg, batch, dtype, device)
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    if kind == "xattn":       # static per request: written at prefill
        shape = (batch, cfg.cross_attn.num_media_tokens, kv, hd)
        return {"mk": torch.zeros(shape, dtype=dtype, device=device),
                "mv": torch.zeros(shape, dtype=dtype, device=device)}
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


def _rows(t):
    """A sub-block's output (B, S, d) laid out as the residual stream on a
    mesh: rows over the batch axes, whole on "model" (its row-parallel
    product's pending sum reduced here). Left to itself DTensor would
    reduce-scatter the sum onto the rows, splitting a row count that does
    not divide the whole mesh unevenly, which a later view cannot undo."""
    return shard_activation(t, "dp", None, None)


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
    kv_cache = None if mode == "train" else (cache["k"], cache["v"])
    a, _ = attn_mod.attention_block(
        params["attn"], cfg, h, positions, kind=kind, kv_cache=kv_cache,
        cache_len=cache_len if mode == "decode" else None, paged=paged)
    return a


def _moe_ffn(params, cfg, h2, mode="train"):
    """The moe block's FFN and its router loss, dispatched as the reference
    does. Decode (one token a row) and ``dispatch == "dense"`` take the
    dropless dense dispatch: capacity at a token count of one would drop
    whole tokens and break decode / full-forward consistency.
    ``"shardmap"`` in training under an active mesh with a "model" axis
    takes the expert-parallel all-to-all (``models/moe_shardmap``);
    everything else the capacity-bounded sparse dispatch. Training on a
    mesh runs the dense and sparse dispatches whole on every rank (their
    capacity is the whole batch's), on all rows gathered. Serving on a
    mesh runs them on each rank's own experts and range of the shared
    experts (the serve layout), the dense one on the rank's own rows, the
    sparse one on all rows; the partial outputs sum over the expert axes,
    and the router loss, a training quantity, is not computed (None)."""
    if cfg.moe.dispatch == "shardmap" and mode == "train":
        mesh = get_activation_mesh()
        if mesh is not None and "model" in mesh.mesh_dim_names \
                and is_sharded(h2):
            return apply_moe_shardmap(params["moe"], cfg, h2, mesh)
    dense = cfg.moe.dispatch == "dense" or h2.shape[1] == 1
    fn = moe_mod.apply_moe if dense else moe_mod.apply_moe_sparse
    if mode != "train" and is_sharded(h2):
        p = params["moe"]
        parts = dict(part=part_of(p["wi"], 0),
                     shared_part=(part_of(p["shared"]["wo"], 0)
                                  if "shared" in p else None))
        return over_channels(lambda x, p_: fn(p_, cfg, x, **parts)[0],
                             (h2,), p, whole=not dense), None
    return on_rows(lambda x, p: fn(p, cfg, x), (h2,), params["moe"],
                   n_rep=1, whole=True)


def _ssm_on_mesh(p, cfg, h, cache, mode, seq_mask, lengths):
    """hymba's SSM heads serving on a mesh: each rank's rows and channels
    (``partitioning.over_channels``), its shards of the ``ssm`` and
    ``conv`` leaves written in place (decode advances the state; prefill
    starts it from zeros, as the reference's does)."""
    part = part_of(p["conv"], 1)
    if part is not None and p["in_proj"].dim() == 2:
        raise ValueError(
            "hymba's SSM on a mesh reads in_proj in the serve form "
            "(d, 2, di): make the params with launch/sharding.shard_params("
            "..., serve_tp_only=True)")

    def run(h_, sm, ln, p_, ssm_st, conv_st):
        if mode == "decode":
            s, st, cv = ssm_mod.apply_ssm(p_, cfg, h_, ssm_st, conv_st,
                                          part=part)
        else:
            s, st, cv = ssm_mod.apply_ssm(p_, cfg, h_, ssm_st.zero_(), None,
                                          seq_mask=sm, lengths=ln, part=part)
        if st is not ssm_st:
            ssm_st.copy_(st)
        conv_st.copy_(cv)
        return s

    return over_channels(run, (h, seq_mask, lengths), p,
                         (cache["ssm"], cache["conv"]))


def _rwkv(params, cfg, x, st, *, seq_mask=None, lengths=None,
          parts=(None, None, None)):
    """The rwkv block on plain tensors from the state ``st``: (x_out, wkv,
    tm_prev, cm_prev). ``parts`` (serving on a mesh): the
    ``partitioning.Part`` s of this rank's heads, channel-mix hidden units
    and channel-mix output channels."""
    h = rms_norm(x, params["ln1"], eps=cfg.rms_eps)
    y, tm_prev, wkv = rwkv_mod.apply_time_mix(
        params["tm"], cfg, h, st["tm_prev"], st["wkv"], seq_mask=seq_mask,
        part=parts[0])
    if lengths is not None:
        tm_prev = _gather_last(h, lengths)
    x = x + y
    h2 = rms_norm(x, params["ln2"], eps=cfg.rms_eps)
    y2, cm_prev = rwkv_mod.apply_channel_mix(params["cm"], cfg, h2,
                                             st["cm_prev"], parts=parts[1:])
    if lengths is not None:
        cm_prev = _gather_last(h2, lengths)
    return x + y2, wkv, tm_prev, cm_prev


def _rwkv_on_mesh(params, cfg, x, cache, seq_mask, lengths):
    """The rwkv block serving on a mesh: each rank's rows and heads
    (``partitioning.over_channels``), its shard of ``wkv`` advanced in
    place; the token-shift carries, split over "model" in the
    ``shard_seq`` layout, gathered whole to be read, and each rank's slice
    written back."""
    tm, cm = params["tm"], params["cm"]
    parts = (part_of(tm["wr"], 1), part_of(cm["wk"], 1),
             part_of(cm["wr"], 1))
    c0, group = part_of(cache["tm_prev"], 1) or (0, None)

    def run(x_, sm, ln, p, wkv, tm_prev, cm_prev):
        st = {"wkv": wkv, "tm_prev": gather_over(tm_prev, group, 1),
              "cm_prev": gather_over(cm_prev, group, 1)}
        out, new_wkv, new_tm, new_cm = _rwkv(p, cfg, x_, st, seq_mask=sm,
                                             lengths=ln, parts=parts)
        if new_wkv is not wkv:
            wkv.copy_(new_wkv)
        tm_prev.copy_(new_tm[:, c0:c0 + tm_prev.shape[1]])
        cm_prev.copy_(new_cm[:, c0:c0 + cm_prev.shape[1]])
        return out

    return over_channels(run, (x, seq_mask, lengths), params,
                         (cache["wkv"], cache["tm_prev"], cache["cm_prev"]))


def apply_block(params, cfg: ModelConfig, kind: str, x, *, positions,
                media=None, cache=None, cache_len=None, seq_mask=None,
                lengths=None, mode: str = "train", paged=None):
    """Returns (x_out, new_cache, aux): ``aux`` the block's router loss,
    float32, for ``moe``, and None for every other kind.

    mode: "train" (no cache), "prefill" (seeds ``cache`` from right-padded
    rows: K/V at positions [0, S); the recurrent state frozen over the pads
    by ``seq_mask`` (B, S) and the conv tail and token-shift carries taken
    at each row's last real token, ``lengths`` (B,); xattn's media K/V from
    ``media`` (B, M, d), the projected media), "decode" (x is (B, 1, d),
    ``cache_len`` (B,) tokens already in cache; K/V written in place at
    cache_len, the state advanced in place, for inactive slots too, as in
    the reference; xattn reads its cached media K/V). ``paged=(block_table,
    page_size)`` selects the paged-KV decode path (decode mode only). The
    cache is updated in place and returned."""
    _check_kind(kind)
    aux = None
    if kind == "xattn":
        h = rms_norm(x, params["ln1"], eps=cfg.rms_eps)
        media_kv = None
        if mode == "decode" and cache is not None:
            media_kv = (cache["mk"], cache["mv"])
        a, (mk, mv) = attn_mod.cross_attention_block(
            params["xattn"], cfg, h, media, media_kv=media_kv)
        if mode == "prefill" and cache is not None:
            store(cache["mk"], mk)
            store(cache["mv"], mv)
        x = x + _rows(a)
        h2 = rms_norm(x, params["ln2"], eps=cfg.rms_eps)
        f = apply_mlp(params["mlp"], h2)
        return (x + _rows(torch.tanh(params["mlp_gate"].to(x.dtype)) * f),
                cache, aux)
    if kind == "rwkv" and is_sharded(x):
        if cache is not None:           # serving on a mesh
            return (_rwkv_on_mesh(params, cfg, x, cache, seq_mask, lengths),
                    cache, aux)
        # training on a mesh: the block on each rank's own rows
        return on_rows(lambda x_, p: apply_block(p, cfg, kind, x_,
                                                 positions=None)[0],
                       (x,), params), cache, aux
    if kind == "rwkv":
        st = cache if cache is not None else rwkv_mod.init_rwkv_state(
            cfg, x.shape[0], x.dtype, x.device)
        x, wkv, tm_prev, cm_prev = _rwkv(params, cfg, x, st,
                                         seq_mask=seq_mask, lengths=lengths)
        if cache is not None:
            _store(cache, "wkv", wkv)
            _store(cache, "tm_prev", tm_prev)
            _store(cache, "cm_prev", cm_prev)
        return x, cache, aux

    h = rms_norm(x, params["ln1"], eps=cfg.rms_eps)
    a = _rows(_attention(params, cfg, "local" if kind == "hymba" else kind,
                         h, positions, cache, cache_len, mode, paged))
    if kind == "hymba" and cache is not None and is_sharded(h):
        s = _ssm_on_mesh(params["ssm"], cfg, h, cache, mode, seq_mask,
                         lengths)                   # serving on a mesh
    elif kind == "hymba":
        if mode == "decode":
            s, ssm_st, conv_st = ssm_mod.apply_ssm(
                params["ssm"], cfg, h, cache["ssm"], cache["conv"])
        elif is_sharded(h):             # training on a mesh: own rows
            s = on_rows(lambda h_, p: ssm_mod.apply_ssm(p, cfg, h_)[0],
                        (h,), params["ssm"])
        else:
            s, ssm_st, conv_st = ssm_mod.apply_ssm(
                params["ssm"], cfg, h, None, None, seq_mask=seq_mask,
                lengths=lengths)
        if cache is not None:
            _store(cache, "ssm", ssm_st)
            _store(cache, "conv", conv_st)
    if kind == "hymba":
        beta = params["beta"].to(x.dtype)
        a = (beta[0] * rms_norm(a, params["fuse_norm_a"], eps=cfg.rms_eps)
             + beta[1] * rms_norm(s, params["fuse_norm_s"], eps=cfg.rms_eps))
    x = x + a
    h2 = rms_norm(x, params["ln2"], eps=cfg.rms_eps)
    if kind == "moe":
        f, aux = _moe_ffn(params, cfg, h2, mode)
        return x + _rows(f), cache, aux
    return x + _rows(apply_mlp(params["mlp"], h2)), cache, aux


def apply_stack(params, cfg: ModelConfig, x, *, positions, media=None,
                cache=None, cache_len=None, seq_mask=None, lengths=None,
                mode: str = "train", remat: bool = False, paged=None):
    """Run all layers. Returns (x, new_cache, aux): ``aux`` the sum of the
    layers' router losses, float32.

    ``remat`` (train mode, with autograd on): each layer runs under
    ``torch.utils.checkpoint``, keeping only its input and recomputing its
    activations in the backward — the reference's ``jax.checkpoint`` of the
    scanned layer body. ``paged`` (the block table and page size) is shared
    by every layer; each layer has its own page pools. ``media`` (B, M, d),
    the projected media, is read by every xattn layer."""
    new_cache = None if cache is None else []
    aux_total = None
    ckpt = remat and mode == "train" and torch.is_grad_enabled()
    for i, kind in enumerate(layer_kinds(cfg)):
        c = cache[i] if cache is not None else None
        aux = None
        if ckpt and kind == "moe":
            x, aux = checkpoint(_train_block, params[i], cfg, kind, x,
                                positions, media, use_reentrant=False)
            nc = None
        elif ckpt:
            x = checkpoint(_train_block, params[i], cfg, kind, x, positions,
                           media, use_reentrant=False)
            nc = None
        else:
            x, nc, aux = apply_block(params[i], cfg, kind, x,
                                     positions=positions, media=media,
                                     cache=c, cache_len=cache_len,
                                     seq_mask=seq_mask, lengths=lengths,
                                     mode=mode, paged=paged)
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux
        if new_cache is not None:
            new_cache.append(nc)
    if aux_total is None:
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, new_cache, aux_total


def _train_block(params, cfg, kind, x, positions, media):
    """One layer in train mode: x, or (x, aux) for a moe layer."""
    x, _, aux = apply_block(params, cfg, kind, x, positions=positions,
                            media=media)
    return x if aux is None else (x, aux)
