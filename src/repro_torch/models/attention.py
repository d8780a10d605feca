"""GQA attention: chunked-causal (flash-style online softmax) for prefill,
single-token decode against the dense or the paged KV cache, and the VLM's
non-causal cross-attention to media tokens.

:func:`chunked_attention` and :func:`decode_attention` are the plain PyTorch
versions of the prefill and decode kernels (``hopper/flash_attn.py``,
``hopper/decode_attn.py``) and the ports of the JAX functions of the same
names; :func:`paged_gather_kv` followed by :func:`decode_attention` is the
plain version of the paged decode kernel (``hopper/paged_decode_attn.py``).
:func:`attention_block` calls the kernel wrappers, which take the plain
versions for CPU tensors and launch the CUDA kernels for CUDA tensors.
"""
from __future__ import annotations

import torch

from repro_torch.common.partitioning import (over_heads, part_of,
                                             shard_start, split_heads)
from repro_torch.hopper import decode_attn as decode_op
from repro_torch.hopper import flash_attn as flash_op
from repro_torch.hopper import paged_decode_attn as paged_op
from repro_torch.models.layers import apply_rope, dense_init, rms_norm, softcap

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------


def init_attention(cfg, dtype, device, gen, *, cross: bool = False):
    """Self-attention projections (with qk-norm scales where the config has
    them); ``cross`` makes the cross-attention's: no qk-norm, and the
    llama-vision tanh ``gate``, zero at init."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init((d, h * hd), dtype, device, gen),
        "wk": dense_init((d, kv * hd), dtype, device, gen),
        "wv": dense_init((d, kv * hd), dtype, device, gen),
        "wo": dense_init((h * hd, d), dtype, device, gen, fan_in=h * hd),
    }
    if cfg.qk_norm and not cross:
        p["q_norm"] = torch.ones(hd, dtype=dtype, device=device)
        p["k_norm"] = torch.ones(hd, dtype=dtype, device=device)
    if cross:
        p["gate"] = torch.zeros((), dtype=dtype, device=device)
    return p


# ---------------------------------------------------------------------------
# core chunked attention (flash-style online softmax) and its backward
# ---------------------------------------------------------------------------


def _mask_for(q_pos, k_pos, Sk, *, causal, window):
    mask = (k_pos < Sk)[None, :]                                 # kv padding
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window > 0:
        mask = mask & ((q_pos[:, None] - k_pos[None, :]) < window)
    return mask                                                   # (bq, bk)


def chunked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      attn_softcap: float = 0.0, scale: float = 0.0,
                      q_offset: int = 0, block_q: int = 512,
                      block_k: int = 512, return_lse: bool = False):
    """Blocked attention with an online softmax in float32.

    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) with H a multiple of KV (GQA,
    grouped: no head repetition is materialised). ``q_offset`` is the
    absolute position of query 0. Returns (B, Sq, H, hd) in q's dtype and,
    with ``return_lse``, also the logsumexp of each row's scores, float32
    (B, H, Sq) — the reference's ``L`` (B, G, R, Sq) with (G, R) flattened,
    which the backward reads."""
    B, Sq, H, hd = q.shape
    Sk, G = k.shape[1], k.shape[2]
    R = H // G
    if scale <= 0.0:
        scale = hd ** -0.5
    block_q = min(block_q, max(Sq, 8))
    block_k = min(block_k, max(Sk, 8))
    dev = q.device
    qg = q.float().reshape(B, Sq, G, R, hd)
    kf, vf = k.float(), v.float()
    outs, lses = [], []
    for q0 in range(0, Sq, block_q):
        q_blk = qg[:, q0:q0 + block_q]
        bq = q_blk.shape[1]
        q_pos = q_offset + q0 + torch.arange(bq, device=dev)
        m_run = torch.full((B, G, R, bq), NEG_INF, device=dev)
        l_run = torch.zeros((B, G, R, bq), device=dev)
        acc = torch.zeros((B, bq, G, R, hd), device=dev)
        for k0 in range(0, Sk, block_k):
            k_blk, v_blk = kf[:, k0:k0 + block_k], vf[:, k0:k0 + block_k]
            k_pos = k0 + torch.arange(k_blk.shape[1], device=dev)
            mask = _mask_for(q_pos, k_pos, Sk, causal=causal, window=window)
            s = torch.einsum("bqgrd,bkgd->bgrqk", q_blk, k_blk) * scale
            if attn_softcap > 0.0:
                s = softcap(s, attn_softcap)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(dim=-1))           # (B,G,R,bq)
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            pv = torch.einsum("bgrqk,bkgd->bqgrd", p, v_blk)
            acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
            m_run = m_new
        lnorm = l_run.clamp_min(1e-30).permute(0, 3, 1, 2)        # (B,bq,G,R)
        outs.append(acc / lnorm[..., None])
        lses.append(m_run + torch.log(l_run.clamp_min(1e-30)))
    out = torch.cat(outs, dim=1).reshape(B, Sq, H, hd).to(q.dtype)
    if return_lse:
        return out, torch.cat(lses, dim=-1).reshape(B, H, Sq)
    return out


def flash_attention_bwd_plain(q, k, v, out, lse, dout, *, causal=True,
                              window=0, attn_softcap=0.0, scale=0.0,
                              block_q=512, block_k=512):
    """Flash-attention backward in plain PyTorch: the port of the
    reference's ``_flash_bwd``. Recomputes each probability block from the
    saved logsumexp ``lse`` (B, H, Sq) instead of storing the (Sq, Sk)
    probabilities. One loop over (q block, kv block) pairs accumulates dq,
    dk and dv (the reference and the kernel split it into a q-major pass
    for dq and a kv-major pass for dk and dv). Grouped GQA: dk/dv of KV
    head g sum over its H/KV query heads. Returns (dq, dk, dv) in the
    dtypes of q, k, v."""
    B, Sq, H, hd = q.shape
    Sk, G = k.shape[1], k.shape[2]
    R = H // G
    if scale <= 0.0:
        scale = hd ** -0.5
    block_q = min(block_q, max(Sq, 8))
    block_k = min(block_k, max(Sk, 8))
    dev = q.device
    qg = q.float().reshape(B, Sq, G, R, hd)
    dog = dout.float().reshape(B, Sq, G, R, hd)
    kf, vf = k.float(), v.float()
    Lg = lse.float().reshape(B, G, R, Sq)
    # D_i = rowsum(dout * out), grouped (B, G, R, Sq)
    Dg = (dout.float() * out.float()).sum(-1).reshape(
        B, Sq, G, R).permute(0, 2, 3, 1)

    dq = torch.zeros(B, Sq, G, R, hd, device=dev)
    dk = torch.zeros(B, Sk, G, hd, device=dev)
    dv = torch.zeros(B, Sk, G, hd, device=dev)
    for q0 in range(0, Sq, block_q):
        qs = slice(q0, q0 + block_q)
        q_blk, do_blk = qg[:, qs], dog[:, qs]
        L_blk, D_blk = Lg[..., qs, None], Dg[..., qs, None]
        q_pos = q0 + torch.arange(q_blk.shape[1], device=dev)
        for k0 in range(0, Sk, block_k):
            ks = slice(k0, k0 + block_k)
            k_blk, v_blk = kf[:, ks], vf[:, ks]
            k_pos = k0 + torch.arange(k_blk.shape[1], device=dev)
            mask = _mask_for(q_pos, k_pos, Sk, causal=causal, window=window)
            s_raw = torch.einsum("bqgrd,bkgd->bgrqk", q_blk, k_blk) * scale
            s = softcap(s_raw, attn_softcap) if attn_softcap > 0.0 else s_raw
            p = torch.where(mask, torch.exp(s - L_blk), 0.0)
            dp = torch.einsum("bqgrd,bkgd->bgrqk", do_blk, v_blk)
            ds = p * (dp - D_blk)
            if attn_softcap > 0.0:
                th = torch.tanh(s_raw / attn_softcap)
                ds = ds * (1.0 - th * th)
            dq[:, qs] += torch.einsum("bgrqk,bkgd->bqgrd", ds, k_blk) * scale
            dv[:, ks] += torch.einsum("bgrqk,bqgrd->bkgd", p, do_blk)
            dk[:, ks] += torch.einsum("bgrqk,bqgrd->bkgd", ds, q_blk) * scale
    return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0,
                     attn_softcap: float = 0.0, scale: float = 0.0,
                     start: int = 0, return_lse: bool = False):
    """Single-token decode attention against a cache.

    q: (B, 1, H, hd); k_cache/v_cache: (B, L, KV, hd); cache_len: (B,) —
    number of valid cache entries *including* the current token's K/V (the
    cache is updated before calling). Scores and softmax in float32; the
    probabilities are rounded to the cache dtype before the value product,
    as in the reference.

    ``start``: the caches hold global positions [start, start + L) of a
    longer cache (a rank's slice of a length-split cache). ``return_lse``:
    also return each head's log-sum-exp over its unmasked scores, float32
    (B, H), and the output in float32, unrounded; a row with no unmasked
    position then returns zeros and -inf, so slices merge by
    :func:`merge_slices`' rule before their one rounding."""
    B, _, H, hd = q.shape
    L, KV = k_cache.shape[1], k_cache.shape[2]
    rep = H // KV
    if scale <= 0.0:
        scale = hd ** -0.5
    qg = q.float().reshape(B, 1, KV, rep, hd)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k_cache.float()) * scale
    if attn_softcap > 0.0:
        s = softcap(s, attn_softcap)
    pos = start + torch.arange(L, device=q.device)[None, :]      # (1, L)
    clen = cache_len.to(torch.int64)[:, None]
    mask = pos < clen
    if window > 0:
        mask = mask & (pos >= clen - window)
    s = torch.where(mask[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype).float()
    out = torch.einsum("bgrqk,bkgd->bqgrd", p, v_cache.float())
    out = out.reshape(B, 1, H, hd)
    if not return_lse:
        return out.to(q.dtype)
    live = mask.any(-1)                                          # (B,)
    lse = torch.where(live[:, None], torch.logsumexp(s, dim=-1).reshape(B, H),
                      float("-inf"))
    return torch.where(live[:, None, None, None], out, 0.0), lse


def merge_slices(out, lse, group):
    """The whole-cache decode output from each rank's slice of a cache
    whose length is split over the ranks of ``group``: ``out`` (B, 1, H,
    hd) and ``lse`` (B, H) of this rank's slice (:func:`decode_attention`
    with ``return_lse``, float32), merged in float32 by the log-sum-exp
    rule, m = max of lse, w = exp(lse - m), out = sum(w o) / sum(w), with
    plain collectives over ``group``. Every rank returns the same float32
    result."""
    import torch.distributed as dist
    m = lse.clone()
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    w = torch.exp(lse - torch.where(torch.isfinite(m), m, 0.0))  # (B, H)
    num = out.float() * w[:, None, :, None]
    dist.all_reduce(num, group=group)
    dist.all_reduce(w, group=group)
    return num / w.clamp_min(1e-30)[:, None, :, None]


# ---------------------------------------------------------------------------
# paged KV decode (block-table indirection; plain version = gather-to-dense)
# ---------------------------------------------------------------------------


def paged_pool(num_pages: int, page_size: int, kv: int, hd: int, dtype,
               device):
    """A zeroed physical page pool (NP, ps, KV, hd): a view of the first NP
    pages of a buffer that holds one more page, the *sink*. The sink takes
    the writes :func:`paged_write_kv` drops and is never read unmasked."""
    buf = torch.zeros(num_pages + 1, page_size, kv, hd, dtype=dtype,
                      device=device)
    return buf[:num_pages]


def _with_sink(pool):
    """Flat (NP*ps + ps, KV, hd) view of a :func:`paged_pool` pool and its
    sink page (raises for a pool made without one)."""
    NP, ps, kv, hd = pool.shape
    need = (pool.storage_offset() + (NP + 1) * ps * kv * hd) \
        * pool.element_size()
    if not pool.is_contiguous() or pool.untyped_storage().nbytes() < need:
        raise ValueError("paged_write_kv: the pool has no sink page (make "
                         "it with paged_pool)")
    return pool.as_strided(((NP + 1) * ps, kv, hd), (kv * hd, hd, 1))


def paged_write_kv(pool, new, block_table, page_size: int, cache_len):
    """Write one decode token's K (or V) into a paged pool, in place.

    pool: (NP, ps, KV, hd) physical pages made by :func:`paged_pool`; new:
    (B, 1, KV, hd); block_table: (B, max_pages) int32 with sentinel NP for
    unmapped pages; cache_len: (B,) logical write position. The reference
    scatters with ``mode="drop"``: a row on a sentinel page (a dead or
    padding slot, whose recycled pages may already belong to a new
    trajectory) or at ``cache_len >= max_pages * ps`` (a full slot) writes
    nowhere. Here such a row writes into the sink page, so the write needs
    no host synchronisation and no row is clamped onto a live position."""
    NP, ps = pool.shape[0], pool.shape[1]
    B, max_pages = block_table.shape
    pos = cache_len.to(torch.int64)
    rows = torch.arange(B, device=pool.device)
    pg = block_table[rows, (pos // page_size).clamp(0, max_pages - 1)]
    pg = pg.to(torch.int64)
    live = (pos >= 0) & (pos < max_pages * page_size) & (pg >= 0) & (pg < NP)
    pg = torch.where(live, pg, NP)                        # NP = the sink
    flat = pg * ps + pos % page_size
    _with_sink(pool)[flat] = new[:, 0].to(pool.dtype)
    return pool


def paged_gather_kv(pool, block_table, page_size: int):
    """Gather a paged pool back to the dense per-slot layout
    (B, max_pages * ps, KV, hd). Sentinel pages read as zeros (the
    reference's ``mode="fill"``), by masking: page NP is never read. Every
    such position lies past cache_len and is masked by
    :func:`decode_attention`, so paged decode equals dense decode bit for
    bit on the CPU."""
    NP = pool.shape[0]
    B, max_pages = block_table.shape
    if page_size != pool.shape[1]:
        raise ValueError(f"paged_gather_kv: page_size {page_size} != the "
                         f"pool's {pool.shape[1]}")
    bt = block_table.to(torch.int64)
    mapped = (bt >= 0) & (bt < NP)
    pages = pool[torch.where(mapped, bt, 0)]             # (B, mp, ps, KV, hd)
    pages = torch.where(mapped[:, :, None, None, None], pages,
                        torch.zeros((), dtype=pool.dtype, device=pool.device))
    return pages.reshape(B, max_pages * page_size, *pool.shape[2:])


# ---------------------------------------------------------------------------
# full attention sub-block (proj + rope + attend + out-proj)
# ---------------------------------------------------------------------------


def attention_block(params, cfg, x, positions, *, kind: str, kv_cache=None,
                    cache_len=None, paged=None):
    """Self-attention sub-block.

    Full sequence: kv_cache is None -> returns (out, (k, v)) where k/v are
    the full-sequence keys/values.
    Prefill: kv_cache=(k_cache, v_cache) (B, L, KV, hd) and no cache_len ->
    the full-sequence attention, its K/V written into positions [0, S) of
    the caches in place; returns (out, (k_cache, v_cache)).
    Decode: kv_cache=(k_cache, v_cache) (B, L, KV, hd), cache_len (B,) int32
    tokens already in cache; x is (B, 1, d). The new token's K/V is written
    at cache_len IN PLACE on the cache tensors (the reference's
    dynamic_update_slice, whose start index is clamped to L - 1), then
    attention reads cache_len + 1 entries. Returns (out, (k_cache, v_cache)).
    Paged decode: ``paged=(block_table (B, max_pages) int32, page_size)``
    and kv_cache holds the physical page pools (NP, ps, KV, hd) shared by
    all slots (:func:`paged_write_kv`, then the paged decode kernel).

    On a mesh the attention runs on each rank's own rows and heads
    (``partitioning.over_heads``), with the caches' own shards: each rank
    holds its rows and either its kv heads or, where the kv heads do not
    divide "model", a slice of the cache's length
    (``launch/sharding.cache_placements``), written where it holds them; a
    decode step over a length slice merges the slices' outputs over the
    ranks that hold the others (:func:`merge_slices`), over one mesh dim
    or, in the ``shard_seq`` layout, two (("data", "model")).
    """
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = x.dtype
    q = split_heads(x @ params["wq"].to(dt), h, hd)
    k = split_heads(x @ params["wk"].to(dt), kv, hd)
    v = split_heads(x @ params["wv"].to(dt), kv, hd)
    if "q_norm" in params:
        q = rms_norm(q, params["q_norm"], eps=cfg.rms_eps)
        k = rms_norm(k, params["k_norm"], eps=cfg.rms_eps)
    window = cfg.sliding_window if kind == "local" else 0
    cap = cfg.attn_softcap
    cache = () if kv_cache is None else tuple(kv_cache)
    # this rank's slice of the cache length: its first position, the
    # cache's length, and the ranks holding the other slices (None: whole,
    # or no other rank holds a slice)
    start = shard_start(cache[0], 1) if cache else 0
    L = cache[0].shape[1] if cache else 0
    part = part_of(cache[0], 1) if cache else None
    group = None if part is None else part.group

    if cache_len is None:
        def attend(q, k, v, positions, *caches):
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
            out = flash_op.flash_attention(q, k, v.contiguous(), causal=True,
                                           window=window, attn_softcap=cap)
            for c, t in zip(caches, (k, v)):
                write_prefix(c, t, start)
            return out.flatten(-2), k, v

        out, k, v = over_heads(attend, q, k, v, positions, cache=cache)
        return out @ params["wo"].to(dt), (cache or (k, v))

    def attend(q, k, v, positions, clen, k_cache, v_cache):
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        if paged is not None:
            bt, psz = paged
            paged_write_kv(k_cache, k, bt, psz, clen)
            paged_write_kv(v_cache, v, bt, psz, clen)
            out = paged_op.paged_decode_attention(
                q, k_cache, v_cache, bt, psz, clen + 1, window=window,
                attn_softcap=cap)
            return out.flatten(-2), k, v
        write_token(k_cache, k, clen, start, L)
        write_token(v_cache, v, clen, start, L)
        out = decode_op.decode_attention(q, k_cache, v_cache, clen + 1,
                                         window=window, attn_softcap=cap,
                                         start=start,
                                         return_lse=group is not None)
        if group is not None:
            out = merge_slices(*out, group).to(q.dtype)
        return out.flatten(-2), k, v

    out, _, _ = over_heads(attend, q, k, v, positions, cache_len,
                           cache=cache)
    return out @ params["wo"].to(dt), cache


def write_token(cache, new, cache_len, start: int, length: int):
    """Write one decode token's K (or V) ``new`` (B, 1, KV, hd) into the
    dense ``cache`` (B, L, KV, hd) at position ``cache_len`` (B,), in
    place: the reference's dynamic_update_slice, whose start index is
    clamped to ``length - 1``. ``cache`` holds global positions [start,
    start + L) of a cache of ``length`` positions (a rank's slice of a
    length-split cache): a row writes only where its clamped position lies
    in the slice."""
    B, L = cache.shape[0], cache.shape[1]
    rows = torch.arange(B, device=cache.device)
    idx = cache_len.to(torch.int64).clamp(0, length - 1)
    val = new[:, 0].to(cache.dtype)
    if L != length:
        idx = idx - start
        own = (idx >= 0) & (idx < L)
        idx = idx.clamp(0, L - 1)
        val = torch.where(own[:, None, None], val, cache[rows, idx])
    cache[rows, idx] = val


def write_prefix(cache, new, start: int = 0):
    """Prefill's write of the full-sequence K (or V) ``new`` (B, S, KV, hd)
    into positions [0, S) of the dense ``cache`` (B, L, KV, hd), in place.
    ``cache`` holds global positions [start, start + L) (a rank's slice of
    a length-split cache, ``new`` then every position): the part of [0, S)
    it holds."""
    end = min(new.shape[1], start + cache.shape[1])
    if end > start:
        cache[:, :end - start] = new[:, start:end].to(cache.dtype)


def cross_attention_block(params, cfg, x, media, *, media_kv=None):
    """Tanh-gated (llama-vision) non-causal cross-attention of x (B, S, d)
    to the projected media embeddings ``media`` (B, M, d).

    ``media_kv``: the cached (mk, mv) (B, M, KV, hd), which decode reads
    instead of projecting the media again (they are static per request:
    prefill writes them into the slot cache). Train, prefill and decode all
    run the flash kernel with ``causal=False``: q (B, S, H, hd) against the
    M media keys, and at decode the same kernel at S = 1 (one query row
    against every key: a 64-row q tile with one live row). On CPU tensors
    it is the plain ``chunked_attention``, as in the reference. Returns
    (y, (mk, mv))."""
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = x.dtype
    q = split_heads(x @ params["wq"].to(dt), h, hd)
    if media_kv is None:
        k = split_heads(media @ params["wk"].to(dt), kv, hd)
        v = split_heads(media @ params["wv"].to(dt), kv, hd)
    else:
        k, v = (t.to(dt) for t in media_kv)

    def attend(q, k, v):
        out = flash_op.flash_attention(q.contiguous(), k.contiguous(),
                                       v.contiguous(), causal=False)
        return out.flatten(-2), k, v

    out, k, v = over_heads(attend, q, k, v)
    y = out @ params["wo"].to(dt)
    return torch.tanh(params["gate"].to(dt)) * y, (k, v)
