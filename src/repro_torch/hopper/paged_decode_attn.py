"""Single-token decode attention over the paged KV cache: wrapper of the
hand-written CUDA kernel ``csrc/paged_decode_attn.cu`` (the port of the
Pallas ``paged_decode_attn`` TPU kernel).

Layout: the model's own page pools ``(NP, ps, KV, hd)`` (one pool per
layer, as ``models.attention.paged_pool`` makes them), read in place. The
Pallas wrapper transposes them to (NP, KV, ps, hd) on every call; on the
card that would copy every layer's whole pool at every decode step, so the
kernel reads the model layout instead. The block table is
``(B, max_pages)`` int32 with the sentinel NP for unmapped pages.

On a CPU tensor the wrapper runs the plain PyTorch version,
:func:`paged_decode_attention_plain` (``paged_gather_kv`` then
``decode_attention``, the oracle of ``kernels/paged_decode_attn/ref.py``);
on a CUDA tensor it launches the kernel or raises. The kernel runs the
dense kernel's loop, split over chunks of positions, with the same
workspace (``decode_attn.split_workspace``).
"""
from __future__ import annotations

import torch

from repro_torch.hopper import build
from repro_torch.hopper.decode_attn import split_workspace

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128, 256)
_PAGE_SIZES = (8, 16, 32)


def paged_decode_attention_plain(q, k_pool, v_pool, block_table, page_size,
                                 cache_len, *, window=0, attn_softcap=0.0,
                                 scale=0.0):
    """The plain PyTorch version: gather the pages to the dense layout
    (sentinel pages read as zeros), then the masked dense decode."""
    from repro_torch.models.attention import decode_attention, paged_gather_kv
    k = paged_gather_kv(k_pool, block_table, page_size)
    v = paged_gather_kv(v_pool, block_table, page_size)
    return decode_attention(q, k, v, cache_len, window=window,
                            attn_softcap=attn_softcap, scale=scale)


def _check(q, k_pool, v_pool, block_table, page_size, cache_len):
    if q.dim() != 4 or q.shape[1] != 1 or k_pool.dim() != 4 \
            or v_pool.shape != k_pool.shape or block_table.dim() != 2:
        raise ValueError(f"paged_decode_attention: want q (B, 1, H, hd), "
                         f"pools (NP, ps, KV, hd), block_table (B, max_pages);"
                         f" got {tuple(q.shape)}, {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)}, {tuple(block_table.shape)}")
    B, _, H, hd = q.shape
    if k_pool.shape[1] != page_size or k_pool.shape[3] != hd \
            or H % k_pool.shape[2] != 0:
        raise ValueError(f"paged_decode_attention: incompatible q "
                         f"{tuple(q.shape)}, pool {tuple(k_pool.shape)} and "
                         f"page_size {page_size}")
    if block_table.shape[0] != B or cache_len.shape != (B,):
        raise ValueError(f"paged_decode_attention: block_table and cache_len "
                         f"need {B} rows; got {tuple(block_table.shape)}, "
                         f"{tuple(cache_len.shape)}")
    if not (q.device == k_pool.device == v_pool.device == block_table.device
            == cache_len.device):
        raise ValueError("paged_decode_attention: tensors on different "
                         "devices")
    if not (q.dtype == k_pool.dtype == v_pool.dtype):
        raise TypeError("paged_decode_attention: q and pool dtypes differ")


def paged_decode_attention(q, k_pool, v_pool, block_table, page_size,
                           cache_len, *, window=0, attn_softcap=0.0,
                           scale=0.0):
    """q: (B, 1, H, hd); k_pool/v_pool: (NP, ps, KV, hd); block_table:
    (B, max_pages) int32, sentinel NP; cache_len: (B,) int32 valid entries
    per row, including the current token. Returns (B, 1, H, hd) in q's
    dtype. The kernel walks the positions [max(0, cache_len - window),
    min(cache_len, max_pages * ps)) and never reads a sentinel page: a
    sentinel entry inside that range reads as zeros, as the plain gather
    fills it (the allocator never produces one). A row with cache_len <= 0
    (never produced by the engine) returns zeros."""
    _check(q, k_pool, v_pool, block_table, page_size, cache_len)
    build.refuse_fake("paged_decode_attention", q)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pool, v_pool, block_table, page_size, cache_len,
            window=window, attn_softcap=attn_softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    B, _, H, hd = q.shape
    NP, ps, KV, _ = k_pool.shape
    if q.dtype not in _DTYPES or hd not in _HEAD_DIMS \
            or ps not in _PAGE_SIZES:
        raise TypeError(f"paged_decode_attention kernel takes float32/"
                        f"bfloat16, head_dim in {_HEAD_DIMS}, page_size in "
                        f"{_PAGE_SIZES}; got {q.dtype}, hd={hd}, ps={ps}")
    if block_table.dtype != torch.int32 or cache_len.dtype != torch.int32:
        raise TypeError(f"paged_decode_attention: block_table and cache_len "
                        f"must be int32, got {block_table.dtype}, "
                        f"{cache_len.dtype}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_table", block_table), ("cache_len", cache_len)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"paged_decode_attention kernel needs a "
                             f"contiguous, 16-byte aligned {name}")
    if scale <= 0.0:
        scale = hd ** -0.5
    out = torch.empty_like(q)
    max_pages = block_table.shape[1]
    lib = build.library("paged_decode_attn")
    with torch.cuda.device(q.device):
        ws, tickets = split_workspace(q.device, B, H, hd, max_pages * ps)
        err = lib.paged_decode_attn_fwd(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_table.data_ptr(), cache_len.data_ptr(), out.data_ptr(),
            ws.data_ptr(), ws.numel(), tickets.data_ptr(), B, NP, ps,
            max_pages, H, KV, hd, int(window),
            float(attn_softcap), float(scale), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_decode_attn_fwd")
    build.count(paged_decode_attention)
    return out


paged_decode_attention.launches = 0
