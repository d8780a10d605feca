"""Single-token decode attention over the dense KV cache: wrapper of the
hand-written CUDA kernel ``csrc/decode_attn.cu`` (the port of the Pallas
``decode_attn`` TPU kernel, wired into dense decode here).

On a CPU tensor the wrapper runs the plain PyTorch version,
:func:`decode_attention_plain` (= ``models.attention.decode_attention``); on a
CUDA tensor it launches the kernel or raises.

The kernel splits each row over chunks of :data:`DECODE_CHUNK` positions and
merges the chunks' partials in the same launch; a GQA ratio above 5 is
also split over the grid into groups of query heads. :func:`split_workspace`
holds the float32 partials and the per-(row, kv head, head group) ticket
counters it needs, one set per device and stream, grown when a call needs
more and never synchronised with the host. The paged kernel shares it.
"""
from __future__ import annotations

import torch

from repro_torch.hopper import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128, 256)
DECODE_CHUNK = 128              # kDecodeChunk of csrc/decode_common.cuh
_WORKSPACES = {}


def split_workspace(device, B, H, hd, length):
    """(partials, tickets) for a split decode of B rows of H query heads
    over ``length`` cache positions: float32 room for B * H *
    ceil(length / DECODE_CHUNK) partials of hd + 2 values, and B * H int32
    counters, one per (row, kv head, group of query heads) at most, zero
    between calls (the kernel resets them). Kept per
    (device, stream): calls on one stream are ordered, so they can share
    it, and threads that decode on streams of their own (the overlapped
    trainer's rollout producer beside ``evaluate`` on the caller's stream)
    never share one. A set outgrown on a stream is dropped while that
    stream may still read it, which is safe: the caching allocator reuses
    its memory only for work queued later on the same stream."""
    floats = B * H * -(-length // DECODE_CHUNK) * (hd + 2)
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    acc, tickets = _WORKSPACES.get(key, (None, None))
    if acc is None or acc.numel() < floats:
        acc = torch.empty(floats, dtype=torch.float32, device=device)
    if tickets is None or tickets.numel() < B * H:
        tickets = torch.zeros(B * H, dtype=torch.int32, device=device)
    _WORKSPACES[key] = (acc, tickets)
    return acc, tickets


def decode_attention_plain(q, k_cache, v_cache, cache_len, *, window=0,
                           attn_softcap=0.0, scale=0.0):
    """The plain PyTorch version (masked softmax over the whole cache)."""
    from repro_torch.models.attention import decode_attention
    return decode_attention(q, k_cache, v_cache, cache_len, window=window,
                            attn_softcap=attn_softcap, scale=scale)


def _check(q, k_cache, v_cache, cache_len):
    if q.dim() != 4 or q.shape[1] != 1 or k_cache.dim() != 4 \
            or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention: want q (B, 1, H, hd), caches "
                         f"(B, L, KV, hd); got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, _, H, hd = q.shape
    if k_cache.shape[0] != B or k_cache.shape[3] != hd \
            or H % k_cache.shape[2] != 0:
        raise ValueError(f"decode_attention: incompatible q {tuple(q.shape)} "
                         f"and cache {tuple(k_cache.shape)}")
    if cache_len.shape != (B,):
        raise ValueError(f"decode_attention: cache_len must be ({B},), got "
                         f"{tuple(cache_len.shape)}")
    if not (q.device == k_cache.device == v_cache.device == cache_len.device):
        raise ValueError("decode_attention: tensors on different devices")
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise TypeError("decode_attention: q and cache dtypes differ")


def decode_attention(q, k_cache, v_cache, cache_len, *, window=0,
                     attn_softcap=0.0, scale=0.0):
    """q: (B, 1, H, hd); k_cache/v_cache: (B, L, KV, hd) in the model's cache
    layout; cache_len: (B,) int32 valid entries per row, including the
    current token. Returns (B, 1, H, hd) in q's dtype. The kernel reads
    positions [max(0, cache_len - window), min(cache_len, L)); a row with
    cache_len <= 0 (never produced by the engine) returns zeros."""
    _check(q, k_cache, v_cache, cache_len)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, cache_len,
                                      window=window, attn_softcap=attn_softcap,
                                      scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    B, _, H, hd = q.shape
    L, KV = k_cache.shape[1], k_cache.shape[2]
    if q.dtype not in _DTYPES or hd not in _HEAD_DIMS:
        raise TypeError(f"decode_attention kernel takes float32/bfloat16 "
                        f"with head_dim in {_HEAD_DIMS}; got {q.dtype}, "
                        f"hd={hd}")
    if cache_len.dtype != torch.int32:
        raise TypeError(f"decode_attention: cache_len must be int32, got "
                        f"{cache_len.dtype}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("cache_len", cache_len)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"decode_attention kernel needs a contiguous, "
                             f"16-byte aligned {name}")
    if scale <= 0.0:
        scale = hd ** -0.5
    out = torch.empty_like(q)
    lib = build.library("decode_attn")
    with torch.cuda.device(q.device):
        ws, tickets = split_workspace(q.device, B, H, hd, L)
        err = lib.decode_attn_fwd(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            cache_len.data_ptr(), out.data_ptr(), ws.data_ptr(), ws.numel(),
            tickets.data_ptr(), B, L, H, KV, hd,
            int(window), float(attn_softcap), float(scale), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "decode_attn_fwd")
    build.count(decode_attention)
    return out


decode_attention.launches = 0
