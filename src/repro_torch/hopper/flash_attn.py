"""Prefill attention: wrapper of the hand-written CUDA kernel
``csrc/flash_attn.cu`` (the port of the Pallas ``flash_attn`` TPU kernel).

On a CPU tensor the wrapper runs the plain PyTorch version,
:func:`flash_attention_plain` (= ``models.attention.chunked_attention``); on a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.hopper import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64)


def flash_attention_plain(q, k, v, *, causal=True, window=0, attn_softcap=0.0,
                          scale=0.0):
    """The plain PyTorch version: blocked online-softmax attention in f32."""
    from repro_torch.models.attention import chunked_attention
    return chunked_attention(q, k, v, causal=causal, window=window,
                             attn_softcap=attn_softcap, scale=scale)


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: want q (B, S, H, hd), k/v "
                         f"(B, S, KV, hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2] != 0:
        raise ValueError(f"flash_attention: incompatible q {tuple(q.shape)} "
                         f"and k {tuple(k.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_attention: q, k, v dtypes differ")


def flash_attention(q, k, v, *, causal=True, window=0, attn_softcap=0.0,
                    scale=0.0):
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) with H a multiple of KV.
    Returns (B, Sq, H, hd) in q's dtype."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     attn_softcap=attn_softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES or hd not in _HEAD_DIMS:
        raise TypeError(f"flash_attention kernel takes float32/bfloat16 with "
                        f"head_dim in {_HEAD_DIMS}; got {q.dtype}, hd={hd}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel needs contiguous q, k, v")
    if scale <= 0.0:
        scale = hd ** -0.5
    out = torch.empty_like(q)
    lib = build.library("flash_attn")
    with torch.cuda.device(q.device):
        err = lib.flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Sk, H, KV, hd, int(causal), int(window), float(attn_softcap),
            float(scale), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attn_fwd")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
