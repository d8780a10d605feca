"""Prefill / train attention: wrappers of the hand-written CUDA kernels
``csrc/flash_attn.cu`` (forward, the port of the Pallas ``flash_attn`` TPU
kernel) and ``csrc/flash_attn_bwd.cu`` (backward, the port of the
reference's ``models/attention._flash_bwd``; the Pallas family has none).

:func:`flash_attention` is differentiable: when q, k or v requires a
gradient it runs :class:`_FlashAttn`, whose forward also returns the
logsumexp of each row, float32 (B, H, Sq), and whose backward recomputes
the probabilities from it. Without a gradient (serving) the forward runs
without the logsumexp. On CPU tensors the wrappers run the plain PyTorch
versions (:func:`flash_attention_plain`, :func:`flash_attention_bwd_plain`);
on CUDA tensors they launch the kernels or raise.

On CUDA the kernel is chosen by dtype, never as a fallback: bfloat16 runs
the tensor-core (``wgmma``) kernels, float32 the SIMT kernels on the f32
FMA pipes (the f32 GPU-against-CPU references need atol 1e-4, which TF32
tensor cores would not meet). Both take head_dim 32, 64, 128 or 256
(the registry's archs) and any H / KV; anything else raises. Each wrapper counts its launches in ``launches``, and those of the
f32 SIMT kernels also in ``simt_launches``.

On fake tensors (the dry run, ``launch/dryrun``) the wrappers launch
nothing, whatever the tensors' device: they return empty outputs of the
kernel's shapes and charge :func:`flash_cost` (``build.charge``).
"""
from __future__ import annotations

import torch

from repro_torch.hopper import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128, 256)


def flash_attention_plain(q, k, v, *, causal=True, window=0, attn_softcap=0.0,
                          scale=0.0, return_lse=False):
    """The plain PyTorch version: blocked online-softmax attention in f32."""
    from repro_torch.models.attention import chunked_attention
    return chunked_attention(q, k, v, causal=causal, window=window,
                             attn_softcap=attn_softcap, scale=scale,
                             return_lse=return_lse)


def flash_attention_bwd_plain(q, k, v, out, lse, dout, *, causal=True,
                              window=0, attn_softcap=0.0, scale=0.0):
    """The plain PyTorch backward (port of ``_flash_bwd``)."""
    from repro_torch.models import attention
    return attention.flash_attention_bwd_plain(
        q, k, v, out, lse, dout, causal=causal, window=window,
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


def attended_pairs(Sq, Sk, causal=True, window=0) -> int:
    """The (query, key) pairs the kernels compute: query i reads keys
    j <= i (causal) and i - j < window (a window), every key else."""
    if not causal:
        return Sq * Sk
    cap = min(Sk, window) if window > 0 else Sk
    m = min(Sq, cap)
    return m * (m + 1) // 2 + (Sq - m) * cap


def flash_cost(q_shape, k_shape, itemsize, *, causal=True, window=0,
               lse=False, backward=False):
    """(FLOPs, device-memory bytes) of one forward (with ``lse``: and its
    logsumexp) or one backward launch at q (B, Sq, H, hd), k/v (B, Sk, KV,
    hd): the work of the kernels' bounds in ``chip_smoke.py``. FLOPs count
    the pairs the kernel computes (the causal triangle, the window), 2
    products of 2 hd FLOPs a pair forward, 5 backward (the scores again,
    dV, dP, dQ, dK). Bytes: the forward reads q, k, v and writes out (and
    lse, float32); the backward reads q, k, v, out, dout and lse and
    writes dq, dk, dv."""
    B, Sq, H, hd = q_shape
    Sk, KV = k_shape[1], k_shape[2]
    pairs = attended_pairs(Sq, Sk, causal, window)
    q_n, k_n = B * Sq * H * hd, B * Sk * KV * hd
    if backward:
        return (10 * B * H * hd * pairs,
                itemsize * (4 * q_n + 4 * k_n) + 4 * B * H * Sq)
    return (4 * B * H * hd * pairs,
            itemsize * (2 * q_n + 2 * k_n) + (4 * B * H * Sq if lse else 0))


def _check_kernel(name, q, *tensors):
    """What the kernels take; raises on anything else. A fake tensor (the
    dry run) is held to the same shapes, dtypes and layouts, on any
    device, and has no address to align."""
    fake = build.is_fake(q)
    if q.device.type != "cuda" and not fake:
        raise ValueError(f"{name}: unsupported device {q.device}")
    hd = q.shape[-1]
    if q.dtype not in _DTYPES or hd not in _HEAD_DIMS:
        raise TypeError(f"{name} kernel takes float32/bfloat16 with "
                        f"head_dim in {_HEAD_DIMS}; got {q.dtype}, hd={hd}")
    if not all(t.is_contiguous() for t in (q,) + tensors):
        raise ValueError(f"{name} kernel needs contiguous inputs")
    if not fake and any(t.data_ptr() % 16 for t in (q,) + tensors):
        raise ValueError(f"{name} kernel needs 16-byte aligned inputs")
    return fake


def _count(fn, dtype):
    build.count(fn, *(("simt_launches",) if dtype == torch.float32 else ()))


def _forward(q, k, v, causal, window, attn_softcap, scale, want_lse):
    """(out, lse or None): the plain version on the CPU, the kernel on
    CUDA."""
    if q.device.type == "cpu" and not build.is_fake(q):
        res = flash_attention_plain(q, k, v, causal=causal, window=window,
                                    attn_softcap=attn_softcap, scale=scale,
                                    return_lse=want_lse)
        return res if want_lse else (res, None)
    fake = _check_kernel("flash_attention", q, k, v)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if scale <= 0.0:
        scale = hd ** -0.5
    out = torch.empty_like(q)
    lse = (torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
           if want_lse else None)
    if fake:
        build.charge("flash_attn", *flash_cost(
            q.shape, k.shape, q.element_size(), causal=causal, window=window,
            lse=want_lse))
        return out, lse
    lib = build.library("flash_attn")
    with torch.cuda.device(q.device):
        err = lib.flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            0 if lse is None else lse.data_ptr(), B, Sq, Sk, H, KV, hd,
            int(causal), int(window), float(attn_softcap), float(scale),
            _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attn_fwd")
    _count(flash_attention, q.dtype)
    return out, lse


class _FlashAttn(torch.autograd.Function):
    """Attention with the flash backward: saves (q, k, v, out, lse), not
    the probabilities."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, attn_softcap, scale):
        out, lse = _forward(q, k, v, causal, window, attn_softcap, scale,
                            want_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.flags = dict(causal=causal, window=window,
                         attn_softcap=attn_softcap, scale=scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(), **ctx.flags)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal=True, window=0, attn_softcap=0.0,
                    scale=0.0, return_lse=False):
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) with H a multiple of KV.
    Returns (B, Sq, H, hd) in q's dtype, and with ``return_lse`` (no
    gradient) also the logsumexp float32 (B, H, Sq). Differentiable in q,
    k and v."""
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if return_lse:
            raise ValueError("flash_attention: return_lse is for calls "
                             "without a gradient")
        return _FlashAttn.apply(q, k, v, causal, window, attn_softcap, scale)
    out, lse = _forward(q, k, v, causal, window, attn_softcap, scale,
                        want_lse=return_lse)
    return (out, lse) if return_lse else out


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal=True, window=0,
                        attn_softcap=0.0, scale=0.0):
    """Gradients (dq, dk, dv) of attention from the forward's output and
    logsumexp ``lse`` (B, H, Sq) float32. dq in q's dtype, dk/dv in k's."""
    _check(q, k, v)
    if out.shape != q.shape or dout.shape != q.shape \
            or lse.shape != (q.shape[0], q.shape[2], q.shape[1]):
        raise ValueError(f"flash_attention_bwd: out/dout must be "
                         f"{tuple(q.shape)} and lse (B, H, Sq); got "
                         f"{tuple(out.shape)}, {tuple(dout.shape)}, "
                         f"{tuple(lse.shape)}")
    if q.device.type == "cpu" and not build.is_fake(q):
        return flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                         causal=causal, window=window,
                                         attn_softcap=attn_softcap,
                                         scale=scale)
    fake = _check_kernel("flash_attention_bwd", q, k, v, out, lse, dout)
    if out.dtype != q.dtype or dout.dtype != q.dtype \
            or lse.dtype != torch.float32:
        raise TypeError("flash_attention_bwd: out/dout must be in q's dtype "
                        "and lse float32")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if scale <= 0.0:
        scale = hd ** -0.5
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    if fake:
        build.charge("flash_attn_bwd", *flash_cost(
            q.shape, k.shape, q.element_size(), causal=causal, window=window,
            backward=True))
        return dq, dk, dv
    lib = build.library("flash_attn_bwd")
    with torch.cuda.device(q.device):
        err = lib.flash_attn_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), B, Sq, Sk, H, KV, hd,
            int(causal), int(window), float(attn_softcap), float(scale),
            _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attn_bwd")
    _count(flash_attention_bwd, q.dtype)
    return dq, dk, dv


flash_attention.launches = flash_attention.simt_launches = 0
flash_attention_bwd.launches = flash_attention_bwd.simt_launches = 0
