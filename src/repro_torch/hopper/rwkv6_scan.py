"""WKV6 recurrence of the rwkv6 time-mix: wrapper of the hand-written CUDA
kernel ``csrc/wkv6.cu`` (the port of the Pallas ``rwkv6_scan`` TPU kernel).

On CPU tensors the wrapper runs the plain PyTorch version,
:func:`wkv6_plain` (a copy of the reference's ``models/rwkv6.wkv6_scan``);
on CUDA tensors it launches the kernel or raises. T = 1 (a decode step)
runs the decode kernel, T > 1 the prefill kernel; ``launches`` counts both,
``decode_launches`` and ``prefill_launches`` each. The kernels are
forward only, as the Pallas kernel is: on CUDA, an input that requires a
gradient while grad is enabled raises.
"""
from __future__ import annotations

import torch

from repro_torch.hopper import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64)       # the hd csrc/wkv6.cu dispatches


def wkv6_plain(r, k, v, w, u, state, seq_mask=None):
    """Sequential WKV6 in float32. r, k, v: (B, T, H, hd); w: (B, T, H, hd)
    decay in (0, 1); u: (H, hd); state: (B, H, hd, hd). ``seq_mask`` (B, T)
    freezes the state across right-pads (w = 1, k = 0). Returns y
    (B, T, H, hd) in r's dtype and the final state, float32 (a new
    tensor)."""
    dt = r.dtype
    r, k, v, w = (a.float() for a in (r, k, v, w))
    u = u.float()
    s = state.float()
    if seq_mask is not None:
        m = seq_mask[:, :, None, None].float()
        k = k * m
        w = w * m + (1.0 - m)
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]        # (B, H, hd, hd)
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               s + u[None, :, :, None] * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(ys, dim=1).to(dt), s


def _check(r, k, v, w, u, state, seq_mask):
    if r.dim() != 4 or not (k.shape == v.shape == w.shape == r.shape):
        raise ValueError(f"wkv6: want r, k, v, w (B, T, H, hd); got "
                         f"{tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(w.shape)}")
    B, T, H, hd = r.shape
    if u.shape != (H, hd) or state.shape != (B, H, hd, hd):
        raise ValueError(f"wkv6: u must be ({H}, {hd}) and state "
                         f"({B}, {H}, {hd}, {hd}); got {tuple(u.shape)}, "
                         f"{tuple(state.shape)}")
    if seq_mask is not None and seq_mask.shape != (B, T):
        raise ValueError(f"wkv6: seq_mask must be ({B}, {T}), got "
                         f"{tuple(seq_mask.shape)}")
    tensors = [r, k, v, w, u, state]
    if seq_mask is not None:
        tensors.append(seq_mask)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("wkv6: tensors on different devices")


def wkv6(r, k, v, w, u, state, *, seq_mask=None):
    """Same contract as :func:`wkv6_plain`. On CUDA: r, k, v, w contiguous
    in one dtype (float32 or bfloat16), u and the state float32 and
    contiguous. The kernel updates ``state`` IN PLACE and returns it as the
    final state."""
    _check(r, k, v, w, u, state, seq_mask)
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, w, u, state, seq_mask=seq_mask)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6: unsupported device {r.device}")
    build.forward_only("wkv6", r, k, v, w, u, state)
    B, T, H, hd = r.shape
    if r.dtype not in _DTYPES or not (r.dtype == k.dtype == v.dtype
                                      == w.dtype) or hd not in _HEAD_DIMS:
        raise TypeError(f"wkv6 kernel takes r, k, v, w all float32 or all "
                        f"bfloat16 and head_dim in {_HEAD_DIMS}; got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}, {w.dtype}, "
                        f"hd={hd}")
    if u.dtype != torch.float32 or state.dtype != torch.float32:
        raise TypeError("wkv6 kernel: u and the state must be float32")
    if seq_mask is not None:                           # exact: mask is 0 / 1
        m = seq_mask[:, :, None, None].to(r.dtype)
        k = k * m
        w = w * m + (1 - m)
    if not all(t.is_contiguous() for t in (r, k, v, w, u, state)):
        raise ValueError("wkv6 kernel needs contiguous r, k, v, w, u, state")
    y = launch(r, k, v, w, u, state)
    wkv6.launches += 1
    if T == 1:
        wkv6.decode_launches += 1
    else:
        wkv6.prefill_launches += 1
    return y, state


def launch(r, k, v, w, u, state, *, prefill_only=False):
    """One launch on CUDA tensors that :func:`wkv6` has checked: the decode
    kernel at T = 1 (unless ``prefill_only``), else the prefill kernel.
    Updates ``state`` in place, counts nothing, returns y."""
    B, T, H, hd = r.shape
    if state.data_ptr() % 16:
        raise ValueError("wkv6 kernel: the state must be 16-byte aligned")
    y = torch.empty_like(r)
    lib = build.library("wkv6")
    with torch.cuda.device(r.device):
        err = lib.wkv6_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), state.data_ptr(), y.data_ptr(), B, T, H, hd,
            _DTYPES[r.dtype], int(prefill_only),
            torch.cuda.current_stream(r.device).cuda_stream)
    build.check(err, "wkv6_fwd")
    return y


wkv6.launches = 0
wkv6.decode_launches = 0                # T = 1: the decode kernel
wkv6.prefill_launches = 0               # T > 1: the prefill kernel
