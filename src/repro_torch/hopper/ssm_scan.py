"""Selective scan of the hymba block's SSM heads: wrapper of the
hand-written CUDA kernel ``csrc/ssm_scan.cu`` (the port of the Pallas
``ssm_scan`` TPU kernel).

On CPU tensors the wrapper runs the plain PyTorch version,
:func:`selective_scan_plain` (a copy of the reference's
``models/ssm.selective_scan``); on CUDA tensors it launches the kernel or
raises. T = 1 (a decode step) runs the decode kernel, T > 1 the prefill
kernel; ``launches`` counts both, ``decode_launches`` and
``prefill_launches`` each. The kernels are forward only, as the Pallas
kernel is: on CUDA, an input that requires a gradient while grad is enabled
raises.
"""
from __future__ import annotations

import torch

from repro_torch.hopper import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_STATE_DIMS = (8, 16)                # the N csrc/ssm_scan.cu dispatches


def selective_scan_plain(x, dt, A_log, Bc, Cc, D, state, seq_mask=None):
    """Sequential scan in float32. x, dt: (B, T, di); A_log: (di, N);
    Bc, Cc: (B, T, N); D: (di,); state: (B, di, N). ``seq_mask`` (B, T)
    freezes the state across right-pads (dt = 0: dA = 1, dBx = 0). Returns
    y (B, T, di) in x's dtype and the final state, float32 (a new tensor)."""
    out_dt = x.dtype
    x, dt, Bc, Cc = (a.float() for a in (x, dt, Bc, Cc))
    h = state.float()
    if seq_mask is not None:
        dt = dt * seq_mask[..., None].float()
    negA = -torch.exp(A_log.float())                          # (di, N)
    ys = []
    for t in range(x.shape[1]):
        dtt = dt[:, t]
        da = torch.exp(negA[None] * dtt[..., None])           # (B, di, N)
        h = da * h + (dtt * x[:, t])[..., None] * Bc[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cc[:, t]))
    y = torch.stack(ys, dim=1) + x * D.float()[None, None, :]
    return y.to(out_dt), h


def _check(x, dt, A_log, Bc, Cc, D, state, seq_mask):
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"selective_scan: want x, dt (B, T, di); got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}")
    B, T, di = x.shape
    N = A_log.shape[-1]
    if A_log.shape != (di, N) or D.shape != (di,) \
            or Bc.shape != (B, T, N) or Cc.shape != (B, T, N) \
            or state.shape != (B, di, N):
        raise ValueError(
            f"selective_scan: incompatible shapes x {tuple(x.shape)}, A_log "
            f"{tuple(A_log.shape)}, B {tuple(Bc.shape)}, C "
            f"{tuple(Cc.shape)}, D {tuple(D.shape)}, state "
            f"{tuple(state.shape)}")
    if seq_mask is not None and seq_mask.shape != (B, T):
        raise ValueError(f"selective_scan: seq_mask must be ({B}, {T}), got "
                         f"{tuple(seq_mask.shape)}")
    tensors = [x, dt, A_log, Bc, Cc, D, state]
    if seq_mask is not None:
        tensors.append(seq_mask)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("selective_scan: tensors on different devices")


def selective_scan(x, dt, A_log, Bc, Cc, D, state, *, seq_mask=None):
    """Same contract as :func:`selective_scan_plain`. On CUDA: x, dt, B, C
    in one dtype (float32 or bfloat16), x and dt contiguous, B and C with a
    contiguous last axis (views of the x_proj output are read in place);
    A_log, D and the state float32 and contiguous. The kernel updates
    ``state`` IN PLACE and returns it as the final state."""
    _check(x, dt, A_log, Bc, Cc, D, state, seq_mask)
    if x.device.type == "cpu":
        return selective_scan_plain(x, dt, A_log, Bc, Cc, D, state,
                                    seq_mask=seq_mask)
    if x.device.type != "cuda":
        raise ValueError(f"selective_scan: unsupported device {x.device}")
    build.forward_only("selective_scan", x, dt, A_log, Bc, Cc, D, state)
    B, T, di = x.shape
    N = A_log.shape[-1]
    if x.dtype not in _DTYPES or not (x.dtype == dt.dtype == Bc.dtype
                                      == Cc.dtype) or N not in _STATE_DIMS:
        raise TypeError(f"selective_scan kernel takes x, dt, B, C all "
                        f"float32 or all bfloat16 and N in {_STATE_DIMS}; got "
                        f"{x.dtype}, {dt.dtype}, {Bc.dtype}, {Cc.dtype}, "
                        f"N={N}")
    if not all(t.dtype == torch.float32 for t in (A_log, D, state)):
        raise TypeError("selective_scan kernel: A_log, D and the state must "
                        "be float32")
    if not all(t.is_contiguous() for t in (x, dt, A_log, D, state)) \
            or Bc.stride(-1) != 1 or Cc.stride(-1) != 1:
        raise ValueError("selective_scan kernel needs contiguous x, dt, "
                         "A_log, D, state and a contiguous last axis of B, C")
    if seq_mask is not None:
        dt = dt * seq_mask[..., None].to(dt.dtype)     # exact: mask is 0 / 1
    y = launch(x, dt, A_log, Bc, Cc, D, state)
    selective_scan.launches += 1
    if T == 1:
        selective_scan.decode_launches += 1
    else:
        selective_scan.prefill_launches += 1
    return y, state


def launch(x, dt, A_log, Bc, Cc, D, state, *, prefill_only=False):
    """One launch on CUDA tensors that :func:`selective_scan` has checked:
    the decode kernel at T = 1 (unless ``prefill_only``), else the prefill
    kernel. Updates ``state`` in place, counts nothing, returns y."""
    B, T, di = x.shape
    N = A_log.shape[-1]
    if state.data_ptr() % 16 or A_log.data_ptr() % 16:
        raise ValueError("selective_scan kernel: the state and A_log must be "
                         "16-byte aligned")
    y = torch.empty_like(x)
    lib = build.library("ssm_scan")
    with torch.cuda.device(x.device):
        err = lib.ssm_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A_log.data_ptr(), Bc.data_ptr(),
            Cc.data_ptr(), D.data_ptr(), state.data_ptr(), y.data_ptr(),
            B, T, di, N, Bc.stride(0), Bc.stride(1), Cc.stride(0),
            Cc.stride(1), _DTYPES[x.dtype], int(prefill_only),
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "ssm_scan_fwd")
    return y


selective_scan.launches = 0
selective_scan.decode_launches = 0      # T = 1: the decode kernel
selective_scan.prefill_launches = 0     # T > 1: the prefill kernel
