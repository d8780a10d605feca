"""Selective scan of the hymba block's SSM heads: wrapper of the
hand-written CUDA kernels ``csrc/ssm_scan.cu`` (the port of the Pallas
``ssm_scan`` TPU kernel, and the backward that the Pallas family lacks).

On CPU tensors the wrapper runs the plain PyTorch versions,
:func:`selective_scan_plain` (a copy of the reference's
``models/ssm.selective_scan``) and :func:`selective_scan_bwd_plain`; on
CUDA tensors it launches the kernels or raises. T = 1 (a decode step) runs
the decode kernel, T > 1 the prefill kernel; ``launches`` counts both,
``decode_launches`` and ``prefill_launches`` each. With grad enabled and an
input that requires it, the scan runs as an autograd function whose
backward is the kernel ``ssm_scan_bwd`` on the card (counted in
``bwd_launches``) and the plain backward on the CPU; on the card its forward
runs the prefill kernel that also stores the states the backward starts its
chunks from (:func:`boundaries`), counted in ``save_launches`` in place of
``prefill_launches``.

On fake tensors (the dry run, ``launch/dryrun``) the wrappers launch
nothing, whatever the tensors' device: each kernel the card would launch
returns empty outputs of its shapes, its scratch and boundary states
allocated as on the card, and charges :func:`scan_cost`
(``build.charge``).
"""
from __future__ import annotations

import torch

from repro_torch.hopper import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_STATE_DIMS = (8, 16)                # the N csrc/ssm_scan.cu dispatches
BWD_CHUNK = 8                        # kBwdChunk of csrc/ssm_scan.cu
# channels a block of the backward covers (BwdSmem<T, N>::CB: 160 threads,
# N / 4 lanes a channel)
BWD_CHANNELS = {8: 80, 16: 40}


def scan_cost(kernel, B, T, di, N, itemsize, boundary_elems=0):
    """(FLOPs, device-memory bytes) of one launch of the forward
    (``"fwd"``, storing ``boundary_elems`` float32 boundary states) or the
    backward (``"bwd"``) at x (B, T, di) and state size N: the work of the
    kernels' bounds in ``chip_smoke.py``. FLOPs: 7 float32 operations on
    the FMA pipe per (row, step, channel, state) forward, 20 backward.
    Bytes: forward x, dt, y and B, C, A_log and D, the state read and
    written (and the boundary states); backward x, dt, dy, dx, ddt and B,
    C, dB, dC, A_log, D and their gradients, the state and its
    gradient."""
    if kernel == "fwd":
        return (7 * B * T * di * N,
                itemsize * (3 * B * T * di + 2 * B * T * N)
                + 4 * (di * N + di) + 8 * B * di * N + 4 * boundary_elems)
    return (20 * B * T * di * N,
            itemsize * (5 * B * T * di + 4 * B * T * N)
            + 8 * (di * N + di) + 8 * B * di * N)


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


def selective_scan_bwd_plain(x, dt, A_log, Bc, Cc, D, state, dy,
                             dstate=None):
    """The gradients of :func:`selective_scan_plain` (without ``seq_mask``:
    the wrappers apply it to dt outside) by an explicit reverse loop in
    float32, the plain version of the kernel ``ssm_scan_bwd``. ``state`` is
    the initial state, ``dy`` the gradient of y, ``dstate`` that of the
    final state (None: zero). With a_t = exp(-exp(A_log) dt_t) and
    G_t = dL/dh_t = dy_t C_t + a_{t+1} G_{t+1}:

        dC_t = sum_d h_t dy_t               dB_t = sum_d G_t dt_t x_t
        dx_t = dt_t (G_t . B_t) + D dy_t
        ddt_t = x_t (G_t . B_t) + sum_n G_t h_{t-1} a_t (-exp A_log)
        dA_log = sum_{b,t} G_t h_{t-1} a_t (-exp A_log) dt_t
        dD = sum_{b,t} dy_t x_t             dstate0 = a_1 G_1

    The states h_t are kept from a forward pass, never recovered by
    dividing by a decay. Returns (dx, ddt, dA_log, dB, dC, dD, dstate0):
    dx, ddt in x's and dt's dtype, dB, dC in B's and C's, the rest
    float32."""
    xf, dtf, Bf, Cf, dyf = (a.float() for a in (x, dt, Bc, Cc, dy))
    negA = -torch.exp(A_log.float())                          # (di, N)
    T = x.shape[1]
    hs, das = [state.float()], []           # h_0 .. h_T; a_1 .. a_T
    for t in range(T):
        da = torch.exp(negA[None] * dtf[:, t, :, None])
        hs.append(da * hs[-1]
                  + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :])
        das.append(da)
    g = (torch.zeros_like(hs[0]) if dstate is None else dstate.float())
    dx, ddt = torch.empty_like(xf), torch.empty_like(xf)
    dB, dC = torch.empty_like(Bf), torch.empty_like(Cf)
    dA = torch.zeros_like(negA)
    for t in reversed(range(T)):
        G = g + dyf[:, t, :, None] * Cf[:, t, None, :]        # (B, di, N)
        dC[:, t] = torch.einsum("bdn,bd->bn", hs[t + 1], dyf[:, t])
        dB[:, t] = torch.einsum("bdn,bd->bn", G, dtf[:, t] * xf[:, t])
        gb = (G * Bf[:, t, None, :]).sum(-1)                  # (B, di)
        gA = G * hs[t] * das[t] * negA[None]
        dx[:, t] = dtf[:, t] * gb + D.float() * dyf[:, t]
        ddt[:, t] = xf[:, t] * gb + gA.sum(-1)
        dA += (gA * dtf[:, t, :, None]).sum(0)
        g = das[t] * G
    dD = (dyf * xf).sum((0, 1))
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA, dB.to(Bc.dtype),
            dC.to(Cc.dtype), dD, g)


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


def _check_kernel(x, dt, A_log, Bc, Cc, D, state):
    """What the CUDA kernels take; raises on anything else."""
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


def _forward_kernel(x, dt, A_log, Bc, Cc, D, state, ckpt=None):
    """One counted launch of the forward kernels; updates ``state`` (and
    stores the backward's boundary states into ``ckpt``)."""
    y = launch(x, dt, A_log, Bc, Cc, D, state, ckpt=ckpt)
    build.count(selective_scan, "save_launches" if ckpt is not None
                else "decode_launches" if x.shape[1] == 1
                else "prefill_launches")
    return y


def boundaries(x, N):
    """The scratch of the backward's boundary states for x (B, T, di) on
    CUDA and state size N: (B, ceil(T / chunk) - 1, di, N) float32, the
    state before every chunk of ``ssm_scan_bwd_chunk`` steps but the first;
    None when T fits in one chunk."""
    B, T, di = x.shape
    chunk = (BWD_CHUNK if build.is_fake(x) else build.library(
        "ssm_scan").ssm_scan_bwd_chunk(N, _DTYPES[x.dtype], None))
    nb = (T + chunk - 1) // chunk - 1
    if nb < 1:
        return None
    return torch.empty(B, nb, di, N, device=x.device, dtype=torch.float32)


class _SelectiveScan(torch.autograd.Function):
    """The scan under autograd: the forward kernel on a copy of the initial
    state, storing the states at the backward's chunk boundaries (kept for
    the backward, which recomputes each chunk's states from them), the
    backward kernel; on the CPU the two plain versions."""

    @staticmethod
    def forward(ctx, x, dt, A_log, Bc, Cc, D, state):
        ckpt = None
        if x.device.type == "cpu" and not build.is_fake(x):
            y, final = selective_scan_plain(x, dt, A_log, Bc, Cc, D, state)
        else:
            final = state.clone()
            ckpt = boundaries(x, A_log.shape[-1])
            y = _forward_kernel(x, dt, A_log, Bc, Cc, D, final, ckpt)
        ctx.save_for_backward(x, dt, A_log, Bc, Cc, D, state, ckpt)
        return y, final

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, dstate):
        x, dt, A_log, Bc, Cc, D, state, ckpt = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        if x.device.type == "cpu" and not build.is_fake(x):
            return selective_scan_bwd_plain(x, dt, A_log, Bc, Cc, D, state,
                                            dy, dstate)
        grads = launch_bwd(x, dt, A_log, Bc, Cc, D, state, dy, dstate,
                           ckpt=ckpt)
        build.count(selective_scan, key="bwd_launches")
        return grads


def selective_scan(x, dt, A_log, Bc, Cc, D, state, *, seq_mask=None):
    """Same contract as :func:`selective_scan_plain`. On CUDA: x, dt, B, C
    in one dtype (float32 or bfloat16), x and dt contiguous, B and C with a
    contiguous last axis (views of the x_proj output are read in place);
    A_log, D and the state float32 and contiguous. Without autograd the
    kernel updates ``state`` IN PLACE and returns it as the final state;
    with grad enabled and an input that requires it, the scan is
    differentiable (``seq_mask`` applied to dt outside it), ``state`` is
    left as it was and the final state is a new tensor."""
    _check(x, dt, A_log, Bc, Cc, D, state, seq_mask)
    fake = build.is_fake(x)
    if x.device.type not in ("cpu", "cuda") and not fake:
        raise ValueError(f"selective_scan: unsupported device {x.device}")
    if x.device.type == "cuda" or fake:
        _check_kernel(x, dt, A_log, Bc, Cc, D, state)
    inputs = (x, dt, A_log, Bc, Cc, D, state)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in inputs)
    if x.device.type == "cpu" and not fake and not grad:
        return selective_scan_plain(*inputs, seq_mask=seq_mask)
    if seq_mask is not None:
        dt = dt * seq_mask[..., None].to(dt.dtype)     # exact: mask is 0 / 1
    if grad:
        return _SelectiveScan.apply(x, dt, A_log, Bc, Cc, D, state)
    return _forward_kernel(x, dt, A_log, Bc, Cc, D, state), state


def launch(x, dt, A_log, Bc, Cc, D, state, *, prefill_only=False,
           ckpt=None):
    """One launch on CUDA tensors that :func:`selective_scan` has checked:
    the decode kernel at T = 1 (unless ``prefill_only``), else the prefill
    kernel; with ``ckpt`` (:func:`boundaries`) the prefill kernel that also
    stores the backward's boundary states there. Updates ``state`` in
    place, counts nothing, returns y."""
    B, T, di = x.shape
    N = A_log.shape[-1]
    fake = build.is_fake(x)
    if not fake and (state.data_ptr() % 16 or A_log.data_ptr() % 16):
        raise ValueError("selective_scan kernel: the state and A_log must be "
                         "16-byte aligned")
    y = torch.empty_like(x)
    if fake:
        build.charge("ssm_scan", *scan_cost(
            "fwd", B, T, di, N, x.element_size(),
            0 if ckpt is None else ckpt.numel()))
        return y
    lib = build.library("ssm_scan")
    ptrs = (x.data_ptr(), dt.data_ptr(), A_log.data_ptr(), Bc.data_ptr(),
            Cc.data_ptr(), D.data_ptr(), state.data_ptr(), y.data_ptr())
    strides = (Bc.stride(0), Bc.stride(1), Cc.stride(0), Cc.stride(1))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if ckpt is None:
            err = lib.ssm_scan_fwd(*ptrs, B, T, di, N, *strides,
                                   _DTYPES[x.dtype], int(prefill_only),
                                   stream)
        else:
            err = lib.ssm_scan_fwd_save(*ptrs, ckpt.data_ptr(), B, T, di, N,
                                        *strides, _DTYPES[x.dtype], stream)
    build.check(err, "ssm_scan_fwd")
    return y


def launch_bwd(x, dt, A_log, Bc, Cc, D, state, dy, dstate=None, *,
               ckpt=None):
    """One launch of ``ssm_scan_bwd`` on CUDA tensors that
    :func:`selective_scan` has checked (``state`` the initial state, left
    as it is; ``dstate`` the final state's gradient or None; ``ckpt`` the
    boundary states the forward stored, or None: the forward that stores
    them runs first, on a copy of the state), then the fixed-order sums of
    its per-block partials. Counts nothing; returns what
    :func:`selective_scan_bwd_plain` returns."""
    B, T, di = x.shape
    N = A_log.shape[-1]
    dy = dy.to(x.dtype).contiguous()
    if dstate is not None:
        dstate = dstate.float().contiguous()
    fake = build.is_fake(x)
    if not fake and (state.data_ptr() % 16 or A_log.data_ptr() % 16):
        raise ValueError("selective_scan kernel: the state and A_log must be "
                         "16-byte aligned")
    lib = None if fake else build.library("ssm_scan")
    cb = (BWD_CHANNELS[N] if fake          # channels a block
          else lib.ssm_scan_bwd_channels(N))
    nblk = (di + cb - 1) // cb
    f32 = dict(device=x.device, dtype=torch.float32)
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    # per block of channels: dB_t, dC_t (summed over its channels); per row:
    # dA_log, dD (summed over its steps)
    pbc = torch.empty(nblk, B, T, 2, N, **f32)
    pA = torch.empty(B, di, N, **f32)
    pD = torch.empty(B, di, **f32)
    ds0 = torch.empty(B, di, N, **f32)
    if ckpt is None:
        ckpt = boundaries(x, N)
        if ckpt is not None:
            launch(x, dt, A_log, Bc, Cc, D, state.clone(), ckpt=ckpt)
    if ckpt is not None and (not ckpt.is_contiguous()
                             or (not fake and ckpt.data_ptr() % 16)):
        raise ValueError("selective_scan kernel: the boundary states must be "
                         "contiguous and 16-byte aligned")
    if fake:
        build.charge("ssm_scan_bwd", *scan_cost("bwd", B, T, di, N,
                                                x.element_size()))
    else:
        with torch.cuda.device(x.device):
            err = lib.ssm_scan_bwd(
                x.data_ptr(), dt.data_ptr(), A_log.data_ptr(), Bc.data_ptr(),
                Cc.data_ptr(), D.data_ptr(), state.data_ptr(), dy.data_ptr(),
                0 if dstate is None else dstate.data_ptr(), dx.data_ptr(),
                ddt.data_ptr(), pbc.data_ptr(), pA.data_ptr(), pD.data_ptr(),
                ds0.data_ptr(), 0 if ckpt is None else ckpt.data_ptr(), B, T, di,
                N, Bc.stride(0), Bc.stride(1), Cc.stride(0), Cc.stride(1),
                _DTYPES[x.dtype],
                torch.cuda.current_stream(x.device).cuda_stream)
        build.check(err, "ssm_scan_bwd")
    bc = pbc.sum(0)                       # the blocks' partials, in order
    return (dx, ddt, pA.sum(0), bc[:, :, 0].to(Bc.dtype),
            bc[:, :, 1].to(Cc.dtype), pD.sum(0), ds0)


selective_scan.launches = 0
selective_scan.decode_launches = 0      # T = 1: the decode kernel
selective_scan.prefill_launches = 0     # T > 1: the prefill kernel
selective_scan.save_launches = 0        # ... storing the boundary states
selective_scan.bwd_launches = 0         # the backward kernel
