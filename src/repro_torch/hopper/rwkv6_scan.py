"""WKV6 recurrence of the rwkv6 time-mix: wrapper of the hand-written CUDA
kernels ``csrc/wkv6.cu`` (the port of the Pallas ``rwkv6_scan`` TPU kernel,
and the backward that the Pallas family lacks).

On CPU tensors the wrapper runs the plain PyTorch versions,
:func:`wkv6_plain` (a copy of the reference's ``models/rwkv6.wkv6_scan``)
and :func:`wkv6_bwd_plain`; on CUDA tensors it launches the kernels or
raises. T = 1 (a decode step) runs the decode kernel, T > 1 the prefill
kernel; ``launches`` counts both, ``decode_launches`` and
``prefill_launches`` each. With grad enabled and an input that requires
it, the recurrence runs as an autograd function whose backward is the
kernel ``wkv6_bwd`` on the card (counted in ``bwd_launches``) and the plain
backward on the CPU; on the card its forward runs the prefill kernel that
also stores the states the backward starts its chunks from
(:func:`boundaries`), counted in ``save_launches`` in place of
``prefill_launches``.

On fake tensors (the dry run, ``launch/dryrun``) the wrappers launch
nothing, whatever the tensors' device: each kernel the card would launch
returns empty outputs of its shapes, its scratch and boundary states
allocated as on the card, and charges :func:`wkv_cost`
(``build.charge``).
"""
from __future__ import annotations

import torch

from repro_torch.hopper import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64)       # the hd csrc/wkv6.cu dispatches
BWD_CHUNK = 8                   # kBwdChunk of csrc/wkv6.cu


def wkv_cost(kernel, B, T, H, hd, itemsize, boundary_elems=0):
    """(FLOPs, device-memory bytes) of one launch of the forward
    (``"fwd"``, storing ``boundary_elems`` float32 boundary states) or the
    backward (``"bwd"``) at r (B, T, H, hd): the work of the kernels'
    bounds in ``chip_smoke.py``. FLOPs: 6 float32 operations per (row,
    step, head, i, j) forward, 14 backward. Bytes: forward r, k, v, w read
    and y written, u, the state read and written (and the boundary
    states); backward r, k, v, w, dy read, dr, dk, dv, dw written, u and
    its gradient, the state and its gradient."""
    n = B * T * H * hd
    if kernel == "fwd":
        return (6 * n * hd, itemsize * 5 * n + 4 * H * hd
                + 8 * B * H * hd * hd + 4 * boundary_elems)
    return (14 * n * hd, itemsize * 9 * n + 8 * H * hd
            + 8 * B * H * hd * hd)


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


def wkv6_bwd_plain(r, k, v, w, u, state, dy, dstate=None):
    """The gradients of :func:`wkv6_plain` (without ``seq_mask``: the
    wrappers apply it to k and w outside) by an explicit reverse loop in
    float32, the plain version of the kernel ``wkv6_bwd``. ``state`` is the
    initial state, ``dy`` the gradient of y, ``dstate`` that of the final
    state (None: zero). With G_t = dL/dS_t, G_{t-1} = w_t G_t + r_t dy_t^T:

        dr_t[i] = sum_j (S_{t-1}[i,j] + u_i k_t[i] v_t[j]) dy_t[j]
        dk_t[i] = sum_j G_t[i,j] v_t[j] + u_i r_t[i] (v_t . dy_t)
        dv_t[j] = sum_i G_t[i,j] k_t[i] + (sum_i r_t[i] u_i k_t[i]) dy_t[j]
        dw_t[i] = sum_j G_t[i,j] S_{t-1}[i,j]
        du[i] = sum_{b,t} r_t[i] k_t[i] (v_t . dy_t)      dstate0 = G_0

    The states S_t are kept from a forward pass, never recovered by
    dividing by a decay. Returns (dr, dk, dv, dw, du, dstate0): the first
    four in r's, k's, v's and w's dtypes, du and dstate0 float32."""
    rf, kf, vf, wf, dyf = (a.float() for a in (r, k, v, w, dy))
    uf = u.float()
    T = r.shape[1]
    ss = [state.float()]                                      # S_0 .. S_T
    for t in range(T):
        ss.append(wf[:, t, :, :, None] * ss[-1]
                  + kf[:, t, :, :, None] * vf[:, t, :, None, :])
    G = torch.zeros_like(ss[0]) if dstate is None else dstate.float()
    dr, dk, dv, dw = (torch.empty_like(rf) for _ in range(4))
    du = torch.zeros_like(uf)
    for t in reversed(range(T)):
        rt, kt, vt, wt, dyt = rf[:, t], kf[:, t], vf[:, t], wf[:, t], dyf[:, t]
        vdy = (vt * dyt).sum(-1, keepdim=True)                # (B, H, 1)
        q = (rt * uf[None] * kt).sum(-1, keepdim=True)
        dr[:, t] = (torch.einsum("bhij,bhj->bhi", ss[t], dyt)
                    + uf[None] * kt * vdy)
        dk[:, t] = (torch.einsum("bhij,bhj->bhi", G, vt)
                    + uf[None] * rt * vdy)
        dv[:, t] = torch.einsum("bhij,bhi->bhj", G, kt) + q * dyt
        dw[:, t] = (G * ss[t]).sum(-1)
        du += (rt * kt * vdy).sum(0)
        G = wt[..., None] * G + rt[..., None] * dyt[..., None, :]
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype),
            du, G)


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


def _check_kernel(r, k, v, w, u, state):
    """What the CUDA kernels take; raises on anything else."""
    hd = r.shape[-1]
    if r.dtype not in _DTYPES or not (r.dtype == k.dtype == v.dtype
                                      == w.dtype) or hd not in _HEAD_DIMS:
        raise TypeError(f"wkv6 kernel takes r, k, v, w all float32 or all "
                        f"bfloat16 and head_dim in {_HEAD_DIMS}; got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}, {w.dtype}, "
                        f"hd={hd}")
    if u.dtype != torch.float32 or state.dtype != torch.float32:
        raise TypeError("wkv6 kernel: u and the state must be float32")


def _forward_kernel(r, k, v, w, u, state, ckpt=None):
    """One counted launch of the forward kernels; updates ``state`` (and
    stores the backward's boundary states into ``ckpt``)."""
    if not all(t.is_contiguous() for t in (r, k, v, w, u, state)):
        raise ValueError("wkv6 kernel needs contiguous r, k, v, w, u, state")
    y = launch(r, k, v, w, u, state, ckpt=ckpt)
    build.count(wkv6, "save_launches" if ckpt is not None
                else "decode_launches" if r.shape[1] == 1
                else "prefill_launches")
    return y


def boundaries(r):
    """The scratch of the backward's boundary states for inputs shaped as
    ``r`` (CUDA): (B, H, ceil(T / chunk) - 1, hd, hd) float32, the state
    before every chunk of ``wkv6_bwd_chunk`` steps but the first; None when
    T fits in one chunk."""
    B, T, H, hd = r.shape
    chunk = (BWD_CHUNK if build.is_fake(r) else build.library(
        "wkv6").wkv6_bwd_chunk(hd, _DTYPES[r.dtype], None))
    nb = (T + chunk - 1) // chunk - 1
    if nb < 1:
        return None
    return torch.empty(B, H, nb, hd, hd, device=r.device,
                       dtype=torch.float32)


class _WKV6(torch.autograd.Function):
    """WKV6 under autograd: the forward kernel on a copy of the initial
    state, storing the states at the backward's chunk boundaries (kept for
    the backward, which recomputes each chunk's states from them), the
    backward kernel; on the CPU the two plain versions."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        ckpt = None
        if r.device.type == "cpu" and not build.is_fake(r):
            y, final = wkv6_plain(r, k, v, w, u, state)
        else:
            final = state.clone()
            ckpt = boundaries(r)
            y = _forward_kernel(r, k, v, w, u, final, ckpt)
        ctx.save_for_backward(r, k, v, w, u, state, ckpt)
        return y, final

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, dstate):
        r, k, v, w, u, state, ckpt = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(r)
        if r.device.type == "cpu" and not build.is_fake(r):
            return wkv6_bwd_plain(r, k, v, w, u, state, dy, dstate)
        grads = launch_bwd(r, k, v, w, u, state, dy, dstate, ckpt=ckpt)
        build.count(wkv6, key="bwd_launches")
        return grads


def wkv6(r, k, v, w, u, state, *, seq_mask=None):
    """Same contract as :func:`wkv6_plain`. On CUDA: r, k, v, w contiguous
    in one dtype (float32 or bfloat16), u and the state float32 and
    contiguous. Without autograd the kernel updates ``state`` IN PLACE and
    returns it as the final state; with grad enabled and an input that
    requires it, the recurrence is differentiable (``seq_mask`` applied to
    k and w outside it), ``state`` is left as it was and the final state is
    a new tensor."""
    _check(r, k, v, w, u, state, seq_mask)
    fake = build.is_fake(r)
    if r.device.type not in ("cpu", "cuda") and not fake:
        raise ValueError(f"wkv6: unsupported device {r.device}")
    if r.device.type == "cuda" or fake:
        _check_kernel(r, k, v, w, u, state)
    inputs = (r, k, v, w, u, state)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in inputs)
    if r.device.type == "cpu" and not fake and not grad:
        return wkv6_plain(*inputs, seq_mask=seq_mask)
    if seq_mask is not None:                           # exact: mask is 0 / 1
        m = seq_mask[:, :, None, None].to(r.dtype)
        k = k * m
        w = w * m + (1 - m)
    if grad:
        return _WKV6.apply(r, k, v, w, u, state)
    return _forward_kernel(r, k, v, w, u, state), state


def launch(r, k, v, w, u, state, *, prefill_only=False, ckpt=None):
    """One launch on CUDA tensors that :func:`wkv6` has checked: the decode
    kernel at T = 1 (unless ``prefill_only``), else the prefill kernel;
    with ``ckpt`` (:func:`boundaries`) the prefill kernel that also stores
    the backward's boundary states there. Updates ``state`` in place,
    counts nothing, returns y."""
    B, T, H, hd = r.shape
    fake = build.is_fake(r)
    if not fake and state.data_ptr() % 16:
        raise ValueError("wkv6 kernel: the state must be 16-byte aligned")
    y = torch.empty_like(r)
    if fake:
        build.charge("wkv6", *wkv_cost("fwd", B, T, H, hd, r.element_size(),
                                       0 if ckpt is None else ckpt.numel()))
        return y
    lib = build.library("wkv6")
    stream = torch.cuda.current_stream(r.device).cuda_stream
    with torch.cuda.device(r.device):
        if ckpt is None:
            err = lib.wkv6_fwd(
                r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), state.data_ptr(), y.data_ptr(), B, T, H, hd,
                _DTYPES[r.dtype], int(prefill_only), stream)
        else:
            err = lib.wkv6_fwd_save(
                r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), state.data_ptr(), y.data_ptr(),
                ckpt.data_ptr(), B, T, H, hd, _DTYPES[r.dtype], stream)
    build.check(err, "wkv6_fwd")
    return y


def launch_bwd(r, k, v, w, u, state, dy, dstate=None, *, ckpt=None):
    """One launch of ``wkv6_bwd`` on CUDA tensors that :func:`wkv6` has
    checked (``state`` the initial state, left as it is; ``dstate`` the
    final state's gradient or None; ``ckpt`` the boundary states the
    forward stored, or None: the forward that stores them runs first, on a
    copy of the state), then the fixed-order sum of its per-row partials of
    du. Counts nothing; returns what :func:`wkv6_bwd_plain` returns."""
    B, T, H, hd = r.shape
    dy = dy.to(r.dtype).contiguous()
    if dstate is not None:
        dstate = dstate.float().contiguous()
    if not all(t.is_contiguous() for t in (r, k, v, w, u, state)):
        raise ValueError("wkv6 kernel needs contiguous r, k, v, w, u, state")
    fake = build.is_fake(r)
    if not fake and (state.data_ptr() % 16 or (
            dstate is not None and dstate.data_ptr() % 16)):
        raise ValueError("wkv6 kernel: the states must be 16-byte aligned")
    f32 = dict(device=r.device, dtype=torch.float32)
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    pu = torch.empty(B, H, hd, **f32)             # du summed over a row's steps
    ds0 = torch.empty(B, H, hd, hd, **f32)
    if ckpt is None:
        ckpt = boundaries(r)
        if ckpt is not None:
            launch(r, k, v, w, u, state.clone(), ckpt=ckpt)
    if ckpt is not None and (not ckpt.is_contiguous()
                             or (not fake and ckpt.data_ptr() % 16)):
        raise ValueError("wkv6 kernel: the boundary states must be "
                         "contiguous and 16-byte aligned")
    if fake:
        build.charge("wkv6_bwd", *wkv_cost("bwd", B, T, H, hd,
                                           r.element_size()))
        return dr, dk, dv, dw, pu.sum(0), ds0
    lib = build.library("wkv6")
    with torch.cuda.device(r.device):
        err = lib.wkv6_bwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), state.data_ptr(), dy.data_ptr(),
            0 if dstate is None else dstate.data_ptr(), dr.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), pu.data_ptr(),
            ds0.data_ptr(), 0 if ckpt is None else ckpt.data_ptr(), B, T, H,
            hd, _DTYPES[r.dtype],
            torch.cuda.current_stream(r.device).cuda_stream)
    build.check(err, "wkv6_bwd")
    return dr, dk, dv, dw, pu.sum(0), ds0


wkv6.launches = 0
wkv6.decode_launches = 0                # T = 1: the decode kernel
wkv6.prefill_launches = 0               # T > 1: the prefill kernel
wkv6.save_launches = 0                  # ... storing the boundary states
wkv6.bwd_launches = 0                   # the backward kernel
