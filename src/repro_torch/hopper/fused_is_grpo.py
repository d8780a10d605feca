"""Fused IS+GRPO loss: wrappers of the hand-written CUDA kernels
``csrc/fused_is_grpo.cu`` (the port of the Pallas ``fused_is_grpo`` TPU
kernels, forward and backward) and the differentiable op
:func:`fused_is_grpo`, the port of ``kernels/fused_is_grpo/ops.py``.

``fused_is_grpo`` computes per-token ``(loss_tok, ratio, logp, entropy)``
of the CoPRIS cross-stage IS / GRPO objective directly from ``(hidden,
unembedding)``: the (B, S, V) logits are never kept between forward and
backward. The forward saves O(rows) values (logp, lse, entropy); the
backward maps the upstream cotangents of ``(loss_tok, ratio)`` through
``torch.autograd.grad`` of the same plain ``grpo.per_token_objective`` to
per-row coefficients ``a`` (of logp) and ``e`` (of entropy) — so clip
boundaries and ties get the reference's subgradients — then recomputes the
logits to form ``dl = a (onehot - p) - e p (logit - E[logit])`` and
``dh = dl w^T``, ``dw = h^T dl``.

``w`` is the logical (d, V) unembedding: for tied embeddings pass
``embed.T`` — the kernels read the (V, d) embedding in place and return its
gradient in the same layout. On CPU tensors the row wrappers
:func:`fused_is_grpo_fwd_rows` and :func:`fused_is_grpo_bwd_rows` run the
plain versions (:func:`stats_plain`/:func:`fwd_plain`, the port of
``_stats_blocked``; :func:`bwd_plain`, the port of ``_bwd_blocked``); on
CUDA tensors they launch the kernels or raise. bfloat16 hidden (the main
path) runs every loss kernel on the tensor cores, from w and dl as two
bf16 terms each; float32 hidden runs the f32 SIMT kernels, which each
wrapper also counts in ``simt_launches``.

On fake tensors (the dry run, ``launch/dryrun``) the row wrappers launch
nothing, whatever the tensors' device: they return empty outputs of the
kernels' shapes, allocate their scratch as on the card (the forward's
partials, the backward's dl rows) and charge :func:`loss_cost`
(``build.charge``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.common.partitioning import is_sharded
from repro_torch.core import grpo
from repro_torch.hopper import build

NEG_INF = -1e30
_H_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the backward's dl scratch holds at most this many float32 (2 GiB): rows
# are processed in chunks of DL_SCRATCH_ELEMS // V
DL_SCRATCH_ELEMS = 1 << 29
_BN = 128                      # the kernel's vocabulary tile
_BM = 128                      # the kernel's row tile
# passes over the logits' products on the tensor cores (bf16 hidden): the
# forward and bwd_dw read w (or dl) as two bf16 terms; bwd_dh recomputes the
# logits (two) and forms dh from dl's two terms against w's two and the
# cross term (three). The f32 SIMT kernels make one pass, bwd_dh two.
TC_PASSES = {"fwd": 2, "dh": 5, "dw": 2}
SIMT_PASSES = {"fwd": 1, "dh": 2, "dw": 1}
H100_SMS = 132                 # SMs of an H100 SXM (the fake splits' grid)


def _softcap(x, cap):
    return torch.tanh(x / cap) * cap if cap and cap > 0.0 else x


def epilogue(logp, ent, behaviour, adv, *, clip_low=0.2, clip_high=0.28,
             use_is=True, is_ratio_cap=10.0, entropy_coef=0.0, **_):
    """The elementwise objective, ``grpo.per_token_objective``."""
    return grpo.per_token_objective(
        logp, behaviour, adv, clip_low=clip_low, clip_high=clip_high,
        use_is=use_is, is_ratio_cap=is_ratio_cap, entropy=ent,
        entropy_coef=entropy_coef)


# -- plain versions ----------------------------------------------------------


def stats_plain(hidden, w, targets, *, logit_softcap=0.0, vocab_block=2048):
    """Port of ``_stats_blocked`` on rows: hidden (R, d), w (d, V), targets
    (R,). One pass over vocab blocks keeps a running (max, sumexp, target
    logit, logit-weighted sumexp) per row. Float32 products, as the kernel.
    Returns (logp, lse, entropy), each float32 (R,)."""
    R = hidden.shape[0]
    V = w.shape[1]
    h = hidden.float()
    tgt = targets.long()
    m = torch.full((R,), NEG_INF, device=h.device)
    l = torch.zeros(R, device=h.device)
    g = torch.zeros(R, device=h.device)
    u = torch.zeros(R, device=h.device)
    for v0 in range(0, V, vocab_block):
        logits = _softcap(h @ w[:, v0:v0 + vocab_block].float(),
                          logit_softcap)
        m_new = torch.maximum(m, logits.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[:, None])
        l = l * corr + p.sum(-1)
        u = u * corr + (p * logits).sum(-1)
        ids = v0 + torch.arange(logits.shape[1], device=h.device)
        g = g + torch.where(tgt[:, None] == ids, logits, 0.0).sum(-1)
        m = m_new
    lse = m + torch.log(l)
    return g - lse, lse, lse - u / l


def fwd_plain(hidden, w, targets, behaviour, adv, **cfg):
    """The plain forward: returns (loss_tok, ratio, logp, lse, entropy)."""
    logp, lse, ent = stats_plain(hidden, w, targets,
                                 logit_softcap=cfg.get("logit_softcap", 0.0))
    loss_tok, ratio = epilogue(logp, ent, behaviour.float(), adv.float(),
                               **cfg)
    return loss_tok, ratio, logp, lse, ent


def _dlogits(logits, ids, targets, lse, ebar, a, e, logit_softcap):
    p = torch.exp(logits - lse[:, None])
    hit = (targets.long()[:, None] == ids).float()
    dl = a[:, None] * (hit - p) - e[:, None] * p * (logits - ebar[:, None])
    if logit_softcap > 0.0:
        dl = dl * (1.0 - torch.square(logits / logit_softcap))
    return dl


def bwd_plain(hidden, w, targets, lse, ebar, a, e, *, logit_softcap=0.0,
              vocab_block=2048):
    """Port of ``_bwd_blocked`` on rows: recompute each vocab block's
    logits, form dl, accumulate dh = dl w^T and write dw = h^T dl per block.
    Returns dh (R, d) in hidden's dtype and dw (d, V) float32."""
    V = w.shape[1]
    h = hidden.float()
    dh = torch.zeros_like(h)
    dw = torch.zeros(w.shape, dtype=torch.float32, device=h.device)
    for v0 in range(0, V, vocab_block):
        blk = w[:, v0:v0 + vocab_block].float()
        logits = _softcap(h @ blk, logit_softcap)
        ids = v0 + torch.arange(blk.shape[1], device=h.device)
        dl = _dlogits(logits, ids, targets, lse, ebar, a, e, logit_softcap)
        dh += dl @ blk.T
        dw[:, v0:v0 + vocab_block] = h.T @ dl
    return dh.to(hidden.dtype), dw


def bwd_dh_plain(hidden, w, targets, lse, ebar, a, e, *, logit_softcap=0.0):
    """Plain version of the ``bwd_dh`` entry point, the reference its
    kernel is checked against: returns (dl (R, V), dh (R, d)), both
    float32."""
    h = hidden.float()
    wf = w.float()
    logits = _softcap(h @ wf, logit_softcap)
    ids = torch.arange(w.shape[1], device=h.device)
    dl = _dlogits(logits, ids, targets, lse, ebar, a, e, logit_softcap)
    return dl, dl @ wf.T


def bwd_dw_plain(hidden, dl):
    """Plain version of the ``bwd_dw`` entry point, the reference its
    kernel is checked against: dw = h^T dl (d, V)."""
    return hidden.float().T @ dl


# -- kernel wrappers ---------------------------------------------------------


def loss_cost(kernel, R, d, V, h_itemsize=2):
    """(FLOPs, device-memory bytes) of one launch of ``kernel`` ("fwd", the
    IS-GRPO forward; "logprob", the log-prob forward; "dh"; "dw") on R rows
    of hidden (``h_itemsize`` bytes an element) against a float32 (d, V)
    w: the work of the kernels' bounds in ``chip_smoke.py``. FLOPs: 2 R d V
    a pass over the logits' products, times the kernel's passes
    (:data:`TC_PASSES` for bf16 hidden, :data:`SIMT_PASSES` for float32).
    Bytes: hidden and w read once; the forward reads 3 and writes 5
    float32 per row (the log-prob forward 1 and 2), bwd_dh reads 7 per row
    and writes dl (R, V) and dh (R, d) in float32, bwd_dw reads dl and
    writes dw (d, V)."""
    passes = (TC_PASSES if h_itemsize == 2 else SIMT_PASSES)[
        "fwd" if kernel == "logprob" else kernel]
    flops = passes * 2 * R * d * V
    h, w = h_itemsize * R * d, 4 * V * d
    if kernel == "fwd":
        return flops, h + w + 32 * R
    if kernel == "logprob":
        return flops, h + w + 12 * R
    if kernel == "dh":
        return flops, h + w + 28 * R + 4 * R * V + 4 * R * d
    return flops, h + 4 * R * V + 4 * V * d


def _w_strides(w):
    """(stride_k, stride_v) of the (d, V) matrix w, in one of the two
    layouts the kernel reads."""
    d, V = w.shape
    if w.stride() == (V, 1) or w.stride() == (1, d):
        return w.stride()
    raise ValueError(f"fused_is_grpo kernel reads w (d, V) row-major or as "
                     f"the transpose of a row-major (V, d); got strides "
                     f"{w.stride()}")


def _check_rows(name, hidden, w, *rows):
    R, d = hidden.shape
    if w.dim() != 2 or w.shape[0] != d:
        raise ValueError(f"{name}: want hidden (R, d), w (d, V); got "
                         f"{tuple(hidden.shape)}, {tuple(w.shape)}")
    for t in rows:
        if t.shape != (R,):
            raise ValueError(f"{name}: per-row inputs must be ({R},), got "
                             f"{tuple(t.shape)}")
    if any(t.device != hidden.device for t in (w,) + rows):
        raise ValueError(f"{name}: tensors on different devices")


def _check_kernel(name, hidden, w):
    if hidden.device.type != "cuda" and not build.is_fake(hidden):
        raise ValueError(f"{name}: unsupported device {hidden.device}")
    if hidden.dtype not in _H_DTYPES or w.dtype != torch.float32:
        raise TypeError(f"{name} kernel takes float32/bfloat16 hidden and "
                        f"float32 w; got {hidden.dtype}, {w.dtype}")
    if not hidden.is_contiguous():
        raise ValueError(f"{name} kernel needs a contiguous hidden")
    return _w_strides(w)


def _check_tc(name, hidden):
    """The tensor-core kernels read bf16 hidden rows with 16-byte loads:
    d a multiple of 8 and a 16-byte aligned start. Returns whether hidden
    takes them (bf16); float32 hidden takes the SIMT kernels."""
    if hidden.dtype != torch.bfloat16:
        return False
    d = hidden.shape[1]
    if d % 8 or (not build.is_fake(hidden) and hidden.data_ptr() % 16):
        raise ValueError(f"{name} tensor-core kernels take a 16-byte aligned "
                         f"bf16 hidden with d a multiple of 8; got d={d}, "
                         f"address {hidden.data_ptr():#x}")
    return True


def _rows32(*ts):
    return [t.float().contiguous() for t in ts]


_FWD_TILES_PER_BLOCK = 4


def _fwd_splits(R: int, V: int, device) -> int:
    """Vocabulary splits of the forward's kernel 1: each block loops over at
    most four 128-column vocabulary tiles (at R = 4064, V = 128256: 251
    splits, 8032 blocks, ~30 waves of two blocks per SM, the tensor-core
    kernel's occupancy; partials of 16 MB), fewer where the grid would not
    give every SM two blocks four times over."""
    n_tiles = -(-V // _BN)
    row_tiles = -(-R // _BM)
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if device.type == "cuda" else H100_SMS)
    per_split = max(1, min(_FWD_TILES_PER_BLOCK,
                           n_tiles * row_tiles // (8 * sms)))
    return -(-n_tiles // per_split)


def fused_is_grpo_fwd_rows(hidden, w, targets, behaviour, adv, *,
                           logit_softcap=0.0, clip_low=0.2, clip_high=0.28,
                           use_is=True, is_ratio_cap=10.0, entropy_coef=0.0):
    """hidden (R, d); w (d, V); targets (R,) int; behaviour/adv (R,).
    Returns ``(loss_tok, ratio, logp, lse, entropy)``, each float32 (R,)."""
    _check_rows("fused_is_grpo_fwd", hidden, w, targets, behaviour, adv)
    cfg = dict(logit_softcap=logit_softcap, clip_low=clip_low,
               clip_high=clip_high, use_is=use_is, is_ratio_cap=is_ratio_cap,
               entropy_coef=entropy_coef)
    fake = build.is_fake(hidden)
    if hidden.device.type == "cpu" and not fake:
        return fwd_plain(hidden, w, targets, behaviour, adv, **cfg)
    w_sk, w_sv = _check_kernel("fused_is_grpo_fwd", hidden, w)
    tc = _check_tc("fused_is_grpo_fwd", hidden)
    R, d = hidden.shape
    V = w.shape[1]
    splits = _fwd_splits(R, V, hidden.device)
    tgt = targets.to(torch.int32).contiguous()
    beh, ad = _rows32(behaviour, adv)
    outs = [torch.empty(R, dtype=torch.float32, device=hidden.device)
            for _ in range(5)]
    partial = torch.empty(splits, R, 4, dtype=torch.float32,
                          device=hidden.device)
    if fake:
        build.charge("fused_is_grpo_fwd", *loss_cost(
            "fwd", R, d, V, hidden.element_size()))
        return tuple(outs)
    lib = build.library("fused_is_grpo")
    with torch.cuda.device(hidden.device):
        err = lib.fused_is_grpo_fwd(
            hidden.data_ptr(), w.data_ptr(), tgt.data_ptr(), beh.data_ptr(),
            ad.data_ptr(), partial.data_ptr(),
            *(o.data_ptr() for o in outs), R, d, V, w_sk, w_sv,
            _H_DTYPES[hidden.dtype], splits, float(logit_softcap),
            1.0 - clip_low, 1.0 + clip_high, int(use_is),
            math.log(is_ratio_cap), float(entropy_coef),
            torch.cuda.current_stream(hidden.device).cuda_stream)
    build.check(err, "fused_is_grpo_fwd")
    build.count(fused_is_grpo_fwd_rows, *(() if tc else ("simt_launches",)))
    return tuple(outs)


def fused_is_grpo_bwd_dh_rows(hidden, w, targets, lse, ebar, a, e, *,
                              logit_softcap=0.0):
    """The ``bwd_dh`` entry point on one chunk of rows: recompute the
    logits, write dl, then dh = dl w^T. Returns (dl (R, V), dh (R, d)),
    both float32. CUDA tensors only: on the CPU the backward runs
    :func:`bwd_plain` through :func:`fused_is_grpo_bwd_rows`.

    bfloat16 hidden (the main path) runs the tensor-core kernels, which
    take d a multiple of 8; float32 hidden the SIMT kernels on the f32 FMA
    pipes, counted also in ``simt_launches``."""
    _check_rows("fused_is_grpo_bwd_dh", hidden, w, targets, lse, ebar, a, e)
    w_sk, w_sv = _check_kernel("fused_is_grpo_bwd_dh", hidden, w)
    tc = _check_tc("fused_is_grpo_bwd_dh", hidden)
    R, d = hidden.shape
    V = w.shape[1]
    tgt = targets.to(torch.int32).contiguous()
    lse, ebar, a, e = _rows32(lse, ebar, a, e)
    dl = torch.empty(R, V, dtype=torch.float32, device=hidden.device)
    dh = torch.empty(R, d, dtype=torch.float32, device=hidden.device)
    if build.is_fake(hidden):
        build.charge("fused_is_grpo_bwd_dh", *loss_cost(
            "dh", R, d, V, hidden.element_size()))
        return dl, dh
    lib = build.library("fused_is_grpo")
    args = [hidden.data_ptr(), w.data_ptr(), tgt.data_ptr(), lse.data_ptr(),
            ebar.data_ptr(), a.data_ptr(), e.data_ptr(), dl.data_ptr(),
            dh.data_ptr(), R, d, V, w_sk, w_sv]
    with torch.cuda.device(hidden.device):
        stream = torch.cuda.current_stream(hidden.device).cuda_stream
        if tc:
            err = lib.fused_is_grpo_bwd_dh_tc(*args, float(logit_softcap),
                                              stream)
        else:
            err = lib.fused_is_grpo_bwd_dh(*args, _H_DTYPES[hidden.dtype],
                                           float(logit_softcap), stream)
    build.check(err, "fused_is_grpo_bwd_dh")
    build.count(fused_is_grpo_bwd_dh_rows, *(() if tc else ("simt_launches",)))
    return dl, dh


def fused_is_grpo_bwd_dw_rows(hidden, dl, dw, *, accumulate=False):
    """The ``bwd_dw`` entry point: dw = h^T dl, or dw += h^T dl with
    ``accumulate``. ``dw`` is the (d, V) float32 output in either layout
    (``torch.empty_like(w)`` of the transposed (V, d) embedding keeps the
    embedding's). Returns dw. CUDA tensors only, as ``bwd_dh``: bfloat16
    hidden on the tensor cores (d a multiple of 8), float32 hidden on the
    SIMT kernel, counted also in ``simt_launches``."""
    R, d = hidden.shape
    V = dl.shape[1]
    if dl.shape != (R, V) or dl.dtype != torch.float32 \
            or dw.shape != (d, V) or dw.dtype != torch.float32:
        raise ValueError(f"fused_is_grpo_bwd_dw: want dl ({R}, V) and dw "
                         f"({d}, V) float32; got {tuple(dl.shape)} "
                         f"{dl.dtype}, {tuple(dw.shape)} {dw.dtype}")
    _check_kernel("fused_is_grpo_bwd_dw", hidden, dw)
    tc = _check_tc("fused_is_grpo_bwd_dw", hidden)
    dw_sk, dw_sv = _w_strides(dw)
    dl = dl.contiguous()
    if build.is_fake(hidden):
        build.charge("fused_is_grpo_bwd_dw", *loss_cost(
            "dw", R, d, V, hidden.element_size()))
        return dw
    lib = build.library("fused_is_grpo")
    with torch.cuda.device(hidden.device):
        err = lib.fused_is_grpo_bwd_dw(
            hidden.data_ptr(), dl.data_ptr(), dw.data_ptr(), R, d, V, dw_sk,
            dw_sv, _H_DTYPES[hidden.dtype], int(accumulate),
            torch.cuda.current_stream(hidden.device).cuda_stream)
    build.check(err, "fused_is_grpo_bwd_dw")
    build.count(fused_is_grpo_bwd_dw_rows, *(() if tc else ("simt_launches",)))
    return dw


def fused_is_grpo_bwd_rows(hidden, w, targets, lse, ebar, a, e, *,
                           logit_softcap=0.0):
    """Backward on rows: (dh (R, d) in hidden's dtype, dw in w's shape and
    layout, float32). CUDA: row chunks of at most DL_SCRATCH_ELEMS // V
    through the bwd_dh and bwd_dw kernels."""
    _check_rows("fused_is_grpo_bwd", hidden, w, targets, lse, ebar, a, e)
    if hidden.device.type == "cpu" and not build.is_fake(hidden):
        return bwd_plain(hidden, w, targets, lse, ebar, a, e,
                         logit_softcap=logit_softcap)
    R, V = hidden.shape[0], w.shape[1]
    chunk = max(1, min(R, DL_SCRATCH_ELEMS // V))
    dh = torch.empty(hidden.shape, dtype=torch.float32, device=hidden.device)
    dw = torch.empty_like(w, dtype=torch.float32)   # keeps w's layout
    for r0 in range(0, R, chunk):
        rs = slice(r0, r0 + chunk)
        dl, dh[rs] = fused_is_grpo_bwd_dh_rows(
            hidden[rs], w, targets[rs], lse[rs], ebar[rs], a[rs], e[rs],
            logit_softcap=logit_softcap)
        fused_is_grpo_bwd_dw_rows(hidden[rs], dl, dw, accumulate=r0 > 0)
        del dl
    return dh.to(hidden.dtype), dw


# -- the differentiable op ----------------------------------------------------


class _FusedISGRPO(torch.autograd.Function):
    """Saves only O(rows) values; the backward recomputes the logits."""

    @staticmethod
    def forward(ctx, hidden, w, targets, behaviour, adv, cfg):
        B, S, d = hidden.shape
        outs = fused_is_grpo_fwd_rows(
            hidden.reshape(B * S, d), w, targets.reshape(-1),
            behaviour.reshape(-1), adv.reshape(-1), **cfg)
        loss_tok, ratio, logp, lse, ent = (o.reshape(B, S) for o in outs)
        ctx.save_for_backward(hidden, w, targets, behaviour, adv, logp, lse,
                              ent)
        ctx.cfg = cfg
        return loss_tok, ratio, logp, ent

    @staticmethod
    def backward(ctx, d_loss, d_ratio, d_logp, d_ent):
        hidden, w, targets, behaviour, adv, logp, lse, ent = ctx.saved_tensors
        cfg = ctx.cfg
        zero = torch.zeros_like(logp)
        d_loss, d_ratio, d_logp, d_ent = (
            zero if g is None else g for g in (d_loss, d_ratio, d_logp, d_ent))
        # per-row cotangents of the logp / entropy channels through the SAME
        # elementwise epilogue the forward used: clip boundaries and
        # minimum ties get the reference's subgradient convention
        with torch.enable_grad():
            ins = [x.detach().requires_grad_()
                   for x in (logp, ent, behaviour, adv)]
            loss_tok, ratio = epilogue(*ins, **cfg)
            dlp, den, d_beh, d_adv = torch.autograd.grad(
                (loss_tok, ratio), ins, (d_loss, d_ratio), allow_unused=True)
        dlp, den, d_beh, d_adv = (zero if g is None else g
                                  for g in (dlp, den, d_beh, d_adv))
        a = d_logp + dlp
        e = d_ent + den
        B, S, d = hidden.shape
        dh, dw = fused_is_grpo_bwd_rows(
            hidden.reshape(B * S, d), w, targets.reshape(-1),
            lse.reshape(-1), (lse - ent).reshape(-1), a.reshape(-1),
            e.reshape(-1), logit_softcap=cfg["logit_softcap"])
        return (dh.reshape(hidden.shape), dw.to(w.dtype), None, d_beh, d_adv,
                None)


def materialize_stats(hidden, w, targets, *, logit_softcap=0.0):
    """The reference's ``materialize`` route, in plain PyTorch (autograd):
    the (B, S, V) logits in one product, laid out rows over the batch axes
    and vocabulary over "model" (``shard_activation``), then (logp, lse,
    entropy) float32 (B, S) from them. The sharded training path takes it
    where the vocabulary is sharded: blocking over a vocab-sharded weight
    would reshard the weight."""
    from repro_torch.common.partitioning import shard_activation
    logits = _softcap(hidden.float() @ w.to(hidden.dtype).float(),
                      logit_softcap)
    logits = shard_activation(logits, "dp", None, "tp")
    m = logits.detach().amax(-1, keepdim=True)
    e = torch.exp(logits - m)
    z = e.sum(-1, keepdim=True)
    lse = (m + torch.log(z))[..., 0]
    ebar = ((e / z) * logits).sum(-1)
    return _target_logit(logits, targets) - lse, lse, lse - ebar


def materialize_is_grpo(hidden, w, targets, behaviour, adv, **cfg):
    """:func:`materialize_stats` and the shared epilogue: ``(loss_tok,
    ratio, logp, entropy)`` float32 (B, S)."""
    logp, _, ent = materialize_stats(hidden, w, targets,
                                     logit_softcap=cfg["logit_softcap"])
    loss_tok, ratio = epilogue(logp, ent, behaviour, adv, **cfg)
    return loss_tok, ratio, logp, ent


def _target_logit(logits, targets):
    """logits[..., targets] of the (B, S, V) ``DTensor`` logits: each rank
    picks the targets in its own vocabulary slice, and the picks sum over
    the axes that split it."""
    if not is_sharded(logits):
        return logits.gather(-1, targets[..., None].long())[..., 0]
    from torch.distributed.tensor import Partial
    from repro_torch.common.partitioning import (activation_placements,
                                                 local_call, vocab_slice)
    mesh = logits.device_mesh
    rows = activation_placements(mesh, targets.shape, "dp", None)
    lay = activation_placements(mesh, logits.shape, "dp", None, "tp")
    split, start, v_local = vocab_slice(mesh, logits.shape[-1], lay, 2)

    def pick(lg, t):
        local = t.long() - start
        hit = (local >= 0) & (local < v_local)
        got = lg.gather(-1, torch.where(hit, local, 0)[..., None])[..., 0]
        return got * hit.to(got.dtype)

    out = tuple(Partial() if a in split else r
                for a, r in zip(mesh.mesh_dim_names, rows))
    return local_call(pick, mesh, (logits, targets), (lay, rows), out)


def vocab_parallel(hidden) -> bool:
    """Whether the sharded path's loss materialises its logits: a mesh
    whose "model" axis has more than one rank shards the vocabulary."""
    mesh = hidden.device_mesh
    return dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1) > 1


def on_own_rows(fn, hidden, w, rows, n_out):
    """``fn(h, w, *rows)`` (a fused op of this family) on each rank's own
    rows (``partitioning.on_rows``): hidden (B, S, d) and each of ``rows``
    (B, S) over the batch axes, the weight whole on every rank (its
    gradient a pending sum over the batch axes). Returns ``n_out``
    (B, S) ``DTensor`` s in the rows' layout (one when ``n_out`` is 1)."""
    from repro_torch.common.partitioning import on_rows
    return on_rows(lambda h, *r: fn(h.contiguous(), r[-1], *r[:-1]),
                   (hidden,) + tuple(rows), w, n_out=n_out)


def _sharded_is_grpo(hidden, w, targets, behaviour, adv, cfg):
    """The loss on a mesh: :func:`materialize_is_grpo` where the
    vocabulary is sharded, else the fused op on each rank's own rows
    (:func:`on_own_rows`)."""
    if vocab_parallel(hidden):
        return materialize_is_grpo(hidden, w, targets, behaviour, adv, **cfg)
    return on_own_rows(lambda h, w_, t, b, a: _FusedISGRPO.apply(
        h, w_, t, b, a, cfg), hidden, w, (targets, behaviour, adv), 4)


def fused_is_grpo(hidden, w, targets, behaviour, adv, *,
                  logit_softcap: float = 0.0, clip_low: float = 0.2,
                  clip_high: float = 0.28, use_is: bool = True,
                  is_ratio_cap: float = 10.0, entropy_coef: float = 0.0):
    """hidden (B, S, d); w (d, V) (``embed.T`` for tied embeddings);
    targets/behaviour/adv (B, S). Returns ``(loss_tok, ratio, logp,
    entropy)`` float32 (B, S). ``adv`` is per-token (broadcast per-sequence
    advantages before calling). Differentiable in hidden, w, behaviour and
    adv; the (B, S, V) logits are never kept between forward and backward.
    On ``DTensor`` s (the sharded training path) see
    :func:`_sharded_is_grpo`.
    """
    cfg = dict(logit_softcap=float(logit_softcap), clip_low=float(clip_low),
               clip_high=float(clip_high), use_is=bool(use_is),
               is_ratio_cap=float(is_ratio_cap),
               entropy_coef=float(entropy_coef))
    if is_sharded(hidden):
        return _sharded_is_grpo(hidden, w, targets, behaviour.float(),
                                adv.float(), cfg)
    return _FusedISGRPO.apply(hidden, w, targets, behaviour.float(),
                              adv.float(), cfg)


fused_is_grpo_fwd_rows.launches = 0
fused_is_grpo_fwd_rows.simt_launches = 0
fused_is_grpo_bwd_dh_rows.launches = 0
fused_is_grpo_bwd_dh_rows.simt_launches = 0
fused_is_grpo_bwd_dw_rows.launches = 0
fused_is_grpo_bwd_dw_rows.simt_launches = 0
