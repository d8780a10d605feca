"""Fused vocab-blocked log-prob: wrapper of the hand-written CUDA kernel
``fused_logprob_fwd`` in ``csrc/fused_is_grpo.cu`` (the port of the Pallas
``fused_logprob`` TPU kernel) and the differentiable op
:func:`fused_logprob`, which ``model.score_logprobs`` calls for the legacy
``fused_loss=False`` loss.

``log p(target | h)`` comes from a running (max, sumexp, target logit) over
vocabulary blocks of ``h @ w`` (with the logit softcap): the (rows, V)
logits never reach device memory. The Pallas kernel is forward-only (the
JAX package differentiates its plain reference); here the gradient is a
``torch.autograd.Function`` whose backward is ``dl = g (onehot - p)``,
which is the fused IS-GRPO backward (``fused_is_grpo_bwd_rows``: the
``bwd_dh`` and ``bwd_dw`` kernels on the card) with ``a = g`` and
``e = 0``. The forward saves the row logsumexp for it.

``w`` is the logical (d, V) unembedding (``embed.T`` for tied embeddings,
read in its own layout). On CPU tensors :func:`fused_logprob_rows` runs the
plain version :func:`fused_logprob_plain`; on CUDA tensors it launches the
kernel or raises; on fake tensors (the dry run) it launches nothing and
charges ``fused_is_grpo.loss_cost`` (``build.charge``).
"""
from __future__ import annotations

import torch

from repro_torch.common.partitioning import is_sharded
from repro_torch.hopper import build
from repro_torch.hopper import fused_is_grpo as fio


def fused_logprob_plain(hidden, w, targets, *, logit_softcap=0.0,
                        vocab_block=2048):
    """The plain version, the port of ``kernels/fused_logprob/ref.py`` on
    rows, vocab-blocked and differentiable: hidden (R, d), w (d, V),
    targets (R,) int. Float32 products, as the kernel. Returns (logp, lse),
    each float32 (R,)."""
    R = hidden.shape[0]
    V = w.shape[1]
    h = hidden.float()
    tgt = targets.long()
    m = torch.full((R,), float("-inf"), device=h.device)
    l = torch.zeros(R, device=h.device)
    g = torch.zeros(R, device=h.device)
    for v0 in range(0, V, vocab_block):
        logits = fio._softcap(h @ w[:, v0:v0 + vocab_block].float(),
                              logit_softcap)
        m_new = torch.maximum(m, logits.detach().amax(-1))
        l = l * torch.exp(m - m_new) \
            + torch.exp(logits - m_new[:, None]).sum(-1)
        ids = v0 + torch.arange(logits.shape[1], device=h.device)
        g = g + torch.where(tgt[:, None] == ids, logits, 0.0).sum(-1)
        m = m_new
    lse = m + torch.log(l)
    return g - lse, lse


def fused_logprob_rows(hidden, w, targets, *, logit_softcap=0.0):
    """hidden (R, d) float32/bfloat16; w (d, V) float32; targets (R,) int.
    Returns (logp, lse), each float32 (R,). On the card bfloat16 hidden
    runs the IS-GRPO forward's kernel 1 on the tensor cores (d a multiple
    of 8), float32 hidden its SIMT version, counted also in
    ``simt_launches``."""
    fio._check_rows("fused_logprob", hidden, w, targets)
    fake = build.is_fake(hidden)
    if hidden.device.type == "cpu" and not fake:
        with torch.no_grad():
            return fused_logprob_plain(hidden, w, targets,
                                       logit_softcap=logit_softcap)
    w_sk, w_sv = fio._check_kernel("fused_logprob", hidden, w)
    tc = fio._check_tc("fused_logprob", hidden)
    R, d = hidden.shape
    V = w.shape[1]
    splits = fio._fwd_splits(R, V, hidden.device)
    tgt = targets.to(torch.int32).contiguous()
    logp = torch.empty(R, dtype=torch.float32, device=hidden.device)
    lse = torch.empty(R, dtype=torch.float32, device=hidden.device)
    partial = torch.empty(splits, R, 4, dtype=torch.float32,
                          device=hidden.device)
    if fake:
        build.charge("fused_logprob", *fio.loss_cost(
            "logprob", R, d, V, hidden.element_size()))
        return logp, lse
    lib = build.library("fused_is_grpo")
    with torch.cuda.device(hidden.device):
        err = lib.fused_logprob_fwd(
            hidden.data_ptr(), w.data_ptr(), tgt.data_ptr(),
            partial.data_ptr(), logp.data_ptr(), lse.data_ptr(), R, d, V,
            w_sk, w_sv, fio._H_DTYPES[hidden.dtype], splits,
            float(logit_softcap),
            torch.cuda.current_stream(hidden.device).cuda_stream)
    build.check(err, "fused_logprob_fwd")
    build.count(fused_logprob_rows, *(() if tc else ("simt_launches",)))
    return logp, lse


class _FusedLogprob(torch.autograd.Function):
    """Saves hidden, w, targets and the row logsumexp; the backward
    recomputes the logits (dl = g (onehot - p))."""

    @staticmethod
    def forward(ctx, hidden, w, targets, logit_softcap):
        B, S, d = hidden.shape
        logp, lse = fused_logprob_rows(hidden.reshape(B * S, d), w,
                                       targets.reshape(-1),
                                       logit_softcap=logit_softcap)
        ctx.save_for_backward(hidden, w, targets, lse)
        ctx.logit_softcap = logit_softcap
        return logp.reshape(B, S)

    @staticmethod
    def backward(ctx, d_logp):
        hidden, w, targets, lse = ctx.saved_tensors
        B, S, d = hidden.shape
        a = d_logp.reshape(-1).float()
        zero = torch.zeros_like(a)
        # the IS-GRPO backward with e = 0: dl = a (onehot - p)
        dh, dw = fio.fused_is_grpo_bwd_rows(
            hidden.reshape(B * S, d), w, targets.reshape(-1), lse, zero, a,
            zero, logit_softcap=ctx.logit_softcap)
        return dh.reshape(hidden.shape), dw.to(w.dtype), None, None


def fused_logprob(hidden, w, targets, *, logit_softcap: float = 0.0):
    """hidden (B, S, d); w (d, V); targets (B, S) int. Returns
    log p(targets) float32 (B, S), differentiable in hidden and w. On
    ``DTensor`` s (the sharded training path) routed as the fused IS-GRPO
    loss is: the logits materialised where the vocabulary is sharded
    (``fused_is_grpo.materialize_stats``), else this op on each rank's own
    rows (``fused_is_grpo.on_own_rows``)."""
    cap = float(logit_softcap)
    if not is_sharded(hidden):
        return _FusedLogprob.apply(hidden, w, targets, cap)
    if fio.vocab_parallel(hidden):
        return fio.materialize_stats(hidden, w, targets,
                                     logit_softcap=cap)[0]
    return fio.on_own_rows(lambda h, w_, t: _FusedLogprob.apply(
        h, w_, t, cap), hidden, w, (targets,), 1)


fused_logprob_rows.launches = 0
fused_logprob_rows.simt_launches = 0
