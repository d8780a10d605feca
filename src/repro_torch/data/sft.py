"""Supervised warmup on task demonstrations: the port of
``repro.data.sft``.

The paper RL-tunes distilled checkpoints that already produce well-formed
answers; a from-scratch model gets the equivalent head start from a few
hundred cross-entropy steps on synthetic demos before GRPO takes over.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.common.tree import leaves, unflatten
from repro_torch.models import model as M
from repro_torch.optim import adam


def make_sft_batch(task, batch_size: int, max_len: int):
    """Numpy ``(tokens (B, L) int32, mask (B, L) float32)``: demos padded to
    ``max_len``, mask 1 on the answer positions."""
    toks = np.zeros((batch_size, max_len), np.int32)
    mask = np.zeros((batch_size, max_len), np.float32)
    for i in range(batch_size):
        full, plen = task.demo()
        L = min(len(full), max_len)
        toks[i, :L] = full[:L]
        mask[i, plen:L] = 1.0
    return toks, mask


def sft_loss(params, cfg, toks, mask):
    """Token-mean cross-entropy of the answer positions."""
    logits = M.forward_train(params, cfg, toks[:, :-1])
    lp = F.log_softmax(logits, dim=-1)
    tgt = lp.gather(-1, toks[:, 1:, None].long())[..., 0]
    m = mask[:, 1:]
    return -(tgt * m).sum() / m.sum().clamp_min(1.0)


def sft_warmup(params, cfg, task, *, steps: int = 200, batch_size: int = 32,
               max_len: int = 24, lr: float = 3e-3, log_every: int = 0):
    """Trains ``params`` in place (their tensors must require grad or are
    made to). Returns (params, final_loss)."""
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    dev = flat[0].device
    opt = adam.init(params)
    loss = float("inf")
    for i in range(steps):
        toks, mask = make_sft_batch(task, batch_size, max_len)
        lv = sft_loss(params, cfg, torch.from_numpy(toks).to(dev),
                      torch.from_numpy(mask).to(dev))
        grads = torch.autograd.grad(lv, flat)
        params, opt, _ = adam.update(unflatten(params, list(grads)), opt,
                                     params, lr=lr, grad_clip=1.0)
        loss = float(lv.detach())
        if log_every and i % log_every == 0:
            print(f"  sft step {i}: loss {loss:.4f}")
    return params, loss
