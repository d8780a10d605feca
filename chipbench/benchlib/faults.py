"""Faults planted under the timed path, to show that ``correct`` catches
them: each is a context manager that patches one function of the program
and restores it on exit.

* ``frozen``: the step returns its state unchanged (AdamW writes nothing).
* ``half``: half of the batch left out, the loss's token mean taken over the
  rest.
* ``token``: a token altered where it is produced (the sampler's token
  moved to the next id, its recorded log-prob kept).

A cell on one chip has no exchange between chips to leave out.
"""
from __future__ import annotations

from contextlib import contextmanager


@contextmanager
def _patched(module, name, fn):
    old = getattr(module, name)
    setattr(module, name, fn(old))
    try:
        yield
    finally:
        setattr(module, name, old)


def frozen():
    from repro_torch.optim import adam

    def make(old):
        def update(grads, state, params, **kw):
            import torch
            return params, state, {"grad_norm": torch.zeros(
                (), device=state["step"].device)}
        return update
    return _patched(adam, "update", make)


def half():
    from repro_torch.core import grpo

    def make(old):
        def aggregate_loss(loss_tok, ratio, logp_new, behaviour, mask, **kw):
            n = max(1, loss_tok.shape[0] // 2)
            return old(loss_tok[:n], ratio[:n], logp_new[:n], behaviour[:n],
                       mask[:n], **kw)
        return aggregate_loss
    return _patched(grpo, "aggregate_loss", make)


def token():
    from repro_torch.core.rollout import RolloutEngine

    def make(old):
        def _sample(self, keys, logits):
            tok, logp = old(self, keys, logits)
            return (tok + 1) % logits.shape[-1], logp
        return _sample
    return _patched(RolloutEngine, "_sample", make)


FAULTS = {"frozen": frozen, "half": half, "token": token}
