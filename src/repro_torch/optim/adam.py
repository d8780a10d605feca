"""AdamW + global-norm clipping: the port of ``repro.optim.adam``.

JAX's update returns new arrays; here :func:`update` writes the parameters
and the moments in place under ``torch.no_grad()`` (one f32 copy of each
moment, no second copy of the parameters), and returns the same
``{"grad_norm"}`` metric. Moments are float32 whatever the parameter dtype.
"""
from __future__ import annotations

import torch

from repro_torch.common.tree import leaves, tree_map


def init(params):
    zeros = lambda p: tree_map(  # noqa: E731
        lambda x: torch.zeros_like(x, dtype=torch.float32,
                                   requires_grad=False), p)
    dev = leaves(params)[0].device
    return {"m": zeros(params), "v": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree):
    return torch.sqrt(sum(l.float().square().sum() for l in leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    gn = global_norm(grads)
    scale = torch.minimum(torch.ones_like(gn),
                          max_norm / torch.maximum(gn, torch.full_like(gn,
                                                                       1e-9)))
    return tree_map(lambda g: g * scale, grads), gn


@torch.no_grad()
def update(grads, state, params, *, lr, betas=(0.9, 0.999), eps=1e-8,
           weight_decay=0.0, grad_clip=0.0):
    """One AdamW step, in place on ``params`` and ``state``. ``lr`` may be
    a float or a 0-dim tensor (schedule evaluated by the caller). Returns
    ``(params, state, metrics)`` — the same objects, updated."""
    b1, b2 = betas
    flat_p = leaves(params)
    gn = torch.zeros((), device=flat_p[0].device)
    if grad_clip and grad_clip > 0.0:
        grads, gn = clip_by_global_norm(grads, grad_clip)
    state["step"] += 1
    t = state["step"].float()
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t
    for g, m, v, p in zip(leaves(grads), leaves(state["m"]),
                          leaves(state["v"]), flat_p):
        g32 = g.float()
        m.mul_(b1).add_((1.0 - b1) * g32)
        v.mul_(b2).add_((1.0 - b2) * g32.square())
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay:
            delta = delta + weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    return params, state, {"grad_norm": gn}
