"""Expert-parallel MoE dispatch with an explicit all-to-all: the port of
``repro.models.moe_shardmap``.

Experts live sharded on the "model" axis; every rank routes its own tokens,
exchanges them with one ``dist.all_to_all_single`` over the "model"
sub-group, runs its local experts, and reverses the exchange (the
counterpart of ``jax.lax.all_to_all`` inside ``shard_map``, tiled=False).
The exchange is an autograd function: its backward is the reverse
all-to-all.

Tokens are flattened and sharded over the whole grid (the batch axes, then
"model"), padded with zero rows to a multiple of the grid, so every rank
routes distinct tokens. Capacity is per (source rank, expert),
``max(1, int(cf * T_local * top_k / E))``: pairs beyond it are dropped
(residual passthrough, weight 0), exactly like the capacity dispatcher.
Shared experts are dense. ``aux`` is the mean over the grid's ranks of each
rank's own Switch loss over its own tokens, not the Switch loss of the whole
batch. The model takes this dispatch for ``MoEConfig.dispatch ==
"shardmap"`` in training under an active mesh with a "model" axis
(``models/transformer._moe_ffn``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.common.partitioning import (activation_placements,
                                             local_call, replicated)
from repro_torch.models.moe import _shared, dispatch_slots, route


class _AllToAll(torch.autograd.Function):
    """``dist.all_to_all_single`` of x (ep, n, d) over ``group``: block i
    goes to rank i of the group; the backward sends the gradients back
    the same way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def _exchange(x, group):
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    apply_moe_shardmap.exchanges += 1
    return out


def apply_moe_shardmap(params, cfg, x, mesh, *, capacity_factor=None):
    """x: (B, S, d) ``DTensor`` (rows over the batch axes). Returns
    ``(y, aux)``, y a ``DTensor`` with rows over the batch axes and aux a
    0-dim one."""
    from torch.distributed.tensor import Partial, Shard
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    names = mesh.mesh_dim_names
    ep = mesh.size(names.index("model"))
    if E % ep:
        raise ValueError(f"apply_moe_shardmap: {E} experts do not divide "
                         f"the model axis of {ep}")
    e_local = E // ep
    d = cfg.d_model
    B, S, _ = x.shape
    cf = capacity_factor if capacity_factor is not None else m.capacity_factor
    group = mesh.get_group("model")

    def local(xt, router, wi, wg, wo):
        """One rank: xt (T_local, d) tokens; router (d, E) whole; wi/wg
        (e_local, d, f), wo (e_local, f, d) its experts."""
        T = xt.shape[0]
        dt = xt.dtype
        cap = max(1, int(cf * T * k / E))          # per (rank, expert)
        _, top_w, top_i, aux = route(router, cfg, xt)
        slot, keep = dispatch_slots(top_i, E, cap)
        # sendbuf[e * cap + c] = the pair routed to expert e, slot c
        src = xt[:, None].expand(T, k, d).reshape(T * k, d)
        buf = xt.new_zeros(E * cap + 1, d).index_put((slot,), src)
        send = buf[:E * cap].reshape(ep, e_local * cap, d)
        # rank p receives every rank's tokens for ITS experts
        recv = _AllToAll.apply(send, group)
        xe = (recv.reshape(ep, e_local, cap, d).transpose(0, 1)
              .reshape(e_local, ep * cap, d))
        h = F.silu(torch.bmm(xe, wg.to(dt))) * torch.bmm(xe, wi.to(dt))
        ye = torch.bmm(h, wo.to(dt))                  # (e_local, ep*cap, d)
        back = (ye.reshape(e_local, ep, cap, d).transpose(0, 1)
                .reshape(ep, e_local * cap, d))
        got = _AllToAll.apply(back, group).reshape(E * cap, d)
        sel = got[slot.clamp_max(E * cap - 1)]
        w = torch.where(keep, top_w.reshape(-1), 0.0).to(dt)
        y = (sel * w[:, None] * keep[:, None].to(dt)).reshape(T, k, d).sum(1)
        return y, aux[None]

    # tokens flattened and sharded over the FULL grid (the batch axes,
    # then "model"), padded to a multiple of it
    grid = tuple(Shard(0) for _ in names)
    T_all = B * S
    pad = (-T_all) % mesh.size()
    xt = x.reshape(T_all, d)
    if pad:
        xt = torch.cat([xt, xt.new_zeros(pad, d)])
    experts = tuple(Shard(0) if a == "model" else r
                    for a, r in zip(names, replicated(mesh)))
    # a weight's gradient is a pending sum over the axes it is whole on
    router_grad = tuple(Partial() for _ in names)
    expert_grad = tuple(e if a == "model" else Partial()
                        for a, e in zip(names, experts))
    y, aux = local_call(
        local, mesh,
        (xt, params["router"], params["wi"], params["wg"], params["wo"]),
        (grid, replicated(mesh), experts, experts, experts),
        (grid, grid),
        (None, router_grad, expert_grad, expert_grad, expert_grad))
    if pad:
        y = y[:T_all]
    y = y.reshape(B, S, d).redistribute(
        mesh, activation_placements(mesh, x.shape, "dp"))
    if "shared" in params:             # shared experts are dense — no EP
        y = y + _shared(params, x.reshape(T_all, d), x.dtype).reshape(
            B, S, d)
    return y, aux.mean()


apply_moe_shardmap.exchanges = 0
