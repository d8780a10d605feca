"""Mixture-of-Experts FFN: top-k router + shared experts.

The port of ``repro.models.moe``. The router runs in float32 (its weight is
float32 and its logits are ``x.float() @ router``) and produces the
Switch-style load-balance loss ``E * sum_e f_e * p_e``, which the model
sums over its layers and reports as ``router_aux``; the trainer adds
``router_aux_coef`` times it to the loss.

Two dispatchers, as in the reference:

* :func:`apply_moe` — dense and dropless: every token runs through every
  expert and a (T, E) combine matrix, zero outside its top-k, weights the
  results. The model takes it for decode (one token a row) and for
  ``dispatch == "dense"``.
* :func:`apply_moe_sparse` — capacity-bounded: each expert takes at most
  ``cap = int(cf * chunk * top_k / E)`` (token, k) pairs of a dispatch
  chunk, in the flat (token, k) order; the pairs past it go to a sink slot
  and add nothing (their residual passes through).

Plain PyTorch is the GPU path as well as the CPU one: the reference computes
the dispatch and the expert products with einsums and scatters outside any
Pallas kernel, so no kernel is owed here. Every sum is taken in a fixed
order — the gather back sums a token's k contributions as a (T, k, d) view
over k, and the scatter into the expert buffer writes each kept slot once —
so a launch gives the same bits every time (no atomic ``index_add_``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common.partitioning import reduce_over
from repro_torch.models.layers import dense_init


def init_moe(cfg, dtype, device, gen):
    m = cfg.moe
    d = cfg.d_model
    E, f = m.num_experts, m.d_expert
    p = {
        "router": dense_init((d, E), torch.float32, device, gen),
        "wi": dense_init((E, d, f), dtype, device, gen, fan_in=d),
        "wg": dense_init((E, d, f), dtype, device, gen, fan_in=d),
        "wo": dense_init((E, f, d), dtype, device, gen, fan_in=f),
    }
    if m.num_shared_experts > 0:
        ds = m.d_shared * m.num_shared_experts
        p["shared"] = {
            "wi": dense_init((d, ds), dtype, device, gen),
            "wg": dense_init((d, ds), dtype, device, gen),
            "wo": dense_init((ds, d), dtype, device, gen, fan_in=ds),
        }
    return p


def route(router, cfg, xt):
    """xt: (T, d) -> (probs (T, E), top_w (T, k), top_i (T, k), aux): the
    float32 router, its top-k renormalised, and the Switch load-balance
    loss of these T tokens."""
    m = cfg.moe
    probs = torch.softmax(xt.float() @ router, dim=-1)
    # a stable sort: on ties the lower expert first, as jax.lax.top_k
    # (the expert-parallel dispatch's zero pad rows tie on every expert)
    top_w, top_i = (t[..., :m.top_k] for t in torch.sort(
        probs, dim=-1, descending=True, stable=True))
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    frac_tokens = F.one_hot(top_i, m.num_experts).float().sum(1).mean(0)
    aux = m.num_experts * (frac_tokens * probs.mean(0)).sum()
    return probs, top_w, top_i, aux


def _shared(params, xt, dt):
    s = params["shared"]
    hs = F.silu(xt @ s["wg"].to(dt)) * (xt @ s["wi"].to(dt))
    return hs @ s["wo"].to(dt)


def _combine_partials(y, params, xt, dt, part, shared_part):
    """The routed output ``y`` plus the shared experts', each a partial sum
    over its group on a mesh (``part`` the experts', ``shared_part`` the
    shared experts' hidden units), summed there: one reduction where the
    groups are one."""
    g_r = None if part is None else part.group
    if "shared" not in params:
        return reduce_over(y, g_r)
    ys = _shared(params, xt, dt)
    g_s = None if shared_part is None else shared_part.group
    if g_r is g_s:
        return reduce_over(y + ys, g_r)
    return reduce_over(y, g_r) + reduce_over(ys, g_s)


def apply_moe(params, cfg, x, *, part=None, shared_part=None):
    """x: (B, S, d) -> (out, aux). Dense dispatch over all E experts.

    ``part`` / ``shared_part`` (serving on a mesh, ``partitioning.Part``
    s): ``params`` holds this rank's experts [part.start, part.start +
    E_l) and its range of the shared experts' hidden units, the router
    whole; the (T, E) combine is sliced to those experts and the partial
    outputs sum over the groups."""
    m = cfg.moe
    dt = x.dtype
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    e0 = 0 if part is None else part.start
    _, top_w, top_i, aux = route(params["router"], cfg, xt)
    onehot = F.one_hot(top_i, m.num_experts).float()              # (T,k,E)
    combine = torch.einsum("tk,tke->te", top_w, onehot)            # (T, E)
    combine = combine[:, e0:e0 + params["wi"].shape[0]]     # own experts
    # (E, T, f): every token through every expert, one batched product each
    h = F.silu(torch.matmul(xt, params["wg"].to(dt))) \
        * torch.matmul(xt, params["wi"].to(dt))
    y_e = torch.matmul(h, params["wo"].to(dt))                      # (E,T,d)
    y = torch.einsum("etd,te->td", y_e, combine.to(dt))
    y = _combine_partials(y, params, xt, dt, part, shared_part)
    return y.reshape(B, S, d), aux


def dispatch_slots(top_i, num_experts: int, cap: int):
    """(slot, keep) of each flat (token, k) pair, (T * k,): its position in
    its expert's buffer, ``expert * cap + the running count of earlier pairs
    routed there``, or the sink ``E * cap`` when that count reaches
    ``cap``."""
    flat_e = top_i.reshape(-1)
    pos_in_e = torch.cumsum(F.one_hot(flat_e, num_experts), dim=0)
    pos = pos_in_e.gather(1, flat_e[:, None])[:, 0] - 1
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos,
                       torch.full_like(pos, num_experts * cap))
    return slot, keep


def capacity(cfg, T: int, *, capacity_factor: float | None = None,
             dispatch_chunk: int = 65536):
    """(chunk, cap): the dispatch chunk (``dispatch_chunk`` halved until it
    divides T) and each expert's capacity within one chunk."""
    m = cfg.moe
    cf = capacity_factor if capacity_factor is not None else m.capacity_factor
    chunk = min(dispatch_chunk, T)
    while T % chunk != 0:
        chunk //= 2
    return chunk, max(1, int(cf * chunk * m.top_k / m.num_experts))


def apply_moe_sparse(params, cfg, x, *, capacity_factor: float | None = None,
                     dispatch_chunk: int = 65536, part=None,
                     shared_part=None):
    """x: (B, S, d) -> (out, aux). Capacity-bounded dispatch over chunks of
    ``dispatch_chunk`` tokens; aux is the mean of the chunks'.

    ``part`` / ``shared_part`` as in :func:`apply_moe`: x is then every
    row (the capacity is the whole batch's), each rank fills the buffers of
    its own experts only (the slots of the others go to the sink) and the
    partial outputs sum over the groups."""
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    dt = x.dtype
    B, S, d = x.shape
    T = B * S
    chunk, cap = capacity(cfg, T, capacity_factor=capacity_factor,
                          dispatch_chunk=dispatch_chunk)
    xt = x.reshape(T, d)
    wg, wi, wo = (params[n].to(dt) for n in ("wg", "wi", "wo"))
    e0, El = 0 if part is None else part.start, wi.shape[0]

    def one_chunk(xc):
        _, top_w, top_i, aux = route(params["router"], cfg, xc)
        slot, keep = dispatch_slots(top_i, E, cap)
        if El != E:             # this rank's experts; the others' pairs sink
            keep = keep & (slot >= e0 * cap) & (slot < (e0 + El) * cap)
            slot = torch.where(keep, slot - e0 * cap,
                               torch.full_like(slot, El * cap))
        # each (token, k) pair's row: a view summed over k in the backward
        src = xc[:, None].expand(chunk, k, d).reshape(chunk * k, d)
        buf = x.new_zeros(El * cap + 1, d).index_put((slot,), src)
        xe = buf[:El * cap].reshape(El, cap, d)
        h = F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wi)
        ye = torch.bmm(h, wo).reshape(El * cap, d)
        sel = ye[slot.clamp_max(El * cap - 1)]
        w = torch.where(keep, top_w.reshape(-1), 0.0).to(dt)
        contrib = sel * w[:, None] * keep[:, None].to(dt)
        return contrib.reshape(chunk, k, d).sum(1), aux

    if chunk == T:
        y, aux = one_chunk(xt)
    else:
        ys, auxs = zip(*(one_chunk(xt[c:c + chunk])
                         for c in range(0, T, chunk)))
        y = torch.cat(ys)
        aux = torch.stack(auxs).mean()
    # the shared experts read a view of x of its own: x's gradient is then
    # (routed) + (shared), two terms, summed as the expert-parallel
    # dispatch sums them; on xt the four terms (router, dispatch, shared wg
    # and wi) would add in another order, which rounds apart in bfloat16
    y = _combine_partials(y, params, x.reshape(T, d), dt, part, shared_part)
    return y.reshape(B, S, d), aux
