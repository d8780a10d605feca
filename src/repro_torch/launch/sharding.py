"""Sharding rules: Megatron tensor-parallel over "model" × ZeRO-3 (FSDP)
over "data" × pure data-parallel over "pod" — the port of
``repro.launch.sharding``, with its rule tables.

Rules are name-based over the last dims of each leaf. A rule gives one
``torch.distributed.tensor`` placement per mesh dim: ``Shard(i)`` when the
reference's PartitionSpec puts that axis on tensor dim ``i``, else
``Replicate()``. The port's stack is a flat per-layer list, so the
reference's leading layer-stack (scan) dim under ``body`` has no
counterpart. A dim that does not divide its mesh axes is replicated, as in
the reference (hymba's vocab of 32001), never sharded unevenly.

The rules take a ``DeviceMesh`` or a plain ``{axis: size}`` dict, so they
are checked against the reference without ranks. :func:`shard_params`
and :func:`shard_batch` apply them to tensors (``distribute_tensor``);
AdamW's state needs no call of its own: ``optim/adam.init`` of the
sharded params makes its moments in their parameters' placements, which
are :func:`opt_state_placements`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.common.config import ModelConfig
from repro_torch.common.tree import tree_map
from repro_torch.launch.mesh import mesh_device, mesh_shape

# name -> spec for the *trailing* dims. "dp" is replaced by the FSDP axis
# ("data"), "tp" by the tensor axis ("model"), "ep" by the expert axis
# ("model").
_MATRIX_RULES = {
    # embeddings / head
    "tok": ("tp", "dp"),              # vocab-parallel embedding (V, d)
    "lm_head": ("dp", "tp"),          # (d, V)
    "media_proj": ("dp", "tp"),
    # column-parallel (out dim over model)
    "wq": ("dp", "tp"), "wk": ("dp", "tp"), "wv": ("dp", "tp"),
    "wi": ("dp", "tp"), "wg": ("dp", "tp"),
    "in_proj": ("dp", "tp"), "x_proj": ("tp", None),
    "mix_a": ("dp", None), "dec_a": ("dp", None),
    # row-parallel (in dim over model)
    "wo": ("tp", "dp"), "out_proj": ("tp", "dp"),
    "dt_proj": (None, "tp"),
    "mix_b": (None, None, "dp"), "dec_b": (None, "dp"),
    # misc
    "router": ("dp", None),
    "conv": (None, "tp"), "A_log": ("tp", None),
    "mu": (None, "dp"),
}
# MoE expert tensors (E, d, f) / (E, f, d): experts over "model" (EP).
_MOE_3D = {"wi": ("ep", "dp", None), "wg": ("ep", "dp", None),
           "wo": ("ep", None, "dp")}


def _axis(axes: dict, tag):
    if tag is None:
        return None
    if tag in axes:                     # literal axis passthrough
        return tag
    if "kvg" in axes:                   # GQA-grouped serve mesh
        return {"dp": "data", "tp": ("kvg", "model"), "ep": ("kvg", "model"),
                "kvh": "kvg"}[tag]
    return {"dp": "data", "tp": "model", "ep": "model", "kvh": "model"}[tag]


def _names(path):
    return [p for p in path if isinstance(p, str)]


def _spec(tags, nd, axes):
    tags = tags[-nd:] if len(tags) > nd else tags
    spec = [None] * nd
    for i, tag in enumerate(reversed(tags)):
        spec[nd - 1 - i] = _axis(axes, tag)
    return spec


def _placements(spec, shape, axes: dict):
    """Per-dim spec (axis name, tuple of names or None) -> one placement
    per mesh dim, with ``_divisible``'s rule: a dim that does not divide
    its axes' product is replicated."""
    out = {a: Replicate() for a in axes}
    for i, ax in enumerate(spec):
        if ax is None:
            continue
        names = ax if isinstance(ax, tuple) else (ax,)
        if shape[i] % int(np.prod([axes[a] for a in names])) != 0:
            continue
        for a in names:
            out[a] = Shard(i)
    return tuple(out[a] for a in axes)


def param_placements(path, shape, mesh, cfg: Optional[ModelConfig] = None,
                     *, serve_decode: bool = False) -> tuple:
    """Placements of one parameter leaf of the port's tree, given its path
    (the dict keys and list indices from the root, e.g. ``("layers", 3,
    "attn", "wq")``) and its shape."""
    axes = mesh_shape(mesh)
    names = _names(path)
    name = names[-1] if names else ""
    in_moe = "moe" in names and "shared" not in names
    nd = len(shape)

    if nd <= 1 or name in ("beta", "u", "w_base", "dt_bias", "D", "conv_b"):
        return tuple(Replicate() for _ in axes)   # scalars / norms / vectors

    if in_moe and name in _MOE_3D and nd >= 3:
        tags = _MOE_3D[name]
    elif name == "in_proj" and nd == 3:         # the serve form (d, 2, di)
        tags = ("dp", None, "tp")
    elif name in _MATRIX_RULES:
        tags = _MATRIX_RULES[name]
    else:
        tags = ("dp", "tp")

    if "kvg" in axes and "attn" in names and name in ("wq", "wk", "wv",
                                                      "wo"):
        # GQA-grouped serve mesh: q/k/v heads over "kvg"; "model" is kept
        # for the cache length, so head dims must not touch it
        tags = {"wq": ("model", "kvh"), "wk": ("model", "kvh"),
                "wv": ("model", "kvh"), "wo": ("kvh", "model")}[name]
        return _placements(_spec(tags, nd, axes), shape, axes)

    kv_indivisible = (cfg is not None
                      and cfg.num_kv_heads % axes.get("model", 1) != 0
                      and "kvg" not in axes)
    # GQA with kv heads not divisible by TP: replicate the kv projections
    # over "model" rather than shard them below a head
    if kv_indivisible and name in ("wk", "wv") and "attn" in names:
        tags = ("dp", None)
    # decode against a length-sharded cache also needs the q heads
    # replicated
    if serve_decode and kv_indivisible and name == "wq" and "attn" in names:
        tags = ("dp", None)
    return _placements(_spec(tags, nd, axes), shape, axes)


def serve_form(path, t):
    """The leaf at ``path`` as the serve layout holds it: hymba's SSM
    ``in_proj`` (d, 2 di) as (d, 2, di), its x and z halves side by side,
    so that di over "model" gives each rank the same channels of both (a
    split of its 2 di columns would give the first half of the ranks
    every x channel and the rest every z channel); every other leaf as it
    is. A ``DTensor`` is gathered whole first, once, when the layout is
    made (never per step)."""
    names = _names(path)
    if names[-2:] != ["ssm", "in_proj"] or t.dim() != 2:
        return t
    from repro_torch.common.partitioning import is_sharded, replicate
    if is_sharded(t):
        t = replicate(t).to_local()
    return t.unflatten(1, (2, t.shape[1] // 2))


def serve_params_placements(params, mesh, cfg: ModelConfig):
    """The placements of the serve layout (:func:`shard_params` with
    ``serve_tp_only`` and ``serve_decode``) of a tree of tensors in either
    form, each leaf in its :func:`serve_form`."""
    shapes = _with_path(lambda path, t: serve_form(
        path, torch.empty(tuple(t.shape), device="meta")), params)
    return params_placements(shapes, mesh, serve_tp_only=True,
                             serve_decode=True, cfg=cfg)


def _with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def params_placements(params_shape, mesh, *, serve_tp_only: bool = False,
                      serve_decode: bool = False,
                      cfg: Optional[ModelConfig] = None):
    """Tree of placements matching a tree of tensors (or of anything with a
    ``.shape``). ``serve_tp_only`` drops the FSDP ("data") axis from every
    weight: tensor-parallel only, for serving (no optimizer state, no
    per-step weight gathers); callers gate it on
    :func:`serve_fits_tp_only`."""
    names = list(mesh_shape(mesh))

    def one(path, leaf):
        pl = param_placements(path, tuple(leaf.shape), mesh, cfg,
                              serve_decode=serve_decode)
        if serve_tp_only:
            pl = tuple(Replicate() if a == "data" else p
                       for a, p in zip(names, pl))
        return pl
    return _with_path(one, params_shape)


def serve_fits_tp_only(cfg: ModelConfig, mesh, *,
                       budget_bytes: Optional[float] = None) -> bool:
    """Would bf16 weights, TP-sharded only, fit the per-device budget?
    ``budget_bytes`` defaults to the card's memory
    (``torch.cuda.get_device_properties``)."""
    if budget_bytes is None:
        if not torch.cuda.is_available():
            raise ValueError("serve_fits_tp_only: no card to read a budget "
                             "from; pass budget_bytes")
        budget_bytes = torch.cuda.get_device_properties(0).total_memory
    tp = 1
    for a, n in mesh_shape(mesh).items():
        if a not in ("data", "pod"):
            tp *= n
    return 2.0 * cfg.param_count() / tp <= budget_bytes


def opt_state_placements(params_shape, mesh, cfg=None):
    ps = params_placements(params_shape, mesh, cfg=cfg)
    return {"m": ps, "v": ps,
            "step": tuple(Replicate() for _ in mesh_shape(mesh))}


# ---------------------------------------------------------------------------
# activation / batch shardings
# ---------------------------------------------------------------------------


def batch_axes(mesh) -> tuple:
    """The axes a global batch shards over."""
    return ("pod", "data") if "pod" in mesh_shape(mesh) else ("data",)


def train_batch_placements(mesh, *, has_media: bool = False):
    """Placements of the train batch's leaves: rows over the batch axes."""
    rows = tuple(Shard(0) if a in batch_axes(mesh) else Replicate()
                 for a in mesh_shape(mesh))
    out = {k: rows for k in ("tokens", "loss_mask", "behaviour_logp",
                             "advantages")}
    if has_media:
        out["media"] = rows
    return out


def cache_placements(path, shape, cfg: ModelConfig, mesh, *,
                     shard_seq: bool = False) -> tuple:
    """KV/state cache placements for serving, over the port's per-layer
    cache leaves (``k``/``v`` (B, L, KV, hd), ``mk``/``mv`` (B, M, KV, hd),
    ``wkv`` (B, H, hd, hd), ``tm_prev``/``cm_prev`` (B, d), ``ssm``
    (B, di, N), ``conv`` (B, K-1, di)).

    Default: slot/batch dim over the data axes, kv-head (or head_dim for
    MQA media K/V) over "model". ``shard_seq``: the cache length over
    "data" instead (sequence-parallel KV, batch 1)."""
    axes = mesh_shape(mesh)
    names = _names(path)
    name = names[-1] if names else ""
    nd = len(shape)
    dp = batch_axes(mesh)
    dpx = dp if len(dp) > 1 else dp[0]
    tp_size = axes["model"]

    spec = [None] * nd
    if name in ("k", "v") and "kvg" in axes:
        spec[0], spec[1], spec[2] = dpx, "model", "kvg"
    elif name in ("mk", "mv") and "kvg" in axes:
        spec[0], spec[2], spec[3] = dpx, "kvg", "model"
    elif name in ("k", "v"):
        if cfg.num_kv_heads % tp_size == 0:
            if not shard_seq:
                spec[0] = dpx
            else:
                spec[1] = "data"
            spec[2] = "model"
        else:
            # kv heads indivisible by TP: K/V are computed replicated over
            # "model", so the cache LENGTH shards over "model"
            if not shard_seq:
                spec[0] = dpx
                spec[1] = "model"
            else:
                spec[1] = ("data", "model")
    elif name in ("mk", "mv"):
        spec[0] = dpx
        if cfg.num_kv_heads % tp_size == 0:
            spec[2] = "model"
        elif cfg.head_dim % tp_size == 0:
            spec[3] = "model"
    elif name == "wkv":
        spec[0] = None if shard_seq else dpx
        spec[1] = "model"
    elif name in ("tm_prev", "cm_prev"):
        spec[0] = None if shard_seq else dpx
        spec[1] = "model" if shard_seq else None
    elif name == "ssm":
        spec[0] = None if shard_seq else dpx
        spec[1] = "model"
    elif name == "conv":
        spec[0] = None if shard_seq else dpx
        spec[2] = "model"
    return _placements(spec, shape, axes)


def cache_placements_tree(cache_shape, cfg: ModelConfig, mesh, *,
                          shard_seq: bool = False):
    return _with_path(
        lambda path, leaf: cache_placements(path, tuple(leaf.shape), cfg,
                                            mesh, shard_seq=shard_seq),
        cache_shape)


# ---------------------------------------------------------------------------
# applying the rules
# ---------------------------------------------------------------------------


def _distribute(t, mesh, placements, requires_grad=False, *, local=False):
    """``t`` as a ``DTensor`` in ``placements``: a plain tensor (the same
    full values on every rank) distributed, from rank 0's copy or, with
    ``local``, each rank cutting its shard from its own copy (no
    collective); a ``DTensor`` redistributed."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    t = t.detach()
    if isinstance(t, DTensor):
        out = (t if tuple(t.placements) == tuple(placements)
               else t.redistribute(mesh, list(placements)))
    elif local:
        out = distribute_tensor(t, mesh, list(placements),
                                src_data_rank=None)
    else:
        out = distribute_tensor(t, mesh, list(placements))
    return out.requires_grad_() if requires_grad else out


def shard_params(params, mesh, cfg: ModelConfig, *,
                 serve_tp_only: bool = False, serve_decode: bool = False,
                 copy: bool = False):
    """The port's parameter dict as ``DTensor`` s on ``mesh``, placed by
    :func:`params_placements`: every rank passes the same full values, or
    ``DTensor`` s in another layout (redistributed). The training layout's
    float leaves require a gradient; ``serve_tp_only`` (with
    ``serve_decode``, the reference's decode placements) is the serving
    layout, with none, each leaf in its :func:`serve_form`. ``copy``: each
    leaf in storage of its own, never a view of the one passed."""
    if serve_tp_only:
        params = _with_path(serve_form, params)
    pl = params_placements(params, mesh, serve_tp_only=serve_tp_only,
                           serve_decode=serve_decode, cfg=cfg)
    grad = not serve_tp_only
    return tree_map(lambda t, p: _distribute(
        t.detach().clone() if copy else t, mesh, p,
        grad and t.is_floating_point()), params, pl)


def init_sharded_params(cfg: ModelConfig, mesh, *, seed: int = 0,
                        compute_dtype=None, serve: bool = False):
    """The port's seeded init made already sharded: the counterpart of the
    reference's ``jit(init_params, out_shardings=p_sh)``. The leaves are
    drawn from ``models/model.init_params``' generator stream in its order,
    on the mesh's device, and each piece (the embedding, one layer, the
    final norm, the head) is distributed to its :func:`params_placements`
    as soon as it is made, each rank cutting its own shards, and its full
    copy freed: a rank never holds more than one layer of the full model.
    Every rank's shards equal those of ``shard_params(init_params(cfg,
    seed=seed), mesh, cfg)`` bit for bit. ``compute_dtype`` casts each
    layer before it is distributed (``init_params``' own rule); ``serve``
    places the leaves in the serving layout (``serve_tp_only`` with the
    decode placements, each leaf in its :func:`serve_form`), with no
    gradient."""
    from repro_torch.models import model as M
    dev = mesh_device(mesh)
    names = list(mesh_shape(mesh))

    def placements(path, shape):
        pl = param_placements(path, shape, mesh, cfg, serve_decode=serve)
        if serve:
            pl = tuple(Replicate() if a == "data" else p
                       for a, p in zip(names, pl))
        return pl

    def place(path, piece):
        def one(p, t):
            if serve:
                t = serve_form(p, t)
            return _distribute(t, mesh, placements(p, tuple(t.shape)),
                               t.is_floating_point() and not serve,
                               local=True)
        return _with_path(one, piece, tuple(path))

    return M.init_params(cfg, seed=seed, device=dev, place=place,
                         compute_dtype=compute_dtype)


def shard_batch(batch, mesh):
    """A train batch (every rank holds the same full tensors) as
    ``DTensor`` s, rows over the batch axes as
    :func:`train_batch_placements` says, or replicated where the row count
    does not divide them."""
    axes = mesh_shape(mesh)
    dp = batch_axes(mesh)
    return {k: _distribute(v, mesh, _placements(
                [dp] + [None] * (v.dim() - 1), tuple(v.shape), axes))
            for k, v in batch.items()}
