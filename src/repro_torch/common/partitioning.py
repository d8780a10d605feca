"""Activation-sharding context: the port of ``repro.common.partitioning``.

Model code is mesh-agnostic; the launcher (``launch/multihost``, or a caller
of the sharded ``make_train_step``) installs the active mesh here and the
model constrains key activations (the embedding output, the loss's
logits) to fixed placements, so the eager ``DTensor`` propagation does not
drift into partial-logits layouts. The reference also constrains the
selective scan's state and inputs; here the SSM branch runs on each rank's
own rows inside ``local_map``, where they are plain tensors.

A call on a plain tensor (unsharded, or a rank's local shard inside
``local_map``) is a no-op that returns its input itself.

The attention layers decide here how they run on a mesh:
:func:`split_heads` lays a projection out so that no rank holds a piece of
a head, and :func:`over_heads` runs the one attention function of a layer
either as it is (plain tensors) or on each rank's rows and whole heads,
with the layer's K/V cache leaves (serving) on each rank's own shard.
:func:`on_rows` does the same for a function of a batch's rows with whole
weights (the recurrent branches and the MoE dispatches in training, the
fused losses, the serving path's row gathers and sampling), and
:func:`over_channels` for a serving sub-block on each rank's range of
channels, heads or experts (the SSM, the rwkv block, the MoE dispatch),
its state leaves on each rank's own shard: the function reads its range
from :func:`part_of` and sums or gathers over the range's group itself
(:func:`reduce_over`, :func:`gather_over`). Each is the function itself
on plain tensors, so the model has one code path for both. A dim split
over two mesh dims (the ``shard_seq`` cache's length over ("data",
"model")) has a process group of its own (:func:`shard_group`).
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import NamedTuple

_STATE: dict = {"mesh": None}


def set_activation_mesh(mesh):
    _STATE["mesh"] = mesh


def get_activation_mesh():
    return _STATE["mesh"]


@contextmanager
def activation_mesh(mesh):
    """``with activation_mesh(mesh):`` installs ``mesh`` (None: leaves the
    installed one) for the block and restores the one before it."""
    before = _STATE["mesh"]
    if mesh is not None:
        _STATE["mesh"] = mesh
    try:
        yield
    finally:
        _STATE["mesh"] = before


def _resolve(mesh, tag) -> tuple:
    """The mesh axes of an activation tag: "dp" the batch axes, "tp" the
    tensor axes (("kvg", "model") on the GQA serve mesh, as the sharding
    rules map them), "kvh" the attention's head axis ("kvg" on that mesh,
    whose "model" axis holds the cache length, else "model")."""
    names = mesh.mesh_dim_names
    if tag is None:
        return ()
    if tag == "dp":
        return tuple(a for a in ("pod", "data") if a in names)
    if tag == "tp":
        return tuple(a for a in ("kvg", "model") if a in names)
    if tag == "kvh":
        return ("kvg",) if "kvg" in names else (
            ("model",) if "model" in names else ())
    return (tag,)


def axes_size(mesh, tag) -> int:
    """The number of ranks over the mesh axes of ``tag``."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    n = 1
    for a in _resolve(mesh, tag):
        n *= sizes[a]
    return n


def activation_placements(mesh, shape, *tags) -> tuple:
    """One placement per mesh dim for tensor dims tagged ``tags`` ("dp":
    the batch axes, "tp": the tensor axes, "kvh": the head axis, None:
    replicated); a dim that does not
    divide its axes stays replicated, and so does a dim of size 1 (a
    one-row prefill: ``DTensor`` views cannot merge a sharded singleton
    dim)."""
    from torch.distributed.tensor import Replicate, Shard
    out = {a: Replicate() for a in mesh.mesh_dim_names}
    for i, tag in enumerate(tags):
        axes = _resolve(mesh, tag)
        if axes and shape[i] % axes_size(mesh, tag) == 0 and shape[i] > 1:
            for a in axes:
                out[a] = Shard(i)
    return tuple(out[a] for a in mesh.mesh_dim_names)


def shard_activation(x, *tags):
    """Redistribute the ``DTensor`` ``x`` to the placements ``tags`` name
    on the installed mesh (or, with none installed, on ``x`` 's own: the
    serving path); ``x`` itself for a plain tensor. Tags: "dp" (batch
    axes), "tp" ("model"), None."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh = _STATE["mesh"] or x.device_mesh
    want = activation_placements(mesh, x.shape, *tags)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def is_sharded(x) -> bool:
    """Whether ``x`` is a ``DTensor`` (the sharded path's tensors)."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def replicated(mesh) -> tuple:
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def partial_over_rows(mesh, row_placements) -> tuple:
    """The gradient placements of a weight that every rank holds whole and
    applies to its own rows (``row_placements``, the rows' placements):
    a pending sum over the mesh dims the rows are sharded on."""
    from torch.distributed.tensor import Partial, Replicate
    return tuple(Partial() if p.is_shard() else Replicate()
                 for p in row_placements)


def local_call(fn, mesh, args, in_placements, out_placements,
               in_grad_placements=None):
    """``fn`` on each rank's local shards of the ``DTensor`` s ``args``
    (``local_map``), after redistributing each to its ``in_placements``;
    the results are ``DTensor`` s with ``out_placements`` (one tuple of
    placements, or a sequence of them for several outputs).
    ``in_grad_placements`` (one entry per input, None for the input's own
    layout) says how each local input's gradient is laid out, e.g.
    ``Partial()`` for a whole weight applied to a rank's own rows. A hand
    kernel called from ``fn`` only ever sees plain tensors."""
    from torch.distributed.tensor import Placement
    from torch.distributed.tensor.experimental import local_map
    if all(isinstance(p, Placement) for p in out_placements):
        out_placements = list(out_placements)           # one output
    else:
        out_placements = tuple(None if p is None else list(p)
                               for p in out_placements)
    if in_grad_placements is not None:      # None: the input's own layout
        in_grad_placements = tuple(
            p if g is None else g
            for p, g in zip(in_placements, in_grad_placements))
    return local_map(fn, out_placements=out_placements,
                     in_placements=tuple(in_placements),
                     in_grad_placements=in_grad_placements,
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def on_rows(fn, args, params=None, *, n_out: int = 1, n_rep: int = 0,
            whole: bool = False):
    """``fn(*args, params)`` (``fn(*args)`` when ``params`` is None), a
    function of a batch's rows: each of ``args`` has the rows on dim 0, and
    ``fn`` returns ``n_out`` tensors whose dim 0 are those rows, then
    ``n_rep`` others (one tensor when the two add up to 1). ``params`` is a
    tree of weights every rank holds whole.

    Plain tensors: ``fn`` itself. ``DTensor`` s: ``fn`` on each rank's own
    rows through :func:`local_call`, the rows over the batch axes, the
    weights replicated with their gradients a pending sum over the batch
    axes; ``whole``: every rank runs ``fn`` on all rows (a function whose
    rows are not independent, e.g. a capacity-bounded MoE dispatch) and
    the row outputs are laid out over the batch axes after it, the others
    replicated."""
    x = args[0]
    if not is_sharded(x):
        return fn(*args) if params is None else fn(*args, params)
    from repro_torch.common.tree import leaves, unflatten
    mesh = x.device_mesh
    flat = [] if params is None else leaves(params)
    n = len(args)
    rep = replicated(mesh)
    rows = [activation_placements(mesh, a.shape, "dp") for a in args]

    def run(*ts):
        local = ts[:n]
        if params is None:
            return fn(*local)
        return fn(*local, unflatten(params, list(ts[n:])))

    if whole:
        outs = local_call(run, mesh, tuple(args) + tuple(flat),
                          (rep,) * (n + len(flat)),
                          rep if n_out + n_rep == 1
                          else (rep,) * (n_out + n_rep))
        if n_out + n_rep == 1:
            return outs.redistribute(mesh, rows[0]) if n_out else outs
        return tuple(o.redistribute(mesh, rows[0]) if i < n_out else o
                     for i, o in enumerate(outs))
    if n_rep:
        raise ValueError("on_rows: an output that is not a row's needs "
                         "whole=True")
    grad_w = partial_over_rows(mesh, rows[0])
    return local_call(run, mesh, tuple(args) + tuple(flat),
                      tuple(rows) + (rep,) * len(flat),
                      rows[0] if n_out == 1 else (rows[0],) * n_out,
                      (None,) * n + (grad_w,) * len(flat))


def on_mesh(t, like):
    """The plain tensor ``t`` (the same values on every rank, e.g. read
    from host state) as a replicated ``DTensor`` on ``like`` 's mesh when
    ``like`` is one (a ``DTensor`` or a ``DeviceMesh``), else ``t``."""
    mesh = getattr(like, "device_mesh", like)
    if mesh is None or not hasattr(mesh, "mesh_dim_names"):
        return t
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, mesh, replicated(mesh), run_check=False)


def replicate(t):
    """A ``DTensor`` laid out whole on every rank; a plain tensor as it
    is."""
    if not is_sharded(t):
        return t
    mesh = t.device_mesh
    return t.redistribute(mesh, replicated(mesh))


def to_host(t):
    """``t`` whole as a plain tensor: a ``DTensor`` gathered
    (``full_tensor``, a collective every rank makes in the same order, so
    every rank reads the same values)."""
    return t.full_tensor() if is_sharded(t) else t


def local_shard(t):
    """This rank's shard of the ``DTensor`` t (its own storage: writes to it
    land in t); a plain tensor itself."""
    return t.to_local() if is_sharded(t) else t


def gather_dims(t, dims):
    """The ``DTensor`` t with its shards on the tensor dims ``dims``
    gathered, every other placement kept; a plain tensor itself."""
    if not is_sharded(t):
        return t
    from torch.distributed.tensor import Replicate
    want = tuple(Replicate() if p.is_shard() and p.dim in dims else p
                 for p in t.placements)
    return t if want == tuple(t.placements) else t.redistribute(
        t.device_mesh, want)


def _shard_axes(t, dim: int) -> list:
    """The mesh dims that shard tensor dim ``dim`` of the ``DTensor`` t,
    in mesh order."""
    from torch.distributed.tensor import Shard
    return [i for i, p in enumerate(t.placements) if p == Shard(dim)]


def shard_start(t, dim: int) -> int:
    """The global index of the first element of this rank's shard of ``t``
    along ``dim``: 0 for a plain tensor or an unsharded dim. Shards are
    even (the sharding rules replicate a dim that does not divide)."""
    if not is_sharded(t):
        return 0
    axes = _shard_axes(t, dim)
    mesh = t.device_mesh
    idx, n = 0, 1
    for i in axes:
        idx = idx * mesh.size(i) + mesh.get_local_rank(i)
        n *= mesh.size(i)
    return idx * (t.shape[dim] // n)


_GROUPS: dict = {}


def _group_over(mesh, axes):
    """The process group of this rank over the mesh dims ``axes`` (indices,
    in mesh order): one mesh dim's own group, or for several a group made
    once for the mesh (``DeviceMesh`` has none over two dims) and cached.
    Making it is collective: every rank of the mesh makes the groups of
    every coordinate of the other dims, in one order, and keeps its
    own."""
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    import torch.distributed as dist
    key = (id(mesh), tuple(axes))
    if key not in _GROUPS:
        grid = mesh.mesh
        rest = [i for i in range(grid.dim()) if i not in axes]
        rows = grid.permute(*rest, *axes).reshape(
            -1, math.prod(grid.shape[i] for i in axes))
        me = dist.get_rank()
        for row in rows.tolist():
            g = dist.new_group(row)
            if me in row:
                _GROUPS[key] = (mesh, g)     # the mesh kept alive with it
    return _GROUPS[key][1]


def shard_group(t, dim: int):
    """The process group over whose ranks ``t`` 's dim ``dim`` is split, or
    None where it is not (a plain tensor, a dim sharded on no mesh dim).
    A dim split over several mesh dims (the ``shard_seq`` cache's length
    over ("data", "model")) takes a group over those dims; their ranks
    hold its slices in the group's rank order."""
    if not is_sharded(t):
        return None
    axes = _shard_axes(t, dim)
    if not axes:
        return None
    wide = [i for i in axes if t.device_mesh.size(i) > 1]
    return _group_over(t.device_mesh, wide or axes[:1])


class Part(NamedTuple):
    """This rank's range of a sharded channel or head dim: its first global
    index, and the group of the ranks that hold the other ranges (None
    where no other rank holds any)."""
    start: int
    group: object


def part_of(t, dim: int):
    """The :class:`Part` of ``t`` 's dim ``dim``, or None for a plain
    tensor or a dim whose every range is on this rank."""
    if not is_sharded(t):
        return None
    group = shard_group(t, dim)
    if group is None:
        return None
    import torch.distributed as dist
    return Part(shard_start(t, dim),
                group if dist.get_world_size(group) > 1 else None)


def reduce_over(t, group):
    """``t`` summed over the ranks of ``group`` in place (None: ``t``)."""
    if group is not None:
        import torch.distributed as dist
        dist.all_reduce(t, group=group)
    return t


def gather_over(t, group, dim: int):
    """The ranges of ``group`` 's ranks of ``t`` 's dim ``dim``,
    concatenated in rank order (None: ``t``)."""
    if group is None:
        return t
    import torch
    import torch.distributed as dist
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def serve_placements(t) -> tuple:
    """The placements of the weight ``t`` in the serve layout: its own with
    the batch axes' (FSDP) shards gathered (``launch/sharding``'s
    ``serve_tp_only``)."""
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() if a in ("pod", "data") else p
                 for a, p in zip(t.device_mesh.mesh_dim_names, t.placements))


def over_channels(fn, rows, params, state=(), *, whole: bool = False):
    """``fn(*rows, params, *state)``: a serving sub-block that takes its
    rows (tensors with the batch on dim 0, None allowed), the block's
    weights and its state leaves (the cache's per-slot leaves, which
    ``fn`` writes in place), and returns the (B, S, d) output rows. Plain
    tensors: ``fn`` itself. ``DTensor`` s: ``fn`` on each rank's local
    shards through :func:`local_call` (the pattern of
    :func:`over_heads`): rows over the batch axes; each weight in the serve
    layout (:func:`serve_placements`: a rank's range of channels or heads
    where the rules shard them, whole where they replicate); each state
    leaf in its own layout, never redistributed, so ``fn`` 's writes land
    in the leaf's own storage. ``fn`` reads its range from :func:`part_of`
    of the weights (taken before the call), sums its partial products over
    the group itself and returns whole rows. ``whole``: every rank runs
    ``fn`` on all rows (a function whose rows are not independent: the
    capacity-bounded MoE dispatch), its rows laid out over the batch axes
    after it."""
    x = rows[0]
    if not is_sharded(x):
        return fn(*rows, params, *state)
    from repro_torch.common.tree import leaves, unflatten
    mesh = x.device_mesh
    here = [i for i, r in enumerate(rows) if r is not None]
    flat = leaves(params)
    n, m = len(here), len(flat)

    def run(*ts):
        got = list(rows)
        for i, t in zip(here, ts[:n]):
            got[i] = t
        return fn(*got, unflatten(params, list(ts[n:n + m])), *ts[n + m:])

    out = activation_placements(mesh, x.shape, "dp")
    lay = ((lambda r: replicated(mesh)) if whole else
           (lambda r: activation_placements(mesh, r.shape, "dp")))
    y = local_call(
        run, mesh, tuple(rows[i] for i in here) + tuple(flat) + tuple(state),
        tuple(lay(rows[i]) for i in here)
        + tuple(serve_placements(w) for w in flat)
        + tuple(tuple(c.placements) for c in state),
        replicated(mesh) if whole else out)
    return y.redistribute(mesh, out) if whole else y


def store(leaf, value):
    """Write ``value`` (the leaf's whole global value, in any layout) into
    the cache leaf ``leaf`` in place: into this rank's own shard of a
    ``DTensor`` leaf (``value`` laid out as the leaf first)."""
    if is_sharded(leaf):
        if tuple(value.placements) != tuple(leaf.placements):
            value = value.redistribute(leaf.device_mesh, leaf.placements)
        leaf.to_local().copy_(value.to_local())
    elif leaf is not value:
        leaf.copy_(value)


def split_heads(t, n: int, hd: int):
    """(..., n * hd) -> (..., n, hd). A ``DTensor`` whose last dim is
    sharded below a head (n not a multiple of its axes' ranks) is laid
    out whole on them first."""
    if is_sharded(t):
        mesh = t.device_mesh
        ranks = 1
        for i in _shard_axes(t, t.dim() - 1):
            ranks *= mesh.size(i)
        if n % ranks:
            t = t.redistribute(mesh, activation_placements(mesh, t.shape,
                                                           "dp"))
    return t.unflatten(-1, (n, hd))


def over_heads(fn, q, k, v, *rows, cache=()):
    """``fn(q, k, v, *rows, *cache) -> (out, k, v)``, an attention over q
    (B, Sq, H, hd) and k, v (B, Sk, KV, hd) with ``rows`` (tensors with
    the batch on dim 0: positions, cache lengths) and ``cache`` (the
    layer's K/V cache leaves, which decode writes in place) that returns
    out (B, Sq, H * hd) and the keys and values it used. Plain tensors:
    ``fn`` itself. ``DTensor`` s: ``fn`` on each rank's local rows and
    whole heads through :func:`local_call`, rows over the batch axes and
    heads over the head axis ("model", or "kvg" on the GQA serve mesh)
    when H and KV both divide it (each rank then holds whole GQA groups),
    else all heads on every rank; q, k and v are laid
    out so first, so a hand kernel never sees a piece of a head. Each
    cache leaf goes in its own layout and is never redistributed, so
    ``fn`` 's writes land in the leaf's own storage (a redistributed cache
    would take them in a copy). out's heads are flattened on each rank,
    so no view of the ``DTensor`` splits or merges a sharded head dim."""
    if not is_sharded(q):
        return fn(q, k, v, *rows, *cache)
    mesh = q.device_mesh
    g = axes_size(mesh, "kvh")
    heads = "kvh" if q.shape[2] % g == 0 and k.shape[2] % g == 0 else None
    q_pl = activation_placements(mesh, q.shape, "dp", None, heads, None)
    k_pl = activation_placements(mesh, k.shape, "dp", None, heads, None)
    out_pl = activation_placements(mesh, q.shape[:2] + (
        q.shape[2] * q.shape[3],), "dp", None, heads)
    return local_call(fn, mesh, (q, k, v, *rows, *cache),
                      (q_pl, k_pl, k_pl)
                      + tuple(activation_placements(mesh, r.shape, "dp")
                              for r in rows)
                      + tuple(tuple(c.placements) for c in cache),
                      (out_pl, k_pl, k_pl))


def vocab_slice(mesh, vocab: int, placements, dim: int):
    """``(axes, start, size)`` of this rank's slice of a vocabulary of
    ``vocab`` entries laid out on tensor dim ``dim`` by ``placements``:
    the mesh axes that split it (empty where none does), and the slice's
    first id and length."""
    from torch.distributed.tensor import Shard
    names = mesh.mesh_dim_names
    axes = [i for i, p in enumerate(placements) if p == Shard(dim)]
    idx, n = 0, 1
    for i in axes:
        idx = idx * mesh.size(i) + mesh.get_local_rank(i)
        n *= mesh.size(i)
    return tuple(names[i] for i in axes), idx * (vocab // n), vocab // n
