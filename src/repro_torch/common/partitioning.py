"""Activation-sharding context: the port of ``repro.common.partitioning``.

Model code is mesh-agnostic; the launcher (``launch/multihost``, or a caller
of the sharded ``make_train_step``) installs the active mesh here and the
model constrains key activations (the embedding output, the loss's
logits) to fixed placements, so the eager ``DTensor`` propagation does not
drift into partial-logits layouts. The reference also constrains the
selective scan's state and inputs; here the SSM branch runs on each rank's
own rows inside ``local_map``, where they are plain tensors.

Without a mesh every call is a no-op that returns its input itself; so is a
call on a plain tensor (a rank's local shard inside ``local_map``).

The attention layers decide here how they run on a mesh:
:func:`split_heads` lays a projection out so that no rank holds a piece of
a head, and :func:`over_heads` runs the one attention function of a layer
either as it is (plain tensors) or on each rank's rows and whole heads.
"""
from __future__ import annotations

_STATE: dict = {"mesh": None}


def set_activation_mesh(mesh):
    _STATE["mesh"] = mesh


def get_activation_mesh():
    return _STATE["mesh"]


def _resolve(mesh, tag) -> tuple:
    names = mesh.mesh_dim_names
    if tag is None:
        return ()
    if tag == "dp":
        return tuple(a for a in ("pod", "data") if a in names)
    if tag == "tp":
        return ("model",) if "model" in names else ()
    return (tag,)


def activation_placements(mesh, shape, *tags) -> tuple:
    """One placement per mesh dim for tensor dims tagged ``tags`` ("dp":
    the batch axes, "tp": "model", None: replicated); a dim that does not
    divide its axes stays replicated."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    out = {a: Replicate() for a in mesh.mesh_dim_names}
    for i, tag in enumerate(tags):
        axes = _resolve(mesh, tag)
        n = 1
        for a in axes:
            n *= sizes[a]
        if axes and shape[i] % n == 0:
            for a in axes:
                out[a] = Shard(i)
    return tuple(out[a] for a in mesh.mesh_dim_names)


def shard_activation(x, *tags):
    """Redistribute the ``DTensor`` ``x`` to the placements ``tags`` name
    on the installed mesh; ``x`` itself without a mesh or for a plain
    tensor. Tags: "dp" (batch axes), "tp" ("model"), None."""
    mesh = _STATE["mesh"]
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
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


def split_heads(t, n: int, hd: int):
    """(..., n * hd) -> (..., n, hd). A ``DTensor`` whose last dim is
    sharded below a head (n not a multiple of the "model" axis) is laid
    out whole over "model" first."""
    if is_sharded(t):
        mesh = t.device_mesh
        if n % dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1):
            t = t.redistribute(mesh, activation_placements(mesh, t.shape,
                                                           "dp"))
    return t.unflatten(-1, (n, hd))


def over_heads(fn, q, k, v, rows=None):
    """``fn(q, k, v, rows) -> (out, k, v)``, an attention over q (B, Sq,
    H, hd) and k, v (B, Sk, KV, hd) with ``rows`` (B, Sq) (positions, or
    None) that returns out (B, Sq, H * hd) and the keys and values it
    used. Plain tensors: ``fn`` itself. ``DTensor`` s: ``fn`` on each
    rank's local rows and whole heads through :func:`local_call`, rows
    over the batch axes and heads over "model" when H and KV both divide
    it (each rank then holds whole GQA groups), else all heads on every
    rank; q, k and v are laid out so first, so a hand kernel never sees a
    piece of a head. out's heads are flattened on each rank, so no view
    of the ``DTensor`` splits or merges a sharded head dim."""
    if not is_sharded(q):
        return fn(q, k, v, rows)
    mesh = q.device_mesh
    tp = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1)
    heads = "tp" if q.shape[2] % tp == 0 and k.shape[2] % tp == 0 else None
    q_pl = activation_placements(mesh, q.shape, "dp", None, heads, None)
    k_pl = activation_placements(mesh, k.shape, "dp", None, heads, None)
    out_pl = activation_placements(mesh, q.shape[:2] + (
        q.shape[2] * q.shape[3],), "dp", None, heads)
    if rows is None:
        return local_call(lambda q_, k_, v_: fn(q_, k_, v_, None), mesh,
                          (q, k, v), (q_pl, k_pl, k_pl),
                          (out_pl, k_pl, k_pl))
    return local_call(fn, mesh, (q, k, v, rows),
                      (q_pl, k_pl, k_pl, activation_placements(
                          mesh, rows.shape, "dp", None)),
                      (out_pl, k_pl, k_pl))


def vocab_slice(mesh, vocab: int, placements, dim: int):
    """``(split, start, size)`` of this rank's slice of a vocabulary of
    ``vocab`` entries laid out on tensor dim ``dim`` by ``placements``:
    whether "model" shards it, and the slice's first id and length."""
    from torch.distributed.tensor import Shard
    names = mesh.mesh_dim_names
    if "model" not in names or placements[names.index("model")] != Shard(dim):
        return False, 0, vocab
    size = vocab // mesh.size(names.index("model"))
    return True, mesh.get_local_rank("model") * size, size
