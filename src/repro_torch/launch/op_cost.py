"""Per-device cost of a step, counted op by op as it runs: the counterpart
of ``repro.launch.hlo_cost``.

The reference walks the compiled, partitioned HLO (``parse_hlo_cost``),
scaling each while-loop body by its trip count, because XLA's
``cost_analysis`` counts a loop body once. The port has no HLO: it runs the
step eagerly, its layers a Python loop, its ``DTensor`` ops dispatched op
by op over ``torch.distributed``, its hand kernels called through ctypes.
So :class:`OpCost` answers the same questions at the dispatcher, as a
``TorchDispatchMode`` around the step. Eager execution runs a loop's body
once a trip, so there is no trip count to scale. The dry run
(``launch/dryrun``) runs the step on fake tensors (shapes, no data) over a
fake process group; the counter works as well on real tensors.

A ``DTensor`` op is followed down to the local ops it runs on this rank's
shards (rank 0), so every quantity is per device, as the reference's are,
and work that every rank repeats (a replicated product) counts on each
rank. ``DTensor``'s sharding propagation runs each op once more on fake
tensors of the global shapes, made on the mesh's device; the dry run's own
fake tensors live on ``meta``, so an op with a fake tensor on another
device is propagation, not the step's work, and is not counted.

Fields, each under the reference's name:

* ``flops``: ``mm``, ``bmm``, ``addmm`` and ``baddbmm`` at 2 M N K, and
  ``convolution`` at 2 x output x (input channels / groups) x kernel size,
  as ``_dot_flops``/``_conv_flops`` count dots and convolutions, plus each
  hand kernel's charge (``hopper/build.charge``: the work of the kernel's
  bound, the causal triangle for attention).
* ``bytes`` (the device-memory traffic proxy): each op's input and output
  bytes, a tensor counted at most once over its storage (an expanded
  input is read once), plus the kernels' charges. Views, ``detach``, the
  collectives' ``wait`` and an allocation without a write (``empty``)
  count nothing.
* ``layout_bytes``: the same for the layout ops ``copy_``, ``_to_copy``
  (casts), ``cat``, ``constant_pad_nd`` and ``clone`` (``contiguous`` of a
  transpose), kept apart. Unlike the TPU, the card runs these as kernels
  of their own, so the dry run's roofline adds them to ``bytes``.
* ``collectives``: the output bytes of each collective by the reference's
  kind names (all-gather, all-reduce, reduce-scatter, all-to-all,
  collective-permute), and their ``total``, from the ``_c10d_functional``
  ops of ``DTensor`` 's redistributes and the ``c10d`` ops of
  ``torch.distributed`` (the expert-parallel exchange). Each collective's
  own input and output bytes are in ``bytes`` too, as in the reference.
* ``kernels``: ``{name: {"launches", "flops", "bytes"}}`` of the hand
  kernels' charges.
* ``memory`` (the counterpart of ``compiled.memory_analysis()``):
  ``argument_size_in_bytes`` the arguments' local storage (:meth:`hold`);
  ``output_size_in_bytes`` the outputs'; ``alias_size_in_bytes`` the
  outputs that are arguments (updated in place: parameters, AdamW state,
  the cache); ``peak_bytes`` the most storage the step held at once beyond
  its arguments, each storage followed from the op that made it until it
  is freed (autograd's saved tensors, the kernels' scratch and the
  gradients included); ``temp_size_in_bytes`` that peak less the outputs
  made by the step; ``total_nonalias`` = argument + output + temp - alias.
"""
from __future__ import annotations

import weakref
from collections import Counter
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.common.tree import leaves
from repro_torch.hopper import build

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten
# the products, by the position of their left factor
_MATMULS = {_aten.mm.default: 0, _aten.bmm.default: 0,
            _aten.addmm.default: 1, _aten.baddbmm.default: 1}
_LAYOUT = {"copy_", "_to_copy", "cat", "constant_pad_nd", "clone"}
_FREE = {"detach", "wait_tensor", "_wrap_tensor_autograd", "empty",
         "empty_like", "empty_strided", "new_empty", "new_empty_strided"}
# collective op name (functional, or c10d) -> kind
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    # one rank's tensor to the others: the nearest of the reference's kinds
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}
# c10d ops write their output into their first argument; those that read
# another tensor take it as their second
_C10D_OUT_FIRST = {"allgather_", "_allgather_base_",
                   "allgather_into_tensor_coalesced_", "allreduce_",
                   "allreduce_coalesced_", "reduce_scatter_",
                   "_reduce_scatter_base_", "alltoall_base_", "alltoall_",
                   "broadcast_"}
_C10D_IN_SECOND = {"allgather_", "_allgather_base_",
                   "allgather_into_tensor_coalesced_", "reduce_scatter_",
                   "_reduce_scatter_base_", "alltoall_base_", "alltoall_"}


def _tensors(x):
    """The tensors in a (nested) argument or result."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for a in x for t in _tensors(a)]
    if isinstance(x, dict):
        return [t for a in x.values() for t in _tensors(a)]
    return []


def _nbytes(t) -> int:
    """The bytes ``t`` reads or writes: its elements, at most its
    storage's (an expanded tensor is read once)."""
    n = t.numel() * t.element_size()
    try:
        return min(n, t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):    # a wrapper subclass
        return n


def _is_dtensor(t) -> bool:
    return hasattr(t, "device_mesh") and hasattr(t, "to_local")


def _is_view(func) -> bool:
    """Whether every return of ``func`` aliases an input without writing
    it (a view)."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _propagation(tensors) -> bool:
    """Whether an op runs on ``DTensor`` 's propagation tensors: fake, on a
    device other than the dry run's ``meta``."""
    return any(build.is_fake(t) and t.device.type != "meta"
               for t in tensors)


class OpCost(TorchDispatchMode):
    """The counter: ``with OpCost() as c: step(*args)``, then
    :meth:`record`. :meth:`hold` marks the arguments, whose storage is not
    the step's."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.layout_bytes = 0.0
        self.collectives: Dict[str, float] = {k: 0.0 for k in COLLECTIVES}
        self.kernels: Dict[str, dict] = {}
        self.ops = 0
        self.op_names: Counter = Counter()   # the counted ops, by name
        self._known = set()                   # ids of argument storages
        self._live: Dict[int, int] = {}       # the step's: id -> bytes
        self.live_bytes = 0
        self.peak_bytes = 0
        self._sink = None

    # -- arguments and memory ----------------------------------------------

    def hold(self, *trees) -> int:
        """Mark the storages of ``trees`` ' local tensors as arguments;
        returns their bytes (each storage once)."""
        total = 0
        for t in _local_leaves(trees):
            st = t.untyped_storage()
            if id(st) not in self._known:
                self._known.add(id(st))
                total += st.nbytes()
        return total

    def _track(self, t) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._known or key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        weakref.finalize(st, self._free, key, n)

    def _free(self, key, n) -> None:
        if self._live.pop(key, None) is not None:
            self.live_bytes -= n

    # -- the mode -----------------------------------------------------------

    def __enter__(self):
        self._sink = build.cost_sink(self._charge)
        self._sink.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._sink.__exit__(*exc)
        return out

    def _charge(self, name, flops, nbytes) -> None:
        self.flops += flops
        self.bytes += nbytes
        k = self.kernels.setdefault(name, {"launches": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["launches"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors(args) + _tensors(kwargs)
        if any(_is_dtensor(t) for t in ins):
            # a DTensor op: DTensor runs it, and this mode sees the local
            # ops it runs on this rank's shards (its redistributions'
            # collectives among them)
            return NotImplemented
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if not _propagation(ins + outs):
            self._account(func, args, ins, outs)
        return out

    def _account(self, func, args, ins, outs) -> None:
        self.ops += 1
        name = func._overloadpacket.__name__
        self.op_names[name] += 1
        for t in outs:
            self._track(t)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        if name in _COLLECTIVE_OPS:
            self._collective(name, args, outs)
            return
        if name in _FREE or _is_view(func):
            return
        if func in _MATMULS:
            self.flops += 2.0 * outs[0].numel() * args[_MATMULS[func]].shape[-1]
        elif name == "convolution":
            w = args[1]          # (C_out, C_in / groups, *kernel)
            self.flops += 2.0 * outs[0].numel() * (w.numel() // w.shape[0])
        if name == "copy_":                  # writes its first argument
            nbytes = _nbytes(ins[1]) + _nbytes(ins[0])
        else:
            nbytes = sum(_nbytes(t) for t in ins + outs)
        if name in _LAYOUT:
            self.layout_bytes += nbytes
        else:
            self.bytes += nbytes

    def _collective(self, name, args, outs) -> None:
        kind = _COLLECTIVE_OPS[name]
        if name in _C10D_OUT_FIRST:
            dst = _tensors(args[0])
            src = _tensors(args[1]) if name in _C10D_IN_SECOND else dst
        else:
            dst, src = outs, _tensors(args[0])
        nbytes = float(sum(_nbytes(t) for t in dst))
        self.collectives[kind] += nbytes
        self.bytes += nbytes + sum(_nbytes(t) for t in src)

    # -- the record ---------------------------------------------------------

    def record(self, outputs=None, *, arguments: int = 0) -> dict:
        """The reference's cost record of the counted step: ``outputs`` its
        results (the aliased ones are the arguments they came in as),
        ``arguments`` the bytes :meth:`hold` returned."""
        out_bytes = alias = 0
        seen = set()
        for t in _local_leaves([outputs]):
            st = t.untyped_storage()
            if id(st) in seen:
                continue
            seen.add(id(st))
            out_bytes += st.nbytes()
            if id(st) in self._known:
                alias += st.nbytes()
        coll = dict(self.collectives)
        coll["total"] = sum(self.collectives.values())
        temp = max(0, self.peak_bytes - (out_bytes - alias))
        mem = {"argument_size_in_bytes": arguments,
               "output_size_in_bytes": out_bytes,
               "temp_size_in_bytes": temp,
               "alias_size_in_bytes": alias,
               "peak_bytes": self.peak_bytes,
               "total_nonalias": arguments + out_bytes + temp - alias}
        return {"flops": self.flops, "bytes": self.bytes,
                "layout_bytes": self.layout_bytes, "collectives": coll,
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "ops": self.ops, "memory": mem}


def _local_leaves(trees):
    """The plain tensors of a list of trees: each ``DTensor`` 's local
    shard."""
    return [t.to_local() if _is_dtensor(t) else t
            for t in leaves(list(trees)) if isinstance(t, torch.Tensor)]
