"""The targets of the port's IR-level checks and IR404's contract file:
the counterpart of ``repro.analysis.contracts``.

A target is one hot path of the port traced once on fake tensors over a
fake mesh, the program the dry run counts (``launch/dryrun``): ``tiny`` on
a 4 x 2 mesh (its train step, prefill, decode and the weight-sync
reshard: small shapes, seconds to trace), and ``llama3.2-1b`` and
``deepseek-moe-16b`` on the 16 x 16 production mesh (decode_32k,
prefill_32k and the weight sync), as in the reference.
:func:`measure_target` returns an ``irlint.MeasuredTarget``; the contract
file (``lowering_contracts.json`` beside this module) holds per target the
per-device collective bytes by kind (``launch/op_cost``) and the donated
and kept leaf counts, written by ``python -m repro_torch.analysis.irlint
--write-contracts``. The file is a budget, not a cache: justify its diff
in review.

Measuring makes the dry run's fake default process group in this process
(it refuses a real one): measure in a process of its own.
"""
from __future__ import annotations

import dataclasses
import inspect
import json
import os
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.analysis.irlint import (SERVE_F32_KEYS, DonatedLeaf,
                                         HostSyncRecorder, MeasuredTarget,
                                         sampled)

CONTRACTS_DEFAULT = str(Path(__file__).with_name("lowering_contracts.json"))

TINY_MESH = (4, 2)
PROD_MESH = (16, 16)

PROD_ARCHS = ("llama3.2-1b", "deepseek-moe-16b")
PROD_SHAPES = ("decode_32k", "prefill_32k", "weight_sync")

#: the arguments the reference donates, by kind: params and AdamW state;
#: the cache
DONATED = {"train": (0, 1), "prefill": (3,), "decode": (2,),
           "weight_sync": ()}

#: the decode chunk IR402 and IR403 trace at the decode targets
DECODE_CHUNK = 2


@dataclass(frozen=True)
class Target:
    arch: str
    #: an INPUT_SHAPES name, "weight_sync", or an InputShape
    shape: Union[str, object]
    mesh_shape: Tuple[int, int]

    @property
    def shape_name(self) -> str:
        return self.shape if isinstance(self.shape, str) else self.shape.name

    @property
    def mesh_name(self) -> str:
        return "x".join(str(d) for d in self.mesh_shape)

    @property
    def key(self) -> str:
        return f"{self.arch}|{self.shape_name}|{self.mesh_name}"


def default_targets(archs: Optional[Sequence[str]] = None) -> List[Target]:
    from repro_torch.common.config import InputShape
    tiny_shapes = [
        InputShape("train_tiny", 256, 16, "train"),
        InputShape("prefill_tiny", 256, 8, "prefill"),
        InputShape("decode_tiny", 256, 8, "decode"),
        "weight_sync",
    ]
    out = [Target("tiny", s, TINY_MESH) for s in tiny_shapes]
    for arch in PROD_ARCHS:
        out.extend(Target(arch, s, PROD_MESH) for s in PROD_SHAPES)
    if archs:
        out = [t for t in out if t.arch in archs]
    return out


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------


def _rel(path: str) -> str:
    return os.path.relpath(path).replace(os.sep, "/")


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _named(tree, name):
    """(path name, tensor) of a tree's tensor leaves in ``leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _named(tree[k],
                                                        f"{name}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _named(v, f"{name}[{i}]")]
    return [(name, tree)] if isinstance(tree, torch.Tensor) else []


def _storage(t):
    return _local(t).untyped_storage()._cdata


def _dtype(t) -> str:
    return str(t.dtype).replace("torch.", "")


def _donated(args, donate, outputs) -> List[DonatedLeaf]:
    """Every tensor leaf of the donated arguments, with whether a result of
    the step holds its storage (an in-place update)."""
    kept = {_storage(t) for _, t in _named(outputs, "out")}
    out, offset = [], 0
    for i, arg in enumerate(args):
        named = _named(arg, f"arg{i}")
        if i in donate:
            for j, (name, t) in enumerate(named):
                loc = _local(t)
                out.append(DonatedLeaf(name, offset + j,
                                       loc.numel() * loc.element_size(),
                                       _dtype(t), _storage(t) in kept))
        offset += len(named)
    return out


def _serve_leaves(args, kind):
    """IR401(b): the float leaves of the params and the cache, and the
    names of those the serve cast keeps in float32 by rule."""
    floats, kept = [], []
    for i in (0, DONATED[kind][0]):
        for name, t in _named(args[i], f"arg{i}"):
            if not t.is_floating_point():
                continue
            if name.rsplit("[", 1)[-1].strip("]'") in SERVE_F32_KEYS:
                kept.append(name)
            else:
                floats.append((name, _dtype(t)))
    return floats, kept


def _count(step, args, mesh, cost=None):
    """``step(*args)`` on ``mesh`` under a :class:`HostSyncRecorder` (and
    ``cost``, an ``OpCost``): (its result, the host syncs)."""
    from repro_torch.common.partitioning import set_activation_mesh
    rec = HostSyncRecorder()
    set_activation_mesh(mesh)
    try:
        if cost is None:
            with rec:
                out = step(*args)
        else:
            with cost, rec:
                out = step(*args)
    finally:
        set_activation_mesh(None)
    return out, rec.syncs


def decode_chunk(cfg, args, steps: int = DECODE_CHUNK):
    """``(step, args)`` of one decode chunk as the engine runs it
    (``models/model.decode_scan``: decode, sample, stop flags) at a decode
    target's arguments, with :func:`irlint.sampled` for the sampling
    kernel. Returns the chunk's cache among its results."""
    from repro_torch.common.partitioning import on_rows, replicate
    from repro_torch.core.rollout import stop_flags
    from repro_torch.models import model as M
    params, token, cache, cache_len = args
    max_len = next(t for layer in cache for t in layer.values()).shape[1]
    active, resp = token >= 0, cache_len * 0

    def step_fn(logits, clen, act, aux):
        resp, d = aux
        tok, logp = on_rows(sampled, (logits,), n_out=2)
        tok, logp = replicate(tok), replicate(logp)
        resp_new = resp + act.to(resp.dtype)
        eos, length = stop_flags(tok, resp_new, clen + 2, eos_id=0,
                                 max_response_len=max_len // 2,
                                 max_len=max_len)
        return tok, logp, eos | length, (resp_new, d + 1)

    def chunk(params, token, cache, cache_len):
        return M.decode_scan(params, cfg, cache, token, cache_len, active,
                             (resp, 0), steps=steps, step_fn=step_fn)

    return chunk, (params, token, cache, cache_len)


def measure_target(t: Target) -> MeasuredTarget:
    """Trace target ``t`` once on fake tensors over a fake mesh: the
    dry run's step under ``OpCost`` (IR404's bytes; IR402 and IR403 but at
    decode), and at decode a decode chunk (IR402, IR403)."""
    from repro_torch.common.config import INPUT_SHAPES
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.op_cost import OpCost
    from repro_torch.models import model as M

    mesh = D.dry_mesh(*t.mesh_shape)
    t0 = time.perf_counter()
    if t.shape == "weight_sync":
        from repro_torch.core.weight_sync import make_param_resharder
        cfg = get_config(t.arch)
        with D.fake_mode():
            params = D.fake_params(cfg, mesh)
        step, _ = make_param_resharder(cfg, params, mesh)
        args, kind, anchor = (params,), "weight_sync", make_param_resharder
    else:
        cfg = D.dryrun_config(get_config(t.arch))
        shape = (INPUT_SHAPES[t.shape] if isinstance(t.shape, str)
                 else t.shape)
        kind = shape.kind
        with D.fake_mode():
            step, args, _ = D.input_specs(cfg, shape, mesh)
        anchor = step
    cost = OpCost()
    cost.hold(*args)
    out, syncs = _count(step, args, mesh, cost)
    rec = cost.record(out)
    floats, kept = [], []
    if kind in ("prefill", "decode"):
        floats, kept = _serve_leaves(args, kind)
    if kind == "decode":
        # the donation and the host syncs across a decode chunk, computed
        # in the serve dtype as input_specs' step is
        chunk, chunk_args = decode_chunk(
            dataclasses.replace(cfg, dtype="bfloat16"), args)
        out, syncs = _count(chunk, chunk_args, mesh)
        anchor = M.decode_scan
    donated = _donated(args, DONATED[kind], out)
    try:
        src = _rel(inspect.getsourcefile(anchor))
        line = inspect.getsourcelines(anchor)[1]
    except (TypeError, OSError):
        src, line = "src/repro_torch/launch/dryrun.py", 1
    return MeasuredTarget(
        key=t.key, arch=t.arch, shape=t.shape_name, mesh=t.mesh_name,
        kind=kind, path=src, line=line, chips=mesh.size(), donated=donated,
        callbacks=syncs,
        collectives={k: float(v) for k, v in rec["collectives"].items()},
        float_leaves=floats, kept_f32=kept,
        trace_s=round(time.perf_counter() - t0, 2))


# ---------------------------------------------------------------------------
# the contract file
# ---------------------------------------------------------------------------


def load_contracts(path: str) -> Dict[str, dict]:
    """key -> entry. A missing file is empty (every target then fails
    IR404 with a 'no contract' finding until one is written)."""
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    return dict(data.get("entries", {}))


def write_contracts(measured: Sequence[MeasuredTarget], path: str, *,
                    keep_others: bool = False) -> int:
    """Write the entries of ``measured`` (``keep_others``: beside the
    file's other entries). Returns the file's number of entries."""
    entries = load_contracts(path) if keep_others else {}
    for mt in measured:
        entries[mt.key] = {
            "arch": mt.arch,
            "shape": mt.shape,
            "mesh": mt.mesh,
            "kind": mt.kind,
            "chips": mt.chips,
            "collective_bytes": {k: mt.collectives.get(k, 0.0)
                                 for k in sorted(mt.collectives)},
            "donated_leaves": len(mt.donated),
            "aliased_leaves": sum(1 for d in mt.donated if d.aliased),
            "kept_f32_leaves": len(mt.kept_f32),
        }
    doc = {
        "_comment": ("Per-(arch, shape, mesh) contracts of the port: "
                     "per-device collective bytes by kind (launch/op_cost "
                     "on the traced step) that IR404 gates against. "
                     "Regenerate with `python -m "
                     "repro_torch.analysis.irlint --write-contracts` and "
                     "justify the diff in review: this file is a budget, "
                     "not a cache."),
        "version": 1,
        "entries": {k: entries[k] for k in sorted(entries)},
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=2)
        fh.write("\n")
    return len(entries)
