"""IR-level checks on the port's program (IR401–IR404, PAL205): the
counterpart of ``repro.analysis.irlint``.

The reference lowers its hot paths on a fake-device mesh and checks the
compiled HLO. The port has no HLO: it runs eagerly, op by op. So each rule
here checks what its counterpart guards, on the port's own program, traced
once on fake tensors over a fake mesh by ``analysis/contracts.measure_target``
(the dry run's ``launch/dryrun``: a ``fake`` process group, fake tensors on
``meta``, the hand kernels charged and never launched):

* **IR401** recompilation hazards: (a) every raw batch inside one prefill
  bucket cell pads to one shape (``core/rollout.prefill_pad_dims``, the
  reference's cells); (b) every float tensor that reaches prefill and
  decode (the prepared params and the cache) is bf16, but the leaves the
  serve cast keeps in float32 by rule (:data:`SERVE_F32_KEYS`: the norm
  scales, the MoE router, the scans' decay and step parameters, which the
  reference also reads in float32). Torch has no weak types, so the
  reference's weak-type half has no counterpart.
* **IR402** donation integrity: every leaf the reference donates keeps its
  storage through one step: the params and the AdamW moments across
  ``make_train_step`` (updated in place, ``optim/adam.update``), the cache
  across a prefill and across a decode chunk (``models/model.decode_scan``).
  A leaf of at least :data:`MIN_ALIAS_BYTES` a device that comes out in new
  storage is a copy of the whole buffer: a finding.
* **IR403** host syncs: no op that makes the host wait for the card
  (:data:`HOST_SYNC_OPS`, or a copy to the host) runs inside a decode chunk,
  a prefill, a train step or the weight-sync reshard
  (:class:`HostSyncRecorder`, a dispatch mode beside ``OpCost``). The
  sampling kernel's wrapper refuses fake tensors, so the decode chunk runs
  with a stand-in of its shapes (:func:`sampled`); on the card
  ``chip_smoke.py`` runs a real chunk under
  ``torch.cuda.set_sync_debug_mode("error")``.
* **IR404** collective budget: per-device collective bytes by kind
  (``launch/op_cost.OpCost``) against the port's contract file
  (``analysis/lowering_contracts.json``): a regression beyond 2% and 1 KiB
  or a missing entry is an error, an improvement a warning, an entry that
  matches no target a stale warning.
* **PAL205** kernel resources: for each hand kernel, ptxas's static shared
  memory, registers and spill bytes from its build log
  (``hopper/build.library_log``) against the card's limits
  (``torch.cuda.get_device_properties``; the H100's without a card); a
  spill is a warning. The reference's proof that every block index is in
  bounds is ``chip_bounds.py``: every kernel family at the reference's
  harness shapes on the card under ``compute-sanitizer --tool memcheck``.

CLI (exit 1 on an error finding, warnings too with ``--strict``)::

    PYTHONPATH=src python -m repro_torch.analysis.irlint --arch tiny
    PYTHONPATH=src python -m repro_torch.analysis.irlint --select IR404 --write-contracts

Measuring needs a process of its own (the dry run's fake process group).
"""
from __future__ import annotations

import argparse
import inspect
import os
import re
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

SEV_ERROR = "error"
SEV_WARNING = "warning"

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute", "total")

#: donated leaves smaller than this are not worth flagging (the step
#: counter): the copy is noise, not a spike of device memory
MIN_ALIAS_BYTES = 1024

#: IR404's tolerance: 2% relative, 1 KiB absolute (the reference's)
CONTRACT_REL_TOL = 0.02
CONTRACT_ABS_TOL = 1024.0

#: the serve cast's float32 leaves (``models/model.cast_params``), by key
SERVE_F32_KEYS = ("ln1", "ln2", "final_norm", "fuse_norm_a", "fuse_norm_s",
                  "q_norm", "k_norm", "router", "A_log", "D", "dt_bias",
                  "dt_proj", "w_base", "dec_b", "u")

#: ops that make the host wait for the card's queue on CUDA: a value read
#: (``.item()``, ``bool()``), a data-dependent output shape
HOST_SYNC_OPS = ("_local_scalar_dense", "is_nonzero", "equal", "nonzero",
                 "masked_select", "unique", "_unique", "_unique2",
                 "unique_consecutive", "unique_dim", "bincount",
                 "repeat_interleave")

#: PAL205 limits without a card: the H100's (``shared_memory_per_block``,
#: and the architectural 255 registers a thread)
H100_LIMITS = {"static_smem_bytes": 49152, "registers_per_thread": 255,
               "source": "H100 datasheet"}

RULES = {
    "IR401": (SEV_ERROR, "bucketed hot path pads to more than one shape, or "
                         "a serve input leaves the serve dtype"),
    "IR402": (SEV_ERROR, "a donated leaf comes out of the step in new "
                         "storage"),
    "IR403": (SEV_ERROR, "a host sync inside a hot path"),
    "IR404": (SEV_ERROR, "per-step collective bytes exceed the contract"),
    "PAL205": (SEV_ERROR, "a hand kernel over the card's shared memory or "
                          "registers"),
}


@dataclass
class Finding:
    rule: str
    severity: str
    path: str                      # repo-relative, forward slashes
    line: int
    col: int
    message: str
    context: str = "<ir>"
    src_line: str = ""

    def location(self) -> str:
        return f"{self.path}:{self.line}:{self.col}"


@dataclass
class DonatedLeaf:
    name: str        # the leaf's path, e.g. "arg1['m']['layers'][0]['ln1']"
    param: int       # flat index over every argument's tensor leaves
    nbytes: int      # per device (the local shard's)
    dtype: str
    aliased: bool    # kept its storage through the step


@dataclass
class MeasuredTarget:
    """What the rules need of one traced hot path; built by
    ``contracts.measure_target``, checked by the ``check_*`` functions."""
    key: str                     # "arch|shape|mesh"
    arch: str
    shape: str
    mesh: str
    kind: str                    # train | prefill | decode | weight_sync
    path: str                    # repo-relative anchor (the step's source)
    line: int
    chips: int
    donated: List[DonatedLeaf] = field(default_factory=list)
    callbacks: List[str] = field(default_factory=list)     # host syncs
    collectives: Dict[str, float] = field(default_factory=dict)
    float_leaves: List[Tuple[str, str]] = field(default_factory=list)
    kept_f32: List[str] = field(default_factory=list)
    trace_s: float = 0.0


def _finding(rule: str, mt_or_path, message: str, *, line: int = 1,
             context: str = "<ir>", src_line: str = "",
             severity: Optional[str] = None) -> Finding:
    if isinstance(mt_or_path, MeasuredTarget):
        path, line, context = mt_or_path.path, mt_or_path.line, mt_or_path.key
    else:
        path = mt_or_path
    return Finding(rule=rule, severity=severity or RULES[rule][0], path=path,
                   line=line, col=1, message=message, context=context,
                   src_line=src_line)


def _rel(path: str) -> str:
    return os.path.relpath(path).replace(os.sep, "/")


def _relsrc(obj) -> str:
    try:
        return _rel(inspect.getsourcefile(obj))
    except TypeError:
        return "<unknown>"


# ---------------------------------------------------------------------------
# IR401: recompilation hazards
# ---------------------------------------------------------------------------


def bucket_cells(bucket: int):
    """The reference's raw variants that must share one padded shape:
    ``(lens, rows, pending)`` each."""
    return [
        [([1], 1, 1), ([bucket], 1, 1)],
        [([5, 9], 2, 2), ([bucket // 2, bucket], 2, 2)],
        [([bucket + 1], 3, 5), ([2 * bucket], 4, 8)],
        [([3 * bucket - 7, 11], 5, 9), ([2 * bucket + 1], 8, 16)],
    ]


def check_bucket_stability() -> List[Finding]:
    """IR401(a): the reference's cells through the port's bucketing."""
    from repro_torch.core import rollout
    path = _relsrc(rollout)
    fn = getattr(rollout, "prefill_pad_dims", None)
    if fn is None:
        return [_finding("IR401", path, "rollout.prefill_pad_dims is "
                         "missing: prefill padding is no longer in one place "
                         "and bucket stability cannot be checked",
                         context="prefill_pad_dims",
                         src_line="prefill_pad_dims missing")]
    line = inspect.getsourcelines(fn)[1]
    out = []
    for cell in bucket_cells(rollout.PREFILL_BUCKET):
        sigs = {(tuple(lens), r, p): fn(lens, r, p) for lens, r, p in cell}
        distinct = set(sigs.values())
        if len(distinct) != 1:
            out.append(_finding(
                "IR401", path, line=line, context="prefill_pad_dims",
                src_line=f"cell:{cell[0]}",
                message=("raw batches inside one prefill bucket cell pad "
                         f"to {len(distinct)} shapes {sigs}: each extra "
                         "shape is another prefill configuration (and "
                         "another capture for a graphed step) on the "
                         "serving path")))
    return out


def check_signature(mt: MeasuredTarget) -> List[Finding]:
    """IR401(b): serve-path float inputs off the serve dtype."""
    out = []
    if mt.kind in ("prefill", "decode"):
        bad = [(n, d) for n, d in mt.float_leaves if d != "bfloat16"]
        for name, dt in bad[:4]:
            out.append(_finding(
                "IR401", mt, src_line=f"dtype:{name}",
                message=(f"{mt.key}: serve-path input {name} is {dt}, not "
                         "bfloat16: mixed dtypes on the decode path cost a "
                         "cast every step")))
    return out


# ---------------------------------------------------------------------------
# IR402: donation integrity
# ---------------------------------------------------------------------------


def check_donation(mt: MeasuredTarget) -> List[Finding]:
    out = []
    for leaf in mt.donated:
        if leaf.aliased or leaf.nbytes < MIN_ALIAS_BYTES:
            continue
        out.append(_finding(
            "IR402", mt, src_line=f"donated:{leaf.name}",
            message=(f"{mt.key}: donated buffer {leaf.name} ({leaf.dtype}, "
                     f"{leaf.nbytes / 2**20:.2f} MiB/device, argument leaf "
                     f"{leaf.param}) comes out of the step in new storage: "
                     "the in-place update degrades to a copy (a spike of "
                     "device memory of the same size)")))
    return out


# ---------------------------------------------------------------------------
# IR403: host syncs in the hot loop
# ---------------------------------------------------------------------------


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for a in x for t in _tensors(a)]
    if isinstance(x, dict):
        return [t for a in x.values() for t in _tensors(a)]
    return []


def _is_dtensor(t) -> bool:
    return hasattr(t, "device_mesh") and hasattr(t, "to_local")


class HostSyncRecorder(TorchDispatchMode):
    """Records each op that, on CUDA tensors, makes the host wait for the
    card: :data:`HOST_SYNC_OPS` and copies to the host from another device
    (the dry run's ``meta`` tensors stand for the card's). A ``DTensor`` op
    is followed down to the local ops it runs, as ``OpCost`` does. On fake
    tensors a value read has no value: the recorder answers it with 0 (a
    data-dependent shape with an empty result), so the trace goes on."""

    def __init__(self):
        super().__init__()
        self.syncs: List[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors(args) + _tensors(kwargs)
        if any(_is_dtensor(t) for t in ins):
            return NotImplemented
        name = func._overloadpacket.__name__
        if name in HOST_SYNC_OPS:
            self.syncs.append(f"aten.{name}")
            try:
                return func(*args, **kwargs)
            except Exception:            # a fake tensor has no value
                return _stand_in(func, ins)
        out = func(*args, **kwargs)
        if name in ("_to_copy", "copy_"):
            dst = _tensors(out)[:1] if name == "_to_copy" else ins[:1]
            src = ins[:1] if name == "_to_copy" else ins[1:2]
            if dst and src and dst[0].device.type == "cpu" \
                    and src[0].device.type != "cpu":
                self.syncs.append(f"aten.{name}(to the host)")
        return out


def _stand_in(func, ins):
    rets = func._schema.returns
    if rets and str(rets[0].type) == "Tensor":
        like = ins[0]
        return torch.empty((0,) * max(1, like.dim()), dtype=torch.int64,
                           device=like.device)
    return 0


def check_callbacks(mt: MeasuredTarget) -> List[Finding]:
    out = []
    for op in sorted(set(mt.callbacks)):
        n = mt.callbacks.count(op)
        out.append(_finding(
            "IR403", mt, src_line=f"callback:{op}",
            message=(f"{mt.key}: {n} `{op}` op(s) inside the {mt.kind} "
                     "step: each makes the host wait for the card's queue "
                     "to drain, every step")))
    return out


def sampled(logits):
    """The sampling kernel's stand-in in the traced decode chunk: its
    output shapes, (tokens (R,) int32, logps (R,) float32), from device
    ops that read no value on the host."""
    return logits.argmax(-1).to(torch.int32), logits.amax(-1).float()


# ---------------------------------------------------------------------------
# IR404: collective budget
# ---------------------------------------------------------------------------


def check_contract(mt: MeasuredTarget, contracts: Dict[str, dict],
                   *, rel_tol: float = CONTRACT_REL_TOL,
                   abs_tol: float = CONTRACT_ABS_TOL) -> List[Finding]:
    entry = contracts.get(mt.key)
    if entry is None:
        return [_finding(
            "IR404", mt, src_line=f"missing-contract:{mt.key}",
            message=(f"{mt.key}: no contract entry: run `python -m "
                     "repro_torch.analysis.irlint --write-contracts` and "
                     "check the diff in"))]
    out = []
    expected = entry.get("collective_bytes", {})
    for kind in COLLECTIVE_KINDS:
        want = float(expected.get(kind, 0.0))
        got = float(mt.collectives.get(kind, 0.0))
        diff = got - want
        if abs(diff) <= max(abs_tol, rel_tol * max(want, got)):
            continue
        if diff > 0:
            out.append(_finding(
                "IR404", mt, src_line=f"coll:{kind}",
                message=(f"{mt.key}: {kind} bytes/device regressed "
                         f"{want:.3e} -> {got:.3e} "
                         f"({diff / max(want, 1.0):+.1%}) against the "
                         "contract: an unbudgeted collective crept into "
                         "the step")))
        else:
            out.append(_finding(
                "IR404", mt, src_line=f"coll:{kind}", severity=SEV_WARNING,
                message=(f"{mt.key}: {kind} bytes/device improved "
                         f"{want:.3e} -> {got:.3e}: refresh the contract "
                         "(`--write-contracts`) so the win is locked in")))
    return out


def check_stale_contracts(measured: Sequence[MeasuredTarget],
                          contracts: Dict[str, dict],
                          path: str = "lowering_contracts.json"
                          ) -> List[Finding]:
    keys = {mt.key for mt in measured}
    return [_finding("IR404", path, context=k, src_line=f"stale:{k}",
                     severity=SEV_WARNING,
                     message=(f"contract entry {k} matches no measured "
                              "target: remove it or restore the target"))
            for k in sorted(set(contracts) - keys)]


# ---------------------------------------------------------------------------
# PAL205: kernel resources
# ---------------------------------------------------------------------------


def _kernel_name(entry: str) -> str:
    """The kernel's own name from its mangled symbol (the rest kept)."""
    m = re.match(r"_Z(\d+)", entry)
    if not m:
        return entry
    n = int(m.group(1))
    return entry[m.end():m.end() + n] + entry[m.end() + n:][:24]


def parse_ptxas(log: str) -> List[dict]:
    """Each entry function of an ``-Xptxas -v`` log: its name, registers,
    spill stores and loads, and static shared memory, in bytes."""
    out = []
    for entry, body in re.findall(
            r"Compiling entry function '(\S+)'(.*?)(?=Compiling entry|\Z)",
            log, re.S):
        regs = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", body)
        smem = re.search(r"(\d+) bytes smem", body)
        out.append(dict(entry=entry, name=_kernel_name(entry),
                        registers=int(regs.group(1)) if regs else 0,
                        spill_stores=int(spill.group(1)) if spill else 0,
                        spill_loads=int(spill.group(2)) if spill else 0,
                        smem=int(smem.group(1)) if smem else 0))
    return out


def card_limits() -> dict:
    """PAL205's limits: the card's (``torch.cuda.get_device_properties``)
    where there is one, else :data:`H100_LIMITS`."""
    if not torch.cuda.is_available():
        return dict(H100_LIMITS)
    p = torch.cuda.get_device_properties(0)
    return {"static_smem_bytes": int(p.shared_memory_per_block),
            "registers_per_thread": H100_LIMITS["registers_per_thread"],
            "source": p.name}


def check_kernel_budget(library: str, log: str, limits: dict
                        ) -> List[Finding]:
    """PAL205 on one library's ptxas log."""
    out = []
    where = f"src/repro_torch/csrc/{library}.cu"
    for k in parse_ptxas(log):
        over = []
        if k["smem"] > limits["static_smem_bytes"]:
            over.append(f"{k['smem']} bytes of static shared memory (the "
                        f"card's {limits['static_smem_bytes']} a block)")
        if k["registers"] > limits["registers_per_thread"]:
            over.append(f"{k['registers']} registers a thread (at most "
                        f"{limits['registers_per_thread']})")
        if over:
            out.append(_finding(
                "PAL205", where, context=library,
                src_line=f"{library}:{k['entry']}:budget",
                message=(f"{library}: {k['name']} uses " + " and ".join(over)
                         + ": the launch fails on this card")))
        if k["spill_stores"] or k["spill_loads"]:
            out.append(_finding(
                "PAL205", where, context=library, severity=SEV_WARNING,
                src_line=f"{library}:{k['entry']}:spill",
                message=(f"{library}: {k['name']} spills "
                         f"{k['spill_stores']} bytes (stores) and "
                         f"{k['spill_loads']} (loads) to local memory")))
    return out


def kernel_budgets(limits: Optional[dict] = None
                   ) -> Tuple[List[Finding], Dict[str, dict]]:
    """PAL205 over every hand kernel's library: findings, and per library
    the largest registers, static shared memory and spill bytes of its
    kernels (None where it is not built here: a warning)."""
    from repro_torch.hopper import build
    limits = limits or card_limits()
    findings, rows = [], {}
    for name in build.KERNELS:
        try:
            log = build.library_log(name)
        except OSError:
            rows[name] = None
            findings.append(_finding(
                "PAL205", f"src/repro_torch/csrc/{name}.cu", context=name,
                severity=SEV_WARNING, src_line=f"{name}:unbuilt",
                message=(f"{name}: no build log here (built with nvcc on "
                         "the card's machine): its budget is not checked")))
            continue
        ks = parse_ptxas(log)
        rows[name] = dict(kernels=len(ks),
                          max_registers=max((k["registers"] for k in ks),
                                            default=0),
                          max_static_smem=max((k["smem"] for k in ks),
                                              default=0),
                          spill_bytes=sum(k["spill_stores"] + k["spill_loads"]
                                          for k in ks))
        findings.extend(check_kernel_budget(name, log, limits))
    return findings, rows


# ---------------------------------------------------------------------------
# the suite
# ---------------------------------------------------------------------------


def _want(rid: str, select) -> bool:
    return not select or any(rid.startswith(s) for s in select)


def measure_all(archs: Optional[Sequence[str]] = None
                ) -> List[MeasuredTarget]:
    """Measure every default target (``contracts.default_targets``). The
    dry run's fake process group is made in this process: call it in a
    process of its own (the CLI is one; tests replace this function)."""
    from repro_torch.analysis import contracts
    return [contracts.measure_target(t)
            for t in contracts.default_targets(archs=archs)]


def run_ir(select: Optional[Sequence[str]] = None,
           contracts_path: Optional[str] = None,
           archs: Optional[Sequence[str]] = None,
           ) -> Tuple[List[Finding], int]:
    """Run the rules; returns (findings, targets and libraries checked)."""
    from repro_torch.analysis import contracts
    contracts_path = contracts_path or contracts.CONTRACTS_DEFAULT
    findings: List[Finding] = []
    scanned = 0
    if _want("IR401", select):
        findings.extend(check_bucket_stability())
    if any(_want(r, select)
           for r in ("IR401", "IR402", "IR403", "IR404")):
        measured = measure_all(archs=archs)
        scanned += len(measured)
        for mt in measured:
            if _want("IR401", select):
                findings.extend(check_signature(mt))
            if _want("IR402", select):
                findings.extend(check_donation(mt))
            if _want("IR403", select):
                findings.extend(check_callbacks(mt))
        if _want("IR404", select):
            cdata = contracts.load_contracts(contracts_path)
            for mt in measured:
                findings.extend(check_contract(mt, cdata))
            if archs is None:
                findings.extend(check_stale_contracts(
                    measured, cdata, _rel(contracts_path)))
    if _want("PAL205", select):
        found, rows = kernel_budgets()
        findings.extend(found)
        scanned += len(rows)
    return findings, scanned


def _split(s: Optional[str]) -> Optional[List[str]]:
    return [x.strip() for x in s.split(",") if x.strip()] if s else None


def main(argv: Optional[List[str]] = None) -> int:
    from repro_torch.analysis import contracts
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.irlint",
        description="IR401-IR404 and PAL205 on the port's program.")
    ap.add_argument("--select", default=None, metavar="RULES",
                    help="comma-separated rule ids or prefixes")
    ap.add_argument("--arch", default=None, metavar="ARCHS",
                    help="only the targets of these archs (comma-separated)")
    ap.add_argument("--contracts", default=contracts.CONTRACTS_DEFAULT,
                    help="IR404's contract file")
    ap.add_argument("--write-contracts", action="store_true",
                    help="measure the targets and write their entries to "
                         "the contract file (with --arch: those archs' "
                         "entries, the others kept)")
    ap.add_argument("--strict", action="store_true",
                    help="warnings fail the run too")
    args = ap.parse_args(argv)
    archs = _split(args.arch)
    if args.write_contracts:
        measured = measure_all(archs=archs)
        n = contracts.write_contracts(measured, args.contracts,
                                      keep_others=archs is not None)
        for mt in measured:
            print(f"  {mt.key}: collectives "
                  f"{mt.collectives.get('total', 0.0):.3e} B/device, "
                  f"{sum(d.aliased for d in mt.donated)}/{len(mt.donated)} "
                  f"donated leaves kept, traced in {mt.trace_s:.1f} s")
        print(f"wrote {n} contract entries to {args.contracts}")
        return 0
    findings, scanned = run_ir(select=_split(args.select),
                               contracts_path=args.contracts, archs=archs)
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        print(f"{f.location()}: {f.severity}: {f.rule} {f.message}")
    errors = [f for f in findings
              if args.strict or f.severity == SEV_ERROR]
    print(f"{scanned} targets and libraries checked, {len(findings)} "
          f"finding(s), {len(errors)} failing")
    return 1 if errors else 0


if __name__ == "__main__":
    # through the package's module, whose classes contracts.py builds
    from repro_torch.analysis import irlint as _irlint
    sys.exit(_irlint.main())
