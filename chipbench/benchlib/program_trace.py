"""The program's own spans in a profiler trace, and the device operations
launched under each.

``repro_torch`` opens a ``record_function`` span named ``repro_torch.<name>``
at each layer boundary while a profiler records (``common/tracing.py``):
the trainer's step, collect, settle, update and publish, the update's
forward, backward and optimizer, the engine's weight cast, prefills,
decode chunks (their key derivation, the enqueue of the chunk's steps,
the readback) and the host replay. A device operation is put under a span
by the host time of the CUDA runtime or driver call that launched it (the
event with the same correlation id), on any thread: the update's backward
kernels are launched from the autograd engine's own thread while the
calling thread waits inside ``update.backward``. An operation with no
launch record, or launched outside every span, is unattributed; none is
guessed. An idle gap goes to the innermost program span that covers its
middle (``trace.charge_gaps``).

The readings the program's spans allow (D is the mix's ``decode_chunk``):
``decode_host_ms_per_step`` (the host time of ``decode.scan`` over its
steps), ``decode_device_ms_per_step`` (device time, as a union, of the
operations launched under ``engine.decode`` over its steps),
``decode_launches_per_step`` (operations launched under ``decode.scan``
over its steps), ``replay_ms_per_chunk`` (the mean ``engine.replay``),
and ``update_fwd_s`` / ``update_bwd_s`` / ``update_opt_s`` (device time of
the operations launched under ``update.forward`` / ``update.backward`` /
``update.optimizer``). A device reading is None where the trace holds no
device operation (the CPU).
"""
from __future__ import annotations

import bisect
from collections import defaultdict

from benchlib.trace import charge_gaps, gaps, union_length

PREFIX = "repro_torch."


class ProgramTrace:
    """The program spans of one traced window and the device operations
    launched under them.

    ``device_ops``: [(name, start, end, correlation id)]; ``launches``:
    {correlation id: host time of the launching call}; ``spans``: [(name
    without the prefix, start, end)]; times in seconds, the window
    [lo, hi]."""

    def __init__(self, device_ops, launches, spans, lo, hi):
        self.lo, self.hi = lo, hi
        self.ops = [(n, max(s, lo), min(e, hi), c) for n, s, e, c in device_ops
                    if min(e, hi) > max(s, lo)]
        self.spans = [(n, s, e) for n, s, e in spans if e > lo and s < hi]
        self.busy_s = union_length([(s, e) for _, s, e, _ in self.ops], lo, hi)
        # each op's launch time, and the spans that cover it
        t = [launches.get(c) for *_, c in self.ops]
        order = sorted((x, i) for i, x in enumerate(t) if x is not None)
        times = [x for x, _ in order]
        self.linked = len(order)            # ops with a launch record
        self.under = defaultdict(set)       # span name -> op indices
        inner = {}                          # op index -> (length, name)
        for name, a, b in self.spans:
            for _, i in order[bisect.bisect_left(times, a):
                              bisect.bisect_right(times, b)]:
                self.under[name].add(i)
                if i not in inner or b - a < inner[i][0]:
                    inner[i] = (b - a, name)
        self.innermost = [inner[i][1] if i in inner else None
                          for i in range(len(self.ops))]

    # -- by span name ------------------------------------------------------
    def count(self, name) -> int:
        return sum(1 for n, _, _ in self.spans if n == name)

    def host_s(self, name) -> float:
        return sum(e - s for n, s, e in self.spans if n == name)

    def launched(self, name) -> int:
        """Device operations launched under any span ``name``."""
        return len(self.under.get(name, ()))

    def device_s(self, name) -> float:
        """Device time (a union) of the operations launched under any span
        ``name``, nested spans included."""
        return union_length([self.ops[i][1:3] for i in self.under.get(name, ())])

    def table(self) -> dict:
        """{span name: count, host seconds, device seconds and idle seconds
        of the operations and gaps whose innermost span it is}, with
        ``"unattributed"``: the device time of the operations put under no
        span and the idle time outside every span."""
        mine = defaultdict(list)
        for i, n in enumerate(self.innermost):
            mine[n].append(self.ops[i][1:3])
        idle = charge_gaps(gaps([op[1:3] for op in self.ops], self.lo, self.hi),
                           self.spans)
        out = {}
        for name in sorted({n for n, _, _ in self.spans}):
            out[name] = {"count": self.count(name),
                         "host_s": self.host_s(name),
                         "device_s": union_length(mine.get(name, [])),
                         "idle_s": idle.get(name, 0.0)}
        out["unattributed"] = {"device_s": union_length(mine.get(None, [])),
                               "idle_s": idle.get("none", 0.0)}
        return out

    def attributed_share(self) -> float:
        """The share of the busy time that operations put under some span
        cover (1 where the window held no device work)."""
        if self.busy_s <= 0:
            return 1.0
        got = [op[1:3] for op, n in zip(self.ops, self.innermost)
               if n is not None]
        return union_length(got, self.lo, self.hi) / self.busy_s


# -- the readings -------------------------------------------------------------
def decode_host_ms_per_step(pt: ProgramTrace, chunk: int):
    n = pt.count("decode.scan")
    return 1000.0 * pt.host_s("decode.scan") / (n * chunk) if n else None


def decode_device_ms_per_step(pt: ProgramTrace, chunk: int):
    n = pt.count("engine.decode")
    if not n or not pt.ops:
        return None
    return 1000.0 * pt.device_s("engine.decode") / (n * chunk)


def decode_launches_per_step(pt: ProgramTrace, chunk: int):
    n = pt.count("decode.scan")
    if not n or not pt.ops:
        return None
    return pt.launched("decode.scan") / (n * chunk)


def replay_ms_per_chunk(pt: ProgramTrace, chunk: int):
    n = pt.count("engine.replay")
    return 1000.0 * pt.host_s("engine.replay") / n if n else None


def _update_part(span):
    def read(pt: ProgramTrace, chunk: int):
        if not pt.count(span) or not pt.ops:
            return None
        return pt.device_s(span)
    return read


READINGS = {
    "decode_host_ms_per_step": decode_host_ms_per_step,
    "decode_device_ms_per_step": decode_device_ms_per_step,
    "decode_launches_per_step": decode_launches_per_step,
    "replay_ms_per_chunk": replay_ms_per_chunk,
    "update_fwd_s": _update_part("update.forward"),
    "update_bwd_s": _update_part("update.backward"),
    "update_opt_s": _update_part("update.optimizer"),
}


def readings(pt: ProgramTrace, chunk: int) -> dict:
    """Every reading that the trace allows, by name (None ones left out)."""
    out = {k: f(pt, chunk) for k, f in READINGS.items()}
    return {k: v for k, v in out.items() if v is not None}


def from_profiler(prof, lo, hi, other_prefixes=()):
    """A :class:`ProgramTrace` of a ``torch.profiler.profile`` run over the
    window [lo, hi] (seconds). The device operations are those
    ``trace.from_profiler`` keeps: a span's mirror on the device's timeline
    (a user annotation, or a name with ``PREFIX`` or one of
    ``other_prefixes``) is no operation. A launch is a host-side CUDA
    runtime or driver call (a name that starts with ``cu``)."""
    from torch.autograd import DeviceType
    skip = (PREFIX,) + tuple(other_prefixes)
    device_ops, host_calls, spans = [], [], []
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns() * 1e-9
        e = s + ev.duration_ns() * 1e-9
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            if not ev.is_user_annotation() and not name.startswith(skip):
                device_ops.append((name, s, e, ev.correlation_id()))
        elif name.startswith(PREFIX):
            spans.append((name[len(PREFIX):], s, e))
        elif name.startswith("cu"):
            host_calls.append((ev.correlation_id(), s))
    wanted = {c for *_, c in device_ops}
    launches = {c: s for c, s in host_calls if c in wanted}
    return ProgramTrace(device_ops, launches, spans, lo, hi)
