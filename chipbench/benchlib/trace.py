"""Reduction of a profiler trace to device time, idle gaps and kernel time.

Device time is the union of the intervals in which any operation ran on
the device (overlapping streams count once), clipped to the traced window.
An idle gap is a stretch of the window in which no device operation ran;
each is charged to the innermost benchmark span (a ``record_function``
range the harness wraps around a call into the program) that covers its
middle.
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict


def union_length(intervals, lo=None, hi=None) -> float:
    """Total length of the union of [start, end) intervals, clipped to
    [lo, hi] where given."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo, hi):
    """The idle stretches of [lo, hi] between the union of intervals."""
    out, t = [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


_IDENT = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


def kernel_ident(name: str) -> str:
    """The function's own identifier in a device operation's name:
    ``void ns::decode_kernel<__nv_bfloat16, 128>(...)`` -> decode_kernel."""
    head = name.replace("(anonymous namespace)::", "").strip()
    if head.startswith("void "):
        head = head[5:]
    head = head.split("<", 1)[0].split("(", 1)[0].strip()
    head = head.rsplit("::", 1)[-1].strip()
    m = _IDENT.match(head)
    return m.group(0) if m else name[:64]


def charge_gaps(gap_list, spans):
    """{span name: idle seconds} with each gap charged to the innermost
    span (shortest) covering its middle; "none" where none does."""
    gl = sorted(gap_list, key=lambda g: g[0] + g[1])
    mids = [0.5 * (s + e) for s, e in gl]
    owner = [None] * len(gl)               # (span length, name)
    for name, a, b in spans:
        i, j = bisect.bisect_left(mids, a), bisect.bisect_right(mids, b)
        for k in range(i, j):
            if owner[k] is None or b - a < owner[k][0]:
                owner[k] = (b - a, name)
    out = defaultdict(float)
    for (s, e), own in zip(gl, owner):
        out[own[1] if own else "none"] += e - s
    return dict(out)


class TraceSummary:
    """What the readers take from one traced window: the device intervals
    (seconds), kernel time by identifier, the benchmark's spans, and the
    window's bounds."""

    def __init__(self, device_ops, spans, lo, hi):
        # device_ops: [(name, start_s, end_s)]; spans: [(name, start, end)]
        self.lo, self.hi = lo, hi
        self.window_s = hi - lo
        self.ops = [(n, max(s, lo), min(e, hi)) for n, s, e in device_ops
                    if min(e, hi) > max(s, lo)]
        self.spans = spans
        ivs = [(s, e) for _, s, e in self.ops]
        self.busy_s = union_length(ivs, lo, hi)
        self.gap_list = gaps(ivs, lo, hi)
        self.by_kernel = defaultdict(float)
        for n, s, e in self.ops:
            self.by_kernel[kernel_ident(n)] += e - s

    def kernel_seconds(self, idents) -> float:
        return sum(self.by_kernel.get(k, 0.0) for k in idents)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_kernel.items(), key=lambda kv: -kv[1])[:top]
        charged = charge_gaps(self.gap_list, self.spans)
        idle = sorted(charged.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in idle]}


def from_profiler(prof, span_prefix: str, window_span: str):
    """A :class:`TraceSummary` of a ``torch.profiler.profile`` run: the
    device operations (kernels, copies, sets) and the CPU spans whose
    names start with ``span_prefix``; the window is the span named
    ``window_span``."""
    from torch.autograd import DeviceType
    device_ops, spans = [], []
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns() * 1e-9
        e = s + ev.duration_ns() * 1e-9
        if ev.device_type() == DeviceType.CUDA:
            # a span's mirror on the device's timeline is no operation
            if not getattr(ev, "is_user_annotation", lambda: False)() \
                    and not ev.name().startswith(span_prefix):
                device_ops.append((ev.name(), s, e))
        elif ev.name().startswith(span_prefix):
            spans.append((ev.name()[len(span_prefix):], s, e))
    win = [(s, e) for n, s, e in spans if n == window_span]
    if not win:
        raise RuntimeError(f"the trace holds no span {window_span!r}")
    lo, hi = min(s for s, _ in win), max(e for _, e in win)
    return TraceSummary(device_ops, spans, lo, hi)
