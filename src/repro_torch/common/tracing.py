"""Named spans of the program's work, for ``torch.profiler``.

    with span("engine.decode"):
        ...

While a profiler records on the calling thread, :func:`span` returns a
``record_function`` range named ``"repro_torch." + name``: the profiler
keeps it in memory with the device activity, on the same clock, and writes
it out when the profile ends, so each device operation can be put down to
the span that launched it and each idle gap to the span the host was in.
At all other times it returns one shared no-op context, at the cost of
one flag read (``record_function`` itself costs several microseconds a
call with no profiler). A thread started before the profiler does not see
it, and the profiler records nothing of that thread either.
"""
from __future__ import annotations

from contextlib import nullcontext

import torch
from torch.autograd.profiler import record_function

PREFIX = "repro_torch."
_OFF = nullcontext()


def span(name: str):
    """A profiler range named ``PREFIX + name`` while a profiler records,
    else the shared no-op context."""
    if torch.autograd._profiler_enabled():
        return record_function(PREFIX + name)
    return _OFF
