"""Versioned weight-sync between the train and rollout sides of the loop.

The port of ``repro.core.weight_sync.ParamStore``. The trainer
**publishes** each optimizer update as ``(params, version)``; the rollout
side **acquires** the freshest published version. The contract:

* ``publish`` is strictly version-monotonic — republishing an old version is
  a programming error (the off-policy accounting keys on version order);
* the store keeps a bounded window of in-flight versions and *drops stale*
  ones as new params land;
* ``acquire`` always returns the freshest version — rollout never waits for
  weights, staleness is bounded by the trainer's pipeline gate instead.

JAX arrays are immutable, so the reference stores references. The port's
trainer updates its parameter tensors in place (``optim/adam.update``), so
``publish`` stores **detached clones**: a published version never changes
under a rollout that holds it.

On CUDA the publisher and the acquirer may run on different streams (the
overlapped trainer's train and rollout streams). ``publish`` clones on the
publisher's current stream and records a ``torch.cuda.Event`` after the
clones; ``acquire`` and ``get`` make the caller's current stream wait on
that event, so no kernel of the acquirer reads a snapshot before its copy
has landed, and mark every snapshot tensor with ``Tensor.record_stream`` for
the acquiring stream: when a later publish drops the version, the caching
allocator does not hand its memory out again until the work queued on that
stream by then has finished.

The train-to-rollout reshard of the disaggregated mode
(``make_param_resharder``) is SPMD and is not ported; ``reshard_time`` is
kept in the stats, always 0.0, for the trainer's metric of that name.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Optional, Tuple

import torch

from repro_torch.common.tree import leaves, tree_map


def _clone(x):
    return x.detach().clone() if isinstance(x, torch.Tensor) else x


def _cuda_leaves(tree):
    return [t for t in leaves(tree)
            if isinstance(t, torch.Tensor) and t.is_cuda]


class ParamStore:
    """Thread-safe versioned params channel (publish / acquire).

    ``max_versions`` bounds how many published versions may be in flight at
    once: with a pipeline that lets rollout lag the trainer by at most K
    optimizer updates, ``K + 1`` versions cover every batch still in the
    system; anything older is dropped at publish time (``stats["dropped"]``
    counts the drop-stale evictions).
    """

    def __init__(self, *, max_versions: int = 2):
        if max_versions < 1:
            raise ValueError(
                f"max_versions must be >= 1 (got {max_versions}); the store "
                "must be able to hold at least the freshest version")
        self._max_versions = max_versions
        self._cv = threading.Condition()
        # version -> (snapshot, the CUDA event after its clones or None)
        self._versions: "OrderedDict[int, Tuple[Any, Any]]" = OrderedDict()
        self.stats = dict(published=0, dropped=0, acquired=0,
                          reshard_time=0.0)

    # ------------------------------------------------------------------
    @property
    def latest_version(self) -> int:
        """Newest published version, or -1 before the first publish."""
        with self._cv:
            return next(reversed(self._versions)) if self._versions else -1

    @property
    def num_versions(self) -> int:
        with self._cv:
            return len(self._versions)

    def versions(self) -> Tuple[int, ...]:
        with self._cv:
            return tuple(self._versions)

    # ------------------------------------------------------------------
    def publish(self, params, version: int, *, replace: bool = False):
        """Make a detached copy of ``params`` available as ``version``.

        ``replace=True`` permits re-publishing the CURRENT latest version
        (checkpoint restore swapping the weights behind an unchanged stage
        number); versions are otherwise strictly monotonic.
        """
        snapshot = tree_map(_clone, params)
        event = None
        cuda = _cuda_leaves(snapshot)
        if cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(cuda[0].device))
        with self._cv:
            latest = next(reversed(self._versions)) if self._versions else -1
            if version < latest or (version == latest and not replace):
                raise ValueError(
                    f"ParamStore.publish: version {version} <= latest "
                    f"published {latest} — versions must be strictly "
                    "monotonic (one publish per optimizer update)")
            self._versions[version] = (snapshot, event)
            self.stats["published"] += 1
            while len(self._versions) > self._max_versions:   # drop-stale
                self._versions.popitem(last=False)
                self.stats["dropped"] += 1
            self._cv.notify_all()

    @staticmethod
    def _fenced(snapshot, event):
        """``snapshot`` made safe to read on the caller's current stream."""
        cuda = _cuda_leaves(snapshot)
        if cuda:
            stream = torch.cuda.current_stream(cuda[0].device)
            stream.wait_event(event)
            for t in cuda:
                t.record_stream(stream)
        return snapshot

    def acquire(self) -> Tuple[Any, int]:
        """Freshest ``(params, version)``. Rollout never generates under a
        superseded version when a newer one has been published."""
        with self._cv:
            if not self._versions:
                raise RuntimeError(
                    "ParamStore.acquire before the first publish — the "
                    "trainer must publish its initial params (version = "
                    "start stage) at construction")
            version = next(reversed(self._versions))
            self.stats["acquired"] += 1
            snapshot, event = self._versions[version]
        return self._fenced(snapshot, event), version

    def get(self, version: int) -> Any:
        """A specific in-flight version (KeyError if already dropped)."""
        with self._cv:
            snapshot, event = self._versions[version]
        return self._fenced(snapshot, event)

    def wait_for(self, version: int, timeout: Optional[float] = None) -> bool:
        """Block until ``latest_version >= version``. Returns False on
        timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while not (self._versions
                       and next(reversed(self._versions)) >= version):
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return False
                self._cv.wait(timeout=remaining)
            return True

    def stats_snapshot(self) -> dict:
        """Consistent copy of the counters."""
        with self._cv:
            return dict(self.stats)
