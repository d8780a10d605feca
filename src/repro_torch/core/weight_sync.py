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

In **disaggregated mode** ``publish`` pushes every version through the
train-to-rollout reshard that :func:`make_param_resharder` builds (the
copy onto the rollout side's device, or on a mesh the redistribute to the
serving placements) instead of cloning it, and does not wait for it.
``stats["reshard_time"]`` sums the transfers' own time: on the card the
span between two CUDA events around the copies on their stream (read when
the stats are next taken), on the host the copy's wall time.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.common.tree import leaves, tree_map, unflatten


def _clone(x):
    return x.detach().clone() if isinstance(x, torch.Tensor) else x


def _cuda_leaves(tree):
    """The tree's CUDA tensors; of a ``DTensor`` its local shard (the
    storage a stream reads)."""
    return [t.to_local() if hasattr(t, "to_local") else t
            for t in leaves(tree)
            if isinstance(t, torch.Tensor) and t.is_cuda]


class ParamStore:
    """Thread-safe versioned params channel (publish / acquire).

    ``max_versions`` bounds how many published versions may be in flight at
    once: with a pipeline that lets rollout lag the trainer by at most K
    optimizer updates, ``K + 1`` versions cover every batch still in the
    system; anything older is dropped at publish time (``stats["dropped"]``
    counts the drop-stale evictions).

    ``reshard``: optional callable ``params -> (copy, elapsed)`` that
    makes the stored copy of every published tree (the train-to-rollout
    transfer of disaggregated mode, :func:`make_param_resharder`);
    ``elapsed()`` gives the transfer's seconds. Without it ``publish``
    clones.
    """

    def __init__(self, *, max_versions: int = 2,
                 reshard: Optional[Callable[[Any], Any]] = None):
        if max_versions < 1:
            raise ValueError(
                f"max_versions must be >= 1 (got {max_versions}); the store "
                "must be able to hold at least the freshest version")
        self._max_versions = max_versions
        self._reshard = reshard
        self._cv = threading.Condition()
        # version -> (snapshot, the CUDA event after its clones or None)
        self._versions: "OrderedDict[int, Tuple[Any, Any]]" = OrderedDict()
        self.stats = dict(published=0, dropped=0, acquired=0,
                          reshard_time=0.0)
        self._elapsed = []        # reshards whose time is not yet read

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
        elapsed = None
        if self._reshard is not None:
            snapshot, elapsed = self._reshard(params)
        else:
            snapshot = tree_map(_clone, params)
        event = None
        cuda = _cuda_leaves(snapshot)
        if cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(cuda[0].device))
        with self._cv:
            if elapsed is not None:
                self._elapsed.append(elapsed)
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
        """Consistent copy of the counters. The times of the reshards
        published since the last call are read first (waiting for their
        copies to land)."""
        with self._cv:
            pending, self._elapsed = self._elapsed, []
        dt = sum(elapsed() for elapsed in pending)
        with self._cv:
            self.stats["reshard_time"] += dt
            return dict(self.stats)


# ---------------------------------------------------------------------------
# train-layout -> rollout-layout reshard
# ---------------------------------------------------------------------------


def make_param_resharder(cfg, params, train_side, rollout_side=None):
    """Build the weight-sync transfer of one published version: values
    unchanged, train side in, rollout side out. Returns ``(reshard,
    out_layout)``.

    ``reshard(params)`` returns ``(copy, elapsed)``, ``elapsed()`` the
    transfer's own seconds (:func:`_timed`):

    * Devices (the one-process disaggregated trainer): ``copy`` holds
      every leaf on the rollout device, bit for bit, with no cast. On
      CUDA the leaves are views of one buffer a dtype, filled by one
      multi-tensor copy on a copy stream of their own, after the work
      queued on the caller's stream (the update that produced the
      version); the caller's stream then waits for them, so the event
      ``ParamStore.publish`` records covers the copies and the next
      in-place update does not overwrite a master before it is read.
      It is timed from right before to right after the copies, the
      buffers already allocated.
      ``out_layout`` is the rollout device.
    * One ``DeviceMesh`` for both sides (two meshes of one process group):
      a ``redistribute`` of each ``DTensor`` leaf from its training
      placements to the serve layout the engine decodes on
      (``launch/sharding.shard_params`` with ``serve_tp_only`` and
      ``serve_decode``), on a copy. ``out_layout`` is that tree of
      placements.

    ``rollout_side`` defaults to ``train_side``."""
    rollout_side = train_side if rollout_side is None else rollout_side
    if _is_mesh(train_side) or _is_mesh(rollout_side):
        if train_side is not rollout_side:
            raise NotImplementedError(
                "make_param_resharder: train and rollout meshes of their own "
                "ranks are multi-rank disaggregated sides, which are not "
                "ported; give one mesh for both")
        from repro_torch.launch.sharding import (serve_params_placements,
                                                 shard_params)
        out = serve_params_placements(params, rollout_side, cfg)

        def redistribute(p):
            return _timed(lambda: shard_params(
                p, rollout_side, cfg, serve_tp_only=True, serve_decode=True,
                copy=True), _device_of(p))
        return redistribute, out

    dst = torch.device(rollout_side)
    src = torch.device(train_side)
    streams = {}

    def copy(p):
        if dst.type != "cuda" and src.type != "cuda":
            out, fills = _buffers(p, dst)
            return out, _timed(lambda: _fill(fills), dst)[1]
        dev = dst if dst.type == "cuda" else src
        current = torch.cuda.current_stream(dev)
        stream = streams.setdefault(dev, torch.cuda.Stream(dev))
        stream.wait_stream(current)
        if src.type == "cuda" and src != dev:
            stream.wait_stream(torch.cuda.current_stream(src))
        with torch.cuda.stream(stream):
            out, fills = _buffers(p, dst)
            elapsed = _timed(lambda: _fill(fills), dev)[1]
        current.wait_stream(stream)
        if src.type == "cuda" and src != dev:
            torch.cuda.current_stream(src).wait_stream(stream)
        return out, elapsed
    return copy, dst


def _buffers(tree, dst):
    """``(copy, fills)``: ``copy`` the tree of ``tree``'s leaves as views
    of one new buffer a dtype on ``dst``, not yet written; ``fills`` the
    (views, sources) pairs that one multi-tensor copy each fills. A copy a
    leaf would be a launch a leaf from Python, and the host, which shares
    the GIL with the rollout thread, would then set the copies' pace."""
    flat = [t.detach() for t in leaves(tree)]
    out = [None] * len(flat)
    by_dtype = {}
    for i, t in enumerate(flat):
        by_dtype.setdefault(t.dtype, []).append(i)
    fills = []
    for dtype, idx in by_dtype.items():
        sizes = [flat[i].numel() for i in idx]
        buf = torch.empty(sum(sizes), dtype=dtype, device=dst)
        views = [v.view(flat[i].shape)
                 for v, i in zip(buf.split(sizes), idx)]
        fills.append((views, [flat[i] for i in idx]))
        for i, v in zip(idx, views):
            out[i] = v
    return unflatten(tree, out), fills


def _timed(fn, device):
    """``(fn(), elapsed)``: ``elapsed()`` the seconds of ``fn``'s work. On
    a CUDA ``device`` the span between two CUDA events recorded on its
    current stream around the call (``elapsed`` waits for the second); on
    the host, where ``fn`` runs to its end before it returns, its wall
    time."""
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        out = fn()
        end.record()

        def elapsed():
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        return out, elapsed
    t0 = time.perf_counter()
    out = fn()
    dt = time.perf_counter() - t0
    return out, lambda: dt


def _device_of(tree):
    cuda = _cuda_leaves(tree)
    return cuda[0].device if cuda else torch.device("cpu")


def _fill(fills):
    for views, srcs in fills:
        torch._foreach_copy_(views, srcs, non_blocking=True)


def _is_mesh(side) -> bool:
    return hasattr(side, "mesh_dim_names")
