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
copy onto the rollout side's device, on one mesh the redistribute to the
serving placements, between two meshes the :class:`MeshTransfer`)
instead of cloning it, and does not wait for it. Between disjoint meshes
the store is one of a pair, one on each side's ranks: the train side
sends every version, the rollout side posts its receives ahead.
``stats["reshard_time"]`` sums the transfers' own time: on the card the
span between two CUDA events around the copies on their stream (read when
the stats are next taken), on the host the copy's wall time.
"""
from __future__ import annotations

import math
import threading
import time
from collections import OrderedDict, deque
from contextlib import nullcontext
from typing import Any, Callable, Optional, Tuple

import numpy as np
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

    Across two sides (``reshard`` a :class:`MeshTransfer` between
    disjoint meshes, each process on one side) the store is one of a
    pair: on a train rank ``publish`` sends every version through the
    transfer and keeps none; on a rollout rank :meth:`expect` posts the
    receive of the next version ahead (at most ``max_versions`` at once),
    ``acquire`` takes up, in order, the versions that have landed and
    returns the freshest, and :meth:`wait_for` waits for the ones up to a
    version. ``stats`` count on each side what that side did: versions
    sent or landed, dropped, acquired, and the seconds of its part of the
    transfers.
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
        # the side of a two-sided store: "train" sends, "rollout" receives
        self.side = None
        if isinstance(reshard, MeshTransfer) \
                and reshard.sends != reshard.receives:
            self.side = "train" if reshard.sends else "rollout"
        self._sent = -1                         # the train side's latest
        self._incoming = deque()    # (version, replace, posted transfer)

    # ------------------------------------------------------------------
    @property
    def latest_version(self) -> int:
        """Newest published version (on a rollout rank: landed), or -1
        before the first."""
        with self._cv:
            return self._latest()

    def _latest(self) -> int:
        if self.side == "train":
            return self._sent
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
        if self.side == "rollout":
            raise RuntimeError("ParamStore.publish on the rollout side: "
                               "its versions come through expect()")
        if self.side == "train":
            with self._cv:
                self._check_monotonic(version, self._sent, replace)
            _, elapsed = self._reshard(params)
            with self._cv:
                self._sent = version
                self._elapsed.append(elapsed)
                self.stats["published"] += 1
            return
        elapsed = None
        if self._reshard is not None:
            snapshot, elapsed = self._reshard(params)
        else:
            snapshot = tree_map(_clone, params)
        self._put(snapshot, version, replace, elapsed)

    @staticmethod
    def _check_monotonic(version, latest, replace):
        if version < latest or (version == latest and not replace):
            raise ValueError(
                f"ParamStore.publish: version {version} <= latest "
                f"published {latest} — versions must be strictly "
                "monotonic (one publish per optimizer update)")

    def _put(self, snapshot, version, replace, elapsed):
        event = None
        cuda = _cuda_leaves(snapshot)
        if cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(cuda[0].device))
        with self._cv:
            if elapsed is not None:
                self._elapsed.append(elapsed)
            self._check_monotonic(version, self._latest(), replace)
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

    def expect(self, version: int, *, replace: bool = False):
        """Rollout side: post the receive of the next version the train
        side publishes, as ``version`` (``replace``: the republish of the
        current one, ``CoPRISTrainer.restore``)."""
        if self.side != "rollout":
            raise RuntimeError("ParamStore.expect off the rollout side")
        with self._cv:
            if len(self._incoming) >= self._max_versions and not replace:
                raise RuntimeError(
                    f"ParamStore.expect: {len(self._incoming)} receives "
                    f"already posted (max_versions {self._max_versions})")
            self._incoming.append((version, replace, self._reshard.start()))

    def _land(self, until: Optional[float] = None):
        """Rollout side: take up, in order, the versions whose transfer
        has landed, and with ``until`` every posted one up to that
        version (a republish included), waiting for them."""
        while True:
            with self._cv:
                if not self._incoming:
                    return
                version, replace, posted = self._incoming[0]
                if not (posted.done() or (until is not None
                                          and version <= until)):
                    return
                self._incoming.popleft()
            copy, elapsed = posted.wait()
            self._put(copy, version, replace, elapsed)

    def drain(self):
        """Rollout side: wait for every posted receive."""
        self._land(until=float("inf"))

    def acquire(self) -> Tuple[Any, int]:
        """Freshest ``(params, version)``. Rollout never generates under a
        superseded version when a newer one has been published (on a
        rollout rank: has landed; before the first has landed, it waits
        for it)."""
        if self.side == "train":
            raise RuntimeError("ParamStore.acquire on the train side: it "
                               "sends its versions and holds none")
        if self.side == "rollout":
            # the first version, and a republish, before any acquire
            with self._cv:
                floor = max([v for v, replace, _ in self._incoming
                             if replace or not self._versions], default=None)
            self._land(until=floor)
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
        if self.side == "rollout":
            while self._incoming and self._incoming[0][0] <= version:
                if deadline is None or self._incoming[0][2].done():
                    self._land(until=self._incoming[0][0])
                elif time.monotonic() > deadline:
                    return False
                else:
                    time.sleep(1e-3)
            return self.latest_version >= version
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


def make_param_resharder(cfg, params, train_side, rollout_side=None, *,
                         group=None):
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
    * Two meshes (disjoint ranks, or the same ranks in another shape): a
      :class:`MeshTransfer` to the same serve layout on the rollout mesh,
      over ``group`` (default: a group of the two meshes' ranks made
      here, NCCL on the card, gloo on the host). Every rank of the
      default process group calls this (making a group is collective);
      ``params`` may be any tree of the leaves' shapes and dtypes on a
      rank outside the train mesh. ``copy`` is None on a rank outside
      the rollout mesh.

    ``rollout_side`` defaults to ``train_side``. A mesh on one side and a
    device on the other is refused."""
    rollout_side = train_side if rollout_side is None else rollout_side
    if _is_mesh(train_side) != _is_mesh(rollout_side):
        raise NotImplementedError(
            "make_param_resharder: a mesh on one side and a device on the "
            "other — disaggregated sides are two devices or two meshes")
    if _is_mesh(train_side):
        from repro_torch.launch.sharding import (serve_params_placements,
                                                 shard_params)
        out = serve_params_placements(params, rollout_side, cfg)
        if train_side is not rollout_side:
            return MeshTransfer(cfg, params, train_side, rollout_side,
                                group=group), out

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


# ---------------------------------------------------------------------------
# the cross-mesh transfer
# ---------------------------------------------------------------------------


def _paths(tree, path=(), tuples=True):
    """``(path, leaf)`` of every leaf of ``tree``, in the order of
    ``common.tree.leaves``; with ``tuples=False`` a tuple is a leaf (a
    tree of placements)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _paths(tree[k], path + (k,), tuples)]
    if isinstance(tree, list) or (tuples and isinstance(tree, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _paths(v, path + (i,), tuples)]
    return [(path, tree)]


def _chunk(lo, hi, n, i):
    """Chunk ``i`` of ``n`` of the range [lo, hi), as ``Shard`` splits a
    dim (``torch.chunk``'s sizes: ceil((hi - lo) / n) each, the last ones
    short or empty)."""
    size = -(-(hi - lo) // n)
    a = min(lo + i * size, hi)
    return a, min(a + size, hi)


def _box(shape, sizes, coord, placements):
    """The index box, ((lo, hi) a dim), that the rank at mesh coordinate
    ``coord`` holds of a tensor of ``shape`` in ``placements`` on a mesh
    of ``sizes``: each mesh dim in order splits the range of the tensor
    dim its ``Shard`` names, as a ``DTensor`` does."""
    box = [(0, n) for n in shape]
    for i, p in enumerate(placements):
        if p.is_shard():
            box[p.dim] = _chunk(*box[p.dim], sizes[i], coord[i])
    return tuple(box)


def _meet(a, b):
    """The intersection of two boxes, or None where it is empty."""
    box = tuple((max(x0, y0), min(x1, y1)) for (x0, x1), (y0, y1) in zip(a, b))
    return box if all(lo < hi for lo, hi in box) else None


def _slices(box, origin):
    """``box`` as slices of a tensor whose first element is at
    ``origin``."""
    return tuple(slice(lo - o, hi - o) for (lo, hi), o in zip(box, origin))


def _pieces(train_shape, serve_shape, box):
    """The parts of a serve-layout box as boxes of the training shape, each
    with the view of the serve-layout shard it fills: the box itself, or
    for ``serve_form``'s (d, 2 di) -> (d, 2, di) one (d, di) part a half
    (element [r, s, c] of the serve form is [r, s di + c])."""
    if tuple(serve_shape) == tuple(train_shape):
        return [(box, lambda t: t)]
    if len(serve_shape) != 3 or serve_shape[1] * serve_shape[2] \
            != train_shape[1]:
        raise ValueError(f"no serve form of {train_shape} is {serve_shape}")
    (r0, r1), (s0, s1), (c0, c1) = box
    di = serve_shape[2]
    return [(((r0, r1), (s * di + c0, s * di + c1)),
             lambda t, j=s - s0: t[:, j]) for s in range(s0, s1)]


def _coords(mesh) -> dict:
    """``{global rank: its coordinate}`` of a ``DeviceMesh``."""
    grid = mesh.mesh
    return {int(grid[idx]): idx for idx in np.ndindex(*grid.shape)}


class MeshTransfer:
    """The weight-sync transfer between two meshes: each leaf from its
    training placements on ``train_mesh`` (``launch/sharding``'s rules) to
    its serve layout on ``rollout_mesh`` (``serve_tp_only`` with
    ``serve_decode``, each leaf in its ``serve_form``), the meshes on
    disjoint ranks or on the same ranks in another shape.

    Every rank computes, from the shapes and placements alone, the index
    box each rank holds on each side (``Shard``'s own split), and so which
    part of which leaf it sends to which rank and which it receives: a
    rollout rank takes each part from a train rank that holds it (itself
    where it can, else the replicas in turn). A rank in both meshes copies
    that overlap locally; everything else moves in one batched
    point-to-point exchange (``dist.batch_isend_irecv``) per dtype, one
    buffer per peer and dtype, on ``group``: the transfer's own group of
    the two meshes' ranks (never a mesh's, whose collectives the
    exchange would have to interleave with in issue order). On a gloo
    group CUDA leaves are staged through pinned host memory.

    ``start(params)`` posts this rank's part: the sends read a packed copy
    of the shards (the snapshot: on the card the caller's stream waits for
    the packing, never for the exchange, and the next in-place update may
    then overwrite the masters), and returns a :class:`_Transfer` whose
    ``wait()`` gives ``(copy, elapsed)``; calling the object does both.
    ``elapsed()`` is the span of this rank's part, between CUDA events on
    the card (from the packing to the sends' completion on a sender, from
    the landed bytes to the placed shards on a receiver), else its wall
    time. ``copy`` is the tree of ``DTensor`` s on the rollout mesh on a
    rollout rank, None elsewhere."""

    def __init__(self, cfg, params, train_mesh, rollout_mesh, *,
                 group=None):
        import torch.distributed as dist

        from repro_torch.launch.mesh import mesh_device, mesh_ranks
        from repro_torch.launch.sharding import (params_placements,
                                                 serve_params_placements)
        if train_mesh.device_type != rollout_mesh.device_type:
            raise ValueError("train and rollout meshes of two device types")
        self.train_ranks = mesh_ranks(train_mesh)
        self.rollout_ranks = mesh_ranks(rollout_mesh)
        ranks = sorted(set(self.train_ranks) | set(self.rollout_ranks))
        if group is None:
            group = dist.new_group(ranks, backend="nccl" if
                                   train_mesh.device_type == "cuda"
                                   else "gloo")
        self.rank = me = dist.get_rank()
        self.mesh = rollout_mesh
        self.group = group
        self.sends = me in self.train_ranks
        self.receives = me in self.rollout_ranks
        self.bytes_sent = 0
        if not (self.sends or self.receives):
            return
        if sorted(dist.get_process_group_ranks(group)) != ranks:
            raise ValueError(
                f"the transfer group's ranks "
                f"{dist.get_process_group_ranks(group)} are not the two "
                f"meshes' {ranks}")
        self.backend = dist.get_backend(group)
        self.device = mesh_device(rollout_mesh if self.receives
                                  else train_mesh)
        cuda = self.device.type == "cuda"
        self._staged = cuda and self.backend == "gloo"
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        # one collective of every rank first: a batched exchange may make
        # an NCCL communicator only with all of its ranks in it
        dist.all_reduce(torch.zeros(1, device="cpu" if self.backend == "gloo"
                                    else self.device), group=group)

        t_pl = dict(_paths(params_placements(params, train_mesh, cfg=cfg),
                           tuples=False))
        s_pl = dict(_paths(serve_params_placements(params, rollout_mesh,
                                                   cfg), tuples=False))
        t_at, r_at = _coords(train_mesh), _coords(rollout_mesh)
        t_sizes, r_sizes = tuple(train_mesh.shape), tuple(rollout_mesh.shape)
        from repro_torch.launch.sharding import serve_form
        # what this rank sends, receives (by dtype, then peer: a list of
        # (leaf, slices of the source shard / the view and slices it
        # fills)) and copies
        self._send, self._recv, self._local = {}, {}, []
        self.out = []           # (shape, dtype, placements, local shape)
        self._like = tree_map(lambda t: None, params)
        for i, (path, leaf) in enumerate(_paths(params)):
            shape = tuple(leaf.shape)
            sshape = tuple(serve_form(path, torch.empty(
                shape, device="meta")).shape)
            placed = _boxes(shape, t_sizes, t_at, t_pl[path])
            if self.receives:
                mine = _box(sshape, r_sizes, r_at[me], s_pl[path])
                self.out.append((sshape, leaf.dtype, s_pl[path],
                                 tuple(hi - lo for lo, hi in mine)))
            for k, dst in enumerate(self.rollout_ranks):
                dbox = _box(sshape, r_sizes, r_at[dst], s_pl[path])
                for piece, view in _pieces(shape, sshape, dbox):
                    for sbox, holders in placed:
                        part = _meet(piece, sbox)
                        if part is None:
                            continue
                        src = (dst if dst in holders
                               else holders[k % len(holders)])
                        if me not in (src, dst):
                            continue
                        read = _slices(part, [lo for lo, _ in sbox])
                        fill = (view, _slices(part, [lo for lo, _ in piece]))
                        if src == dst:
                            self._local.append((i, read, fill))
                        elif src == me:
                            self._send.setdefault(leaf.dtype, {}).setdefault(
                                dst, []).append((i, read))
                            self.bytes_sent += leaf.dtype.itemsize * \
                                math.prod(hi - lo for lo, hi in part)
                        else:
                            self._recv.setdefault(leaf.dtype, {}).setdefault(
                                src, []).append((i, fill, tuple(
                                    hi - lo for lo, hi in part)))

    def __call__(self, params):
        return self.start(params).wait()

    def start(self, params=None) -> "_Transfer":
        """Post this rank's part of the transfer of ``params`` (its train
        shards; ignored on a rank that sends nothing)."""
        import torch.distributed as dist
        if not (self.sends or self.receives):
            return _Transfer(self, None, [], {}, None)
        cuda = self._stream is not None
        current = torch.cuda.current_stream(self.device) if cuda else None
        if cuda:
            self._stream.wait_stream(current)
        with _on_stream(self._stream):
            clock = _Clock(self.device)
            reads = self._send or self._local
            src = ([t.to_local() if hasattr(t, "to_local") else t
                    for t in (x.detach() for x in leaves(params))]
                   if reads else None)
            out = ([torch.empty(local, dtype=dtype, device=self.device)
                    for _, dtype, _, local in self.out]
                   if self.receives else None)
            for i, read, (view, fill) in self._local:
                view(out[i])[fill].copy_(src[i][read])
            sendbufs = {(dtype, peer): torch.cat([src[i][read].reshape(-1)
                                                  for i, read in parts])
                        for dtype, by_peer in self._send.items()
                        for peer, parts in by_peer.items()}
            if cuda and reads:
                # the snapshot is taken: the caller's next update may
                # overwrite the masters (the exchange is not waited for)
                packed = torch.cuda.Event()
                packed.record(self._stream)
                current.wait_event(packed)
            if self._staged:
                sendbufs = {k: _pinned(b) for k, b in sendbufs.items()}
                self._stream.synchronize()    # the host copies landed
            where = "cpu" if self._staged else self.device
            recvbufs = {(dtype, peer): torch.empty(
                            sum(math.prod(shape) for _, _, shape in parts),
                            dtype=dtype, device=where,
                            pin_memory=self._staged)
                        for dtype, by_peer in self._recv.items()
                        for peer, parts in by_peer.items()}
            works = []
            for dtype in sorted({k[0] for k in (*sendbufs, *recvbufs)},
                                key=str):
                ops = [dist.P2POp(dist.isend, b, peer, self.group)
                       for (dt, peer), b in sorted(sendbufs.items(),
                                                   key=_by_peer)
                       if dt == dtype]
                ops += [dist.P2POp(dist.irecv, b, peer, self.group)
                        for (dt, peer), b in sorted(recvbufs.items(),
                                                    key=_by_peer)
                        if dt == dtype]
                works += dist.batch_isend_irecv(ops)
        if not (self._send or self._local):
            clock = None          # a receiver's clock starts when it lands
        return _Transfer(self, out, works, (sendbufs, recvbufs), clock)


def _boxes(shape, sizes, coords, placements):
    """The distinct boxes of a leaf on a mesh, each with the ranks that
    hold it (replicas, in mesh order)."""
    held = {}
    for rank, coord in coords.items():
        held.setdefault(_box(shape, sizes, coord, placements), []).append(
            rank)
    return list(held.items())


def _by_peer(item):
    return item[0][1]


def _pinned(t):
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def _on_stream(stream):
    return torch.cuda.stream(stream) if stream is not None else nullcontext()


class _Clock:
    """A span of device work from now to ``stop()``: two CUDA events on
    the current stream on the card (``stop()``'s ``elapsed`` waits for the
    second), else the host clock (the work has run to its end by then)."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self):
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            start = self.start

            def elapsed():
                end.synchronize()
                return start.elapsed_time(end) / 1e3
            return elapsed
        dt = time.perf_counter() - self.t0
        return lambda: dt


class _Transfer:
    """One posted transfer of a :class:`MeshTransfer` (``wait``,
    ``done``)."""

    def __init__(self, transfer, out, works, buffers, clock):
        self.transfer, self.out, self.works = transfer, out, works
        self.buffers, self.clock = buffers, clock

    def done(self) -> bool:
        """Whether this rank's exchanges have completed (never blocks)."""
        return all(w.is_completed() for w in self.works)

    def wait(self):
        """``(copy, elapsed)``: the rollout-mesh tree on a rollout rank (on
        the card its shards ready for the caller's current stream), None
        elsewhere."""
        tr = self.transfer
        if not (tr.sends or tr.receives):
            return None, lambda: 0.0
        cuda = tr._stream is not None
        current = torch.cuda.current_stream(tr.device) if cuda else None
        with _on_stream(tr._stream):
            for w in self.works:
                w.wait()
            clock = self.clock or _Clock(tr.device)
            _, recvbufs = self.buffers
            for (dtype, peer), buf in sorted(recvbufs.items(), key=_by_peer):
                if tr._staged:
                    buf = buf.to(tr.device, non_blocking=True)
                off = 0
                for i, (view, fill), shape in tr._recv[dtype][peer]:
                    n = math.prod(shape)
                    view(self.out[i])[fill].copy_(buf[off:off + n].view(shape))
                    off += n
            elapsed = clock.stop()
        self.buffers = None
        if not tr.receives:
            return None, elapsed
        if cuda:
            current.wait_stream(tr._stream)
            for t in self.out:
                t.record_stream(current)
        from torch.distributed.tensor import DTensor
        copy = [DTensor.from_local(t, tr.mesh, list(pl), run_check=False,
                                   shape=torch.Size(shape),
                                   stride=_contiguous(shape))
                for t, (shape, _, pl, _) in zip(self.out, tr.out)]
        return unflatten(tr._like, copy), elapsed


def _contiguous(shape):
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


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
    clock = _Clock(device)
    out = fn()
    return out, clock.stop()


def _device_of(tree):
    cuda = _cuda_leaves(tree)
    return cuda[0].device if cuda else torch.device("cpu")


def _fill(fills):
    for views, srcs in fills:
        torch._foreach_copy_(views, srcs, non_blocking=True)


def _is_mesh(side) -> bool:
    return hasattr(side, "mesh_dim_names")
