"""Concurrency-Controlled Generation scheduler (paper §4).

Pure-Python scheduling policy, separated from the JAX engine so its
invariants are unit/property-testable:

* exactly the stage's in-flight target in flight whenever work exists
  (mode="copris"; the target is ``concurrency`` by default, or the value an
  :class:`AdaptiveConcurrencyController` picked for this stage);
* dispatch priority: resume buffered partials > complete under-sampled
  buffered groups > open a new group (Prioritized Resumption);
* early termination once ``batch_size`` groups are complete — and once the
  target is reached the scheduler must never open a NEW group (overspawn at
  the stage tail would mint guaranteed-evicted, maximally-off-policy work);
* mode="sync": submit B*G once, never early-terminate, never buffer;
* mode="naive_partial": submit ``initial_concurrency`` once, no refill
  (the Kimi-K1.5-style baseline of Table 2).
"""
from __future__ import annotations

from typing import Callable, List, Optional

from repro_torch.common.config import RolloutConfig
from repro_torch.core.buffer import TrajectoryBuffer
from repro_torch.core.trajectory import Group, Trajectory


class ConcurrencyScheduler:
    def __init__(self, cfg: RolloutConfig, buffer: TrajectoryBuffer,
                 new_group: Callable[[], Group], *,
                 target_concurrency: Optional[int] = None):
        self.cfg = cfg
        self.buffer = buffer
        self.new_group = new_group
        # per-stage in-flight cap: the engine's slot pool may be larger (it
        # is sized to concurrency_max), but this stage keeps at most this
        # many requests in flight
        self.target_concurrency = (cfg.concurrency
                                   if target_concurrency is None
                                   else target_concurrency)
        # stage completion target; an attribute (not read from cfg) so an
        # incremental caller (launch/serve.py) can raise it as new requests
        # are submitted mid-stage
        self.target_batch = cfg.batch_size
        self.completed: List[Group] = []
        self.dispatched = 0            # requests handed out this stage
        self.in_flight: set = set()    # traj_ids currently occupying slots
        # requests handed back by the engine because a RESOURCE gate (free
        # KV pages) blocked admission — redispatched with top priority, so
        # resource pressure never reorders the scheduling policy
        self._requeued: List[Trajectory] = []

    # ------------------------------------------------------------------
    @property
    def done(self) -> bool:
        if self.cfg.mode == "sync":
            return (len(self.completed) >= self.target_batch
                    and self.buffer.num_unfinished == 0)
        return len(self.completed) >= self.target_batch

    def harvest(self):
        """Move any newly-complete groups out of the buffer."""
        self.completed.extend(self.buffer.pop_complete_groups())

    # ------------------------------------------------------------------
    def next_request(self) -> Optional[Trajectory]:
        """What should fill a freed slot? None -> leave the slot idle."""
        mode = self.cfg.mode
        t = None
        if self._requeued:
            # admission-blocked work was already approved by the policy
            # below — hand it out first (its group is committed; delaying it
            # behind new spawns would mint extra guaranteed-evicted work)
            t = self._requeued.pop(0)
            self.dispatched += 1
            self.in_flight.add(t.traj_id)
            return t
        if mode == "sync":
            # fixed workload: spawn until B groups x G samples exist, no reuse
            t = self.buffer.pop_unspawned()
            if t is None and (self.buffer.num_groups + len(self.completed)
                              < self.target_batch):
                g = self.new_group()
                if g is not None:      # prompt source may decline (no work)
                    self.buffer.add_group(g)
                    t = g.spawn()
        elif mode == "naive_partial":
            # one-shot submission up to initial concurrency, then no refill
            if self.dispatched < self.cfg.concurrency:
                t = self._copris_pick()
        elif mode == "copris":
            if not self.done and len(self.in_flight) < self.target_concurrency:
                t = self._copris_pick()
        else:
            raise ValueError(mode)
        if t is not None:
            self.dispatched += 1
            self.in_flight.add(t.traj_id)
        return t

    def next_requests(self, k: int) -> List[Trajectory]:
        """Dispatch up to ``k`` requests for ``k`` freed slots (the chunked
        engine refills whole batches at chunk boundaries). Dispatch order is
        identical to ``k`` sequential :meth:`next_request` calls, so the
        scheduling policy is invariant to the decode chunk size."""
        out: List[Trajectory] = []
        for _ in range(k):
            t = self.next_request()
            if t is None:
                break
            out.append(t)
        return out

    def release(self, traj: Trajectory):
        """Slot freed (trajectory finished or evicted at stage end)."""
        self.in_flight.discard(traj.traj_id)

    def requeue(self, traj: Trajectory):
        """Undo a dispatch the engine could not admit (e.g. the paged KV
        backend ran out of free pages). The trajectory stays in its buffered
        group — a fresh spawn keeps its sample_idx — and is redispatched
        with priority by the next :meth:`next_request`. Unconsumed requeues
        survive in the buffer across stages (their groups are incomplete),
        so blocked work is never lost."""
        self.in_flight.discard(traj.traj_id)
        self.dispatched -= 1
        self._requeued.append(traj)

    def _copris_pick(self) -> Optional[Trajectory]:
        t = self.buffer.pop_resumable(exclude=self.in_flight)  # prioritized resumption
        if t is None:
            t = self.buffer.pop_unspawned()
        if t is None:
            # No-overspawn guard (defence in depth): once the stage's
            # early-termination target is reached, never OPEN a new group —
            # its samples could only be evicted at stage end and re-enter
            # the next stage maximally off-policy. Resumes/unspawned above
            # are still allowed (they advance already-committed groups).
            # ``next_request`` already gates copris mode on ``done``; this
            # keeps the invariant even for callers that reach the pick
            # directly (naive_partial) or from a future dispatch path.
            if self.done:
                return None
            g = self.new_group()
            if g is None:              # prompt source declined (no work)
                return None
            self.buffer.add_group(g)
            t = g.spawn()
        return t


class AdaptiveConcurrencyController:
    """Overlap-aware N' controller (ROLL-Flash-style, arXiv:2510.11345).

    CoPRIS picks a static N' to balance per-step fixed cost against
    saturation queueing — but the overlapped trainer changes the optimum:
    rollout for stage k+1 has a full train-step of slack, so the target is
    not "finish as fast as possible" but "finish *just inside* the train
    step it hides behind". This controller adjusts the in-flight target
    BETWEEN stages from the observed finish/refill balance:

    * rollout slower than the train step it overlaps (``ratio > 1``):
      rollout is the pipeline bottleneck — grow N' (more slots in flight
      finish the B groups in fewer engine steps);
    * rollout comfortably inside the slack (``ratio < 1``) *and* the stage
      evicted partials: N' is oversized — shrink it, cutting the evicted
      (guaranteed off-policy, re-prefilled) long-tail work the extra slots
      minted without making the pipeline any faster.

    Moves are proportional (``gain`` of the current target, scaled by how
    far the ratio is outside the ``deadband``) and clamped to the
    configured ``[concurrency_min, concurrency_max]``. The static N' is the
    starting point and remains the default behaviour when
    ``adaptive_concurrency`` is off. ``trace`` records the per-stage
    targets (one entry per ``observe``, starting with the initial target).
    """

    def __init__(self, cfg: RolloutConfig, *, gain: float = 0.25,
                 deadband: float = 0.1):
        self.lo = cfg.resolved_concurrency_min
        self.hi = cfg.resolved_concurrency_max
        self.gain = gain
        self.deadband = deadband
        self.target = min(max(cfg.concurrency, self.lo), self.hi)
        self.trace: List[int] = [self.target]

    def observe(self, *, rollout_time: float, train_time: float,
                evicted: int = 0) -> int:
        """Feed one completed stage's timings; returns the target for the
        NEXT stage. ``train_time`` is the consumer-side work the rollout
        overlapped (update + reward gather); 0/None leaves N' unchanged
        (nothing to balance against — e.g. the pipeline prologue)."""
        if train_time and train_time > 0 and rollout_time >= 0:
            ratio = rollout_time / train_time
            if ratio > 1 + self.deadband:
                step = self.gain * self.target * min(ratio - 1.0, 1.0)
                self.target += max(1, int(step))
            elif ratio < 1 - self.deadband and evicted > 0:
                step = self.gain * self.target * min(1.0 - ratio, 1.0)
                self.target -= max(1, int(step))
            self.target = min(max(self.target, self.lo), self.hi)
        self.trace.append(self.target)
        return self.target
