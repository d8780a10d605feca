"""Asynchronous environment / reward execution.

The paper applies asynchronous rewards to BOTH arms of its comparison
("to guarantee fairness in comparison, asynchronous rewards are applied to
both the baseline and CoPRIS", §5.1): reward evaluation (rule-based checking
here; sandboxed execution or reward models in general) overlaps with the
rollout instead of serialising after it.

:class:`AsyncEnvWorker` is the general pool: keyed submissions with a
per-submit deadline and exception isolation — a hung or raising env/reward
fn produces a failed result instead of stalling the stage. Multi-turn
rollouts run ``Environment.step`` here (ROLL-Flash-style environment-level
parallelism): while an episode waits on its environment the engine has
already handed its decode slot to other work, and ``poll`` integrates the
observation at the next chunk boundary.

:class:`AsyncRewardWorker` keeps the historical single-turn surface on top:
the engine invokes ``submit`` the moment a trajectory finishes; the trainer
calls ``gather`` once the batch is collected — by then most rewards are
already done. Rule-based math rewards are microseconds, so the win here is
architectural (the hook is where a slow verifier/RM would plug in); the
thread pool keeps the main thread free either way.

Under the overlapped trainer, ``submit`` (rollout thread, stage k+1) and
``gather`` (train thread, stage k) run concurrently: the pending map is
lock-protected, and ``gather`` never holds the lock while blocking on a
future, so gathering stage k can never stall stage k+1 submissions.

The port's copy of ``repro.core.reward_worker`` (pure Python threads).
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.trajectory import Group, Trajectory


@dataclass
class _Submission:
    future: Future
    deadline: Optional[float]          # time.monotonic() cutoff, None = never


class AsyncEnvWorker:
    """Shared thread pool for environment steps and reward fns, with keyed
    submissions, per-submit timeout, and exception isolation.

    ``submit(key, fn, *args)`` enqueues; results come back either through
    the non-blocking ``poll()`` (the rollout engine's path — integrate at
    chunk boundaries) or the blocking, deadline-bounded ``resolve(key)``
    (the trainer's gather path). Both report ``(ok, value)``: on a timeout
    or an exception ``ok`` is False and ``value`` is the error — the caller
    substitutes a default instead of deadlocking the stage.
    """

    def __init__(self, *, max_workers: int = 4,
                 timeout: Optional[float] = None,
                 thread_name_prefix: str = "env"):
        self.pool = ThreadPoolExecutor(max_workers=max_workers,
                                       thread_name_prefix=thread_name_prefix)
        self.timeout = timeout
        # guards _pending and stats — submit/poll/resolve may race between
        # the engine's producer thread and the trainer's consumer thread
        self._lock = threading.Lock()
        self._pending: Dict[object, _Submission] = {}
        self.stats = dict(submitted=0, completed=0,
                          env_timeouts=0, env_errors=0)

    # ------------------------------------------------------------------
    def submit(self, key, fn: Callable, *args) -> bool:
        """Enqueue ``fn(*args)`` under ``key``; False if ``key`` is already
        pending (duplicate submits are dropped, first wins)."""
        with self._lock:
            if key in self._pending:
                return False
            deadline = (time.monotonic() + self.timeout
                        if self.timeout else None)
            self._pending[key] = _Submission(self.pool.submit(fn, *args),
                                             deadline)
            self.stats["submitted"] += 1
        return True

    @property
    def num_pending(self) -> int:
        with self._lock:
            return len(self._pending)

    def _expired(self, sub: _Submission, now: float) -> bool:
        return sub.deadline is not None and now > sub.deadline

    def _account(self, ok: bool, err) -> None:
        # caller holds no lock; stats writes always take it
        with self._lock:
            self.stats["completed"] += 1
            if not ok:
                self.stats["env_timeouts" if isinstance(err, FutureTimeout)
                           else "env_errors"] += 1

    # ------------------------------------------------------------------
    def poll(self) -> List[Tuple[object, bool, object]]:
        """Non-blocking: every submission that has finished or blown its
        deadline, as ``(key, ok, value_or_error)``. A timed-out submission
        is abandoned (cancelled if not yet started; a running fn keeps a
        pool thread busy but never blocks the caller)."""
        now = time.monotonic()
        with self._lock:
            ready = [(k, s) for k, s in self._pending.items()
                     if s.future.done() or self._expired(s, now)]
            for k, _ in ready:
                del self._pending[k]
        out = []
        for key, sub in ready:
            if sub.future.done():
                try:
                    val, ok = sub.future.result(), True
                except BaseException as e:    # isolation: error -> result
                    val, ok = e, False
            else:
                sub.future.cancel()
                val, ok = FutureTimeout(
                    f"env step {key!r} exceeded {self.timeout}s"), False
            self._account(ok, val if not ok else None)
            out.append((key, ok, val))
        return out

    def wait(self, timeout: float) -> None:
        """Block until SOME pending submission finishes or its deadline
        passes, at most ``timeout`` seconds. Used by the engine when every
        live trajectory is parked on its environment — there is nothing to
        decode until an observation lands."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if not self._pending:
                    return
                now = time.monotonic()
                if any(s.future.done() or self._expired(s, now)
                       for s in self._pending.values()):
                    return
            time.sleep(0.001)

    def resolve(self, key, *, block: bool = True) -> Tuple[bool, object]:
        """Blocking single-key resolve honoring the per-submit deadline;
        ``(ok, value_or_error)``. KeyError if ``key`` was never submitted
        or already polled."""
        with self._lock:
            sub = self._pending.pop(key)
        budget = None
        if sub.deadline is not None:
            budget = max(0.0, sub.deadline - time.monotonic())
        try:
            val, ok = sub.future.result(timeout=budget if block else 0), True
        except FutureTimeout as e:
            sub.future.cancel()
            val, ok = e, False
        except BaseException as e:
            val, ok = e, False
        self._account(ok, val if not ok else None)
        return ok, val

    def drop(self, key) -> None:
        with self._lock:
            sub = self._pending.pop(key, None)
        if sub is not None:
            sub.future.cancel()

    def stats_snapshot(self) -> dict:
        with self._lock:
            return dict(self.stats)

    def shutdown(self):
        self.pool.shutdown(wait=False, cancel_futures=True)


class AsyncRewardWorker(AsyncEnvWorker):
    """The single-turn reward surface on top of the general pool: submit on
    trajectory finish, gather at batch time. A reward fn that hangs past
    ``timeout`` or raises scores 0.0 (counted in ``env_timeouts`` /
    ``env_errors``) instead of wedging the trainer."""

    def __init__(self, reward_fn: Callable, *, max_workers: int = 4,
                 timeout: Optional[float] = None):
        super().__init__(max_workers=max_workers, timeout=timeout,
                         thread_name_prefix="reward")
        self.reward_fn = reward_fn
        self.computed = 0
        # wall-time the trainer actually SPENT blocked in the last gather —
        # the synchronous cost of the reward stage (async work that finished
        # during rollout costs the trainer nothing)
        self.last_gather_time = 0.0

    # -- engine-side hook ------------------------------------------------
    def submit(self, traj: Trajectory, answer) -> None:
        """Called by the rollout engine when a trajectory finishes. Never
        blocks on an in-progress ``gather`` (executor submission is a queue
        push; the pending-map lock is only held for the dict update)."""
        if traj.reward is not None:
            return
        super().submit(traj.traj_id, self.reward_fn,
                       list(traj.response_tokens), answer)

    # -- trainer-side ------------------------------------------------------
    def gather(self, groups: List[Group]) -> int:
        """Resolve rewards for every trajectory in ``groups`` (blocking on
        any still-running futures up to their deadline; computing inline for
        any the engine never submitted — e.g. sync mode without the hook).
        Returns #resolved. Waits on futures OUTSIDE the pending-map lock, so
        a concurrent rollout stage keeps submitting while this stage
        resolves. A timed-out or raising reward fn scores 0.0."""
        t0 = time.perf_counter()
        n = 0
        for g in groups:
            for t in g.trajectories:
                if t.reward is not None:
                    continue
                with self._lock:
                    have = t.traj_id in self._pending
                if have:
                    ok, val = self.resolve(t.traj_id)
                    t.reward = float(val) if ok else 0.0
                else:
                    t.reward = float(self.reward_fn(
                        list(t.response_tokens), g.answer))
                n += 1
        self.computed += n
        self.last_gather_time = time.perf_counter() - t0
        return n
