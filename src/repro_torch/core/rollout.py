"""Slot-pool rollout engine — Concurrency-Controlled Partial Rollout.

Continuous batching with CHUNKED DEVICE-SIDE DECODE: a fixed pool of ``N'``
slots, each slot owning a region of the batched KV cache. Every engine step
runs one loop of ``decode_chunk`` decode+sample iterations over all N' slots
on the device (``model.decode_scan``); EOS / max-length stops are detected on
the device, so the host reads the device once per chunk — ``(tokens, logps,
active)`` in a single transfer — instead of once per token. The host then
*replays* the chunk in (step, slot) order: appending tokens to trajectories,
trimming post-stop over-generation, and refilling freed slots through ONE
batched multi-slot prefill over a padded bucket (padding rows carry an
out-of-range slot id and are dropped by the insert). Early termination fires
when B groups are complete; in-flight trajectories stay in the buffer with
their per-stage behaviour log-probs.

Sampling uses a **per-trajectory PRNG stream**: the key for response token
``j`` of trajectory ``(group_id, sample_idx)`` is::

    fold_in(fold_in(fold_in(stage_key, group_id), sample_idx), j)

so the sampled stream is a pure function of the trajectory identity — not of
slot assignment, batch composition, or chunk size — and equals the JAX
engine's on the same logits. Keys are derived on the host (they depend only
on host state) and shipped with each chunk's inputs.

Modes: "copris" | "sync" | "naive_partial", over the dense or the paged KV
backend (page-gated admission, preemption under page pressure, prefix
sharing with copy-on-write).

Multi-turn environments (``env_factory``): a model turn that stops yields
its slot and hands the turn to the :class:`AsyncEnvWorker`; at the next
chunk boundary the observation is appended with role 0 and the trajectory
goes back to the scheduler, whose next dispatch re-prefills it.

On a mesh (``mesh=``, a ("data", "model") ``DeviceMesh`` or the GQA serve
mesh ("data", "kvg", "model"); every rank runs the engine in lockstep):
every block kind, the weights in the serve layout (``launch/sharding``:
tensor-parallel only, the reference's decode placements), the slot cache
laid out as ``cache_placements`` says (``shard_seq``, the length over
"data", for a pool of one slot, as the reference picks it for batch 1),
the host's inputs and a VLM's media replicated on the mesh, sampling on
each rank's own rows of whole-vocabulary logits, and every host read
gathered (``full_tensor``) so every rank's scheduler sees the same values
and takes the same decisions.

Streams: every kernel and copy runs on the caller's current CUDA stream,
and :meth:`RolloutEngine.block_until_ready` waits for that stream only, so
a producer thread that drives the engine under its own stream (the
overlapped trainer) never waits for the consumer's update.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.config import ModelConfig, RolloutConfig
from repro_torch.common.device import resolve_device, torch_dtype
from repro_torch.common.partitioning import (on_mesh, on_rows, replicate,
                                             to_host)
from repro_torch.common.tracing import span
from repro_torch.core.buffer import TrajectoryBuffer
from repro_torch.core.reward_worker import AsyncEnvWorker
from repro_torch.core.scheduler import ConcurrencyScheduler
from repro_torch.core.trajectory import Group, Trajectory
from repro_torch.hopper import fused_sample
from repro_torch.launch.mesh import mesh_device
from repro_torch.models import model as M
from repro_torch.sampling import kv_cache as kvc
from repro_torch.sampling import prng

PREFILL_BUCKET = 64


def _round_up(n, m):
    return -(-n // m) * m


def prefill_pad_dims(lens, n_rows, n_pending):
    """Padded shape of one batched prefill: (padded seq len S, padded row
    count nr, padded insert count ns). Lengths round up to the 64-token
    bucket and counts to a power of two, so the set of shapes stays small."""
    S = _round_up(max(lens), PREFILL_BUCKET)
    nr = 1 << (n_rows - 1).bit_length()
    ns = 1 << (n_pending - 1).bit_length()
    return S, nr, ns


def _fold_slot_keys(stage_key, gid, sidx):
    """(n,) group ids + sample indices -> (n, 2) per-trajectory keys,
    computed on the host."""
    gid = torch.as_tensor(gid)
    k = prng.fold_in(stage_key.cpu().expand(gid.shape[0], 2), gid)
    return prng.fold_in(k, torch.as_tensor(sidx))


def stop_flags(tok, resp_len_after, total_len_after, *, eos_id: int,
               max_response_len: int, max_len: int):
    """THE stop predicate — one definition shared by the device-side sampling
    step and the host replay (`_maybe_done`), so the two cannot drift apart.

    Evaluated on *post-append* quantities: ``resp_len_after`` /
    ``total_len_after`` count the token ``tok`` that just landed. The
    total-length bound stops at ``max_len - 1`` so the next decode step never
    writes K/V past cache capacity. Works elementwise on tensors (device) and
    on python ints (host). Returns ``(eos_stop, length_stop)``."""
    eos = tok == eos_id
    length = ((resp_len_after >= max_response_len)
              | (total_len_after >= max_len - 1))
    return eos, length


def _check_mesh_engine(ro, env_factory):
    """What the engine on a mesh does not run yet (ROADMAP queue 1) raises
    here, before any work."""
    missing = []
    if ro.kv_backend != "dense":
        missing.append("the paged KV cache (the reference has no sharding "
                       "rule for page pools)")
    if ro.resume_strategy != "reprefill":
        missing.append(f"resume_strategy={ro.resume_strategy!r} (per-slot "
                       "snapshots of a sharded cache)")
    if env_factory is not None:
        missing.append("multi-turn environments")
    if missing:
        raise NotImplementedError(
            "the rollout engine on a mesh: " + "; ".join(missing)
            + " not ported (ROADMAP queue 1)")


class RolloutEngine:
    def __init__(self, model_cfg: ModelConfig, ro_cfg: RolloutConfig,
                 prompt_source: Callable[[], Tuple[np.ndarray, object]], *,
                 eos_id: int, max_len: Optional[int] = None,
                 on_finish: Optional[Callable] = None,
                 env_factory: Optional[Callable] = None,
                 env_worker: Optional[AsyncEnvWorker] = None, media=None,
                 device=None, mesh=None):
        self.cfg = model_cfg
        self.ro = ro_cfg
        self.prompt_source = prompt_source
        self.eos_id = eos_id
        self.on_finish = on_finish      # async-reward hook: (traj, answer)
        self._answers = {}
        # ---- multi-turn environments -----------------------------------
        # env_factory(spec) -> Environment (spec = the prompt source's
        # answer slot). When set, every EOS/length stop yields the slot and
        # hands the finished turn to the AsyncEnvWorker; observations are
        # integrated (and the trajectory re-prefilled) at chunk boundaries.
        # None preserves the single-turn path bit-exactly.
        self.env_factory = env_factory
        self.env_worker = env_worker
        if env_factory is not None and env_worker is None:
            self.env_worker = AsyncEnvWorker(
                timeout=ro_cfg.env_step_timeout or None)
        self._env_pending = {}          # traj_id -> parked Trajectory
        self.mesh = mesh
        if mesh is not None:
            _check_mesh_engine(ro_cfg, env_factory)
            device = mesh_device(mesh)
        self.device = resolve_device(device)
        # a VLM's frontend embeddings (M, d_media), the same for every
        # request: each prefill broadcasts them to its rows; decode reads
        # the media K/V the prefill cached in the slot
        self.media = (None if media is None else
                      torch.as_tensor(np.asarray(media, np.float32),
                                      device=self.device))
        self.dtype = torch_dtype(model_cfg.dtype)
        self.pool = ro_cfg.slot_pool
        self.max_len = max_len or _round_up(
            ro_cfg.max_prompt_len + ro_cfg.max_response_len, PREFILL_BUCKET)
        self._chunk = ro_cfg.decode_chunk

        self.buffer = TrajectoryBuffer()
        # the cache lives behind a CacheBackend: "dense" is one region per
        # slot, "paged" shares physical page pools across slots with
        # block-table indirection (admission then gates on free PAGES, not
        # free slots — continuous batching)
        self.backend = kvc.make_backend(
            ro_cfg.kv_backend, model_cfg, self.pool, self.max_len,
            page_size=ro_cfg.kv_page_size, num_pages=ro_cfg.kv_num_pages,
            device=self.device, mesh=mesh)
        # pages promised to dispatched-but-not-yet-prefilled work
        self._reserved_pages = 0
        self._reservations = {}        # traj_id -> reserved page count
        self.cache_len = np.zeros(self.pool, np.int32)
        self.last_token = np.zeros(self.pool, np.int32)
        self.slot_gid = np.zeros(self.pool, np.int32)   # key-stream identity
        self.slot_sidx = np.zeros(self.pool, np.int32)
        self.slots: List[Optional[Trajectory]] = [None] * self.pool
        self._group_counter = 0
        self.stats_total = {}
        # guards stats_total: _end_stage accumulates on whichever thread
        # drives the stage, while other threads read totals via
        # stats_snapshot()
        self._stats_lock = threading.Lock()
        # the engine OWNS its KV cache and updates it in place, so a second
        # concurrent stage would corrupt the first one's slots; this guard
        # turns any accidental re-entry into a loud error
        self._collect_guard = threading.Lock()

    # ------------------------------------------------------------------
    @property
    def cache(self):
        """Per-layer KV tensors, owned by the backend."""
        return self.backend.cache

    def stats_snapshot(self) -> dict:
        """Consistent copy of the lifetime stat totals."""
        with self._stats_lock:
            return dict(self.stats_total)

    def block_until_ready(self):
        """Wait for the work queued on the engine's stream: the caller's
        current CUDA stream (the producer's in the overlapped trainer), not
        the whole device, so a concurrent update on another stream is not
        waited for."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def prepare_params(self, params):
        """Parameters in the engine's compute dtype and on its device (the
        matmul weights are cast once; already-cast params pass through);
        on a mesh then laid out in the serve layout (plain tensors, the same
        on every rank, are distributed; ``DTensor`` s redistributed)."""
        params = M.cast_params(params, self.dtype, self.device)
        if self.mesh is None:
            return params
        from repro_torch.launch.sharding import shard_params
        return shard_params(params, self.mesh, self.cfg, serve_tp_only=True,
                            serve_decode=True)

    def _put(self, a):
        """A host array on the engine's device, replicated on its mesh."""
        return on_mesh(torch.from_numpy(a).to(self.device), self.mesh)

    def _media_for(self, batch):
        """The media broadcast to ``batch`` prefill rows, or None."""
        if self.media is None:
            return None
        return self.media[None].expand(batch, *self.media.shape)

    def _sample(self, keys, logits):
        """(tokens, logps) of ``logits`` (B, V) under ``keys`` (B, 2). On a
        mesh each rank draws its own rows of the whole-vocabulary logits,
        and the draws are replicated."""
        tok, logp = on_rows(
            lambda k, lg: fused_sample.sample_rows(
                k, lg, temperature=self.ro.temperature, top_p=self.ro.top_p,
                top_k=self.ro.top_k),
            (on_mesh(keys, logits), logits), n_out=2)
        return replicate(tok), replicate(logp)

    # ------------------------------------------------------------------
    def _new_group(self) -> Optional[Group]:
        # a prompt source may return None to DECLINE (finite workloads: a
        # serving queue that is currently empty) — the scheduler then leaves
        # the slot idle instead of opening a group with no prompt
        src = self.prompt_source()
        if src is None:
            return None
        prompt, answer = src
        g = Group(group_id=self._group_counter,
                  prompt_tokens=np.asarray(prompt, np.int32), answer=answer,
                  size=self.ro.group_size)
        self._answers[g.group_id] = answer
        self._group_counter += 1
        return g

    def _finish(self, traj: Trajectory, reason: str,
                sched: ConcurrencyScheduler):
        traj.done = True
        traj.finish_reason = reason
        if self.on_finish is not None:      # async reward pipeline
            self.on_finish(traj, self._answers.get(traj.group_id))
        sched.release(traj)

    def _stop_slot(self, traj: Trajectory, reason: str,
                   sched: ConcurrencyScheduler):
        """A slot-resident trajectory hit a stop (EOS / length). Single-turn:
        the episode is over. Multi-turn: the TURN is over — yield the slot
        (the caller frees it, returning its pages to continuous-batching
        admission) and hand the turn to the async environment."""
        if self.env_factory is None:
            self._finish(traj, reason, sched)
            return
        if traj.env is None:
            traj.env = self.env_factory(self._answers.get(traj.group_id))
            traj.env.reset()
        traj.awaiting_env = True
        # a length stop means the response budget is exhausted: the pending
        # env step is the episode's last (reward still counts, observation
        # is discarded — there is no room to decode another turn)
        traj.env_final = traj.env_final or reason == "length"
        sched.release(traj)
        self._env_pending[traj.traj_id] = traj
        self.env_worker.submit(traj.traj_id, traj.env.step,
                               traj.turn_tokens())
        self._stats["env_steps"] += 1

    def _finish_episode(self, traj: Trajectory, sched: ConcurrencyScheduler):
        """Close a multi-turn episode: the env-accumulated return IS the
        reward (no on_finish — the reward worker has nothing to score)."""
        traj.awaiting_env = False
        traj.done = True
        traj.finish_reason = "length" if traj.env_final else "env_done"
        traj.reward = float(traj.env_return)
        sched.release(traj)

    def _poll_env(self, sched: ConcurrencyScheduler, *, block: bool = False):
        """Integrate finished environment steps (engine thread only): append
        observations and return trajectories to the dispatch pool, or close
        episodes the env declared done. Timeouts / raising env fns end the
        episode with the reward accumulated so far — never a wedged stage."""
        if not self._env_pending:
            return
        if block:
            t0 = time.perf_counter()
            self.env_worker.wait(0.05)
            self._stats["env_wait_time"] += time.perf_counter() - t0
        finished = False
        for key, ok, val in self.env_worker.poll():
            traj = self._env_pending.pop(key, None)
            if traj is None:
                continue
            traj.awaiting_env = False
            if not ok:
                self._stats["env_failures"] += 1
                traj.env_final = True
                obs, done = np.empty(0, np.int32), True
            else:
                obs, r, done = val
                obs = np.asarray(obs, np.int32).reshape(-1)
                traj.env_return += float(r)
            if not done and not traj.env_final:
                # room check: the next turn needs the observation plus at
                # least one decodable model token inside both length budgets
                if (traj.response_len + len(obs) >= self.ro.max_response_len
                        or traj.total_len + len(obs) >= self.max_len - 1):
                    traj.env_final = True
                else:
                    traj.append_env(obs, self._stage)
                    self._stats["env_turns"] += 1
                    continue           # resumable: next dispatch re-prefills
            self._finish_episode(traj, sched)
            finished = True
        if finished:
            sched.harvest()

    def _maybe_done(self, traj: Trajectory) -> Optional[str]:
        if not traj.response_tokens:
            return None
        eos, length = stop_flags(
            traj.response_tokens[-1], traj.response_len, traj.total_len,
            eos_id=self.eos_id, max_response_len=self.ro.max_response_len,
            max_len=self.max_len)
        # an environment observation can legally contain the EOS id; only a
        # MODEL-sampled EOS ends a turn (device decode only ever samples
        # model tokens, so the device/host stop predicates stay in lockstep)
        if eos and traj.roles[-1] == 1:
            return "eos"
        if length:
            return "length"
        return None

    # -- slot refill ---------------------------------------------------
    def _resume_snapshot(self, i: int, traj: Trajectory):
        """resume_strategy="kv_snapshot": restore the evicted slot state
        verbatim — no re-prefill cost, but after a policy update the
        continuation attends to STALE K/V."""
        self.backend.insert_snapshot(traj.kv_snapshot, i)
        self.slots[i] = traj
        self.cache_len[i] = traj.snap_cache_len
        self.last_token[i] = traj.snap_last_token
        self.slot_gid[i] = traj.group_id
        self.slot_sidx[i] = traj.sample_idx
        traj.kv_snapshot = None
        self._stats["resumed"] += 1
        self._stats["snapshot_resumes"] = \
            self._stats.get("snapshot_resumes", 0) + 1

    def _admission_cost(self, traj: Trajectory, fresh_gids: set) -> int:
        """Worst-case free pages this admission needs (paged backend):
        snapshot restores bill their exact page count; prefills bill pages
        through the first decode chunk; a fresh spawn whose group primary is
        already admitted only bills pages past the shared full prompt
        pages."""
        if (self.ro.resume_strategy == "kv_snapshot"
                and traj.kv_snapshot is not None):
            return self.backend.snapshot_pages(traj.kv_snapshot)
        shared = (self.ro.kv_prefix_sharing and traj.response_len == 0
                  and traj.group_id in fresh_gids)
        return self.backend.admission_pages(traj.total_len,
                                            lookahead=self._chunk,
                                            shared=shared)

    def _dispatch_refills(self, idxs, sched: ConcurrencyScheduler):
        """Decide what fills freed slots, in slot order (one sequential
        scheduler dispatch per slot, so scheduling policy is invariant to the
        decode chunk size). kv_snapshot resumes are restored in place;
        re-prefill trajectories are returned as (slot, traj) pairs for the
        batched prefill.

        Paged backend: admission is additionally gated on free PAGES —
        continuous batching. A dispatch the page budget cannot cover is
        handed back to the scheduler (requeue, redispatched with priority)
        and the remaining freed slots stay idle this round; they are
        re-offered at the next chunk boundary, when decode/finishes may have
        freed pages."""
        pending: List[Tuple[int, Trajectory]] = []
        queue = list(idxs)
        paged = self.backend.is_paged
        if paged:
            budget = self.backend.free_page_count() - self._reserved_pages
            fresh_gids = set()         # groups with an admitted fresh spawn
        while queue and not sched.done:
            batch = sched.next_requests(len(queue))
            exhausted = len(batch) < len(queue)
            redo = []
            blocked = False
            for bi, (i, traj) in enumerate(zip(queue, batch)):
                if paged:
                    cost = self._admission_cost(traj, fresh_gids)
                    if cost > budget:
                        # hand this and every later dispatch of the batch
                        # back — scheduler order is priority order
                        for t2 in batch[bi:]:
                            sched.requeue(t2)
                        self._stats["admission_blocked"] += len(batch) - bi
                        blocked = True
                        break
                    budget -= cost
                if (self.ro.resume_strategy == "kv_snapshot"
                        and traj.kv_snapshot is not None):
                    self._resume_snapshot(i, traj)   # allocates pages now
                    reason = self._maybe_done(traj)
                    if reason is not None:
                        self._stop_slot(traj, reason, sched)
                        self.slots[i] = None
                        self.backend.free_slot(i)
                        sched.harvest()
                        redo.append(i)
                else:
                    if paged:
                        self._reserved_pages += cost
                        self._reservations[traj.traj_id] = cost
                        if traj.response_len == 0:
                            fresh_gids.add(traj.group_id)
                    pending.append((i, traj))
            queue = redo
            if exhausted or blocked:
                break
        return pending

    def _prefill_pending(self, pending, params, stage_key):
        """ONE batched prefill over all freed slots: rows padded to a common
        PREFILL_BUCKET length, row count padded to a power of two (padding
        rows insert to the out-of-range slot id ``pool`` and are dropped).
        Returns the rows that finished immediately (their very first sampled
        token already ended the trajectory).

        Prefix sharing (paged backend): fresh same-group spawns collapse onto
        ONE prefill row — the first ("primary") slot allocates and fills the
        prompt pages, the other G-1 members point their block tables at them
        (refcounted; copy-on-write restores exclusivity on the first
        divergent write). Each member still samples its own first token from
        the shared row's logits under its own PRNG stream, so trajectory
        content is unchanged."""
        fulls = [t.full_tokens() for _, t in pending]
        lens = [len(f) for f in fulls]
        for L in lens:
            if L >= self.max_len:
                raise ValueError(
                    f"trajectory length {L} >= max_len {self.max_len}")
        paged = self.backend.is_paged
        if paged:
            for _, traj in pending:
                self._reserved_pages -= self._reservations.pop(
                    traj.traj_id, 0)
        share = self.backend.supports_sharing and self.ro.kv_prefix_sharing
        # row assignment: one row per unique prefill
        rows = []                      # (full_tokens, L, primary_slot)
        row_of_gid = {}
        row_map, primary = [], []
        for (i, traj), f, L in zip(pending, fulls, lens):
            fresh = traj.response_len == 0
            if not fresh:              # resumed: recomputed from its start
                self._stats["reprefill_tokens"] += L
            if share and fresh and traj.group_id in row_of_gid:
                row_map.append(row_of_gid[traj.group_id])
                primary.append(False)
            else:
                r = len(rows)
                rows.append((f, L, i))
                if share and fresh:
                    row_of_gid[traj.group_id] = r
                row_map.append(r)
                primary.append(True)
        S, nr, ns = prefill_pad_dims(lens, len(rows), len(pending))
        self._stats["prefill_positions"] += nr * S
        tokens = np.zeros((nr, S), np.int32)
        lengths = np.ones(nr, np.int32)
        flat_pos = None
        if paged:
            oob = self.backend.num_pages * self.backend.page_size
            flat_pos = np.full((nr, S), oob, np.int32)   # sentinel: dropped
        for r, (f, L, islot) in enumerate(rows):
            tokens[r, :L] = f
            lengths[r] = L
            if paged:
                flat_pos[r, :L] = self.backend.alloc_slot_prefix(islot, L)
            self._stats["prefill_tokens"] += L
        slot_ids = np.full(ns, self.pool, np.int32)   # padding -> dropped
        rmap = np.zeros(ns, np.int32)
        gid = np.zeros(ns, np.int32)
        sidx = np.zeros(ns, np.int32)
        resp_idx = np.zeros(ns, np.int32)
        for s, ((i, traj), r, prim) in enumerate(
                zip(pending, row_map, primary)):
            slot_ids[s] = i
            rmap[s] = r
            gid[s] = traj.group_id
            sidx[s] = traj.sample_idx
            resp_idx[s] = traj.response_len
            if paged and not prim:
                self.backend.share_slots(rows[r][2], i, rows[r][1])
                self._stats["shared_prefill_rows"] += 1
        tok, logp = self._prefill_batch(params, tokens, lengths, slot_ids,
                                        rmap, flat_pos, gid, sidx, resp_idx,
                                        stage_key)
        self._stats["prefill_calls"] += 1
        self._stats["prefill_rows"] += len(rows)
        self._stats["host_syncs"] += 1
        finished = []
        for s, (i, traj) in enumerate(pending):
            traj.append(int(tok[s]), float(logp[s]), self._stage)
            self.slots[i] = traj
            self.cache_len[i] = lens[s]
            self.last_token[i] = int(tok[s])
            self.slot_gid[i] = traj.group_id
            self.slot_sidx[i] = traj.sample_idx
            self._stats["prefill_count"] += 1
            if traj.resume_count > 0 and traj.response_len > 1:
                self._stats["resumed"] += 1
            reason = self._maybe_done(traj)
            if reason:
                finished.append((i, traj, reason))
        return finished

    def _prefill_batch(self, params, tokens, lengths, slot_ids, row_map,
                       flat_pos, gid, sidx, resp_idx, stage_key):
        """Device half of one batched prefill: forward the padded prompts
        into a scratch cache sized to the bucket S (not max_len), sample each
        slot's first token, insert the scratch rows into the slot cache (the
        dense insert by slot, or the paged insert: K/V by ``flat_pos``,
        per-slot state by slot). Returns
        host (tokens, logps) from ONE transfer."""
        dev = self.device
        n, S = tokens.shape
        keys = prng.fold_in(_fold_slot_keys(stage_key, gid, sidx),
                            torch.as_tensor(resp_idx))
        scratch = M.init_cache(self.cfg, n, S, self.dtype, dev,
                               mesh=self.mesh, shard_seq=False)
        logits, scratch = M.prefill(
            params, self.cfg, self._put(tokens), self._put(lengths), scratch,
            media=self._media_for(n))
        rows = torch.from_numpy(np.clip(row_map, 0, n - 1).astype(np.int64))
        rows = rows.to(dev)
        # each slot's row (a row gather: whole rows on every rank on a mesh)
        logits = on_rows(lambda lg: lg[rows], (logits,), n_out=0, n_rep=1,
                         whole=True)
        tok, logp = self._sample(keys.to(dev), logits)
        if self.backend.is_paged:
            kvc.paged_insert_rows(self.cache, scratch, slot_ids, row_map,
                                  flat_pos)
        else:
            kvc.dense_insert_rows(self.cache, scratch, slot_ids, row_map)
        out = to_host(torch.stack([tok.float(), logp])).cpu().numpy()
        return out[0].astype(np.int32), out[1]

    def _prefill_rounds(self, pending, sched: ConcurrencyScheduler, params,
                        stage_key):
        """Batched prefill, iterated: a prefill's very first sampled token
        may already be EOS, freeing the slot again."""
        while pending:
            with span("engine.prefill"):
                finished = self._prefill_pending(pending, params, stage_key)
            freed = []
            for i, traj, reason in finished:
                self._stop_slot(traj, reason, sched)
                self.slots[i] = None
                self.backend.free_slot(i)
                freed.append(i)
            pending = []
            if freed:
                sched.harvest()
                pending = self._dispatch_refills(freed, sched)

    def _preempt_slot(self, i: int, sched: ConcurrencyScheduler,
                      copies: Optional[List[Tuple[int, int]]] = None):
        """Evict a live slot mid-stage to free its pages. The trajectory
        keeps everything generated so far and goes back to the scheduler
        with redispatch priority (requeue) — under kv_snapshot resume it also
        carries its page-list snapshot, so preemption costs one re-prefill at
        worst and nothing at best.

        ``copies`` is the current round's pending COW batch: if the victim
        COW'd earlier in this round, its block table already points at copy
        DESTINATION pages whose copy has not run yet, so the batch must be
        flushed before a snapshot is extracted (sources are still intact —
        no decode write happens until after the round)."""
        traj = self.slots[i]
        if self.ro.resume_strategy == "kv_snapshot":
            if copies:
                self.backend.apply_copies(copies)
                copies.clear()
            traj.kv_snapshot = self.backend.extract_snapshot(i)
            traj.snap_cache_len = int(self.cache_len[i])
            traj.snap_last_token = int(self.last_token[i])
        sched.requeue(traj)
        self.slots[i] = None
        self.backend.free_slot(i)
        self._stats["page_preemptions"] += 1

    def _prepare_decode_pages(self, live, sched: ConcurrencyScheduler):
        """Before each decode chunk (paged backend only): ensure every live
        slot has pages mapped for the chunk's write range [cache_len,
        cache_len + chunk) and owns them EXCLUSIVELY (copy-on-write detaches
        prefix-shared pages on their first divergent write). On page
        exhaustion, preempt the youngest live slot (fewest response tokens —
        least redone work) until growth fits. Page copies run as one batch."""
        copies = []
        for i in range(self.pool):
            if not live[i]:
                continue
            clen = int(self.cache_len[i])
            upto = min(clen + self._chunk, self.max_len)
            while not self.backend.grow(i, upto, clen, copies):
                victim = None
                for j in range(self.pool):
                    if live[j] and j != i and (
                            victim is None or self.slots[j].response_len
                            < self.slots[victim].response_len):
                        victim = j
                if victim is None:
                    raise kvc.PageExhausted(
                        f"slot {i} cannot map its decode range [{clen}, "
                        f"{upto}) and no other live slot is preemptible — "
                        "kv_num_pages is too small for a single trajectory")
                self._preempt_slot(victim, sched, copies)
                live[victim] = False
                # drop pending COW copies targeting pages the preemption just
                # freed (their dst could be recycled to a new owner before
                # the batched copy runs); under kv_snapshot the batch was
                # already flushed and cleared before snapshotting
                copies[:] = [(s, d) for s, d in copies
                             if self.backend.refcount[d] > 0]
        self.backend.apply_copies(copies)
        return live

    def _decode_chunk(self, params, live, resp_len, stage_key):
        """Device half of one engine step: ``decode_chunk`` fused
        decode+sample iterations over the whole pool, then ONE transfer of
        (tokens, logps, was_active), each (D, pool).

        Step d samples slot i with key fold_in(slot_key_i, resp_len_i + d).
        For a slot active at step d that IS its current response index; for
        an inactive slot the draw is discarded by the host replay, so keys
        for the whole chunk are derived up front on the host."""
        D, dev = self._chunk, self.device
        with span("engine.decode"):
            with span("decode.keys"):
                slot_keys = _fold_slot_keys(stage_key, self.slot_gid,
                                            self.slot_sidx)
                idx = torch.from_numpy(resp_len).to(torch.int64)[None] \
                    + torch.arange(D)[:, None]                    # (D, pool)
                keys = prng.fold_in(slot_keys[None].expand(D, self.pool, 2),
                                    idx).to(dev)
            eos_id, max_resp, max_len = (self.eos_id,
                                         self.ro.max_response_len,
                                         self.max_len)

            def step_fn(logits, clen, act, aux):
                resp, d = aux
                tok, logp = self._sample(keys[d], logits)
                resp_new = resp + act.to(resp.dtype)
                eos, length = stop_flags(tok, resp_new, clen + 2,
                                         eos_id=eos_id,
                                         max_response_len=max_resp,
                                         max_len=max_len)
                return tok, logp, eos | length, (resp_new, d + 1)

            # a fresh device block table for every chunk (None for dense)
            bt = self.backend.block_table_device()
            with span("decode.scan"):
                _, (toks, logps, acts) = M.decode_scan(
                    params, self.cfg, self.cache, self._put(self.last_token),
                    self._put(self.cache_len), self._put(live),
                    (self._put(resp_len), 0), steps=D, step_fn=step_fn,
                    paged=None if bt is None else (bt, self.backend.page_size))
            with span("decode.readback"):
                out = to_host(torch.stack([toks.float(), logps, acts.float()])
                              ).cpu().numpy()
        return out[0].astype(np.int32), out[1], out[2].astype(bool)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def collect(self, params, stage_id: int, key, *,
                target_concurrency: Optional[int] = None
                ) -> Tuple[List[Group], dict]:
        """Run rollout until B complete groups are collected (early
        termination). Returns (groups, stats). ``key`` is the stage's raw
        (2,) uint32 key (``prng.PRNGKey``). ``collect`` is single-owner — it
        must only ever run on one thread at a time (see ``_collect_guard``).
        It runs without autograd: a trainer's parameters require gradients,
        and every decode step would otherwise record a graph."""
        self.begin_stage(params, stage_id, key,
                         target_concurrency=target_concurrency)
        try:
            while not self._sched.done and self.step_stage(params, key):
                pass
        except BaseException:
            self._collect_guard.release()
            raise
        return self.end_stage()

    # -- incremental stage API -----------------------------------------
    # collect() == begin_stage + step_stage-until-idle + end_stage. The
    # split exists so external callers (launch/serve.py's ServeEngine) can
    # interleave their own work between decode chunks.

    def begin_stage(self, params, stage_id: int, key, *,
                    target_concurrency: Optional[int] = None
                    ) -> ConcurrencyScheduler:
        """Open a stage: reset per-stage stats, build the scheduler, and run
        the initial whole-pool fill. Takes the engine's single-owner guard
        (released by :meth:`end_stage`)."""
        if not self._collect_guard.acquire(blocking=False):
            raise RuntimeError(
                "RolloutEngine stage re-entered: the engine owns its KV "
                "cache and must be driven from a single thread")
        if target_concurrency is not None and not (
                1 <= target_concurrency <= self.pool):
            self._collect_guard.release()
            raise ValueError(
                f"target_concurrency {target_concurrency} outside "
                f"[1, pool={self.pool}]")
        try:
            with span("engine.prepare_params"):
                self._params = self.prepare_params(params)
            self._stage = stage_id
            self._stats = dict(prefill_count=0, prefill_tokens=0,
                               prefill_calls=0, prefill_rows=0,
                               shared_prefill_rows=0, reprefill_tokens=0,
                               prefill_positions=0, decode_kv_positions=0,
                               decode_steps=0,
                               decode_chunks=0, host_syncs=0,
                               active_slot_steps=0, slot_steps=0, generated=0,
                               overgen_tokens=0, resumed=0, evicted=0,
                               admission_blocked=0, page_preemptions=0,
                               env_steps=0, env_turns=0, env_failures=0,
                               env_wait_time=0.0)
            self._reserved_pages = 0
            self._reservations.clear()
            self._t0 = time.perf_counter()
            self._sched = ConcurrencyScheduler(
                self.ro, self.buffer, self._new_group,
                target_concurrency=target_concurrency)
            if self.ro.mode == "sync" and len(self.buffer) != 0:
                raise RuntimeError("sync mode must start with empty buffer")
            # initial fill: one batched prefill over the whole pool
            self._prefill_rounds(
                self._dispatch_refills(range(self.pool), self._sched),
                self._sched, self._params, key)
        except BaseException:
            self._collect_guard.release()
            raise
        return self._sched

    def step_stage(self, params, key, *,
                   admit_idle: Optional[bool] = None) -> bool:
        """Run ONE decode chunk (+ its host replay and refill prefills).
        Returns False when the engine is idle — nothing live in the pool.
        ``admit_idle`` re-offers idle slots to the scheduler before decoding
        (default: on for the paged backend, whose admission gate and
        preemption can idle slots mid-stage, and with environments, whose
        turns yield their slots; serving callers pass True so
        requests submitted between steps are admitted immediately). The
        stage's params were prepared by :meth:`begin_stage`; ``params`` is
        accepted for API parity."""
        sched = self._sched
        stage_id = self._stage
        params = self._params
        # integrate environment observations FIRST: returned trajectories
        # become resumable before this round's idle slots are re-offered
        self._poll_env(sched)
        has_env = self.env_factory is not None
        admit = ((self.backend.is_paged or has_env)
                 if admit_idle is None else admit_idle)
        if admit and not sched.done:
            # slots idled by an admission block, a page preemption, an empty
            # request queue, or an env-yielded turn are re-offered every
            # chunk boundary
            idle = [i for i in range(self.pool) if self.slots[i] is None]
            if idle:
                self._prefill_rounds(
                    self._dispatch_refills(idle, sched), sched, params, key)
        live = np.array([t is not None for t in self.slots], bool)
        if not live.any():
            if self._env_pending and not sched.done:
                # every in-flight trajectory is parked on its environment:
                # block briefly for an observation instead of spinning (the
                # worker's per-submit timeout bounds the total wait)
                self._poll_env(sched, block=True)
                return True
            return False               # nothing in flight and scheduler idle
        if self.backend.is_paged:
            live = self._prepare_decode_pages(live, sched)
            if not live.any():
                return True            # all preempted; retry next step
        D = self._chunk
        resp_len = np.array([0 if t is None else t.response_len
                             for t in self.slots], np.int32)
        toks, logps, was_active = self._decode_chunk(params, live, resp_len,
                                                     key)
        self._stats["decode_chunks"] += 1
        self._stats["host_syncs"] += 1
        self._stats["decode_steps"] += D
        self._stats["slot_steps"] += D * self.pool
        # the cached positions each active row read at each step of the chunk
        step = np.arange(1, D + 1)[:, None]
        self._stats["decode_kv_positions"] += int(
            ((self.cache_len.astype(np.int64) + step) * was_active).sum())

        # host replay of the chunk, in (step, slot) order
        pending = []
        with span("engine.replay"):
            for d in range(D):
                if sched.done or not live.any():
                    self._stats["overgen_tokens"] += int(was_active[d:].sum())
                    break
                if not np.array_equal(was_active[d], live):
                    raise RuntimeError(
                        "device/host stop detection desynchronised")
                step_live = np.nonzero(live)[0]
                self._stats["active_slot_steps"] += len(step_live)
                freed = []
                for i in step_live:
                    i = int(i)
                    traj = self.slots[i]
                    self.cache_len[i] += 1
                    tok = int(toks[d, i])
                    traj.append(tok, float(logps[d, i]), stage_id)
                    self.last_token[i] = tok
                    self._stats["generated"] += 1
                    reason = self._maybe_done(traj)
                    if reason:
                        self._stop_slot(traj, reason, sched)
                        self.slots[i] = None
                        self.backend.free_slot(i)
                        live[i] = False
                        freed.append(i)
                if freed:
                    sched.harvest()
                    pending.extend(self._dispatch_refills(freed, sched))
        self._prefill_rounds(pending, sched, params, key)
        return True

    def end_stage(self) -> Tuple[List[Group], dict]:
        """Close the stage: evict in-flight work to the buffer, finalize
        stats, release the single-owner guard."""
        try:
            return self._end_stage()
        finally:
            self._collect_guard.release()

    def _end_stage(self) -> Tuple[List[Group], dict]:
        sched = self._sched
        t0 = self._t0
        # early termination: evict in-flight work back to the buffer
        for i, traj in enumerate(self.slots):
            if traj is not None:
                if self.ro.resume_strategy == "kv_snapshot":
                    traj.kv_snapshot = self.backend.extract_snapshot(i)
                    traj.snap_cache_len = int(self.cache_len[i])
                    traj.snap_last_token = int(self.last_token[i])
                sched.release(traj)
                self.slots[i] = None
                self.backend.free_slot(i)
                self._stats["evicted"] += 1
        sched.harvest()

        groups = sched.completed[: self.ro.batch_size]
        # surplus complete groups stay buffered for the next step
        for g in sched.completed[self.ro.batch_size:]:
            self.buffer.add_group(g)

        st = self._stats
        self._params = None
        # queued device work must finish so wall_time covers compute
        self.block_until_ready()
        st["wall_time"] = time.perf_counter() - t0
        st["concurrency_target"] = sched.target_concurrency
        st["buffer_unfinished"] = self.buffer.num_unfinished
        st["utilization"] = (st["active_slot_steps"] / st["slot_steps"]
                             if st["slot_steps"] else 1.0)
        st["multi_stage_trajs"] = sum(1 for g in groups for t in g.trajectories
                                      if t.num_stages > 1)
        with self._stats_lock:
            for k_, v in st.items():
                self.stats_total[k_] = self.stats_total.get(k_, 0) + v
        return groups, st
