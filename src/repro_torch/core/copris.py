"""CoPRIS trainer: rollout → reward → cross-stage IS → GRPO update.

The port of ``repro.core.copris``, with its names. ``make_train_step``
builds the training step (GRPO with cross-stage IS correction, microbatched
gradient accumulation, AdamW); ``CoPRISTrainer`` drives the RL loop on a
live model: ``RolloutEngine.collect`` → async reward gather →
``pack_groups`` → group advantages → loss and its backward → AdamW.

Two pipelines share one code path, as in the reference:

* ``overlap=False`` — the sequential loop: collect, reward gather and train
  inline, with the reference's per-trajectory PRNG streams and stage
  stamps, so a step draws the same tokens as the JAX trainer;
* ``overlap=True`` — a background producer thread runs
  ``RolloutEngine.collect`` against the freshest version published to the
  :class:`~repro_torch.core.weight_sync.ParamStore` while the consumer
  (``step``) trains on a previously collected batch; ``max_staleness``
  bounds how many optimizer updates the training step may be ahead of the
  params that generated its batch. On CUDA the producer's kernels run on a
  stream of their own and the consumer's on another.

Tasks with ``make_env`` (multi-turn environments) run through the async env
worker in either pipeline. With ``TrainConfig.disaggregated`` every
published version is resharded from the train side to the rollout side
(``weight_sync.make_param_resharder``): here the two sides are devices of
one process (``device`` / ``rollout_device``, the counterpart of the
reference's ``train_mesh`` / ``rollout_mesh``), and the reshard copies each
version onto the rollout device bit for bit.

``make_train_step`` also runs sharded: given parameters, AdamW state and a
batch as ``DTensor`` s (``launch/sharding``) under an active mesh
(``common/partitioning.set_activation_mesh``), the same code computes the
sharded update — attention and the fused loss kernels on each rank's local
shards through ``local_map``, the logits materialised sharded where the
vocabulary is sharded, gradients and the global norm over the whole mesh.

``CoPRISTrainer(train_mesh=)`` runs the whole loop on one mesh, every rank
in lockstep: the params made already sharded (or the given ones sharded)
in the training layout with their AdamW state, the update sharded, each
published version redistributed to the serving layout, and the rollout
engine sharded on the same mesh (``rollout_mesh`` defaults to
``train_mesh``). A ``rollout_mesh`` of the same ranks in another shape
(the GQA serve mesh) runs the same way, each version crossing through the
cross-mesh transfer (``weight_sync.MeshTransfer``).

Train and rollout on meshes of their own (``launch/mesh.
make_disaggregated_meshes``, with ``overlap`` and ``disaggregated``): each
process plays one side, and every rank calls ``step()``. A rollout rank's
step makes the next collect under the freshest version that has landed
(waiting only for the staleness gate's), resolves its rewards, packs it
and sends it from the rollout side's first rank to every train rank over
a gloo group of its own; a train rank's step receives that batch, runs
the sharded update and publishes the version through the transfer, whose
receive the rollout side posted ahead. The sides meet only at versioned
weights and finished batches, so rollout decodes while the update runs,
with no GIL between them. With adaptive N' the train side's first rank
owns the controller: after each update it observes the batch's rollout
time and evictions against the update's time and sends the next target
to the rollout side's first rank before it publishes the version, over a
gloo group of the two kept for it; the rollout side's first rank takes
the freshest target that has arrived before each collect (waiting, once
the staleness gate's version has landed, for the target of the update
before it) and broadcasts it over the rollout mesh, so every rollout rank
collects under one target.

Parameters are float32 master tensors that the trainer owns and updates in
place (``optim/adam.update``); every update is published to the
:class:`~repro_torch.core.weight_sync.ParamStore` as a detached copy, which
the rollout side acquires.
"""
from __future__ import annotations

import dataclasses
import pickle
import queue
import threading
import time
from collections import deque
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig, RolloutConfig, TrainConfig
from repro_torch.common.device import resolve_device
from repro_torch.common.partitioning import (activation_mesh,
                                             activation_placements,
                                             is_sharded, on_mesh, replicated,
                                             to_host)
from repro_torch.common.tracing import span
from repro_torch.common.tree import leaves, tree_map, unflatten
from repro_torch.core import grpo
from repro_torch.core.importance import pack_groups
from repro_torch.core.reward_worker import AsyncEnvWorker, AsyncRewardWorker
from repro_torch.core.rollout import RolloutEngine
from repro_torch.core.scheduler import AdaptiveConcurrencyController
from repro_torch.core.weight_sync import ParamStore, make_param_resharder
from repro_torch.hopper import fused_is_grpo as fio
from repro_torch.launch.mesh import make_disaggregated_devices, mesh_device
from repro_torch.models import model as M
from repro_torch.optim import adam, schedule
from repro_torch.sampling import prng

FUSED_VOCAB_THRESHOLD = 8192     # above this, use the vocab-blocked logp path


def make_loss_fn(cfg: ModelConfig, tcfg: TrainConfig):
    """``loss_fn(params, mb) -> (loss, metrics)`` with metrics as 0-dim
    tensors. Above FUSED_VOCAB_THRESHOLD the fused IS+GRPO op reads the
    final hidden states and the unembedding and never materialises the
    (B, S, V) logits; with ``fused_loss=False`` the legacy branch scores the
    log-probs with the fused vocab-blocked kernel (``score_logprobs``) and
    applies the unfused GRPO loss, without entropy; below the threshold
    (``tiny``) the full logits are computed. In every branch the loss is
    the GRPO loss plus ``router_aux_coef`` times the MoE layers' summed
    load-balance loss (``metrics["router_aux"]``; zero without MoE), and
    a VLM reads its media from ``mb["media"]``."""
    aux_coef = cfg.moe.router_aux_coef if cfg.moe is not None else 0.0
    big_vocab = cfg.vocab_size >= FUSED_VOCAB_THRESHOLD
    if big_vocab and not tcfg.fused_loss and tcfg.entropy_coef > 0.0:
        raise ValueError(
            f"entropy_coef={tcfg.entropy_coef} with fused_loss=False: the "
            f"legacy score_logprobs path cannot compute entropy above "
            f"FUSED_VOCAB_THRESHOLD={FUSED_VOCAB_THRESHOLD} (vocab_size="
            f"{cfg.vocab_size}) — the bonus would silently be dropped. "
            "Enable TrainConfig.fused_loss or set entropy_coef=0.")

    def loss_fn(params, mb):
        tokens = mb["tokens"]
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        # loss_mask = response positions of the model's own tokens
        mask = mb["loss_mask"][:, 1:]
        behaviour = mb["behaviour_logp"][:, 1:]
        media = mb.get("media")
        if big_vocab and tcfg.fused_loss:
            hidden, aux = M.forward_hidden(params, cfg, inputs, media=media,
                                           remat=tcfg.remat, return_aux=True)
            adv_tok = mb["advantages"][:, None].expand(targets.shape)
            loss_tok, ratio, logp_new, entropy = fio.fused_is_grpo(
                hidden, M.unembed_weight(params, cfg), targets, behaviour,
                adv_tok, logit_softcap=cfg.logit_softcap,
                clip_low=tcfg.clip_low, clip_high=tcfg.clip_high,
                use_is=tcfg.use_is_correction,
                is_ratio_cap=tcfg.is_ratio_cap,
                entropy_coef=tcfg.entropy_coef)
            loss, metrics = grpo.aggregate_loss(
                loss_tok, ratio, logp_new, behaviour, mask,
                clip_low=tcfg.clip_low, use_is=tcfg.use_is_correction,
                loss_agg=tcfg.loss_agg)
        elif big_vocab:
            # legacy fused-logprob recompute (no entropy available —
            # entropy_coef > 0 is rejected at build time above)
            entropy = None
            logp_new, aux = M.score_logprobs(params, cfg, inputs, targets,
                                             media=media, remat=tcfg.remat,
                                             return_aux=True)
            loss, metrics = grpo.grpo_loss(
                logp_new, behaviour, mb["advantages"], mask,
                clip_low=tcfg.clip_low, clip_high=tcfg.clip_high,
                use_is=tcfg.use_is_correction, is_ratio_cap=tcfg.is_ratio_cap,
                loss_agg=tcfg.loss_agg, entropy=None,
                entropy_coef=tcfg.entropy_coef)
        else:
            logits, aux = M.forward_train(params, cfg, inputs, media=media,
                                          remat=tcfg.remat, return_aux=True)
            logp_all = F.log_softmax(logits, dim=-1)
            logp_new = logp_all.gather(-1, targets[..., None].long())[..., 0]
            entropy = -(logp_all.exp() * logp_all).sum(-1)
            loss, metrics = grpo.grpo_loss(
                logp_new, behaviour, mb["advantages"], mask,
                clip_low=tcfg.clip_low, clip_high=tcfg.clip_high,
                use_is=tcfg.use_is_correction, is_ratio_cap=tcfg.is_ratio_cap,
                loss_agg=tcfg.loss_agg, entropy=entropy,
                entropy_coef=tcfg.entropy_coef)
        with torch.no_grad():
            if entropy is not None:
                denom = mask.sum().clamp_min(1.0)
                metrics["entropy"] = (entropy * mask).sum() / denom
            metrics["pg_loss"] = loss.detach()
            metrics["router_aux"] = aux["router_aux"].detach()
        return loss + aux_coef * aux["router_aux"], metrics

    return loss_fn


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """Returns ``step(params, opt_state, batch, lr) -> (params, opt_state,
    metrics)``. ``batch`` leaves have leading dim N = microbatches * m; the
    gradient is the mean over microbatches. ``params`` and ``opt_state``
    are updated in place and returned."""
    loss_fn = make_loss_fn(cfg, tcfg)
    k = tcfg.microbatches

    def grad_fn(params, mb):
        flat = leaves(params)
        with span("update.forward"):
            loss, metrics = loss_fn(params, mb)
        with span("update.backward"):
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
            return metrics, [torch.zeros_like(p) if g is None
                             else _like(g, p) for p, g in zip(flat, grads)]

    def train_step(params, opt_state, batch, lr):
        n = next(iter(batch.values())).shape[0] // k
        gsum, msum = None, None
        for i in range(k):
            mb = {key: _rows(v, i * n, (i + 1) * n)
                  for key, v in batch.items()}
            metrics, g = grad_fn(params, mb)
            if gsum is None:
                gsum, msum = g, metrics
            else:
                with span("update.backward"):
                    gsum = [a + b for a, b in zip(gsum, g)]
                    msum = {key: msum[key] + metrics[key] for key in msum}
            del g
        if k > 1:
            with span("update.backward"):
                gsum = [g / k for g in gsum]
                msum = {key: v / k for key, v in msum.items()}
        with span("update.optimizer"):
            params, opt_state, om = adam.update(
                unflatten(params, gsum), opt_state, params, lr=lr,
                betas=tcfg.betas, eps=tcfg.eps,
                weight_decay=tcfg.weight_decay, grad_clip=tcfg.grad_clip)
        msum.update(om)
        return params, opt_state, {key: to_host(v) for key, v in msum.items()}

    return train_step


def _like(g, p):
    """A ``DTensor`` gradient in its parameter's placements (a pending
    sum becomes a reduce-scatter or an all-reduce here); a plain one as it
    is."""
    if is_sharded(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _rows(v, lo, hi):
    """Rows [lo, hi) of a batch leaf. A ``DTensor`` leaf is gathered,
    sliced and sharded again over the batch axes, so a microbatch is the
    reference's (rows [lo, hi) of the global batch)."""
    if not is_sharded(v) or (lo == 0 and hi == v.shape[0]):
        return v[lo:hi]
    mesh = v.device_mesh
    rows = v.redistribute(mesh, replicated(mesh))[lo:hi]
    return rows.redistribute(mesh, activation_placements(mesh, rows.shape,
                                                         "dp"))


def _into(dst, src):
    """``src`` (a plain tensor, the same on every rank) in ``dst`` 's
    layout: distributed where ``dst`` is a ``DTensor``."""
    if not is_sharded(dst) or is_sharded(src):
        return src
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(src.to(dst.device), dst.device_mesh,
                             dst.placements, src_data_rank=None)


# ---------------------------------------------------------------------------


@dataclass
class _StageBatch:
    """One collected rollout stage, in flight between producer and consumer.
    ``batch`` onwards are filled by ``_settle`` (rewards resolved, packed)
    on the side that collected it; across two sides only those cross, the
    groups stay."""

    collect_idx: int        # 0-based index of this collect within the run
    params_version: int     # trainer.stage baked into the rollout params
    groups: List = field(default_factory=list)
    roll_stats: dict = field(default_factory=dict)
    batch: Optional[dict] = None            # pack_groups of the groups
    reward_time: float = 0.0
    mean_resp_len: float = 0.0
    env_timeouts: int = 0
    # the rollout side's ParamStore when it collected: versions held, and
    # the drops and seconds of placing landed versions since its last batch
    store: dict = field(default_factory=dict)


class _SideLink:
    """The host channel between the two sides of disjoint meshes: a gloo
    group of both meshes' ranks kept for it alone (the weights travel on
    the transfer's group, so a pair of ranks never has a batch and a
    version in one ordered queue). The rollout side's first rank sends
    each packed batch, pickled, to every train rank without waiting for
    it; a train rank waits for it."""

    BATCH, EVAL = 0, 1                      # tags

    def __init__(self, train_mesh, rollout_mesh):
        import torch.distributed as dist

        from repro_torch.launch.mesh import mesh_ranks
        train, rollout = mesh_ranks(train_mesh), mesh_ranks(rollout_mesh)
        self.group = dist.new_group(sorted(train + rollout), backend="gloo")
        self.me = dist.get_rank()
        self.source, self.train = rollout[0], train
        self._sending = deque()             # (works, the tensors they read)

    def send(self, obj, tag: int):
        """``obj`` to every train rank, from the rollout side's first rank
        (the other rollout ranks send nothing)."""
        import torch.distributed as dist
        if self.me != self.source:
            return
        data = torch.frombuffer(bytearray(pickle.dumps(obj)),
                                dtype=torch.uint8)
        size = torch.tensor([data.numel()], dtype=torch.int64)
        for peer in self.train:
            self._sending.append(([dist.isend(t, peer, group=self.group,
                                              tag=tag)
                                   for t in (size, data)], (size, data)))
        while self._sending and all(w.is_completed()
                                    for w in self._sending[0][0]):
            self._sending.popleft()

    def recv(self, tag: int):
        """The next object the rollout side's first rank sent with
        ``tag``."""
        import torch.distributed as dist
        size = torch.zeros(1, dtype=torch.int64)
        dist.recv(size, self.source, group=self.group, tag=tag)
        data = torch.empty(int(size), dtype=torch.uint8)
        dist.recv(data, self.source, group=self.group, tag=tag)
        return pickle.loads(data.numpy().tobytes())

    def close(self):
        """Wait for every send."""
        while self._sending:
            for w in self._sending.popleft()[0]:
                w.wait()


class _TargetLink:
    """Adaptive N' across two sides: the concurrency targets, the other
    way from :class:`_SideLink`. The train side's first rank, which owns
    the controller, sends the target it sets after each update to the
    rollout side's first rank over a gloo group of those two ranks kept
    for it alone; the rollout side's first rank posts the receive of each
    update's target ahead, and before each collect takes the freshest one
    that has arrived and broadcasts it over a group of the rollout mesh's
    ranks (on the mesh's device: NCCL on the card), so every rollout rank
    collects under one target."""

    def __init__(self, train_mesh, rollout_mesh):
        import torch.distributed as dist

        from repro_torch.launch.mesh import mesh_ranks
        train, rollout = mesh_ranks(train_mesh), mesh_ranks(rollout_mesh)
        self.owner, self.source = train[0], rollout[0]
        self.me = dist.get_rank()
        self.group = dist.new_group(sorted((self.owner, self.source)),
                                    backend="gloo")
        self.rollout = dist.new_group(
            rollout, backend="nccl" if rollout_mesh.device_type == "cuda"
            else "gloo")
        self.device = mesh_device(rollout_mesh)
        self._sending = deque()       # (work, the tensor it reads)
        self._posted = deque()        # (update index, work, its buffer)

    def send(self, target: int):
        """The owner's target after its latest update, without waiting."""
        import torch.distributed as dist
        t = torch.tensor([target], dtype=torch.int64)
        self._sending.append((dist.isend(t, self.source, group=self.group),
                              t))
        while self._sending and self._sending[0][0].is_completed():
            self._sending.popleft()

    def post(self, update: int):
        """Post the receive of update ``update`` 's target (the rollout
        side's first rank; the other ranks post nothing)."""
        import torch.distributed as dist
        if self.me != self.source:
            return
        t = torch.zeros(1, dtype=torch.int64)
        self._posted.append((update, dist.irecv(t, self.owner,
                                                group=self.group), t))

    def take(self, need: int, current: int) -> int:
        """The target of the next collect, the same on every rollout rank:
        the freshest that has arrived, once the targets of the updates up
        to ``need`` have (``current`` where none has since the last
        call)."""
        import torch.distributed as dist
        if self.me == self.source:
            while self._posted and (self._posted[0][0] <= need
                                    or self._posted[0][1].is_completed()):
                _, work, t = self._posted.popleft()
                work.wait()
                current = int(t)
        t = torch.tensor([current], dtype=torch.int64, device=self.device)
        dist.broadcast(t, self.source, group=self.rollout)
        return int(t)

    def close(self):
        """Wait for every send and every posted receive."""
        while self._sending:
            self._sending.popleft()[0].wait()
        while self._posted:
            self._posted.popleft()[1].wait()


class ThreadSafeTask:
    """Serialises ``sample_prompt`` against the rollout producer thread.

    Tasks draw prompts from a numpy ``Generator``, which is NOT thread-safe;
    with ``overlap=True`` the producer samples prompts continuously while the
    main thread may run ``evaluate``/pass@k on the same task. Everything else
    (``reward`` etc.) passes through untouched — rewards must already be
    pure/concurrent-safe for the async reward pool.
    """

    def __init__(self, task, lock: threading.Lock):
        self._task = task
        self._lock = lock

    def sample_prompt(self):
        with self._lock:
            return self._task.sample_prompt()

    def __getattr__(self, name):
        return getattr(self._task, name)


def _on(stream):
    """``torch.cuda.stream(stream)``, or no change for ``None``."""
    return torch.cuda.stream(stream) if stream is not None else nullcontext()


class CoPRISTrainer:
    """The RL loop on one device (the card unless ``device="cpu"``), or on
    meshes (``train_mesh``, ``rollout_mesh``: the module docstring). The
    trainer takes ownership of ``params`` and updates them in place.
    ``transfer_group``: the process group of the weights' transfer
    between two meshes (default: one made of both meshes' ranks, NCCL on
    the card; a gloo group stages the card's tensors through host memory,
    for processes that share a card).

    With ``tcfg.disaggregated`` the rollout side runs on ``rollout_device``
    (default: ``device``, the train side) and reads only the versions the
    store copied there.

    With ``tcfg.overlap`` a background producer thread owns the rollout
    engine and feeds ``step()`` through a bounded queue; ``close()`` (or the
    context-manager exit) shuts the pipeline down. On CUDA the producer
    runs every collect on a stream of its own and the consumer trains on
    another, so the update's kernels and the rollout's run side by side;
    weights cross between the two only through the ``ParamStore``, whose
    versions are fenced by an event. ``overlap=False`` runs the identical
    logic inline on the caller's stream and reproduces the sequential
    trainer bit-for-bit."""

    def __init__(self, model_cfg: ModelConfig, ro_cfg: RolloutConfig,
                 tcfg: TrainConfig, task, *, eos_id: int, key=None,
                 params=None, device=None, rollout_device=None,
                 train_mesh=None, rollout_mesh=None, transfer_group=None):
        self.cfg = model_cfg
        self.ro = ro_cfg
        self.tcfg = tcfg
        self.task = task
        self.train_mesh = train_mesh
        self.rollout_mesh = (train_mesh if rollout_mesh is None
                             else rollout_mesh)
        # "train" / "rollout": this rank's side of disjoint meshes
        self.role = None
        reshard = None
        if self.rollout_mesh is not None:
            # the device is the rank's own
            self.role = self._mesh_role()
            params = self._mesh_params(params, rollout_device)
            self.device = self.rollout_device = mesh_device(
                self.rollout_mesh if self.role == "rollout" else train_mesh)
            reshard, _ = make_param_resharder(model_cfg, params, train_mesh,
                                              self.rollout_mesh,
                                              group=transfer_group)
            if self.role is not None:
                self._link = _SideLink(train_mesh, self.rollout_mesh)
        else:
            self.device = resolve_device(device)
            self.rollout_device = self.device
            sides = make_disaggregated_devices(self.device, rollout_device)
            if tcfg.disaggregated:
                self.device, self.rollout_device = sides
                reshard, _ = make_param_resharder(model_cfg, params, *sides)
            elif sides[0] != sides[1]:
                raise ValueError("rollout_device differs from the train "
                                 "device: that needs "
                                 "TrainConfig(disaggregated=True)")
        # all trainer-originated sample_prompt calls go through this proxy
        # (producer thread during overlapped rollout, main thread during
        # evaluate) — hand it to external eval helpers too
        self.safe_task = ThreadSafeTask(task, threading.Lock())
        # the reference's key schedule: PRNGKey(seed) -> split -> one split
        # per collect (the init half is unused: weights come from `params`
        # or the port's own seeded init)
        key = key if key is not None else prng.PRNGKey(tcfg.seed)
        self.key = prng.split(key)[0]
        if params is None:
            params = M.init_params(model_cfg, seed=tcfg.seed,
                                   device=self.device)

        # ---- overlapped-pipeline state -------------------------------
        self.overlap = tcfg.overlap
        self.max_staleness = tcfg.max_staleness
        # how long step() may wait on the producer before declaring the
        # pipeline wedged (None = wait forever; tests set a finite value)
        self.batch_timeout: Optional[float] = None
        # CUDA streams of the overlapped pipeline: the producer collects on
        # one, the consumer trains on the other (None: the caller's current
        # stream, sequentially). Both start after the work queued so far.
        self.rollout_stream = self.train_stream = None
        if self.overlap and self.role is None \
                and self.device.type == "cuda":
            self.rollout_stream = torch.cuda.Stream(self.rollout_device)
            self.train_stream = torch.cuda.Stream(self.device)
            self.rollout_stream.wait_stream(
                torch.cuda.current_stream(self.rollout_device))
            self.train_stream.wait_stream(
                torch.cuda.current_stream(self.device))

        # the train side of disjoint meshes collects nothing: its batches
        # come packed, rewards resolved, from the rollout side
        self.reward_worker = self.env_worker = self.engine = None
        timeout = ro_cfg.env_step_timeout or None
        if self.role != "train":
            self.reward_worker = AsyncRewardWorker(task.reward,
                                                   timeout=timeout)
            # multi-turn: a task exposing make_env(spec) routes every turn
            # through the async env pool — the engine yields decode slots
            # while episodes wait on their environments. make_env must be
            # a pure function of the spec (no task RNG), so no
            # ThreadSafeTask guard.
            env_factory = None
            if hasattr(task, "make_env"):
                self.env_worker = AsyncEnvWorker(timeout=timeout)
                env_factory = task.make_env
            with _on(self.rollout_stream):  # the KV cache: rollout's memory
                self.engine = RolloutEngine(
                    model_cfg, ro_cfg, self.safe_task.sample_prompt,
                    eos_id=eos_id, on_finish=self.reward_worker.submit,
                    env_factory=env_factory, env_worker=self.env_worker,
                    device=self.rollout_device, mesh=self.rollout_mesh)
        self._train_step = make_train_step(model_cfg, tcfg)
        self.stage = 0
        self.history = []
        self.last_groups: List = []
        self.last_batch: Optional[dict] = None

        # ---- versioned weight sync (ParamStore) ----------------------
        # ALL producer/consumer param handoff goes through the store: the
        # consumer publishes version = stage after every update, the
        # producer / evaluate acquire the freshest. max_staleness bounds
        # the pipeline depth, so K+1 versions cover every batch still in
        # flight — older ones are dropped at publish.
        self.param_store = ParamStore(max_versions=self.max_staleness + 1,
                                      reshard=reshard)
        if self.role == "rollout":
            # the train side's params and AdamW state are not here: the
            # versions it publishes arrive through the store
            self.params = self.opt_state = None
            self.param_store.expect(self.stage)
        else:
            with _on(self.train_stream):
                self.params = (params if self.train_mesh is not None else
                               tree_map(lambda t: t.detach().to(
                                   self.device).requires_grad_(), params))
                self.opt_state = adam.init(self.params)
                self.param_store.publish(self.params, self.stage)

        # ---- overlap-aware adaptive N' -------------------------------
        # observe() runs on the consumer thread between stages; the
        # producer reads the plain-int target at collect start (GIL-atomic).
        # Across two sides the train side's first rank alone observes (one
        # clock, one trace) and sends each target to the rollout side
        # (_TargetLink)
        self._concurrency_ctrl = self._concurrency_target = None
        self._targets = None
        if ro_cfg.adaptive_concurrency:
            ctrl = AdaptiveConcurrencyController(ro_cfg)
            self._concurrency_target = ctrl.target
            if self.role is not None:
                self._targets = _TargetLink(train_mesh, self.rollout_mesh)
            if self._targets is None or \
                    self._targets.me == self._targets.owner:
                self._concurrency_ctrl = ctrl

        self._progress = threading.Condition()
        self._batches: "queue.Queue[_StageBatch]" = queue.Queue(
            maxsize=self.max_staleness + 1)
        self._producer: Optional[threading.Thread] = None
        self._producer_exc: Optional[Exception] = None
        self._collect_idx = 0                 # next collect, producer-owned
        self._trained_batches = 0             # consumed collects
        self._first_stage = None              # the stage of the first step
        # store totals already reported, so step metrics emit per-step deltas
        self._reported = self.param_store.stats_snapshot()
        self._stop = threading.Event()
        self._closed = False

    def _mesh_role(self):
        """This rank's side: None where the two meshes are one mesh or the
        same ranks (every rank runs both sides in lockstep), "train" or
        "rollout" where they are disjoint. Refuses meshes that share some
        ranks but not all, and disjoint meshes without overlap and
        disaggregation (the reference's requirement) or not covering the
        world."""
        import torch.distributed as dist

        from repro_torch.launch.mesh import mesh_ranks
        if self.train_mesh is None:
            raise ValueError("rollout_mesh without a train_mesh")
        a = set(mesh_ranks(self.train_mesh))
        b = set(mesh_ranks(self.rollout_mesh))
        if a == b:
            return None
        if a & b:
            raise ValueError(
                f"train mesh ranks {sorted(a)} and rollout mesh ranks "
                f"{sorted(b)} share some ranks but not all: one process "
                "would play both sides (make_disaggregated_meshes makes "
                "disjoint ones)")
        if not (self.tcfg.overlap and self.tcfg.disaggregated):
            raise ValueError(
                "train and rollout meshes of their own ranks need "
                "TrainConfig(overlap=True, disaggregated=True)")
        if len(a | b) != dist.get_world_size():
            raise ValueError(
                f"the two meshes hold {len(a | b)} of the "
                f"{dist.get_world_size()} ranks: every rank plays a side")
        return "train" if dist.get_rank() in a else "rollout"

    def _mesh_params(self, params, rollout_device):
        """The train-layout ``DTensor`` params of the trainer on a mesh:
        made already sharded from ``tcfg.seed``, or the given ones (the
        same full values on every rank) sharded; on the rollout side of
        disjoint meshes only their shapes (the given tree, or a ``meta``
        one). Refuses what the meshes do not run."""
        from repro_torch.launch import sharding as shd
        if self.tcfg.overlap and self.role is None:
            raise NotImplementedError(
                "overlap=True on a mesh: the producer thread and the "
                "consumer would issue collectives on one process group from "
                "two threads, whose order no rank can agree on, and "
                "deadlock (ROADMAP queue 1)")
        if rollout_device is not None:
            raise ValueError("rollout_device with a mesh: the rollout side "
                             "is rollout_mesh")
        if self.role == "rollout":
            return (params if params is not None
                    else M.init_params(self.cfg, device="meta"))
        if params is None:
            return shd.init_sharded_params(self.cfg, self.train_mesh,
                                           seed=self.tcfg.seed)
        return shd.shard_params(params, self.train_mesh, self.cfg)

    # ------------------------------------------------------------------
    # rollout production (caller thread when sequential, producer thread
    # when overlapped — never both in a given mode, but a caller may split
    # the key while a producer is mid-collect, so the split-and-advance is
    # guarded)
    # ------------------------------------------------------------------
    def _next_rollout_key(self):
        with self._progress:
            self.key, k = prng.split(self.key)
        return k

    def _collect_stage(self, params, version: int, idx: int) -> _StageBatch:
        k_roll = self._next_rollout_key()
        with span("trainer.collect"):
            groups, roll_stats = self.engine.collect(
                params, version, k_roll,
                target_concurrency=self._concurrency_target)
        return _StageBatch(collect_idx=idx, params_version=version,
                           groups=groups, roll_stats=roll_stats)

    def _producer_loop(self):
        try:
            while not self._stop.is_set():
                # staleness gate: collect ``idx`` trains as the ``idx``-th
                # consumed batch, so its params snapshot may lag the
                # training stage by at most max_staleness updates
                with self._progress:
                    idx = self._collect_idx
                    while (self._trained_batches < idx - self.max_staleness
                           and not self._stop.is_set()):
                        self._progress.wait(timeout=0.1)
                if self._stop.is_set():
                    return
                # freshest published version, fenced for the rollout stream;
                # the collect (the bf16 cast of prepare_params included)
                # runs on that stream
                with _on(self.rollout_stream):
                    params, version = self.param_store.acquire()
                    item = self._collect_stage(params, version, idx)
                del params       # a dropped version is freed while we wait
                with self._progress:
                    self._collect_idx = idx + 1
                while not self._stop.is_set():
                    try:
                        self._batches.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except Exception as e:               # surfaced by _next_batch
            self._producer_exc = e

    def _ensure_producer(self):
        if self._closed:
            raise RuntimeError("trainer is closed")
        if self._producer is None:
            self._producer = threading.Thread(target=self._producer_loop,
                                              name="copris-rollout",
                                              daemon=True)
            self._producer.start()

    def _next_batch(self) -> _StageBatch:
        deadline = (None if self.batch_timeout is None
                    else time.perf_counter() + self.batch_timeout)
        while True:
            try:
                return self._batches.get(timeout=0.2)
            except queue.Empty:
                pass
            if self._producer_exc is not None:
                raise RuntimeError("rollout producer failed") \
                    from self._producer_exc
            if self._producer is not None and not self._producer.is_alive():
                raise RuntimeError("rollout producer exited without a batch")
            if deadline is not None and time.perf_counter() > deadline:
                raise TimeoutError(
                    f"no rollout batch within {self.batch_timeout}s — "
                    "overlapped pipeline wedged?")

    # ------------------------------------------------------------------
    def step(self) -> dict:
        """One training step. Sequential mode collects inline; overlapped
        mode consumes the producer's next batch (collected under params up
        to ``max_staleness`` updates behind the ones being trained)."""
        if self._closed:
            raise RuntimeError("trainer is closed")
        with span("trainer.step"):
            if self._first_stage is None:
                self._first_stage = self.stage
            if self.role == "rollout":
                return self._rollout_step()
            t0 = time.perf_counter()
            if self.role == "train":
                item = self._link.recv(_SideLink.BATCH)
            elif self.overlap:
                self._ensure_producer()
                item = self._next_batch()
            else:
                # same handoff as the producer thread: freshest published
                # version — identical to (self.params, self.stage) here, since
                # the sequential consumer is the only publisher
                params, version = self.param_store.acquire()
                with self._progress:
                    idx = self._collect_idx
                item = self._collect_stage(params, version, idx)
                with self._progress:
                    self._collect_idx += 1
            t_collected = time.perf_counter()
            with _on(self.train_stream):
                out = self._train_on(item, t0, t_collected)
            self.history.append(out)
            return out

    def _batch_tensors(self, batch):
        """The packed batch on the train device (on a mesh, its rows over
        the batch axes: ``sharding.shard_batch``)."""
        dev = self.device
        tb = {k: torch.from_numpy(batch[k]).to(dev)
              for k in ("tokens", "loss_mask", "behaviour_logp")}
        tb["advantages"] = grpo.group_advantages(
            torch.from_numpy(batch["rewards"]).to(dev), self.ro.group_size)
        if self.train_mesh is None:
            return tb
        from repro_torch.launch.sharding import shard_batch
        return shard_batch(tb, self.train_mesh)

    def _rollout_step(self) -> dict:
        """The rollout side's ``step``: the next collect, under the
        freshest version that has landed once the staleness gate's
        version has (collect ``idx`` trains as the ``idx``-th batch, so
        it waits for the version published after ``idx - max_staleness``
        updates), sent to the train side with its rewards resolved; then
        the receive of the version the train side publishes after
        training on it is posted. Returns the collect's stats."""
        with self._progress:
            idx = self._collect_idx
        if self._targets is not None:
            # the target the train side sets after training this collect
            self._targets.post(idx)
        self.param_store.wait_for(self._first_stage + idx
                                  - self.max_staleness)
        if self._targets is not None:
            # the gate's version was published after the target of update
            # idx - max_staleness - 1 was sent: waiting for that target
            # costs nothing and bounds its age as the reference's gate does
            self._concurrency_target = self._targets.take(
                idx - self.max_staleness - 1, self._concurrency_target)
        params, version = self.param_store.acquire()
        item = self._collect_stage(params, version, idx)
        del params
        self._settle(item)
        ps = self.param_store.stats_snapshot()
        item.store = dict(
            versions=self.param_store.num_versions,
            dropped=ps["dropped"] - self._reported["dropped"],
            reshard_time=ps["reshard_time"] - self._reported["reshard_time"])
        self._reported = ps
        self._link.send(dataclasses.replace(item, groups=[]),
                        _SideLink.BATCH)
        self.stage += 1
        self.param_store.expect(self.stage)
        with self._progress:
            self._collect_idx = idx + 1
        self.last_groups, self.last_batch = item.groups, item.batch
        out = dict(collect_idx=idx, params_version=version,
                   reward_time=item.reward_time,
                   mean_resp_len=item.mean_resp_len,
                   param_store_versions=item.store["versions"],
                   rollout_reshard_time=item.store["reshard_time"],
                   **{k: v for k, v in item.roll_stats.items()
                      if isinstance(v, (int, float))})
        self.history.append(out)
        return out

    def _settle(self, item: _StageBatch):
        """Resolve the rewards of a collected stage and pack it."""
        # rewards were computed asynchronously during rollout; gather
        # resolves any stragglers and runs on the CONSUMER thread, so the
        # producer keeps submitting stage k+1 rewards while stage k gathers
        with span("trainer.settle"):
            self.reward_worker.gather(item.groups)
            item.reward_time = self.reward_worker.last_gather_time
            item.batch = pack_groups(item.groups, max_len=self.engine.max_len)
            item.mean_resp_len = float(np.mean([
                len(t.response_tokens) for g in item.groups
                for t in g.trajectories]))
            item.env_timeouts = (
                self.env_worker.stats_snapshot()["env_timeouts"]
                if self.env_worker is not None else 0)

    def _train_on(self, item: _StageBatch, t0: float,
                  t_collected: float) -> dict:
        groups, roll_stats = item.groups, item.roll_stats
        if item.batch is None:
            self._settle(item)
        t_reward = time.perf_counter()

        train_stage = self.stage
        batch = item.batch
        lr = schedule.warmup_constant(train_stage, lr=self.tcfg.lr,
                                      warmup_steps=self.tcfg.warmup_steps)
        with activation_mesh(self.train_mesh), span("trainer.update"):
            self.params, self.opt_state, metrics = self._train_step(
                self.params, self.opt_state, self._batch_tensors(batch), lr)
        # publish the update as a new version for the producer, then wake
        # its staleness gate. Only the consumer thread mutates
        # params/opt_state/stage; the producer reads exclusively through
        # the store (fenced copies), so no lock is needed around them.
        self.stage = train_stage + 1
        if self._targets is not None:
            # across two sides the update's target leaves before its
            # version (the rollout side's gate bounds the target's age by
            # it), so train_time ends with the update, before the publish
            self._observe(roll_stats, self._synced() - t_collected)
        with span("trainer.publish"):
            self.param_store.publish(self.params, self.stage)
        with self._progress:
            self._trained_batches += 1
            self._progress.notify_all()
        # kernels run asynchronously: wait for the update (this stream only,
        # never the rollout's) before stamping t_end, so update_time covers
        # the update's device work and nothing of the rollout's
        t_end = self._synced()

        # staleness relative to the CONSUMING training stage
        stages_arr = batch["stage_ids"]
        resp = stages_arr >= 0
        n_resp = int(resp.sum())
        gaps = (train_stage - stages_arr)[resp]
        staleness_hist = {int(g): int(c) for g, c in
                          zip(*np.unique(gaps, return_counts=True))}
        off_tokens = int((gaps > 0).sum())

        out = {k: float(v) for k, v in metrics.items()}
        # ONE consistent counter snapshot for both the reported delta and
        # the new reported total
        ps_stats = self.param_store.stats_snapshot()
        rollout_time = roll_stats["wall_time"]
        update_time = t_end - t_reward
        reward_time = item.reward_time
        step_time = t_end - t0
        # the versions held are the rollout side's, where that is another
        # process
        store = item.store or dict(
            versions=self.param_store.num_versions,
            dropped=ps_stats["dropped"] - self._reported["dropped"])
        if self._targets is None:
            self._observe(roll_stats, t_end - t_collected)
        out.update(
            step=train_stage,
            reward_mean=float(batch["rewards"].mean()),
            reward_std=float(batch["rewards"].std()),
            rollout_time=rollout_time,
            reward_time=reward_time,
            update_time=update_time,
            host_syncs=roll_stats["host_syncs"],
            step_time=step_time,
            off_policy_frac=off_tokens / max(1, n_resp),
            staleness_hist=staleness_hist,
            # optimizer updates between the batch's rollout params and the
            # params trained on it: 0 sequentially, <= max_staleness overlapped
            param_staleness=train_stage - item.params_version,
            batch_wait_time=(t_collected - t0 if self.overlap else 0.0),
            # what the sequential pipeline would have paid on top of this
            # step's wall-clock (rollout ran concurrently with the previous
            # train step)
            overlap_saved_time=(max(0.0, rollout_time + reward_time
                                    + update_time - step_time)
                                if self.overlap else 0.0),
            multi_stage_trajs=roll_stats["multi_stage_trajs"],
            utilization=roll_stats["utilization"],
            buffer_unfinished=roll_stats["buffer_unfinished"],
            concurrency_target=roll_stats["concurrency_target"],
            param_store_versions=store["versions"],
            dropped_versions=store["dropped"],
            reshard_time=(ps_stats["reshard_time"]
                          - self._reported["reshard_time"]),
            mean_resp_len=item.mean_resp_len,
            # multi-turn environment accounting (all 0 for single-turn)
            env_steps=roll_stats["env_steps"],
            env_turns=roll_stats["env_turns"],
            env_failures=roll_stats["env_failures"],
            env_wait_time=roll_stats["env_wait_time"],
            env_timeouts=item.env_timeouts,
        )
        if item.store:
            # the seconds the rollout side spent placing landed versions
            out["rollout_reshard_time"] = item.store["reshard_time"]
        self._reported = ps_stats
        self.last_groups = groups
        self.last_batch = batch
        return out

    def _synced(self) -> float:
        """The host clock once this stream's queued work is done."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return time.perf_counter()

    def _observe(self, roll_stats, train_time: float):
        """Feed one trained stage to the adaptive N' controller (where this
        rank owns one): the collect's wall time and evictions against the
        consumer work it overlapped. The producer picks the new target up
        at its NEXT collect start (across two sides: it is sent there), so
        concurrency adjusts between stages, never inside one."""
        if self._concurrency_ctrl is None:
            return
        self._concurrency_target = self._concurrency_ctrl.observe(
            rollout_time=roll_stats["wall_time"], train_time=train_time,
            evicted=roll_stats["evicted"])
        if self._targets is not None:
            self._targets.send(self._concurrency_target)

    # ------------------------------------------------------------------
    def restore(self, *, params=None, opt_state=None, stage=None):
        """Resume from checkpoint state: copy the given values into the
        trainer's tensors and republish through the ParamStore, so the
        rollout side acquires the restored weights. Must be called before
        the first ``step()``. Across two sides every rank calls it: the
        train side republishes, the rollout side receives that version
        (its ``params`` and ``opt_state`` are not used there)."""
        if self._producer is not None or (self.role is not None
                                          and self._first_stage is not None):
            raise RuntimeError("restore() after the first step() — "
                               "restore before it")
        if self.role == "rollout":
            if stage is not None:
                self._check_restore_stage(stage)
                self.stage = stage
            self.param_store.expect(self.stage, replace=True)
            return
        with _on(self.train_stream), torch.no_grad():
            if params is not None:
                for dst, src in zip(leaves(self.params), leaves(params)):
                    dst.copy_(_into(dst, src))
            if opt_state is not None:
                for name in ("m", "v", "step"):
                    for dst, src in zip(leaves(self.opt_state[name]),
                                        leaves(opt_state[name])):
                        dst.copy_(_into(dst, src))
            if stage is not None:
                self._check_restore_stage(stage)
                self.stage = stage
            self.param_store.publish(self.params, self.stage, replace=True)

    def _check_restore_stage(self, stage):
        if stage < self.stage:
            raise ValueError(
                f"restore to stage {stage} < current {self.stage}: "
                "ParamStore versions are strictly monotonic — build "
                "a fresh trainer to rewind")

    # ------------------------------------------------------------------
    def close(self):
        """Stop the producer thread, the reward pool and the env pool, and
        wait for both streams' queued work. Across two sides the rollout
        side first waits for its batches' sends and for every version it
        posted a receive for (the train side publishes one a step, so the
        sides end matched); with adaptive N' the train side waits for its
        targets' sends and the rollout side for the target of every update
        it posted a receive for (one a step). Idempotent."""
        if self._closed:
            return
        self._closed = True
        if self.role == "rollout":
            self._link.close()
            self.param_store.drain()
        if self._targets is not None:
            self._targets.close()
        self._stop.set()
        with self._progress:
            self._progress.notify_all()
        if self._producer is not None:
            # drain so a blocked put() observes the stop flag
            while self._producer.is_alive():
                try:
                    self._batches.get_nowait()
                except queue.Empty:
                    pass
                self._producer.join(timeout=0.2)
        while True:                    # batches nobody will train on
            try:
                self._batches.get_nowait()
            except queue.Empty:
                break
        if self.reward_worker is not None:
            self.reward_worker.shutdown()
        if self.env_worker is not None:
            self.env_worker.shutdown()
        for stream in (self.rollout_stream, self.train_stream):
            if stream is not None:
                stream.synchronize()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ------------------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, n_prompts: int = 32) -> float:
        """Greedy accuracy on fresh task prompts (exact reward), on the
        caller's stream, through ``safe_task`` (the producer may be
        sampling prompts meanwhile). Across two sides every rank calls it:
        the rollout side evaluates the freshest version that has landed,
        and its first rank sends the value to the train side."""
        if self.role == "train":
            return self._link.recv(_SideLink.EVAL)
        value = self._evaluate(n_prompts)
        if self.role == "rollout":
            self._link.send(value, _SideLink.EVAL)
        return value

    def _evaluate(self, n_prompts):
        eos_id = self.engine.eos_id
        # evaluate is a rollout-side consumer: freshest published version
        params, _ = self.param_store.acquire()
        params = self.engine.prepare_params(params)
        dev, mesh = self.rollout_device, self.rollout_mesh

        def put(values):            # replicated on the mesh, if any
            return on_mesh(torch.tensor(values, dtype=torch.int32,
                                        device=dev), mesh)

        correct = 0.0
        for _ in range(n_prompts):
            cache = M.init_cache(self.cfg, 1, self.engine.max_len,
                                 device=dev, mesh=mesh)
            prompt, answer = self.safe_task.sample_prompt()
            L = len(prompt)
            pad = np.zeros(-(-L // 16) * 16, np.int32)
            pad[:L] = prompt
            logits, cache = M.prefill(params, self.cfg, put(pad[None]),
                                      put([L]), cache)
            toks, cl = [], L
            tok = int(to_host(logits)[0].argmax())
            for _ in range(32):
                toks.append(tok)
                if tok == eos_id:
                    break
                lg, cache = M.decode_step(params, self.cfg, put([tok]),
                                          cache, put([cl]))
                cl += 1
                tok = int(to_host(lg)[0].argmax())
            correct += self.task.reward(toks, answer)
        return correct / n_prompts
