"""Batched serving front end: the CoPRIS slot engine running pure inference
(concurrency-controlled continuous batching, no training), on the GPU.

Typed request/result API: callers build :class:`GenerateRequest` objects,
:meth:`ServeEngine.submit` queues them, and :meth:`ServeEngine.step` advances
the engine by one decode chunk — returning any newly finished
:class:`GenerateResult` — so the caller interleaves its own work (new
submissions, streaming partial tokens via :meth:`ServeEngine.peek`) without
owning the loop.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --requests 12 --concurrency 4 --max-tokens 32

``--arch`` takes every registered architecture: the dense ones, the
mixtures of experts, the VLM llama-3.2-vision-90b (served with random media
embeddings), the hybrid hymba-1.5b and the attention-free rwkv6-1.6b (no
K/V: over ``--kv-backend paged`` it keeps the page accounting and per-slot
state).

Weights are random, made from ``--seed``. ``--smoke`` selects the reduced
config; ``--device cpu`` runs the plain PyTorch path on the host;
``--kv-backend paged`` serves over the paged KV cache (``--kv-page-size``
tokens a page, ``--kv-num-pages`` pages; 0 = the dense-equivalent count);
``--num-layers`` serves fewer layers at the published widths (a model
whose weights do not fit the card: qwen3-moe-235b-a22b at 8 of its 94
layers, llama-3.2-vision-90b at 10 of its 100).

On a mesh of cards, one process a card under ``torchrun``, every arch:
the weights tensor-parallel over "model" (made already sharded: heads,
channels, experts), the slot cache over the batch axes and over the kv
heads or, where they do not divide "model", over its length (with one
slot, ``--concurrency 1``, the length over "data" too: ``shard_seq``),
the recurrent state over its heads or channels; on the GQA serve mesh
(``--mesh D,G,M``) the heads over "kvg" and the cache length over
"model". Every rank runs the engine in lockstep and rank 0 prints:

    torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --arch llama3.2-1b --mesh 2,2
    torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --arch tiny --device cpu --mesh 1,4        # gloo, 4 CPU ranks
    torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --arch hymba-1.5b --smoke --device cpu --mesh 2,2
    torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --arch tiny --device cpu --mesh 1,2,2      # the GQA serve mesh
"""
from __future__ import annotations

import argparse
import dataclasses
import threading
import time
from collections import deque
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.common.config import ModelConfig, RolloutConfig
from repro_torch.common.device import resolve_device, torch_dtype
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.rollout import RolloutEngine
from repro_torch.models import model as M
from repro_torch.sampling import prng


@dataclasses.dataclass
class GenerateRequest:
    """One generation request. Sampling knobs (temperature/top_p/top_k) and
    the response-length cap are engine-level — every request in a batch
    shares the decode step."""
    prompt: Sequence[int]
    request_id: Optional[int] = None   # assigned by submit() when None


@dataclasses.dataclass
class GenerateResult:
    request_id: int
    prompt_tokens: List[int]
    tokens: List[int]
    logprobs: List[float]
    finish_reason: str                 # "eos" | "length"


class ServeEngine:
    """Incremental serving facade over :class:`RolloutEngine`.

    Each request is its own GRPO "group" of size 1; the request queue acts
    as the engine's prompt source (declining — returning None — when empty,
    which leaves slots idle rather than blocking). The underlying stage
    stays open across :meth:`step` calls: ``submit`` raises the scheduler's
    completion target, so newly queued requests are admitted at the next
    chunk boundary — continuous batching at the request level. The weights
    are cast to the model's compute dtype once, here.
    """

    def __init__(self, model_cfg: ModelConfig, ro_cfg: RolloutConfig, *,
                 eos_id: int, params, key, media=None, device=None,
                 mesh=None):
        if ro_cfg.group_size != 1:
            raise ValueError("serving: one trajectory per request "
                             "(group_size=1)")
        if ro_cfg.mode != "copris":
            raise ValueError("serving rides the copris refill scheduler")
        # submit() may be called from a different thread than the step()
        # caller: the lock guards the request queue, id counter, and
        # stage-target bumps
        self._lock = threading.Lock()
        self._queue = deque()          # (request_id, prompt) FIFO
        self._next_id = 0
        self._submitted = 0            # total requests ever submitted
        self._finished = 0             # total results returned by step()
        self._harvested = 0            # prefix of sched.completed consumed
        self._key = key
        self.eng = RolloutEngine(model_cfg, ro_cfg, self._next_prompt,
                                 eos_id=eos_id, media=media, device=device,
                                 mesh=mesh)
        self._params = self.eng.prepare_params(params)
        self._sched = None

    @property
    def params(self):
        """The weights being served (compute dtype, on the engine's device)."""
        return self._params

    # -- prompt source (engine callback) --------------------------------
    def _next_prompt(self):
        with self._lock:
            if not self._queue:
                return None            # decline: leave the slot idle
            rid, prompt = self._queue.popleft()
        return prompt, rid             # request id rides the answer field

    # -- public API ------------------------------------------------------
    def submit(self, req: GenerateRequest) -> int:
        """Queue a request; returns its id. Admitted at the next step().
        Thread-safe: may be called while another thread drives step()."""
        prompt = np.asarray(req.prompt, np.int32)
        with self._lock:
            rid = req.request_id
            if rid is None:
                rid = self._next_id
                self._next_id += 1
            self._queue.append((rid, prompt))
            self._submitted += 1
            if self._sched is not None:
                self._sched.target_batch += 1
        return rid

    @property
    def pending(self) -> int:
        """Requests submitted but not yet returned by step()."""
        return self._submitted - self._finished

    def step(self) -> List[GenerateResult]:
        """Advance one decode chunk; returns requests that finished during
        it. An idle engine with an empty queue returns [] immediately."""
        if self._sched is None:
            if not self.pending:
                return []
            # open (or reopen after close()) a stage; evicted partials and
            # unconsumed completions resume from the engine buffer, so the
            # stage target is exactly the unserved request count
            self._harvested = 0
            sched = self.eng.begin_stage(self._params, 0, self._key)
            with self._lock:
                # publish the stage and seed its target atomically, so a
                # concurrent submit() either lands in `pending` here or
                # bumps target_batch itself — never both, never neither
                self._sched = sched
                self._sched.target_batch = self.pending
        else:
            self.eng.step_stage(self._params, self._key, admit_idle=True)
        done = self._sched.completed[self._harvested:]
        self._harvested += len(done)
        self._finished += len(done)
        return [self._result(g) for g in done]

    def peek(self, request_id: int) -> Optional[List[int]]:
        """Tokens generated so far for an in-flight request (streaming
        view); None if the request is unknown or not yet admitted."""
        for g in self.eng.buffer.groups():
            if g.answer == request_id and g.trajectories:
                return list(g.trajectories[0].response_tokens)
        return None

    def drain(self) -> List[GenerateResult]:
        """Step until every submitted request has finished."""
        out = []
        while self.pending:
            out.extend(self.step())
        return out

    def close(self) -> dict:
        """End the stage and return the engine's rollout stats. In-flight
        requests are evicted to the engine buffer and resume when a later
        submit()/step() reopens a stage; completions not yet returned stay
        buffered the same way (call :meth:`drain` first to receive them)."""
        if self._sched is None:
            return {}
        # hand completions step() has not returned back to the buffer
        # (end_stage would otherwise consume them as a training batch)
        for g in self._sched.completed[self._harvested:]:
            self.eng.buffer.add_group(g)
        del self._sched.completed[:]
        self._harvested = 0
        _, stats = self.eng.end_stage()
        with self._lock:
            self._sched = None    # submits from here queue for a new stage
        return stats

    def _result(self, group) -> GenerateResult:
        t = group.trajectories[0]
        return GenerateResult(
            request_id=group.answer,
            prompt_tokens=list(map(int, t.prompt_tokens)),
            tokens=list(map(int, t.response_tokens)),
            logprobs=list(map(float, t.behaviour_logps)),
            finish_reason=t.finish_reason)


def make_serve_engine(arch: str = "tiny", *, smoke: bool = False,
                      max_prompt_len: int = 8, max_tokens: int = 32,
                      concurrency: int = 4, temperature: float = 0.8,
                      top_p: float = 1.0, top_k: int = -1,
                      kv_backend: str = "dense", kv_page_size: int = 16,
                      kv_num_pages: int = 0, seed: int = 0, device=None,
                      num_layers: int = 0, mesh=None):
    """Build a ready ServeEngine with random weights made from ``seed``,
    and for a media model its media, as the reference makes them: a numpy
    ``default_rng(seed)`` normal of shape (M, d_media) times 0.1, the same
    for every request. Runs on the GPU unless ``device='cpu'``.
    ``num_layers`` > 0 keeps that many layers of the config at its widths
    (a model whose weights do not fit the card, served at reduced depth):
    the prefix and whole repeats of ``block_pattern``. ``mesh`` (a
    ("data", "model") ``DeviceMesh`` or the GQA serve mesh; every rank
    calls this alike) serves sharded: the same weights and media, the
    weights made already in the serve layout."""
    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if num_layers > 0:
        body = num_layers - len(cfg.prefix_pattern)
        if body <= 0 or body % len(cfg.block_pattern):
            raise ValueError(
                f"num_layers={num_layers}: {cfg.name} needs its "
                f"{len(cfg.prefix_pattern)} prefix layers and whole repeats "
                f"of its {len(cfg.block_pattern)}-layer block pattern")
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    rng = np.random.default_rng(seed)
    media = None
    if cfg.uses_media:
        xa = cfg.cross_attn
        media = rng.normal(size=(xa.num_media_tokens, xa.d_media)).astype(
            np.float32) * 0.1
    ro = RolloutConfig(batch_size=1, group_size=1,
                       max_prompt_len=max_prompt_len,
                       max_response_len=max_tokens, concurrency=concurrency,
                       mode="copris", temperature=temperature, top_p=top_p,
                       top_k=top_k, kv_backend=kv_backend,
                       kv_page_size=kv_page_size, kv_num_pages=kv_num_pages)
    # the weights as the engine reads them, cast layer by layer: a model
    # whose float32 weights do not fit the card is served all the same
    if mesh is None:
        params = M.init_params(cfg, seed=seed, device=dev,
                               compute_dtype=torch_dtype(cfg.dtype))
    else:
        from repro_torch.launch.sharding import init_sharded_params
        params = init_sharded_params(cfg, mesh, seed=seed, serve=True,
                                     compute_dtype=torch_dtype(cfg.dtype))
    return ServeEngine(cfg, ro, eos_id=cfg.vocab_size - 1, params=params,
                       key=prng.PRNGKey(seed + 1), media=media,
                       device=dev, mesh=mesh), cfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tiny",
                    help="a registered architecture (repro_torch.configs), "
                         "e.g. llama3.2-1b, hymba-1.5b, rwkv6-1.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--concurrency", type=int, default=4)
    ap.add_argument("--max-tokens", type=int, default=32)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--kv-backend", default="dense",
                    choices=("dense", "paged"))
    ap.add_argument("--kv-page-size", type=int, default=16)
    ap.add_argument("--kv-num-pages", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num-layers", type=int, default=0,
                    help="serve this many layers of the config at its "
                         "widths (0: all): the prefix and whole repeats "
                         "of its block pattern")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--mesh", default=None,
                    help="DATA,MODEL, or DATA,KVG,MODEL for the GQA serve "
                         "mesh: serve sharded over the ranks of torchrun "
                         "(NCCL on cards, gloo with --device cpu)")
    args = ap.parse_args(argv)

    mesh = None
    if args.mesh is not None:
        from repro_torch.launch.multihost import mesh_from_args
        mesh = mesh_from_args(args.mesh, resolve_device(args.device).type)
        if mesh is None:
            return 2
    serve, cfg = make_serve_engine(
        args.arch, smoke=args.smoke, max_prompt_len=args.prompt_len,
        max_tokens=args.max_tokens, concurrency=args.concurrency,
        temperature=args.temperature, kv_backend=args.kv_backend,
        kv_page_size=args.kv_page_size, kv_num_pages=args.kv_num_pages,
        seed=args.seed, device=args.device, num_layers=args.num_layers,
        mesh=mesh)
    # on a mesh every rank serves alike; rank 0 prints
    say = print if mesh is None or mesh.get_rank() == 0 else _quiet
    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        serve.submit(GenerateRequest(
            prompt=rng.integers(0, cfg.vocab_size, args.prompt_len)))

    served = []
    t0 = time.perf_counter()
    while serve.pending:
        for r in serve.step():
            served.append(r)
            say(f"req {r.request_id:3d}: prompt={r.prompt_tokens[:6]}… "
                f"-> {len(r.tokens)} tokens ({r.finish_reason})")
    serve.eng.block_until_ready()
    dt = time.perf_counter() - t0
    stats = serve.close()
    tok = sum(len(r.tokens) for r in served)
    extra = ""
    if args.kv_backend == "paged":
        b = serve.eng.backend
        extra = (f", prefill rows {stats['prefill_rows']}"
                 f" blocked {stats['admission_blocked']}"
                 f" preempted {stats['page_preemptions']}"
                 f" pages allocated {b.pages_allocated}"
                 f" cow copies {b.cow_copies}")
    where = ("" if mesh is None else
             f", mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    say(f"\nserved {len(served)} requests, {tok} tokens in {dt:.2f}s "
        f"({tok/dt:.1f} tok/s, slot utilization "
        f"{stats['utilization']:.2f}, pool={serve.eng.pool}, "
        f"kv={args.kv_backend}{extra}, device={serve.eng.device}{where})")
    return 0


def _quiet(*_):
    pass


if __name__ == "__main__":
    code = main()
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    raise SystemExit(code)
