#!/usr/bin/env python3
"""On-GPU smoke run of the PyTorch port (src/repro_torch): the serving path
and the CoPRIS training loop at the full width of llama3.2-1b, over the dense
and the paged KV cache, sequential and overlapped (rollout on its own CUDA
stream), with single-turn tasks and multi-turn environments, serving,
rollouts and training of the hybrid hymba-1.5b and the attention-free
rwkv6-1.6b at full width, the archs with wide heads (head_dim 128 and 256,
any GQA ratio): the paper's own paper-qwen-7b, gemma2-2b, qwen3-14b and
granite-34b, with musicgen-medium, and the mixtures of experts
deepseek-moe-16b and qwen3-moe-235b-a22b and the VLM llama-3.2-vision-90b
(cross-attention to 1601 media tokens), the sharded update on
torch.distributed (a (1, 1) mesh over NCCL, the expert-parallel MoE
dispatch, the torchrun launcher), the disaggregated trainer in one
process and with train and rollout on meshes of their own in two, through
the port's hand-written kernels.

    python3 chip_smoke.py          # from the root of a checkout, one GPU
    python3 chip_smoke.py --ab DIR # llama3.2-1b's attention and loss
                                   # kernels (and their SASS), sampling,
                                   # the selective scan and WKV6 (decode,
                                   # prefill and backward; the scan
                                   # libraries' SASS) against the checkout
                                   # at DIR, and the sweep of the sampling
                                   # kernel's cluster sizes

Phases, each printed as one JSON line (with ``t_s``, the seconds since the
start):

1. device  — the card's name and power limit (nvidia-smi);
2. build   — nvcc builds every kernel source from csrc/, in parallel;
   then "pal205": PAL205 of ``repro_torch.analysis.irlint`` on the card,
   each built library's kernels (ptxas's static shared memory,
   registers, spill bytes from the build log) against this card's limits
   (``torch.cuda.get_device_properties``), failing over them; then
   "warm_flex": a subprocess started beside the build, on the cores it
   leaves idle, has compiled the flex_attention library calls of
   gemma2-2b's checks (their kernels cached under build/ for the checks
   below) and is waited for; cuobjdump counts the HGMMA (wgmma) instructions of the two flash
   libraries and of the loss library (its bf16 forward, dl, dh and dw
   kernels), which must have some; ptxas's registers and spills of the
   tensor-core kernels (every kernel named ``*_tc``) and of the scan
   kernels, forward (the prefill kernels that store the backward's
   boundary states too) and backward (with their shared memory);
3. kernel checks — each kernel against its plain PyTorch version at the
   main paths' shapes (serving: prefill, dense and paged decode and
   sampling; the dense decode's lse and float32 output, and its length
   split for sharded serving: 2 and 4 slices launched with their start,
   merged by the log-sum-exp rule, against the whole cache at llama's and
   granite-34b's shapes; each also at the hybrid paths' shapes, hymba's H/KV = 5 and
   window and the vocabularies of 32001 and 65536; the selective scan and
   WKV6 at their decode and prefill shapes, plus the JAX kernel tests'
   cases, each scan's decode kernel beside its prefill kernel at T = 1,
   the selective scan bounded by the largest of its bytes, its FMA-pipe
   operations and its exponentials on the MUFU pipe; the scans' backward
   kernels at the JAX kernel tests' f32 cases and at the hybrid updates'
   shape, bf16 (32 rows of 127 steps), as autograd runs them: reading the
   boundary states their forward kernel stored, bit-equal across two
   launches, bounded the same way; the save kernels (the prefill kernels
   that store those states) at the same shape, y and state bit-equal to
   the forward kernel's, y and the last boundary state against the plain
   forward, timed with and without the stores and bounded;
   sampling also as the train phase runs it, T = 1 untruncated, bounded by
   the larger of its bytes and the threefry draws' integer instructions,
   counted from the SASS of the draw probes; training: the
   flash forward with its logsumexp, the flash backward, the fused IS+GRPO
   forward and backward, and the fused log-prob of the legacy loss; the
   first four also at the hybrid updates' shapes: flash at hymba's 25/5
   heads with its window of 1024, the loss at hymba's d 1600 against the
   tied V 32001 and at rwkv6's d 2048 against the untied V 65536; and at
   the shapes of the archs with wide heads and of musicgen-medium: flash
   with lse and its backward at paper-qwen-7b's (28/4 heads of 128: REP
   7), gemma2-2b's (8/4 of 256, softcap 50, window 4096) and
   musicgen-medium's (24/24 of 64) update shapes, prefill at theirs and at
   qwen3-14b's (40/8 of 128) and granite-34b's (48/1 of 128), dense and
   paged decode at REP 7, 2, 5, 48 and 1 (paged bit-equal to dense),
   sampling at V 152064 and 256000, the loss
   at d 3584 / untied V 152064 and d 2304 / tied V 256000 with the logit
   softcap of 30; and at the MoE and VLM archs' shapes: flash with lse
   and its backward at deepseek-moe-16b's update shape (16/16 heads of
   128), prefill at its, qwen3-moe-235b-a22b's (64/4) and
   llama-3.2-vision-90b's (64/8), dense and paged decode at REP 1, 16 and
   8 x 128, sampling at V 102400 and 151936, the loss at d 2048 / untied
   V 102400, and the cross-attention non-causal against 1601 media keys:
   the forward with lse at q (16, 512, 64, 128), the backward at (32, 127)
   rows (bit-equal across launches) and the decode step at Sq = 1, SDPA
   the library call of each; every flash backward bit-equal across two launches,
   within atol 5e-2 of its plain version, or at head_dim 128 and 256
   within one bf16 ulp of the element where that is larger), with
   its time, the plain version's, one library call's where PyTorch has one,
   and the least time the card could take; the flash and decode checks
   also give the library call's error against the same plain version
   (``library_err``, a yardstick of bf16 tensor-core attention) and
   ``vs_library``, their time over its: SDPA's (masked for decode), or
   with gemma2-2b's score softcap, which SDPA has not, a compiled
   flex_attention with the softcap as its score_mod, forward (with the
   logsumexp), backward and decode (SDPA's time without the softcap kept
   beside it); the loss kernels' bounds are their tensor cores' (the
   forwards and dw 2 bf16 passes of 2 R d V, bwd_dh 5), each with the f32
   FMA bound of the same product kept beside it; every decode-shaped check
   prints the timer's floor, a near-empty launch timed the same way;
4. reference — beside these phases (which time nothing) run "multihost"
   (``python -m torch.distributed.run --standalone --nproc-per-node 1 -m
   repro_torch.launch.multihost --arch llama3.2-1b --steps 2``: global
   batch 8 x 512, a (1, 1) mesh over NCCL, its params made by
   sharding.init_sharded_params, a subprocess that must exit 0 with two
   finite losses and rank 0's init peak memory, its line printed after
   them) and the dry run's two subprocesses ("dryrun" below); then
   the GPU engine (kernels, float32) against the same engine on
   the CPU (plain versions) on the reduced config, dense and paged, and the
   CPU paged engine against the CPU dense one: equal tokens; the same as
   "reference_hybrid" on a reduced hymba (5 heads of 64) and the reduced
   rwkv6; then "train_reference": make_loss_fn / make_train_step on the
   reduced config with vocab 8192, the fused loss and the legacy
   fused_loss=False one, GPU against CPU: loss, metrics, every gradient,
   and no attention weight with a zero gradient; the same as
   "train_reference_hybrid" with the fused loss on the reduced hymba and
   rwkv6 (scans forward and backward), no scan parameter (A_log, D, u,
   w_base) with a zero gradient; "reference_wide" and
   "train_reference_wide": the same engine and fused-loss train checks on
   two 2-layer configs with wide heads, paper-qwen-7b's 7/1 heads of 128
   and gemma2-2b's local/global pair with 2/1 heads of 256, both softcaps
   and a window of 32; "reference_moe" and "train_reference_moe": the
   same on reduced deepseek-moe-16b and qwen3-moe-235b-a22b with their
   capacity-bounded dispatch (equal tokens; the router loss GPU against
   CPU; no router and no expert left at a zero gradient; where token
   streams part, the router margin of the token where they do);
   "reference_vlm" and "train_reference_vlm": llama-3.2-vision-90b reduced
   to one period (4 attn, 1 xattn), its gates open, with media in the
   engine's prefills and in mb["media"] (no cross-attention weight, gate
   or mlp_gate left at a zero gradient); then "reference_overlap": the overlapped
   trainer on the GPU (reduced config, vocab 8192, float32) records each
   batch's params version and a sequential CPU trainer replays that
   schedule (each collect takes ``param_store.get(v)``): equal tokens on
   every trajectory, losses and metrics atol 1e-4, grad_norm rtol 1e-5,
   final params atol 1e-4; and "reference_multiturn": MultiTurnMathTask
   episodes on the reduced config (float32, 20 SFT steps) from the same
   weights and key on the GPU dense engine, the GPU paged one (8 pages of
   16: admission blocks and preempts) and the CPU dense one: equal tokens,
   roles and turn starts on common keys, logps within 1e-5;
5. serve   — make_serve_engine("llama3.2-1b") with random bf16 weights made
   from a seed serves 24 requests; every kernel's launch count must be > 0;
   then "profile": first one more steady step whose decode chunk
   (``model.decode_scan``) runs under
   ``torch.cuda.set_sync_debug_mode("error")`` (IR403 on the card: any
   operation inside it that makes the host wait for the card raises),
   then torch.profiler over two steady decode chunks (host time, device
   busy time, the decode attention kernels' time, top device kernels);
   then "serve_paged": the same 24 requests over the paged KV cache with
   40% of the dense-equivalent pages: page pressure (blocked admissions or
   preemptions) and every request returned; then "profile_paged": the
   profile phase's two chunks over the paged cache; then "serve_sharded":
   the same 24 requests at 4 of the 16 layers, unsharded and on a (1, 1)
   NCCL mesh (weights in the serve layout, the cache by cache_placements,
   prefill, decode and sampling on the local shards), bit-equal, every
   kernel launched, its steady-chunk host and device time beside the
   unsharded (its group
   destroyed);
6. copris  — two RolloutEngine.collect stages: the first buffers partials
   (early termination), the second resumes them;
   then "serve_hymba" (8 of its 32 layers), "serve_hymba_paged" (4 of
   its 32 layers, 40% of the pages) and
   "serve_rwkv6" (6 of its 24): 24 requests each at full width, each
   with its profile; then "copris_hybrid": two stages on each family at
   those 8 and 6 layers (hymba resuming from kv_snapshot, rwkv6 by
   re-prefill), evicting and resuming;
7. train   — sft_warmup, then three CoPRISTrainer.step() calls on
   llama3.2-1b at full width (bf16 compute, f32 masters): finite reward,
   loss, grad norm, ratio and off-policy share; rollout, reward and update
   times, resumed partials, peak memory; every kernel launched; then
   "train_profile": torch.profiler over one more update (device busy
   time, top device kernels); then "train_overlap": from the first 8 of
   the 16 layers of the train phase's SFT-warmed weights (kept on the
   host), four overlapped steps
   (overlap=True, max_staleness=1; the producer collects on its own CUDA
   stream, the consumer trains on another): finite metrics,
   param_staleness <= 1 and == 1 at least once, at most 2 ParamStore
   versions, no trained token from a stage newer than its step, every
   kernel launched; rollout, update, batch-wait and overlap-saved times
   and each step's wall time beside the train phase's sequential ones,
   peak memory; then "train_overlap_profile": torch.profiler over one
   more overlapped step: each stream's kernels and busy time and
   ``concurrent_ms``, the device time during which kernels of both
   streams ran at once, and from CUDA events on each stream the update's
   span and the collects', a collect's required to be open during part of
   the update (``update_overlap_ms``); then "train_multiturn": two overlapped steps of
   MultiTurnMathTask(max_value=9, num_turns=2) at full width from the
   same weights, their SFT continued for 8 steps (after 4 no turn ends
   with EOS), max_response_len 64: environment steps and second turns,
   observation positions with loss mask 0, behaviour log-prob 0 and stage
   -1, every kernel launched, env_wait_time and step times; then
   "train_disaggregated": three steps from the same 8 layers with
   overlap=True, disaggregated=True, train and rollout on cuda:0 (every
   version the reshard's copy on a copy stream): the store's freshest
   version equal to the consumer's params bit for bit at every stage,
   reshard_time (the copies' span on their stream) a step and the step
   times beside train_overlap's; then "train_disaggregated_mesh": train
   and rollout on meshes of their own in two processes on the card
   (``chip_smoke.py --two-sided-rank R DIR`` each; rank 0 trains on a
   (1, 1) mesh, rank 1 collects on another, made by
   make_disaggregated_meshes), 4 of the 16 layers of the same weights,
   three steps a side, every version through the cross-mesh transfer on
   a gloo group (pinned host staging), adaptive N' across the two sides:
   each collect within the gate, each acquired version's fingerprints
   equal to the train side's params at its stage, finite losses, each
   side's kernels launched, the controller's trace equal to one fed its
   recorded observations, each collect's target set after an update the
   gate allows, reported as the train side's concurrency_target; the
   transfer's
   bytes and reshard_time on each side, the step, rollout and update
   times beside train_disaggregated's; then
   "train_paged": two CoPRISTrainer.step()
   calls at full width and 8 of the 16 layers over the paged KV cache with half the
   dense-equivalent pages and the legacy fused_loss=False loss: prefix
   sharing, copy-on-write, finite metrics, every kernel of that path
   launched; then "train_hymba" and "train_rwkv6": sft_warmup, then two
   CoPRISTrainer.step() calls on each family at full width (16 and 12
   layers), as "train"
   runs llama: finite metrics, step times, peak memory, every kernel of the
   path launched (the scans' backward kernels, once per layer per update,
   and, for hymba, the flash backward among them), each with the profile
   of one more update;
   then the wide-head archs through the same entry points, one at a time,
   each freed before the next: "serve_qwen7b" (paper-qwen-7b at 7 of
   its 28 layers) and "serve_qwen7b_paged" (4 of its 28 layers, 40% of
   the pages), "copris_qwen7b" (two stages at 7), "train_qwen7b" (4 of
   its 28 layers at full width: SFT, then two steps with the fused loss
   at d 3584 / V 152064), "serve_gemma2" and "train_gemma2" (6 of its 26
   layers: head_dim 256, the softcaps, the local window),
   "serve_qwen3_14b" (10 of its 40 layers, qk_norm),
   "serve_granite" (12 of its 88 layers: the full depth's bf16 weights do
   not fit the card), "serve_musicgen" and "train_musicgen" (12 of its 48
   layers, V 2048: the full-logits loss; one step; these depths keep the
   run under 770 s); then the MoE and VLM archs: "serve_deepseek"
   (deepseek-moe-16b at 7 of its 28 layers) and "serve_deepseek_paged"
   (4 of its 28 layers, 40% of the pages), "copris_deepseek" (two stages
   at 7, evicting and re-prefilling), "train_deepseek" (its dense first layer and two MoE
   layers at full width: SFT, then two steps; ``router_aux`` finite and >
   0 in each), "train_sharded" (two make_train_step updates of
   llama3.2-1b at full width and depth on seeded 32 x 128 batches,
   unsharded and on a (1, 1) ("data", "model") mesh in a NCCL process
   group of world size 1: params, AdamW state and batch as DTensors, the
   flash and loss kernels on the local shards through local_map; each
   leaf's update and AdamW moments within 1e-4 of its largest element,
   loss and grad_norm, the flash and loss kernels launched in the sharded
   run, both runs' update times and peak memory; the group destroyed
   after it), "dryrun" (the dry run, ``repro_torch.launch.dryrun``, in
   two CPU subprocesses started beside the reference phases (which time
   nothing) and done before the serve phases, each with its own
   timeout, their records read here: llama3.2-1b's
   decode_32k and weight sync on a fake 16 x 16 mesh of 256 ranks, both
   records ok with decode_attn charged once a layer; and train_sharded's
   update, two steps on a fake (1, 1) mesh, its kernels' charges equal to
   train_sharded's launches and its peak within 10% of train_sharded's
   measured peak; while they run, the constants the fake branches copy
   held against the built libraries and the card), "copris_sharded" (two
   CoPRISTrainer steps of llama3.2-1b at full width and 4 of its 16
   layers, unsharded and with train_mesh a (1, 1) NCCL
   mesh: sharded init and AdamW state, the sharded update, versions
   resharded to the serve layout, the sharded engine; rollout tokens
   equal at both steps, each leaf's update within 1e-4 of its largest
   element, the kernels launched; step times beside the unsharded ones,
   and the peak memory of init_sharded_params against the whole model
   first; its group destroyed), "train_moe_ep" (the same 1 + 2 layers: make_loss_fn and
   its gradient with dispatch="shardmap" on the (1, 1) mesh, two
   all-to-all exchanges a MoE layer, against "sparse" unsharded from the
   same weights: in bf16 and in float32 loss and metrics within 1e-4 and
   each gradient leaf within 1e-4 of its largest element, every kernel
   launched in bf16), "serve_qwen3_moe" (8 of its 94 layers), "serve_vision"
   (llama-3.2-vision-90b at 10 of its 100 layers, two xattn layers, with
   its 1601 x 7680 media), "grad_vision" (its loss and gradient with
   mb["media"] at one 5-layer period, float32 weights: the non-causal
   flash backward on the path); the train phases with an entropy bonus of
   0.01, so every step has a gradient; each serve phase with its profile,
   each train phase with an update's profile;
then "attribution": the whole run's seconds (the process's start before
   the first stamp, then each line's span since the line before it,
   split into the phase's own timed ``seconds`` and the rest where it
   reports them, and the tail), summing to ``total_s``, with the spans
   added up by kind of phase;
8. kernels — one {"kernels": [...]} line, one row per kernel entry point,
   each with the launches of the path it runs on (train; the rows that
   train_overlap and train_multiturn launch carry their counts under
   ``launches_by_phase``; train_paged for
   the paged decode and the fused log-prob; serve_hymba and serve_rwkv6
   for the two scans, split by T = 1 and T > 1; train_hymba and
   train_rwkv6 for the scans' backward kernels); the sampling row has the
   train configuration's time and bound, as its launches are train's; the
   flash and loss rows count the bf16
   tensor-core kernels' launches and, apart, the f32 SIMT kernels'
   (``simt_launches``: every phase that counts launches runs in bf16 and
   fails on a SIMT launch); those rows also carry the hybrid shapes'
   checks under "train_hybrid", with train_hymba's and train_rwkv6's
   launches, the wide-head checks under "wide_heads", the MoE archs'
   under "moe" and the VLM's (its cross-attention under
   "cross_attention" and "cross_decode") under "vlm", each with the
   launches of the phase that runs its shape (every new phase's counts
   are under ``launches_by_phase``);

then the card's nvidia-smi line and, last, {"ok": true, "device": {...}}.
Any failed check raises, so the run exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor cores
PEAK_F32_FLOPS = 67e12              # H100 SXM float32 outside tensor cores


T0 = time.perf_counter()
# (phase, t_s, the seconds of its own timed section or None), a line each
STAMPS = []


def emit(phase, **kw):
    """One phase's JSON line, with the seconds since the script started."""
    t = time.perf_counter() - T0
    own = kw.get("seconds")
    STAMPS.append((phase, t, own if isinstance(own, float) else None))
    print(json.dumps({"phase": phase, "t_s": t, **kw}), flush=True)


def process_start_s() -> float:
    """Seconds from this process's start to T0 (interpreter start and the
    imports above), from /proc: its start in clock ticks after boot."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19]) / ticks
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - start - (time.perf_counter() - T0))
    except (OSError, ValueError, IndexError):
        return 0.0


def attribution():
    """The whole run's seconds, attributed from the stamps: the process's
    start before T0; then each line's span since the line before it
    (every phase's own setup included), split where the phase reports its
    own timed ``seconds`` into that and the rest (``gap_s``: making and
    freeing models, references, profiles); the tail after the last line.
    The parts sum to ``total_s`` by construction; ``groups`` add the spans
    up by kind of phase ("serve": the serve phases, their profiles and the
    CoPRIS stages)."""
    end = time.perf_counter() - T0
    start = process_start_s()
    parts, prev = [], 0.0
    for phase, t, own in STAMPS:
        span = t - prev
        part = {"phase": phase, "span_s": span}
        if own is not None and own <= span:
            part.update(own_s=own, gap_s=span - own)
        parts.append(part)
        prev = t
    groups = {}
    for p in parts:
        name = p["phase"]
        kind = ("build" if name in ("device", "build", "pal205",
                                    "warm_flex") else
                "kernel_checks" if name.startswith("check_") else
                "references" if "reference" in name else
                "sharded" if ("sharded" in name or name in (
                    "multihost", "dryrun", "train_moe_ep",
                    "train_disaggregated_mesh")) else
                "train" if name.startswith(("train", "grad")) else
                "serve")
        groups[kind] = groups.get(kind, 0.0) + p["span_s"]
    tail = end - prev
    total = start + end
    return dict(total_s=total, process_start_s=start, tail_s=tail,
                groups=groups, parts=parts,
                sum_s=start + sum(p["span_s"] for p in parts) + tail)


def fail(msg):
    raise SystemExit(f"chip_smoke: {msg}")


class Background:
    """A subprocess of this checkout started now, its output read by a
    thread, so that it runs beside the phases that follow; ``finish()``
    waits for it until ``timeout`` seconds after its start (then kills it)
    and returns ``(returncode, stdout, stderr)``, or None if it timed
    out; ``seconds`` is its run time."""

    def __init__(self, argv, timeout):
        self.t0, self.timeout = time.perf_counter(), timeout
        self.proc = subprocess.Popen(
            [sys.executable, *argv], cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.out, self.seconds = None, None
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def _read(self):
        out, err = self.proc.communicate()
        self.seconds = time.perf_counter() - self.t0
        self.out = (self.proc.returncode, out, err)

    def finish(self):
        self.thread.join(max(0.0, self.timeout
                             - (time.perf_counter() - self.t0)))
        if self.thread.is_alive():
            self.proc.kill()
            self.thread.join()
            return None
        return self.out


def bound(nbytes, flops, peak_flops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cost_bound(cost, peak_flops, extra_bytes=0):
    """:func:`bound` of a kernel's work as its wrapper's ``*_cost`` formula
    gives it ((FLOPs, bytes): the one the dry run charges), with
    ``extra_bytes`` more read."""
    flops, nbytes = cost
    return bound(nbytes + extra_bytes, flops, peak_flops)


class Timer:
    """Median device time of a callable, one CUDA-event pair per call, with
    the L2 cache flushed (a 64 MB write) before every call, so inputs come
    from device memory as they do on the main path. After the flush the
    device spins for ~1 ms (``torch.cuda._sleep``), so the host has
    enqueued the first event and the call before the first event fires:
    the pair brackets the device's work, not the Python wrapper's (the
    profile phases report the host time of the decode path)."""

    BUSY_CYCLES = 2_000_000

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(64 << 20, dtype=torch.uint8,
                                     device="cuda")
        # the timer's floor: one launch that does next to nothing (a
        # one-element fill), timed as every kernel is
        one = torch.empty(1, device="cuda")
        self.floor_ms = self(one.zero_)

    def __call__(self, fn, iters=10, warmup=2):
        torch = self.torch
        for _ in range(warmup):
            fn()
        ts = []
        for _ in range(iters):
            self.flush_buf.zero_()
            torch.cuda._sleep(self.BUSY_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        return statistics.median(ts)


def check_decode(torch, F, timer, decode_attn):
    B, L, H, KV, hd = 16, 640, 32, 8, 64       # serve pool, max_len 640
    g = torch.Generator(device="cuda").manual_seed(11)
    q = torch.randn(B, 1, H, hd, device="cuda", generator=g).bfloat16()
    kc = torch.randn(B, L, KV, hd, device="cuda", generator=g).bfloat16()
    vc = torch.randn(B, L, KV, hd, device="cuda", generator=g).bfloat16()
    lens = torch.randint(65, L + 1, (B,), device="cuda", generator=g,
                         dtype=torch.int32)
    out = decode_attn.decode_attention(q, kc, vc, lens)
    ref = decode_attn.decode_attention_plain(q, kc, vc, lens)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    atol = 2e-2
    if not err <= atol:
        fail(f"decode_attn disagrees with its plain version: {err} > {atol}")
    mask = (torch.arange(L, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, kc, vc))
    kernel_ms = timer(lambda: decode_attn.decode_attention(q, kc, vc, lens))
    plain_ms = timer(lambda: decode_attn.decode_attention_plain(
        q, kc, vc, lens))
    library_ms = timer(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True))
    live = int(lens.sum().item())
    b_ms, b_by = cost_bound(decode_attn.decode_cost(q.shape, KV, live, 2),
                            PEAK_BF16_FLOPS)
    # the log-sum-exp output of the length split (sharded serving): the
    # kernel's lse against the plain version's, its float32 output rounding
    # to the bf16 call's bits, and the kernel's time with it, in turns with
    # the time without it
    out_l, lse = decode_attn.decode_attention(q, kc, vc, lens,
                                              return_lse=True)
    _, lse_ref = decode_attn.decode_attention_plain(q, kc, vc, lens,
                                                    return_lse=True)
    torch.cuda.synchronize()
    lse_err = (lse - lse_ref).abs().max().item()
    same_out = out_l.dtype == torch.float32 and torch.equal(
        out_l.to(out.dtype), out)
    if not (lse_err <= 1e-4 and same_out):
        fail(f"decode_attn's lse {lse_err} from the plain version's (atol "
             f"1e-4), float32 output with lse rounding to the output "
             f"without: {same_out}")
    lse_ms = [timer(lambda: decode_attn.decode_attention(
        q, kc, vc, lens, return_lse=True)) for _ in range(2)]
    no_lse_ms = [kernel_ms, timer(lambda: decode_attn.decode_attention(
        q, kc, vc, lens))]
    res = dict(shape=f"q {list(q.shape)} cache {list(kc.shape)} bf16, "
               f"sum(cache_len)={live}",
               max_abs_err=err, atol=atol, ms=kernel_ms, plain_ms=plain_ms,
               library_ms=library_ms, vs_library=kernel_ms / library_ms,
               bound_ms=b_ms, bound_by=b_by, timer_floor_ms=timer.floor_ms,
               lse_err=lse_err, lse_atol=1e-4, with_lse_ms=lse_ms,
               without_lse_ms=no_lse_ms)
    emit("check_decode_attn", **res)
    return res


def check_decode_split(torch, timer, decode_attn, H, KV, hd, tag):
    """The length split of sharded serving on one card: the pool of 16
    rows, max_len 640, live lengths 1-640 (rows whose live range misses
    whole slices), H query heads of ``hd`` over KV, in float32 and in
    bf16. The cache is cut into 2 and 4 slices along its length, each
    launched with its ``start`` and ``return_lse``, and the slices' outputs
    merged by the log-sum-exp rule (m = max lse, w = exp(lse - m), sum w o
    / sum w, in float32, as models/attention.merge_slices does over the
    "model" ranks) against the whole-cache kernel: within 1e-5 in float32,
    within one bf16 ulp of each element (plus 1e-5) in bf16. Times a
    4-way slice's launch beside the whole cache's."""
    B, L = 16, 640
    g = torch.Generator(device="cuda").manual_seed(31)
    lens = torch.randint(1, L + 1, (B,), device="cuda", generator=g,
                         dtype=torch.int32)
    lens[:4] = torch.tensor([1, 100, 200, 640], device="cuda")
    res = {"shape": f"pool {B}, max_len {L}, H/KV {H}/{KV} (REP {H // KV})"
           f" x {hd}, lengths 1-640", "errors": {}}
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        q = torch.randn(B, 1, H, hd, device="cuda", generator=g).to(dtype)
        kc = torch.randn(B, L, KV, hd, device="cuda", generator=g).to(dtype)
        vc = torch.randn(B, L, KV, hd, device="cuda", generator=g).to(dtype)
        whole = decode_attn.decode_attention(q, kc, vc, lens).float()
        for n in (2, 4):
            size = L // n
            parts = [decode_attn.decode_attention(
                q, kc[:, i * size:(i + 1) * size].contiguous(),
                vc[:, i * size:(i + 1) * size].contiguous(), lens,
                start=i * size, return_lse=True) for i in range(n)]
            lse = torch.stack([p[1] for p in parts])
            m = lse.amax(0)
            w = torch.exp(lse - torch.where(torch.isfinite(m), m, 0.0))
            num = sum(p[0].float() * wi[:, None, :, None]
                      for p, wi in zip(parts, w))
            merged = num / w.sum(0).clamp_min(1e-30)[:, None, :, None]
            err = (merged - whole).abs().max().item()
            if dtype == torch.float32:
                ok = err <= 1e-5
            else:
                ok = bf16_excess(torch, merged, whole, ulps=1.0,
                                 atol=1e-5) <= 0.0
            res["errors"][f"{name}_{n}way"] = err
            if not ok:
                fail(f"decode length split {n}-way at {H}/{KV} x {hd} "
                     f"{name}: merged slices {err} from the whole cache")
        if dtype == torch.bfloat16:
            sl = (kc[:, :L // 4].contiguous(), vc[:, :L // 4].contiguous())
            res["slice_4way_ms"] = timer(lambda: decode_attn.decode_attention(
                q, *sl, lens, start=0, return_lse=True))
            res["whole_ms"] = timer(lambda: decode_attn.decode_attention(
                q, kc, vc, lens))
    res.update(f32_atol=1e-5, bf16_tol="one bf16 ulp + 1e-5")
    emit(f"check_decode_split_{tag}", **res)
    return res


# the JAX kernel tests' paged cases (tests/test_kernels.py PDA_CASES):
# B, NP, max_pages, ps, H, KV, hd, window, softcap, dtype
PDA_CASES = [(2, 12, 4, 16, 4, 2, 64, 0, 0.0, "float32"),
             (3, 20, 6, 8, 8, 8, 32, 0, 30.0, "float32"),
             (2, 16, 8, 16, 4, 1, 64, 48, 0.0, "float32"),
             (1, 9, 3, 32, 5, 5, 64, 0, 0.0, "bfloat16")]


def scatter_pages(torch, kc, vc, lens, ps, g):
    """The dense caches (B, L, KV, hd) laid out as page pools of one page per
    (row, logical page) at random physical pages, with a block table whose
    pages past each row's length are the sentinel NP = B * L / ps."""
    B, L, KV, hd = kc.shape
    mp = L // ps
    NP = B * mp
    perm = torch.randperm(NP, device="cuda", generator=g)
    kp = torch.empty(NP, ps, KV, hd, dtype=kc.dtype, device="cuda")
    vp = torch.empty_like(kp)
    kp[perm] = kc.reshape(NP, ps, KV, hd)
    vp[perm] = vc.reshape(NP, ps, KV, hd)
    bt = perm.reshape(B, mp).to(torch.int32)
    unmapped = (torch.arange(mp, device="cuda")[None, :] * ps
                >= lens[:, None])
    return kp, vp, torch.where(unmapped, NP, bt).contiguous()


def check_paged_decode(torch, timer, paged_decode_attn, decode_attn):
    """The paged decode kernel against its plain version at the JAX kernel
    tests' cases and at the serve shape (pool 16, max_len 640, ps 16, the
    llama3.2-1b heads, bf16), where the dense kernel's time on the same live
    lengths and the same bytes is the comparison: no single PyTorch call
    computes a paged decode."""
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for i, (B, NP, mp, ps, H, KV, hd, win, cap, dt) in enumerate(PDA_CASES):
        g = torch.Generator(device="cuda").manual_seed(20 + i)
        dtype = getattr(torch, dt)
        q = torch.randn(B, 1, H, hd, device="cuda", generator=g).to(dtype)
        kp = torch.randn(NP, ps, KV, hd, device="cuda", generator=g).to(dtype)
        vp = torch.randn(NP, ps, KV, hd, device="cuda", generator=g).to(dtype)
        lens = (torch.arange(B, device="cuda") * 29) % (mp * ps - 2) + 2
        lens = lens.to(torch.int32)
        bt = torch.full((B, mp), NP, dtype=torch.int32, device="cuda")
        perm = torch.randperm(NP, device="cuda", generator=g)
        used = 0
        for b in range(B):
            npg = -(-int(lens[b]) // ps)
            bt[b, :npg] = perm[used:used + npg].to(torch.int32)
            used += npg
        kw = dict(window=win, attn_softcap=cap)
        out = paged_decode_attn.paged_decode_attention(q, kp, vp, bt, ps,
                                                       lens, **kw)
        ref = paged_decode_attn.paged_decode_attention_plain(
            q, kp, vp, bt, ps, lens, **kw)
        torch.cuda.synchronize()
        worst[dt] = max(worst[dt],
                        (out.float() - ref.float()).abs().max().item())
    atols = {"float32": 1e-4, "bfloat16": 2e-2}
    if not all(worst[k] <= atols[k] for k in worst):
        fail(f"paged_decode_attn disagrees with its plain version at the "
             f"kernel tests' cases: {worst}")

    B, L, H, KV, hd, ps = 16, 640, 32, 8, 64, 16
    g = torch.Generator(device="cuda").manual_seed(11)
    q = torch.randn(B, 1, H, hd, device="cuda", generator=g).bfloat16()
    kc = torch.randn(B, L, KV, hd, device="cuda", generator=g).bfloat16()
    vc = torch.randn(B, L, KV, hd, device="cuda", generator=g).bfloat16()
    lens = torch.randint(65, L + 1, (B,), device="cuda", generator=g,
                         dtype=torch.int32)
    kp, vp, bt = scatter_pages(torch, kc, vc, lens, ps, g)
    out = paged_decode_attn.paged_decode_attention(q, kp, vp, bt, ps, lens)
    ref = paged_decode_attn.paged_decode_attention_plain(q, kp, vp, bt, ps,
                                                         lens)
    dense = decode_attn.decode_attention(q, kc, vc, lens)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    dense_diff = (out.float() - dense.float()).abs().max().item()
    atol = 2e-2
    if not (err <= atol and dense_diff == 0.0):
        fail(f"paged_decode_attn at the serve shape: {err} from the plain "
             f"version (atol {atol}), {dense_diff} from the dense kernel")
    kernel_ms = timer(lambda: paged_decode_attn.paged_decode_attention(
        q, kp, vp, bt, ps, lens))
    plain_ms = timer(lambda: paged_decode_attn.paged_decode_attention_plain(
        q, kp, vp, bt, ps, lens))
    dense_ms = timer(lambda: decode_attn.decode_attention(q, kc, vc, lens))
    live = int(lens.sum().item())
    # live K/V (no window on llama), q, out, the lengths: the dense kernel's
    # work, and the block table
    b_ms, b_by = cost_bound(decode_attn.decode_cost(q.shape, KV, live, 2),
                            PEAK_BF16_FLOPS, 4 * bt.numel())
    res = dict(shape=f"q {list(q.shape)} pools {list(kp.shape)} bf16, "
               f"block table {list(bt.shape)}, sum(cache_len)={live}; and "
               f"the {len(PDA_CASES)} kernel-test cases",
               max_abs_err=max(err, *worst.values()),
               max_abs_err_cases=worst, atol=atol,
               diff_from_dense_kernel=dense_diff, ms=kernel_ms,
               plain_ms=plain_ms, library_ms=None, dense_kernel_ms=dense_ms,
               bound_ms=b_ms, bound_by=b_by, timer_floor_ms=timer.floor_ms)
    emit("check_paged_decode_attn", **res)
    return res


def check_sample(torch, timer, fused_sample, prng, V=128256,
                 phase="check_fused_sample"):
    """Sampling at the serve pool of 16 rows over a vocabulary of ``V``
    (llama3.2-1b's 128256; hymba-1.5b's odd 32001; rwkv6-1.6b's 65536)."""
    R = 16
    g = torch.Generator(device="cuda").manual_seed(12)
    logits = torch.randn(R, V, device="cuda", generator=g) * 2.0
    keys = prng.split(prng.PRNGKey(5), R).to("cuda")
    main = dict(temperature=0.8, top_k=50, top_p=0.95)
    worst = 0.0
    for kw in (dict(temperature=0.8), dict(temperature=0.8, top_k=50),
               dict(temperature=0.8, top_p=0.95), main,
               dict(temperature=0.0)):
        tok, logp = fused_sample.sample_rows(keys, logits, **kw)
        rt, rl = fused_sample.sample_rows_plain(keys, logits, **kw)
        torch.cuda.synchronize()
        if not torch.equal(tok, rt):
            fail(f"fused_sample tokens differ from the plain version ({kw})")
        worst = max(worst, (logp - rl).abs().max().item())
    atol = 1e-4
    if not worst <= atol:
        fail(f"fused_sample logps differ: {worst} > {atol}")
    kernel_ms = timer(lambda: fused_sample.sample_rows(keys, logits, **main))
    plain_ms = timer(lambda: fused_sample.sample_rows_plain(keys, logits,
                                                            **main))
    nbytes = logits.numel() * 4 + keys.numel() * 4 + R * 8
    # float work per element (divide, compare, exp) is negligible against the
    # bytes at the card's float32 rate; the threefry integer work has no
    # published peak and is not counted
    flops = 8 * logits.numel()
    b_ms, b_by = bound(nbytes, flops, PEAK_F32_FLOPS)
    res = dict(shape=f"keys [{R}, 2] u32, logits [{R}, {V}] f32, "
               "T=0.8 top_k=50 top_p=0.95; also none/top-k/top-p/greedy",
               max_abs_err=worst, atol=atol, ms=kernel_ms, plain_ms=plain_ms,
               library_ms=None, bound_ms=b_ms, bound_by=b_by,
               timer_floor_ms=timer.floor_ms)
    emit(phase, **res)
    return res


# SASS opcodes on the 32-bit integer pipe (64 results per clock per SM on
# Hopper) and on the float pipes; uniform-datapath (U*) instructions run
# once per warp and IMAD on the FMA pipe, so neither is counted as integer
INT_OPS = {"IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "PRMT", "LEA",
           "ISETP", "SEL", "IMNMX", "IABS", "POPC", "FLO", "BREV", "BMSK",
           "SGXT", "VIADD", "VIMNMX"}
FLOAT_OPS = {"FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FSET", "MUFU",
             "FCHK", "FRND", "F2I", "I2F", "F2F", "FSWZADD"}
INT_RESULTS_PER_CLOCK_PER_SM = 64
# MUFU (ex2, rcp, ...) results per clock per SM on Hopper: an exponential
# issues there, beside its float32 range reduction on the FMA pipe
MUFU_RESULTS_PER_CLOCK_PER_SM = 16


def sass_opcodes(text, marker):
    """Opcode counts (without modifiers) of the functions of a
    ``cuobjdump -sass`` listing whose mangled name contains ``marker``."""
    counts = {}
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        if marker not in block.split(None, 1)[0]:
            continue
        for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                             r"([A-Z][A-Z0-9_]*)", block):
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return counts


def draw_ops(build):
    """SASS instructions of one Gumbel draw as csrc/fused_sample.cu runs it:
    its probe with two draws per thread less the probe with one (the key
    schedule and the addressing cancel), by pipe and by opcode."""
    text = build.sass("fused_sample")
    one = sass_opcodes(text, "gumbel_draw_probeILi1E")
    two = sass_opcodes(text, "gumbel_draw_probeILi2E")
    if not one or not two:
        fail("fused_sample: no SASS of the Gumbel draw probes")
    diff = {op: two.get(op, 0) - one.get(op, 0) for op in set(one) | set(two)}
    diff = {op: n for op, n in sorted(diff.items()) if n}
    return dict(int_ops=sum(n for op, n in diff.items() if op in INT_OPS),
                float_ops=sum(n for op, n in diff.items() if op in FLOAT_OPS),
                imad=diff.get("IMAD", 0), by_opcode=diff)


def check_sample_train(torch, timer, fused_sample, prng, build, sm_mhz):
    """Sampling as the train phase runs it (rollouts at temperature 1, no
    truncation: a threefry draw for every element) at 16 rows x llama's
    128256. Bound: the larger of the bytes and the draws' 32-bit integer
    instructions (counted from the SASS, ``draw_ops``) at 64 results per
    clock per SM on every SM at the card's maximum SM clock."""
    R, V = 16, 128256
    g = torch.Generator(device="cuda").manual_seed(12)
    logits = torch.randn(R, V, device="cuda", generator=g) * 2.0
    keys = prng.split(prng.PRNGKey(5), R).to("cuda")
    kw = dict(temperature=1.0)
    tok, logp = fused_sample.sample_rows(keys, logits, **kw)
    rt, rl = fused_sample.sample_rows_plain(keys, logits, **kw)
    torch.cuda.synchronize()
    if not torch.equal(tok, rt):
        fail("fused_sample tokens differ from the plain version (train)")
    err = (logp - rl).abs().max().item()
    atol = 1e-4
    if not err <= atol:
        fail(f"fused_sample logps differ (train): {err} > {atol}")
    kernel_ms = timer(lambda: fused_sample.sample_rows(keys, logits, **kw))
    plain_ms = timer(lambda: fused_sample.sample_rows_plain(keys, logits,
                                                            **kw))
    ops = draw_ops(build)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int_rate = INT_RESULTS_PER_CLOCK_PER_SM * sms * sm_mhz * 1e6
    draws = R * V                                  # every element is kept
    nbytes = logits.numel() * 4 + keys.numel() * 4 + R * 8
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = draws * ops["int_ops"] / int_rate * 1e3
    b_ms, b_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
    res = dict(shape=f"keys [{R}, 2] u32, logits [{R}, {V}] f32, T=1.0, "
               "no top-k or top-p (the train phase's sampling)",
               max_abs_err=err, atol=atol, ms=kernel_ms, plain_ms=plain_ms,
               library_ms=None, bound_ms=b_ms, bound_by=b_by,
               bytes_bound_ms=bytes_ms, int_ops_bound_ms=ops_ms,
               int_ops_per_draw=ops["int_ops"], draw_sass=ops, draws=draws,
               sms=sms, max_sm_clock_mhz=sm_mhz,
               timer_floor_ms=timer.floor_ms)
    emit("check_fused_sample_train", **res)
    return res


def bf16_ulp(torch, x):
    """One bf16 ulp of each element of x (float32)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
                      - 7)


def bf16_excess(torch, got, want, ulps=2.0, atol=1e-4):
    """Largest excess of |got - want| over ``ulps`` bf16 ulps of each element
    of ``want`` plus the float32 ``atol`` (<= 0: within tolerance). Kernel
    and plain version sum in float32 in another order, then round once:
    near zero that order alone exceeds an ulp."""
    want = want.float()
    return float(((got.float() - want).abs() - ulps * bf16_ulp(torch, want)
                  - atol).max())


def check_flash_prefill(torch, F, timer, flash_attn, H, KV, hd, win=0,
                        cap=0.0, phase="check_flash_attn_prefill"):
    """Prefill at a serve phase's shape: 16 rows of the largest prompt
    bucket (512), H query heads of ``hd`` over KV, with the model's window
    (gemma2-2b's 4096 spans the prompt) and score softcap (its 50: the
    library call is then flex_attention; see attention_library)."""
    B, S = 16, 512
    g = torch.Generator(device="cuda").manual_seed(21)
    q = torch.randn(B, S, H, hd, device="cuda", generator=g).bfloat16()
    k = torch.randn(B, S, KV, hd, device="cuda", generator=g).bfloat16()
    v = torch.randn(B, S, KV, hd, device="cuda", generator=g).bfloat16()
    kw = dict(causal=True, window=win, attn_softcap=cap)
    out = flash_attn.flash_attention(q, k, v, **kw)
    ref = flash_attn.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    atol = 2e-2
    if not err <= atol:
        fail(f"flash_attn prefill at H/KV {H}/{KV} x {hd} disagrees with "
             f"its plain version: {err} > {atol}")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = attention_library(torch, F, timer, qt, kt, vt, ref, cap, win=win,
                            is_causal=True)
    kernel_ms = timer(lambda: flash_attn.flash_attention(q, k, v, **kw))
    plain_ms = timer(lambda: flash_attn.flash_attention_plain(q, k, v, **kw),
                     iters=3, warmup=1)
    b_ms, b_by = cost_bound(flash_attn.flash_cost(q.shape, k.shape, 2,
                                                  window=win),
                            PEAK_BF16_FLOPS)
    res = dict(shape=f"q {list(q.shape)} kv {list(k.shape)} bf16 causal"
               + (f", window {win}" if win else "")
               + (f", softcap {cap}" if cap else ""),
               max_abs_err=err, atol=atol, ms=kernel_ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, **lib)
    if res["library_ms"]:
        res["vs_library"] = kernel_ms / res["library_ms"]
    emit(phase, **res)
    return res


def check_decode_wide(torch, F, timer, decode_attn, paged_decode_attn, H,
                      KV, hd, win=0, cap=0.0, tag=""):
    """Dense and paged decode at a serve phase's shape with wide heads: the
    pool of 16 rows, max_len 640, live lengths 65-640, H query heads of
    ``hd`` over KV (REP 7 and 48 at 128, 2 at 256 with gemma2-2b's softcap
    and window), the paged pools laid out at random in pages of 16. Each
    kernel against its plain version (atol 2e-2), the paged kernel bit-equal
    to the dense one on the same live K/V; SDPA's masked call (with a
    softcap flex_attention's with a length mask) is the library time of the
    dense kernel. Emits
    check_decode_attn_<tag> and check_paged_decode_attn_<tag>."""
    B, L, ps = 16, 640, 16
    g = torch.Generator(device="cuda").manual_seed(22)
    q = torch.randn(B, 1, H, hd, device="cuda", generator=g).bfloat16()
    kc = torch.randn(B, L, KV, hd, device="cuda", generator=g).bfloat16()
    vc = torch.randn(B, L, KV, hd, device="cuda", generator=g).bfloat16()
    lens = torch.randint(65, L + 1, (B,), device="cuda", generator=g,
                         dtype=torch.int32)
    kp, vp, bt = scatter_pages(torch, kc, vc, lens, ps, g)
    kw = dict(window=win, attn_softcap=cap)
    out = decode_attn.decode_attention(q, kc, vc, lens, **kw)
    paged = paged_decode_attn.paged_decode_attention(q, kp, vp, bt, ps, lens,
                                                     **kw)
    ref = decode_attn.decode_attention_plain(q, kc, vc, lens, **kw)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    perr = (paged.float() - ref.float()).abs().max().item()
    dense_diff = (paged.float() - out.float()).abs().max().item()
    atol = 2e-2
    if not (err <= atol and perr <= atol and dense_diff == 0.0):
        fail(f"decode at H/KV {H}/{KV} x {hd}: dense {err}, paged {perr} "
             f"from the plain version (atol {atol}), paged {dense_diff} "
             f"from dense")
    mask = (torch.arange(L, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    if win > 0:
        mask = mask & (torch.arange(L, device="cuda")[None, :]
                       >= (lens - win)[:, None])[:, None, None, :]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, kc, vc))
    lib = attention_library(torch, F, timer, qt, kt, vt, ref, cap, win=win,
                            lens=lens, attn_mask=mask)
    kernel_ms = timer(lambda: decode_attn.decode_attention(q, kc, vc, lens,
                                                           **kw))
    plain_ms = timer(lambda: decode_attn.decode_attention_plain(
        q, kc, vc, lens, **kw))
    paged_ms = timer(lambda: paged_decode_attn.paged_decode_attention(
        q, kp, vp, bt, ps, lens, **kw))
    paged_plain_ms = timer(
        lambda: paged_decode_attn.paged_decode_attention_plain(
            q, kp, vp, bt, ps, lens, **kw))
    live = int((lens.clamp(max=win) if win > 0 else lens).sum().item())
    cost = decode_attn.decode_cost(q.shape, KV, live, 2)
    b_ms, b_by = cost_bound(cost, PEAK_BF16_FLOPS)
    pb_ms, pb_by = cost_bound(cost, PEAK_BF16_FLOPS, 4 * bt.numel())
    shape = (f"q {list(q.shape)}, H/KV {H}/{KV} (REP {H // KV}) x {hd} bf16"
             + (f", window {win}" if win else "")
             + (f", softcap {cap}" if cap else "")
             + f", sum(cache_len)={live}")
    dense = dict(shape=f"{shape}, cache {list(kc.shape)}", max_abs_err=err,
                 atol=atol, ms=kernel_ms, plain_ms=plain_ms, bound_ms=b_ms,
                 bound_by=b_by, timer_floor_ms=timer.floor_ms, **lib)
    if dense["library_ms"]:
        dense["vs_library"] = kernel_ms / dense["library_ms"]
    pres = dict(shape=f"{shape}, pools {list(kp.shape)}, block table "
                f"{list(bt.shape)}", max_abs_err=perr, atol=atol,
                diff_from_dense_kernel=dense_diff, ms=paged_ms,
                plain_ms=paged_plain_ms, library_ms=None,
                dense_kernel_ms=kernel_ms, bound_ms=pb_ms, bound_by=pb_by,
                timer_floor_ms=timer.floor_ms)
    emit(f"check_decode_attn_{tag}", **dense)
    emit(f"check_paged_decode_attn_{tag}", **pres)
    return dense, pres


# the serve phases' largest prompt bucket (prompts of 64-512 tokens)
PREFILL_T = 512
# the JAX kernel tests' cases (tests/test_kernels.py), float32
SSM_CASES = [(2, 64, 128, 16), (1, 50, 64, 8), (2, 33, 256, 16)]
WKV_CASES = [(2, 64, 4, 32), (1, 100, 2, 64), (2, 33, 3, 16)]


def ssm_inputs(torch, B, T, di, N, dtype, g, *, model_A=False):
    """Scan inputs shaped as apply_ssm hands them over: B and C as views
    into one projection; with ``model_A`` the init's A_log = log(1..N)."""
    x = torch.randn(B, T, di, device="cuda", generator=g) * 0.5
    dt = torch.nn.functional.softplus(
        torch.randn(B, T, di, device="cuda", generator=g)) * 0.1
    if model_A:
        A_log = torch.log(torch.arange(1, N + 1, device="cuda",
                                       dtype=torch.float32)).repeat(di, 1)
    else:
        A_log = torch.log(torch.randn(di, N, device="cuda", generator=g).abs()
                          + 0.5)
    proj = torch.randn(B, T, 100 + 2 * N, device="cuda", generator=g) * 0.5
    Bc, Cc = proj[..., 100:100 + N], proj[..., 100 + N:]
    D = torch.randn(di, device="cuda", generator=g) * 0.2
    s0 = torch.randn(B, di, N, device="cuda", generator=g) * 0.2
    return (x.to(dtype), dt.to(dtype), A_log, Bc.to(dtype), Cc.to(dtype), D,
            s0)


def scan_check(torch, timer, name, kernel, plain, args, state, label, shape,
               nbytes, flops, *, exps=0, mufu_rate=None, **extra):
    """One scan kernel at a serve shape, bf16: against its plain version
    (output within 2 bf16 ulps of each element plus 1e-4, final state
    within 1e-4 of its largest element), timed beside the plain version.
    The kernel updates the state in place, so each call gets a fresh
    copy. Bound: the largest of the bytes, the float32 operations on the
    FMA pipe at 67 TFLOP/s and ``exps`` exponentials on the MUFU pipe at
    ``mufu_rate`` a second; ``bound_pipe`` names the operations' pipe."""
    y, sf = kernel(*args, state.clone())
    yp, sp = plain(*args, state)
    torch.cuda.synchronize()
    excess = bf16_excess(torch, y, yp)
    s_err = float((sf - sp).abs().max() / sp.abs().max())
    err = float((y.float() - yp.float()).abs().max())
    if not (excess <= 0.0 and s_err <= 1e-4):
        fail(f"{name} at the {label} shape: {excess} beyond 2 bf16 ulps + "
             f"1e-4, state {s_err} of its largest element")
    work = state.clone()
    kernel_ms = timer(lambda: kernel(*args, work))
    plain_ms = timer(lambda: plain(*args, state), iters=3, warmup=1)
    bounds = {"bytes": nbytes / PEAK_BYTES_PER_S * 1e3,
              "fma": flops / PEAK_F32_FLOPS * 1e3}
    if exps:
        bounds["mufu"] = exps / mufu_rate * 1e3
    pipe = max(bounds, key=bounds.get)
    res = dict(shape=shape, max_abs_err=err, tol="2 bf16 ulps + 1e-4",
               excess_over_tol=excess, state_err_of_max=s_err, ms=kernel_ms,
               plain_ms=plain_ms, library_ms=None, bound_ms=bounds[pipe],
               bound_by="bytes" if pipe == "bytes" else "operations",
               bound_pipe=None if pipe == "bytes" else pipe,
               bounds_ms=bounds, bytes=nbytes, flops=flops,
               timer_floor_ms=timer.floor_ms, **extra)
    emit(f"check_{name}_{label}", **res)
    return res


def check_ssm_scan(torch, timer, ssm_scan, sm_mhz):
    """The selective scan at the JAX kernel tests' f32 cases (atol 1e-4),
    then at hymba-1.5b's serve shapes in bf16: decode (B = 16, T = 1) and
    prefill (16 rows x the largest prompt bucket), di = 3200, N = 16. At
    T = 1 the prefill kernel runs beside the decode kernel on the same
    inputs. Bound: the largest of the bytes (x, dt, B, C, y once, A_log and
    D, the state read and written), 7 float32 operations per (row, step,
    channel, state) on the FMA pipe, and the exponentials (one per (row,
    step, channel, state), one per (channel, state) for -exp(A_log)) on the
    MUFU pipe at 16 a clock per SM on every SM at the card's maximum SM
    clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mufu_rate = MUFU_RESULTS_PER_CLOCK_PER_SM * sms * sm_mhz * 1e6
    worst = 0.0
    for i, (B, T, di, N) in enumerate(SSM_CASES):
        g = torch.Generator(device="cuda").manual_seed(30 + i)
        args = ssm_inputs(torch, B, T, di, N, torch.float32, g)
        y, sf = ssm_scan.selective_scan(*args[:6], args[6].clone())
        yp, sp = ssm_scan.selective_scan_plain(*args)
        torch.cuda.synchronize()
        worst = max(worst, float((y - yp).abs().max()),
                    float((sf - sp).abs().max()))
    if not worst <= 1e-4:
        fail(f"ssm_scan disagrees with its plain version at the kernel "
             f"tests' cases: {worst}")
    res = {}
    di, N = 3200, 16
    fn = ssm_scan.selective_scan
    for label, (B, T) in (("decode", (16, 1)), ("prefill", (16, PREFILL_T))):
        g = torch.Generator(device="cuda").manual_seed(33)
        args = ssm_inputs(torch, B, T, di, N, torch.bfloat16, g, model_A=True)
        s0 = args[6]
        flops, nbytes = ssm_scan.scan_cost("fwd", B, T, di, N, 2)
        exps = B * T * di * N + di * N
        extra = {}
        if T == 1:
            # the prefill kernel at T = 1 (the decode path before the
            # decode kernel), beside the decode kernel on the same inputs
            y_dec = ssm_scan.launch(*args[:6], s0.clone())
            y_pre = ssm_scan.launch(*args[:6], s0.clone(), prefill_only=True)
            torch.cuda.synchronize()
            work = s0.clone()
            extra = dict(
                diff_from_prefill_kernel=float(
                    (y_dec.float() - y_pre.float()).abs().max()),
                prefill_kernel_ms=timer(lambda: ssm_scan.launch(
                    *args[:6], work, prefill_only=True)))
        n0 = (fn.decode_launches, fn.prefill_launches)
        res[label] = scan_check(
            torch, timer, "ssm_scan", fn, ssm_scan.selective_scan_plain,
            args[:6], s0, label,
            f"x, dt [{B}, {T}, {di}] bf16, B, C [{B}, {T}, {N}] views, "
            f"state [{B}, {di}, {N}] f32", nbytes, flops, exps=exps,
            mufu_rate=mufu_rate, exp_count=exps, sms=sms,
            max_sm_clock_mhz=sm_mhz, **extra)
        ran = (fn.decode_launches - n0[0], fn.prefill_launches - n0[1])
        if (ran[0] > 0) != (T == 1) or (ran[1] > 0) != (T > 1):
            fail(f"ssm_scan at T = {T} ran (decode, prefill) kernels {ran}")
    res["decode"]["max_abs_err_cases"] = worst
    return res


def check_wkv6(torch, timer, rwkv6_scan):
    """WKV6 at the JAX kernel tests' f32 cases and one case with decays down
    to ~1e-8 (atol 1e-4), then at rwkv6-1.6b's serve shapes in bf16: decode
    (B = 16, T = 1, with the prefill kernel beside the decode kernel on the
    same inputs, and a copy of the state timed beside it) and prefill (16
    rows x the largest prompt bucket), H = 32, hd = 64. Bound: bytes (r, k,
    v, w, y once, u, the state read and written) against 6 f32 operations
    per (row, step, head, i, j)."""
    def inputs(B, T, H, hd, dtype, g, strong=False):
        r, k, v = (torch.randn(B, T, H, hd, device="cuda", generator=g)
                   * 0.5 for _ in range(3))
        x = torch.randn(B, T, H, hd, device="cuda", generator=g)
        w = torch.exp(-torch.exp(x * 1.2 + 0.9 if strong else x * 0.5 - 1.0))
        u = torch.randn(H, hd, device="cuda", generator=g) * 0.3
        s0 = torch.randn(B, H, hd, hd, device="cuda", generator=g) * 0.2
        return [t.to(dtype) for t in (r, k, v, w)] + [u, s0]

    worst = 0.0
    for i, (B, T, H, hd) in enumerate(WKV_CASES + [(2, 70, 4, 64)]):
        g = torch.Generator(device="cuda").manual_seed(40 + i)
        args = inputs(B, T, H, hd, torch.float32, g,
                      strong=i == len(WKV_CASES))
        y, sf = rwkv6_scan.wkv6(*args[:5], args[5].clone())
        yp, sp = rwkv6_scan.wkv6_plain(*args)
        torch.cuda.synchronize()
        worst = max(worst, float((y - yp).abs().max()),
                    float((sf - sp).abs().max()))
    if not worst <= 1e-4:
        fail(f"wkv6 disagrees with its plain version at the kernel tests' "
             f"cases: {worst}")
    res = {}
    H, hd = 32, 64
    fn = rwkv6_scan.wkv6
    for label, (B, T) in (("decode", (16, 1)), ("prefill", (16, PREFILL_T))):
        g = torch.Generator(device="cuda").manual_seed(43)
        args = inputs(B, T, H, hd, torch.bfloat16, g)
        s0 = args[5]
        flops, nbytes = rwkv6_scan.wkv_cost("fwd", B, T, H, hd, 2)
        extra = {}
        if T == 1:
            # the prefill kernel at T = 1 (the decode path before the
            # decode kernel), beside the decode kernel on the same inputs
            y_dec = rwkv6_scan.launch(*args[:5], s0.clone())
            y_pre = rwkv6_scan.launch(*args[:5], s0.clone(),
                                      prefill_only=True)
            torch.cuda.synchronize()
            work, dst = s0.clone(), torch.empty_like(s0)
            extra = dict(
                diff_from_prefill_kernel=float(
                    (y_dec.float() - y_pre.float()).abs().max()),
                prefill_kernel_ms=timer(lambda: rwkv6_scan.launch(
                    *args[:5], work, prefill_only=True)),
                # a yardstick, never a limit: PyTorch's copy of the state
                # moves the bytes the decode step must move
                state_copy_ms=timer(lambda: dst.copy_(s0)))
        n0 = (fn.decode_launches, fn.prefill_launches)
        res[label] = scan_check(
            torch, timer, "wkv6", fn, rwkv6_scan.wkv6_plain,
            args[:5], s0, label,
            f"r, k, v, w [{B}, {T}, {H}, {hd}] bf16, state [{B}, {H}, {hd}, "
            f"{hd}] f32", nbytes, flops, **extra)
        ran = (fn.decode_launches - n0[0], fn.prefill_launches - n0[1])
        if (ran[0] > 0) != (T == 1) or (ran[1] > 0) != (T > 1):
            fail(f"wkv6 at T = {T} ran (decode, prefill) kernels {ran}")
    res["decode"]["max_abs_err_cases"] = worst
    return res


# the train phase's packed batch at its largest: 32 sequences (8 groups x 4)
# of max_len 128, so 127 loss positions each
TRAIN_B, TRAIN_S = 32, 127


def bwd_excess(torch, got, want):
    """How far the backward kernel's gradients lie outside their tolerance
    against the plain backward's (<= 0: inside): float32 within 1e-4 of
    each gradient's largest element; bfloat16 within 2 bf16 ulps of each
    element plus that (both sides sum in float32 and round once). Also
    returns the largest absolute error."""
    excess, err = -1.0, 0.0
    for x, y in zip(got, want):
        if x.shape != y.shape or x.dtype != y.dtype:
            fail(f"a backward scan gradient is {x.dtype} {tuple(x.shape)}, "
                 f"its plain version's {y.dtype} {tuple(y.shape)}")
        scale = float(y.float().abs().max())
        diff = (x.float() - y.float()).abs()
        err = max(err, float(diff.max()))
        tol = torch.full_like(diff, 1e-4 * scale)
        if x.dtype == torch.bfloat16:
            tol = tol + 2.0 * bf16_ulp(torch, y.float())
        excess = max(excess, float((diff - tol).max()))
    return excess, err


def bwd_check(torch, timer, name, mod, plain, cases, train_args,
              train_shape, nbytes, flops, exps, mufu_rate, fwd_plain,
              fwd_bound):
    """One backward scan kernel (``mod.launch_bwd(*args, dy, dstate)``)
    against its plain version: at the JAX kernel tests' float32 cases with
    a nonzero final-state gradient, then at the update's shape in bf16 (a
    zero final-state gradient, as training gives). As under autograd, the
    forward kernel stores the backward's boundary states
    (``mod.launch(..., ckpt=mod.boundaries(...))``) and the backward reads
    them: checked at every case, timed beside the plain version and
    launched a second time to show the same bits. The forward with its
    stores (the save kernel) is held to the forward without (the same y
    and state bit for bit) and to its plain version ``fwd_plain`` (y within
    2 bf16 ulps + 1e-4, the last boundary state within 1e-4 of its largest
    element against the plain state after as many steps), timed beside
    both (``fwd_ms``, ``fwd_save_ms``), with its own bound
    (``fwd_bound(boundary bytes)``: the forward's bytes and operations, the
    boundary states' writes added). ``same_basis_ms`` is the backward plus
    the stores of the two forwards an update runs under remat,
    2 (fwd_save_ms - fwd_ms): the work that replaced the first pass an
    earlier backward ran itself. Bound: the largest of the bytes (every
    input read once, every gradient written once), the float32 operations
    on the FMA pipe at 67 TFLOP/s (an FMA counted as two) and ``exps``
    exponentials on the MUFU pipe; no single PyTorch call computes it."""
    wkv = mod.__name__.endswith("rwkv6_scan")

    def split(args):          # (forward inputs, state, dy, dstate)
        return (args[:5], args[5], args[6], args[7]) if wkv else \
            (args[:6], args[6], args[7], args[8])

    def saved(args):          # the forward's boundary states, its y, state
        inputs, state, _, _ = split(args)
        ckpt = (mod.boundaries(inputs[0]) if wkv
                else mod.boundaries(inputs[0], inputs[2].shape[-1]))
        final = state.clone()
        y = mod.launch(*inputs, final, ckpt=ckpt)
        return ckpt, y, final

    def grads(args, ckpt):
        return mod.launch_bwd(*args, ckpt=ckpt)

    worst = -1.0
    for args in cases:
        ckpt, _, _ = saved(args)
        worst = max(worst, bwd_excess(torch, grads(args, ckpt),
                                      plain(*args))[0])
    if worst > 0.0:
        fail(f"{name} disagrees with its plain version at the kernel tests' "
             f"cases by {worst} beyond the tolerance")
    ckpt, y_save, final_save = saved(train_args)
    inputs, state, _, _ = split(train_args)
    final = state.clone()
    y = mod.launch(*inputs, final)
    got = grads(train_args, ckpt)
    want = plain(*train_args)
    again = grads(train_args, ckpt)
    torch.cuda.synchronize()
    excess, err = bwd_excess(torch, got, want)
    same_bits = all(torch.equal(a, b) for a, b in zip(got, again))
    fwd_same = torch.equal(y, y_save) and torch.equal(final, final_save)
    if excess > 0.0 or not same_bits or not fwd_same:
        fail(f"{name} at the update's shape: {excess} beyond the tolerance, "
             f"bit-equal across launches: {same_bits}, the forward's stores "
             f"leave y and the state: {fwd_same}")
    # the save kernel against the plain forward: y, and the last boundary
    # state against the plain state after as many steps
    from repro_torch.hopper import build
    T = inputs[0].shape[1]
    bf16 = int(inputs[0].dtype == torch.bfloat16)
    chunk = (build.library("wkv6").wkv6_bwd_chunk(inputs[0].shape[-1], bf16,
                                                  None) if wkv
             else build.library("ssm_scan").ssm_scan_bwd_chunk(
                 inputs[2].shape[-1], bf16, None))
    nb = ckpt.shape[2] if wkv else ckpt.shape[1]
    yp, _ = fwd_plain(*inputs, state)
    _, sp = fwd_plain(*(a[:, :nb * chunk] if a.dim() >= 3 and a.shape[1] == T
                        else a for a in inputs), state)
    last = ckpt[:, :, nb - 1] if wkv else ckpt[:, nb - 1]
    torch.cuda.synchronize()
    save_excess = bf16_excess(torch, y_save, yp)
    save_err = float((y_save.float() - yp.float()).abs().max())
    bound_err = float((last - sp).abs().max() / sp.abs().max())
    if not (save_excess <= 0.0 and bound_err <= 1e-4):
        fail(f"{name}'s save kernel at the update's shape: y {save_excess} "
             f"beyond 2 bf16 ulps + 1e-4, the last boundary state "
             f"{bound_err} of its largest element")
    del got, want, again, y, y_save, yp, sp
    kernel_ms = timer(lambda: grads(train_args, ckpt))
    fwd_ms = timer(lambda: mod.launch(*inputs, final))
    fwd_save_ms = timer(lambda: mod.launch(*inputs, final, ckpt=ckpt))
    plain_ms = timer(lambda: plain(*train_args), iters=3, warmup=1)
    boundary_bytes = ckpt.numel() * 4
    bounds = {"bytes": nbytes / PEAK_BYTES_PER_S * 1e3,
              "fma": flops / PEAK_F32_FLOPS * 1e3,
              "mufu": exps / mufu_rate * 1e3}
    pipe = max(bounds, key=bounds.get)
    save_bounds = fwd_bound(boundary_bytes)
    save_pipe = max(save_bounds, key=save_bounds.get)
    save = dict(
        shape=train_shape, ms=fwd_save_ms, fwd_ms=fwd_ms,
        max_abs_err=save_err,
        tol="y 2 bf16 ulps + 1e-4, the last boundary state 1e-4 of its "
            "largest element; y and the state bit-equal to the forward "
            "kernel's", excess_over_tol=save_excess,
        boundary_err_of_max=bound_err, same_bits=fwd_same,
        boundary_bytes=boundary_bytes,
        plain_ms=timer(lambda: fwd_plain(*inputs, state), iters=3,
                       warmup=1),
        library_ms=None, bound_ms=save_bounds[save_pipe],
        bound_by="bytes" if save_pipe == "bytes" else "operations",
        bound_pipe=None if save_pipe == "bytes" else save_pipe,
        bounds_ms=save_bounds)
    res = dict(shape=train_shape, max_abs_err=err,
               tol="f32 1e-4 of each gradient's largest element; bf16 2 "
                   "ulps + that", excess_over_tol=excess,
               excess_over_tol_cases=worst, bit_equal_launches=same_bits,
               fwd_save_same_bits=fwd_same, ms=kernel_ms, fwd_ms=fwd_ms,
               fwd_save_ms=fwd_save_ms,
               same_basis_ms=kernel_ms + 2 * (fwd_save_ms - fwd_ms),
               boundary_bytes=boundary_bytes,
               plain_ms=plain_ms, library_ms=None,
               library="none: no single PyTorch call computes it",
               bound_ms=bounds[pipe],
               bound_by="bytes" if pipe == "bytes" else "operations",
               bound_pipe=None if pipe == "bytes" else pipe,
               bounds_ms=bounds, bytes=nbytes, flops=flops, exp_count=exps,
               timer_floor_ms=timer.floor_ms, save_kernel=save)
    emit(f"check_{name}", **res)
    return res


def check_ssm_scan_bwd(torch, timer, ssm_scan, sm_mhz):
    """The selective scan's backward kernel (ssm_scan_bwd) at the JAX
    kernel tests' f32 cases, then at hymba-1.5b's update shape: the packed
    batch (32 rows of 127 steps), di 3200, N 16, bf16. Per (row, step,
    channel, state) the gradients need 20 float32 operations (the state
    recomputed: 4; G, dC, dB, G.B, gA, dA_log and a_t G: 14; the sums of
    dB and dC over channels: 2) and one exponential (a_t)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mufu_rate = MUFU_RESULTS_PER_CLOCK_PER_SM * sms * sm_mhz * 1e6

    def case(B, T, di, N, dtype, seed, dstate):
        g = torch.Generator(device="cuda").manual_seed(seed)
        args = ssm_inputs(torch, B, T, di, N, dtype, g, model_A=dtype
                          == torch.bfloat16)
        dy = torch.randn(B, T, di, device="cuda", generator=g).to(dtype)
        ds = (torch.randn(B, di, N, device="cuda", generator=g) if dstate
              else None)
        return (*args, dy, ds)

    cases = [case(*c, torch.float32, 50 + i, True)
             for i, c in enumerate(SSM_CASES)]
    B, T, di, N = TRAIN_B, TRAIN_S, 3200, 16
    train = case(B, T, di, N, torch.bfloat16, 55, False)
    flops, nbytes = ssm_scan.scan_cost("bwd", B, T, di, N, 2)

    def fwd_bound(extra):     # as check_ssm_scan's, with the stores' bytes
        fwd_flops, fwd_bytes = ssm_scan.scan_cost("fwd", B, T, di, N, 2,
                                                  extra // 4)
        return {"bytes": fwd_bytes / PEAK_BYTES_PER_S * 1e3,
                "fma": fwd_flops / PEAK_F32_FLOPS * 1e3,
                "mufu": (B * T * di * N + di * N) / mufu_rate * 1e3}

    return bwd_check(
        torch, timer, "ssm_scan_bwd", ssm_scan,
        ssm_scan.selective_scan_bwd_plain, cases, train,
        f"x, dt, dy [{B}, {T}, {di}] bf16, B, C [{B}, {T}, {N}] views, "
        f"state [{B}, {di}, {N}] f32", nbytes, flops, B * T * di * N,
        mufu_rate, ssm_scan.selective_scan_plain, fwd_bound)


def check_wkv6_bwd(torch, timer, rwkv6_scan, sm_mhz):
    """WKV6's backward kernel (wkv6_bwd) at the JAX kernel tests' f32 cases
    and one with decays down to ~1e-8, then at rwkv6-1.6b's update shape:
    the packed batch (32 rows of 127 steps), H 32, hd 64, bf16. Per (row,
    step, head, i, j) the gradients need 14 float32 operations (the state
    recomputed: 3; dr, dk, dw and dv's sums: 8; G: 3); no exponential, so
    the MUFU bound is 0."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mufu_rate = MUFU_RESULTS_PER_CLOCK_PER_SM * sms * sm_mhz * 1e6

    def case(B, T, H, hd, dtype, seed, dstate, strong=False):
        g = torch.Generator(device="cuda").manual_seed(seed)
        r, k, v = (torch.randn(B, T, H, hd, device="cuda", generator=g)
                   * 0.5 for _ in range(3))
        x = torch.randn(B, T, H, hd, device="cuda", generator=g)
        w = torch.exp(-torch.exp(x * 1.2 + 0.9 if strong else x * 0.5 - 1.0))
        u = torch.randn(H, hd, device="cuda", generator=g) * 0.3
        s0 = torch.randn(B, H, hd, hd, device="cuda", generator=g) * 0.2
        dy = torch.randn(B, T, H, hd, device="cuda", generator=g)
        ds = (torch.randn(B, H, hd, hd, device="cuda", generator=g)
              if dstate else None)
        return (*(t.to(dtype) for t in (r, k, v, w)), u, s0, dy.to(dtype),
                ds)

    cases = [case(*c, torch.float32, 60 + i, True, strong=i == len(WKV_CASES))
             for i, c in enumerate(WKV_CASES + [(2, 70, 4, 64)])]
    B, T, H, hd = TRAIN_B, TRAIN_S, 32, 64
    train = case(B, T, H, hd, torch.bfloat16, 65, False)
    flops, nbytes = rwkv6_scan.wkv_cost("bwd", B, T, H, hd, 2)

    def fwd_bound(extra):     # as check_wkv6's, with the stores' bytes
        fwd_flops, fwd_bytes = rwkv6_scan.wkv_cost("fwd", B, T, H, hd, 2,
                                                   extra // 4)
        return {"bytes": fwd_bytes / PEAK_BYTES_PER_S * 1e3,
                "fma": fwd_flops / PEAK_F32_FLOPS * 1e3}

    return bwd_check(
        torch, timer, "wkv6_bwd", rwkv6_scan,
        rwkv6_scan.wkv6_bwd_plain, cases, train,
        f"r, k, v, w, dy [{B}, {T}, {H}, {hd}] bf16, state [{B}, {H}, {hd}, "
        f"{hd}] f32", nbytes, flops, 0, mufu_rate,
        rwkv6_scan.wkv6_plain, fwd_bound)


def flex_call(torch, qt, kt, vt, cap, win=0, lens=None, return_lse=False,
              kernel_options=None):
    """A closure of one compiled flex_attention call (torch.compile, for
    timing only: the port never calls it) computing the kernels' function
    with a score softcap, which SDPA has not: (B, H, S, hd) views, the tanh
    softcap ``cap`` as the score_mod, GQA, and as the block mask the causal
    mask with the window ``win`` (0: none) or, with the cache lengths
    ``lens``, decode's mask of positions below each row's length (and
    within the window), with ``kernel_options`` (None: flex_attention's
    own choice)."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    torch._dynamo.reset()           # a fresh compile for each shape

    def score_mod(s, b, h, qi, ki):
        return cap * torch.tanh(s / cap)

    B, Sq, Sk = qt.shape[0], qt.shape[2], kt.shape[2]
    if lens is None:
        def mask_mod(b, h, qi, ki):
            m = ki <= qi
            return m & (qi - ki < win) if win else m
        block_mask = create_block_mask(mask_mod, None, None, Sq, Sk,
                                       device=qt.device)
    else:
        def mask_mod(b, h, qi, ki):
            m = ki < lens[b]
            return m & (ki >= lens[b] - win) if win else m
        block_mask = create_block_mask(mask_mod, B, None, Sq, Sk,
                                       device=qt.device)
    fn = torch.compile(flex_attention, dynamic=False)
    return lambda: fn(qt, kt, vt, score_mod=score_mod, block_mask=block_mask,
                      enable_gqa=True, return_lse=return_lse,
                      kernel_options=kernel_options)


# flex_attention's tiles where its own configurations give none for the
# shape (at the update's 127-row sequences of head_dim 256 its list of
# choices is empty): 32 x 32 in the forward and both backward passes
FLEX_SMALL_TILES = {"BLOCK_M": 32, "BLOCK_N": 32, "BLOCK_M1": 32,
                    "BLOCK_N1": 32, "BLOCK_M2": 32, "BLOCK_N2": 32,
                    "num_warps": 4, "num_stages": 1}


def flex_library(timer, make, err):
    """library_call of the flex_attention closure ``make(kernel_options)``
    with flex_attention's own configurations or, where it has none for the
    shape, with FLEX_SMALL_TILES (then named in ``library_options``)."""
    lib = library_call(timer, make(None), err)
    if lib["library_ms"] is None:
        lib = dict(library_call(timer, make(FLEX_SMALL_TILES), err),
                   library_options=FLEX_SMALL_TILES,
                   default_options_failed=lib["library_failed"])
    return lib


def library_call(timer, run, err):
    """library_ms and library_err of a library call: ``run`` computes its
    result (the first call compiles), ``err`` its largest error against the
    plain version. A call that raises (flex_attention's generated kernels
    may not fit a head size) gives None, with the reason."""
    try:
        library_err = err(run())
        return dict(library_ms=timer(run), library_err=library_err)
    except Exception as e:                          # noqa: BLE001
        return dict(library_ms=None, library_err=None,
                    library_failed=f"{type(e).__name__}: {e}"[:300])


def attention_library(torch, F, timer, qt, kt, vt, ref, cap, win=0,
                      lens=None, ref_lse=None, **kw):
    """The library call computing the same function on the same inputs,
    (B, H, S, hd) views: SDPA (``kw``: its causal flag or mask), or with a
    score softcap, which SDPA has not, flex_attention (see flex_call), with
    SDPA's time without the softcap kept apart as a yardstick
    (sdpa_without_softcap_ms). library_err is the call's largest error
    against the plain version ``ref`` (and the logsumexp ``ref_lse``, where
    given, for flex_attention)."""
    def out_err(out):
        return (out.transpose(1, 2).float() - ref.float()).abs().max().item()

    if cap <= 0.0:
        return dict(library="scaled_dot_product_attention", **library_call(
            timer, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, enable_gqa=True, **kw), out_err))

    def flex_err(res):
        if ref_lse is None:
            return out_err(res)
        return max(out_err(res[0]),
                   (res[1].float() - ref_lse.float()).abs().max().item())

    lib = flex_library(timer, lambda opts: flex_call(
        torch, qt, kt, vt, cap, win=win, lens=lens,
        return_lse=ref_lse is not None, kernel_options=opts), flex_err)
    return dict(library="flex_attention (compiled), tanh softcap score_mod",
                sdpa_without_softcap_ms=timer(
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, enable_gqa=True, **kw)), **lib)


def check_flash_lse(torch, F, timer, flash_attn, H=32, KV=8, win=0,
                    phase="check_flash_attn_lse", hd=64, cap=0.0):
    """The train forward: flash_attn with the logsumexp output, at the
    update's packed shape (32 rows of 127) with H query heads of ``hd`` over
    KV, a sliding window ``win`` (0: none; hymba's 1024 and gemma2-2b's
    4096 span the whole row, so SDPA's causal mask is the same function)
    and a score softcap ``cap`` (gemma2-2b's 50: the library call is then
    flex_attention, with its logsumexp)."""
    B, S = TRAIN_B, TRAIN_S
    g = torch.Generator(device="cuda").manual_seed(13)
    q, k, v = (torch.randn(B, S, n, hd, device="cuda", generator=g).bfloat16()
               for n in (H, KV, KV))
    kw = dict(window=win, attn_softcap=cap)
    out, lse = flash_attn.flash_attention(q, k, v, return_lse=True, **kw)
    ref, ref_lse = flash_attn.flash_attention_plain(q, k, v, return_lse=True,
                                                    **kw)
    torch.cuda.synchronize()
    err = max((out.float() - ref.float()).abs().max().item(),
              (lse - ref_lse).abs().max().item())
    atol = 2e-2
    if not err <= atol:
        fail(f"flash_attn (lse) at H/KV {H}/{KV} x {hd}, window {win}, "
             f"softcap {cap}, disagrees with its plain version: {err}")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib = attention_library(torch, F, timer, qt, kt, vt, ref, cap, win=win,
                            ref_lse=ref_lse, is_causal=True)
    kernel_ms = timer(lambda: flash_attn.flash_attention(
        q, k, v, return_lse=True, **kw))
    plain_ms = timer(lambda: flash_attn.flash_attention_plain(
        q, k, v, return_lse=True, **kw), iters=3, warmup=1)
    b_ms, b_by = cost_bound(flash_attn.flash_cost(q.shape, k.shape, 2,
                                                  window=win, lse=True),
                            PEAK_BF16_FLOPS)
    res = dict(shape=f"q {list(q.shape)} kv {list(k.shape)} bf16 causal"
               + (f", window {win}" if win else "")
               + (f", softcap {cap}" if cap else "")
               + ", with lse (B, H, S) f32",
               max_abs_err=err, atol=atol, ms=kernel_ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, **lib)
    if res["library_ms"]:
        res["vs_library"] = kernel_ms / res["library_ms"]
    emit(phase, **res)
    return res


def grad_excess(torch, got, want, atol, wide):
    """Largest excess of |got - want| over atol (<= 0: within tolerance);
    with ``wide`` (head_dim 128 and 256) over the larger of atol and one
    bf16 ulp of each element of ``want``: there dk and dv sum REP x S terms
    and reach |x| in [8, 16), where one ulp is 0.0625 > 5e-2, so kernel and
    plain version, both exact to ~1e-5 in float32, may round to neighbouring
    bf16 values."""
    got, want = got.float(), want.float()
    tol = torch.full_like(want, atol)
    if wide:
        tol = torch.maximum(tol, bf16_ulp(torch, want))
    return float(((got - want).abs() - tol).max())


def check_flash_bwd(torch, F, timer, flash_attn, H=32, KV=8, win=0,
                    phase="check_flash_attn_bwd", hd=64, cap=0.0):
    """The train backward: dq, dk, dv from the saved lse, against the plain
    version, at check_flash_lse's shapes, bit-equal across two launches;
    the library time is SDPA's backward alone (with a softcap
    flex_attention's, compiled)."""
    B, S = TRAIN_B, TRAIN_S
    g = torch.Generator(device="cuda").manual_seed(14)
    q, k, v = (torch.randn(B, S, n, hd, device="cuda", generator=g).bfloat16()
               for n in (H, KV, KV))
    do = torch.randn(B, S, H, hd, device="cuda", generator=g).bfloat16()
    kw = dict(window=win, attn_softcap=cap)
    out, lse = flash_attn.flash_attention(q, k, v, return_lse=True, **kw)
    grads = flash_attn.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    again = flash_attn.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    ref = flash_attn.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(grads, ref))
    atol = 5e-2
    excess = max(grad_excess(torch, a, b, atol, hd >= 128)
                 for a, b in zip(grads, ref))
    bit_equal = all(torch.equal(a, b) for a, b in zip(grads, again))
    del again
    if not (excess <= 0.0 and bit_equal):
        fail(f"flash_attn_bwd at H/KV {H}/{KV} x {hd}, window {win}, "
             f"softcap {cap}: {err} from its plain version (excess over the "
             f"tolerance {excess}), bit-equal across launches {bit_equal}")
    kernel_ms = timer(lambda: flash_attn.flash_attention_bwd(
        q, k, v, out, lse, do, **kw))
    plain_ms = timer(lambda: flash_attn.flash_attention_bwd_plain(
        q, k, v, out, lse, do, **kw), iters=3, warmup=1)
    # the library's backward alone: SDPA's, or with a softcap
    # flex_attention's (compiled)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)

    def grads_of(forward):
        outs = []               # the forward, run once, on the first call

        def run():
            if not outs:
                outs.append(forward())
            return torch.autograd.grad(outs[0], (qt, kt, vt), dot,
                                       retain_graph=True)
        return run

    def grads_err(grads):
        return max((a.transpose(1, 2).float() - b.float()).abs().max().item()
                   for a, b in zip(grads, ref))

    if cap > 0.0:
        lib = dict(library="flex_attention (compiled) backward, tanh "
                   "softcap score_mod", **flex_library(
                       timer, lambda opts: grads_of(flex_call(
                           torch, qt, kt, vt, cap, win=win,
                           kernel_options=opts)), grads_err))
    else:
        lib = dict(library="scaled_dot_product_attention backward",
                   **library_call(timer, grads_of(
                       lambda: F.scaled_dot_product_attention(
                           qt, kt, vt, is_causal=True, enable_gqa=True)),
                       grads_err))
    # read q, out, dout, k, v, lse; write dq, dk, dv; QK^T, dO V^T, dS K,
    # P^T dO, dS^T Q: 5 causal products
    b_ms, b_by = cost_bound(flash_attn.flash_cost(q.shape, k.shape, 2,
                                                  window=win, backward=True),
                            PEAK_BF16_FLOPS)
    res = dict(shape=f"q {list(q.shape)} kv {list(k.shape)} bf16 causal"
               + (f", window {win}" if win else "")
               + (f", softcap {cap}" if cap else ""),
               max_abs_err=err, atol=atol,
               tolerance="atol" + (" or one bf16 ulp of the element"
                                   if hd >= 128 else ""),
               max_excess_over_tolerance=excess, bit_equal_launches=bit_equal,
               ms=kernel_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               **lib)
    if res["library_ms"]:
        res["vs_library"] = kernel_ms / res["library_ms"]
    emit(phase, **res)
    return res


# the VLM's cross-attention: H/KV 64/8 heads of 128 against the 1601 media
# tokens (25 full tiles of 64 keys and one key over)
XATTN_H, XATTN_KV, XATTN_HD, XATTN_M = 64, 8, 128, 1601


def check_flash_cross(torch, F, timer, flash_attn):
    """The flash kernels non-causal with Sk != Sq, as llama-3.2-vision-90b's
    xattn layers run them: the forward with its logsumexp at the prefill
    shape, q (16, 512, 64, 128) against media k/v (16, 1601, 8, 128); the
    backward at the update's (32, 127) rows against 1601 keys, bit-equal
    across two launches; and the decode step, q (16, 1, 64, 128) against
    the cached media K/V (the flash kernel at Sq = 1). Each against its
    plain version (forward atol 2e-2, the logsumexp of rows that see every
    key included; backward atol 5e-2 or one bf16 ulp of the element), with
    SDPA non-causal as the library call. Returns {"cross_fwd",
    "cross_bwd", "cross_decode"}."""
    H, KV, hd, M = XATTN_H, XATTN_KV, XATTN_HD, XATTN_M
    out_res = {}
    for label, B, S in (("cross_fwd", 16, 512), ("cross_decode", 16, 1)):
        g = torch.Generator(device="cuda").manual_seed(31)
        q = torch.randn(B, S, H, hd, device="cuda", generator=g).bfloat16()
        k, v = (torch.randn(B, M, KV, hd, device="cuda",
                            generator=g).bfloat16() for _ in range(2))
        want_lse = label == "cross_fwd"
        kw = dict(causal=False, return_lse=want_lse)
        got = flash_attn.flash_attention(q, k, v, **kw)
        ref = flash_attn.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        out, lse = got if want_lse else (got, None)
        ref_out, ref_lse = ref if want_lse else (ref, None)
        err = (out.float() - ref_out.float()).abs().max().item()
        lse_err = ((lse - ref_lse).abs().max().item() if want_lse else 0.0)
        atol = 2e-2
        if not max(err, lse_err) <= atol:
            fail(f"flash_attn {label} at q {list(q.shape)} against "
                 f"{M} keys: {err} (lse {lse_err}) from its plain version")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = attention_library(torch, F, timer, qt, kt, vt, ref_out, 0.0)
        kernel_ms = timer(lambda: flash_attn.flash_attention(q, k, v, **kw))
        plain_ms = timer(lambda: flash_attn.flash_attention_plain(
            q, k, v, **kw), iters=3, warmup=1)
        b_ms, b_by = cost_bound(flash_attn.flash_cost(
            q.shape, k.shape, 2, causal=False, lse=want_lse), PEAK_BF16_FLOPS)
        res = dict(shape=f"q {list(q.shape)} kv {list(k.shape)} bf16 "
                   "non-causal" + (", with lse (B, H, S) f32" if want_lse
                                   else ""),
                   max_abs_err=max(err, lse_err), out_err=err,
                   lse_err=lse_err, atol=atol, ms=kernel_ms,
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, **lib)
        if res["library_ms"]:
            res["vs_library"] = kernel_ms / res["library_ms"]
        emit(f"check_flash_attn_{label}", **res)
        out_res[label] = res
        del q, k, v, got, ref
    B, S = TRAIN_B, TRAIN_S
    g = torch.Generator(device="cuda").manual_seed(32)
    q = torch.randn(B, S, H, hd, device="cuda", generator=g).bfloat16()
    k, v = (torch.randn(B, M, KV, hd, device="cuda", generator=g).bfloat16()
            for _ in range(2))
    do = torch.randn(B, S, H, hd, device="cuda", generator=g).bfloat16()
    kw = dict(causal=False)
    out, lse = flash_attn.flash_attention(q, k, v, return_lse=True, **kw)
    grads = flash_attn.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    again = flash_attn.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    ref = flash_attn.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(grads, ref))
    atol = 5e-2
    excess = max(grad_excess(torch, a, b, atol, True)
                 for a, b in zip(grads, ref))
    bit_equal = all(torch.equal(a, b) for a, b in zip(grads, again))
    del again
    if not (excess <= 0.0 and bit_equal):
        fail(f"flash_attn_bwd non-causal at q {list(q.shape)} against {M} "
             f"keys: {err} from its plain version (excess {excess}), "
             f"bit-equal across launches {bit_equal}")
    kernel_ms = timer(lambda: flash_attn.flash_attention_bwd(
        q, k, v, out, lse, do, **kw))
    plain_ms = timer(lambda: flash_attn.flash_attention_bwd_plain(
        q, k, v, out, lse, do, **kw), iters=3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)
    outs = []

    def sdpa_grads():
        if not outs:
            outs.append(F.scaled_dot_product_attention(qt, kt, vt,
                                                       enable_gqa=True))
        return torch.autograd.grad(outs[0], (qt, kt, vt), dot,
                                   retain_graph=True)

    lib = dict(library="scaled_dot_product_attention backward",
               **library_call(timer, sdpa_grads, lambda gs: max(
                   (a.transpose(1, 2).float() - b.float()).abs().max().item()
                   for a, b in zip(gs, ref))))
    b_ms, b_by = cost_bound(flash_attn.flash_cost(
        q.shape, k.shape, 2, causal=False, backward=True), PEAK_BF16_FLOPS)
    res = dict(shape=f"q {list(q.shape)} kv {list(k.shape)} bf16 non-causal",
               max_abs_err=err, atol=atol,
               tolerance="atol or one bf16 ulp of the element",
               max_excess_over_tolerance=excess, bit_equal_launches=bit_equal,
               ms=kernel_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               **lib)
    if res["library_ms"]:
        res["vs_library"] = kernel_ms / res["library_ms"]
    emit("check_flash_attn_bwd_cross", **res)
    out_res["cross_bwd"] = res
    return out_res


def check_fused_is_grpo(torch, timer, fio, d=2048, V=128256, tied=True,
                        suffix="", cap=0.0):
    """The loss kernels at a train phase's largest packed shape: R = 32 x
    127 rows, hidden (R, d) bf16, against the f32 unembedding: with
    ``tied`` the embedding (V, d) read in its own layout (llama3.2-1b's
    d 2048 / V 128256, hymba-1.5b's 1600 / 32001), else a row-major
    lm_head (d, V) (rwkv6-1.6b's 2048 / 65536). Every one runs on the
    tensor cores from split bf16 terms and is bound at 989 TFLOP/s: the
    forward and dw 2 passes of 2 R d V, bwd_dh 5; each keeps beside it the
    f32 FMA bound (one pass at 67 TFLOP/s) of the f32 product its plain
    version computes. ``cap`` is the final-logit softcap (gemma2-2b's 30).
    Rows are emitted as check_<kernel><suffix>."""
    R = TRAIN_B * TRAIN_S
    g = torch.Generator(device="cuda").manual_seed(15)
    h = torch.randn(R, d, device="cuda", generator=g).bfloat16()
    if tied:
        w = (torch.randn(V, d, device="cuda", generator=g) * 0.02).T
    else:
        w = torch.randn(d, V, device="cuda", generator=g) * 0.02
    t = torch.randint(0, V, (R,), device="cuda", generator=g,
                      dtype=torch.int32)
    beh = torch.randn(R, device="cuda", generator=g) * 0.3 - 11.0
    adv = torch.randn(R, device="cuda", generator=g)
    kw = dict(logit_softcap=cap, clip_low=0.2, clip_high=0.28, use_is=True,
              is_ratio_cap=10.0, entropy_coef=0.0)
    outs = fio.fused_is_grpo_fwd_rows(h, w, t, beh, adv, **kw)
    ref = fio.fwd_plain(h, w, t, beh, adv, **kw)
    torch.cuda.synchronize()
    err_f = max((a - b).abs().max().item() for a, b in zip(outs, ref))
    atol_f = 1e-3
    if not err_f <= atol_f:
        fail(f"fused_is_grpo fwd (d {d}, V {V}) disagrees with its plain "
             f"version: {err_f}")
    _, _, logp, lse, ent = outs
    ca = torch.randn(R, device="cuda", generator=g)
    ce = torch.randn(R, device="cuda", generator=g) * 0.1
    ebar = lse - ent
    dl, dh = fio.fused_is_grpo_bwd_dh_rows(h, w, t, lse, ebar, ca, ce,
                                           logit_softcap=cap)
    dw = fio.fused_is_grpo_bwd_dw_rows(h, dl, torch.empty_like(w))
    rdl, rdh = fio.bwd_dh_plain(h, w, t, lse, ebar, ca, ce,
                                logit_softcap=cap)
    rdw = fio.bwd_dw_plain(h, rdl)
    torch.cuda.synchronize()
    # sums of 128256 (dh) or 4064 (dw) f32 products in another order:
    # errors relative to the largest element
    err_dh = ((dh - rdh).abs().max() / rdh.abs().max()).item()
    err_dw = ((dw - rdw).abs().max() / rdw.abs().max()).item()
    rtol = 1e-4
    if not (err_dh <= rtol and err_dw <= rtol):
        fail(f"fused_is_grpo bwd (d {d}, V {V}) disagrees with its plain "
             f"version: dh {err_dh}, dw {err_dw}")
    del rdl, rdh, rdw
    hf = h.float()
    fwd_ms = timer(lambda: fio.fused_is_grpo_fwd_rows(h, w, t, beh, adv,
                                                      **kw), iters=3)
    fwd_plain_ms = timer(lambda: fio.fwd_plain(h, w, t, beh, adv, **kw),
                         iters=3)
    gemm_ms = timer(lambda: hf @ w, iters=3)
    dh_ms = timer(lambda: fio.fused_is_grpo_bwd_dh_rows(
        h, w, t, lse, ebar, ca, ce, logit_softcap=cap), iters=3, warmup=1)
    dh_plain_ms = timer(lambda: fio.bwd_dh_plain(
        h, w, t, lse, ebar, ca, ce, logit_softcap=cap), iters=3, warmup=1)
    dw_ms = timer(lambda: fio.fused_is_grpo_bwd_dw_rows(h, dl, dw),
                  iters=3, warmup=1)
    dw_plain_ms = timer(lambda: fio.bwd_dw_plain(h, dl), iters=3, warmup=1)
    # library times: one f32 cuBLAS call (TF32 off) each; for bwd_dh only
    # its dh GEMM, without the logits recompute
    dh_gemm_ms = timer(lambda: dl @ w.T, iters=3, warmup=1)
    dw_gemm_ms = timer(lambda: hf.T @ dl, iters=3, warmup=1)
    op = 2 * R * d * V
    shape = (f"hidden [{R}, {d}] bf16, "
             + (f"w = embed.T of [{V}, {d}] f32, " if tied
                else f"w = lm_head [{d}, {V}] f32, ")
             + (f"logit softcap {cap}, " if cap else "") + "tensor cores, ")
    # the tensor-core passes (fio.TC_PASSES) of the kernels' work
    # (fio.loss_cost): the forward reads 3 and writes 5 float32 a row;
    # bwd_dh recomputes the logits and writes dl (R, V) and dh; bwd_dw
    # reads h and dl and writes dw (V, d); beside each, the f32 FMA bound
    # of its SIMT passes (fio.SIMT_PASSES)
    (b_f, b_f_f32), (b_dh, b_dh_f32), (b_dw, b_dw_f32) = (
        (cost_bound(fio.loss_cost(k, R, d, V), PEAK_BF16_FLOPS),
         bound(fio.loss_cost(k, R, d, V)[1], fio.SIMT_PASSES[k] * op,
               PEAK_F32_FLOPS)) for k in ("fwd", "dh", "dw"))
    res = {
        "fused_is_grpo_fwd": dict(
            shape=shape + "2 bf16 passes of split f32 w",
            max_abs_err=err_f, atol=atol_f, ms=fwd_ms,
            plain_ms=fwd_plain_ms, library_ms=gemm_ms,
            library_what="logits GEMM only (f32 cuBLAS hidden @ w)",
            bound_ms=b_f[0], bound_by=b_f[1],
            bound_f32_fma_ms=b_f_f32[0], bound_f32_fma_by=b_f_f32[1]),
        "fused_is_grpo_bwd_dh": dict(
            shape=shape + "5 bf16 passes of split f32 terms",
            max_abs_err=err_dh, rtol_of_max=rtol, ms=dh_ms,
            plain_ms=dh_plain_ms, library_ms=dh_gemm_ms,
            library_what="dh GEMM only (f32 cuBLAS dl @ w^T)",
            bound_ms=b_dh[0], bound_by=b_dh[1],
            bound_f32_fma_ms=b_dh_f32[0], bound_f32_fma_by=b_dh_f32[1]),
        "fused_is_grpo_bwd_dw": dict(
            shape=shape + "2 bf16 passes of split f32 dl",
            max_abs_err=err_dw, rtol_of_max=rtol, ms=dw_ms,
            plain_ms=dw_plain_ms, library_ms=dw_gemm_ms,
            library_what="f32 cuBLAS hidden^T @ dl",
            bound_ms=b_dw[0], bound_by=b_dw[1],
            bound_f32_fma_ms=b_dw_f32[0], bound_f32_fma_by=b_dw_f32[1]),
    }
    for name, r in res.items():
        emit(f"check_{name}{suffix}", **r)
    return res


def check_fused_logprob(torch, timer, flp):
    """The legacy loss's log-prob kernel at the train phase's largest packed
    shape (R = 32 x 127 rows, d = 2048, V = 128256, hidden bf16, the tied
    f32 embedding in its own layout). The IS-GRPO forward's kernel 1 on the
    tensor cores: bound by 2 bf16 passes of 2 R d V at 989 TFLOP/s, the f32
    FMA bound (one pass at 67 TFLOP/s) beside it; the library time is the
    f32 cuBLAS logits GEMM alone."""
    R, d, V = TRAIN_B * TRAIN_S, 2048, 128256
    g = torch.Generator(device="cuda").manual_seed(16)
    h = torch.randn(R, d, device="cuda", generator=g).bfloat16()
    w = (torch.randn(V, d, device="cuda", generator=g) * 0.02).T
    t = torch.randint(0, V, (R,), device="cuda", generator=g,
                      dtype=torch.int32)
    logp, lse = flp.fused_logprob_rows(h, w, t)
    rlogp, rlse = flp.fused_logprob_plain(h, w, t)
    torch.cuda.synchronize()
    err = max((logp - rlogp).abs().max().item(),
              (lse - rlse).abs().max().item())
    atol = 1e-3
    if not err <= atol:
        fail(f"fused_logprob disagrees with its plain version: {err}")
    hf = h.float()
    kernel_ms = timer(lambda: flp.fused_logprob_rows(h, w, t), iters=3)
    plain_ms = timer(lambda: flp.fused_logprob_plain(h, w, t), iters=3)
    gemm_ms = timer(lambda: hf @ w, iters=3)
    from repro_torch.hopper import fused_is_grpo as fio
    cost = fio.loss_cost("logprob", R, d, V)
    b_ms, b_by = cost_bound(cost, PEAK_BF16_FLOPS)
    b_f32 = bound(cost[1], fio.SIMT_PASSES["fwd"] * 2 * R * d * V,
                  PEAK_F32_FLOPS)
    res = dict(shape=f"hidden [{R}, {d}] bf16, w = embed.T of [{V}, {d}] "
               "f32, tensor cores, 2 bf16 passes of split f32 w; logp and "
               "lse",
               max_abs_err=err, atol=atol, ms=kernel_ms, plain_ms=plain_ms,
               library_ms=gemm_ms,
               library_what="logits GEMM only (f32 cuBLAS hidden @ w)",
               bound_ms=b_ms, bound_by=b_by, bound_f32_fma_ms=b_f32[0],
               bound_f32_fma_by=b_f32[1])
    emit("check_fused_logprob", **res)
    return res


def train_reference_phase(torch, np, copris, model, tree, adam, cfg):
    """make_loss_fn + make_train_step on the GPU (kernels) against the CPU
    (plain versions): reduced llama3.2-1b, vocab 8192, float32, for the
    fused branch and the legacy fused_loss=False one. Loss and metrics atol
    1e-4; each gradient leaf within 1e-4 of its own largest element (the
    kernels sum in another order), a leaf whose reference gradient is all
    zero exactly zero; grad_norm rtol 1e-5; no attention projection (nor,
    for the hybrid families' "train_reference_hybrid", no scan parameter)
    left at a zero gradient."""
    from repro_torch.common.config import TrainConfig
    for phase, tc in (
            ("train_reference", TrainConfig(lr=1e-3, entropy_coef=0.01,
                                            remat=True)),
            ("train_reference_legacy", TrainConfig(lr=1e-3, remat=True,
                                                   fused_loss=False))):
        train_reference_case(torch, np, copris, model, tree, adam, cfg, tc,
                             phase)


def open_gates(params):
    """Set the xattn layers' tanh gates (zero at init, where the
    cross-attention would not reach the output) to 0.5 and 0.7."""
    for layer in params["layers"]:
        if "xattn" in layer:
            layer["xattn"]["gate"].fill_(0.5)
            layer["mlp_gate"].fill_(0.7)
    return params


def ref_media(np, cfg, rows=None):
    """A media model's frontend embeddings, (M, d_media) or (rows, M,
    d_media), float32, from a seed; None for a model without media."""
    if not cfg.uses_media:
        return None
    xa = cfg.cross_attn
    shape = (xa.num_media_tokens, xa.d_media)
    m = (np.random.default_rng(6).normal(size=shape) * 0.1).astype(
        np.float32)
    return m if rows is None else np.broadcast_to(m, (rows,) + shape).copy()


def train_reference_case(torch, np, copris, model, tree, adam, cfg, tc,
                         phase):
    """See train_reference_phase. A MoE config reports its router loss
    (``router_aux`` among the metrics) and fails if the router or any
    expert of any layer has an all-zero gradient; a VLM config trains on
    ``mb["media"]`` with its gates open and fails if a cross-attention
    projection, its gate or ``mlp_gate`` has one."""
    rng = np.random.default_rng(4)
    N, T = 8, 64
    mask = np.zeros((N, T), np.float32)
    for n in range(N):
        mask[n, rng.integers(4, 16):rng.integers(30, T)] = 1.0
    host = dict(tokens=rng.integers(0, cfg.vocab_size, (N, T)).astype(
                    np.int32),
                loss_mask=mask,
                behaviour_logp=((rng.standard_normal((N, T)) * 0.3 - 9.0)
                                * mask).astype(np.float32),
                advantages=rng.standard_normal(N).astype(np.float32))
    if cfg.uses_media:
        host["media"] = ref_media(np, cfg, rows=N)
    base = open_gates(model.init_params(cfg, seed=5, device="cpu"))
    res = {}
    for dev in ("cuda", "cpu"):
        params = tree.tree_map(lambda x: x.to(dev).clone().requires_grad_(),
                               base)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        loss, metrics = copris.make_loss_fn(cfg, tc)(params, batch)
        grads = torch.autograd.grad(loss, tree.leaves(params))
        _, _, sm = copris.make_train_step(cfg, tc)(
            params, adam.init(params), batch, 1e-3)
        res[dev] = dict(loss=float(loss.detach()),
                        metrics={k: float(v) for k, v in metrics.items()},
                        grad_norm=float(sm["grad_norm"]),
                        grads=[g.cpu() for g in grads], params=params)
    def leaf_err(a, b):
        scale = float(b.abs().max())
        diff = float((a - b).abs().max())
        return diff / scale if scale > 0.0 else diff

    g_err = max(leaf_err(a, b)
                for a, b in zip(res["cuda"]["grads"], res["cpu"]["grads"]))
    gn_err = (abs(res["cuda"]["grad_norm"] - res["cpu"]["grad_norm"])
              / res["cpu"]["grad_norm"])
    m_err = max(abs(res["cuda"]["metrics"][k] - res["cpu"]["metrics"][k])
                for k in res["cpu"]["metrics"])
    loss_err = abs(res["cuda"]["loss"] - res["cpu"]["loss"])
    gpu_grads = tree.unflatten(res["cuda"]["params"], res["cuda"]["grads"])
    # no attention projection, no scan parameter, no router, no expert and
    # no cross-attention weight or gate left at zero gradient
    watched = {"attn": ("wq", "wk", "wv", "wo"), "ssm": ("A_log", "D"),
               "tm": ("u", "w_base"), "moe": ("router",),
               "xattn": ("wq", "wk", "wv", "wo", "gate")}
    zero_attn = [f"layer{i}.{block}.{n}"
                 for i, layer in enumerate(gpu_grads["layers"])
                 for block, names in watched.items() if block in layer
                 for n in names
                 if float(layer[block][n].abs().max()) == 0.0]
    for i, layer in enumerate(gpu_grads["layers"]):
        if "mlp_gate" in layer and float(layer["mlp_gate"].abs()) == 0.0:
            zero_attn.append(f"layer{i}.mlp_gate")
        for n in ("wi", "wg", "wo") if "moe" in layer else ():
            per_expert = layer["moe"][n].abs().flatten(1).amax(1)
            zero_attn += [f"layer{i}.moe.{n}[{e}]"
                          for e in (per_expert == 0).nonzero().flatten()
                          .tolist()]
    extra = {}
    if cfg.moe is not None:
        extra = dict(router_aux_gpu=res["cuda"]["metrics"]["router_aux"],
                     router_aux_cpu=res["cpu"]["metrics"]["router_aux"],
                     dispatch=cfg.moe.dispatch,
                     capacity_factor=cfg.moe.capacity_factor)
    if cfg.uses_media:
        extra["media"] = list(host["media"].shape)
    emit(phase, config=cfg.name, vocab=cfg.vocab_size,
         fused_loss=tc.fused_loss, metrics=sorted(res["cpu"]["metrics"]),
         batch=f"{N} x {T}", loss_gpu=res["cuda"]["loss"],
         loss_cpu=res["cpu"]["loss"], loss_err=loss_err,
         max_metric_err=m_err, max_grad_err_rel=g_err, grad_rtol=1e-4,
         grad_norm_gpu=res["cuda"]["grad_norm"],
         grad_norm_cpu=res["cpu"]["grad_norm"], grad_norm_rel_err=gn_err,
         grad_norm_rtol=1e-5, zero_watched_grads=zero_attn, atol=1e-4,
         **extra)
    if zero_attn:
        fail(f"attention, scan, expert or cross-attention weights got zero "
             f"gradient on the GPU: {zero_attn}")
    if not (loss_err <= 1e-4 and m_err <= 1e-4 and g_err <= 1e-4
            and gn_err <= 1e-5):
        fail(f"{phase}: GPU train step disagrees with the CPU train step")


def reference_phase(torch, np, serve_mod, model, cfg, phase="reference"):
    """Engine on the GPU (kernels) vs the same engine on the CPU (plain
    versions) on a reduced config in float32, same weights and keys, over
    the dense and the paged KV cache; and the CPU paged engine against the
    CPU dense one (the same plain arithmetic: logps within 1e-6, or 1e-5
    where a recurrent state, a MoE router or cross-attention carries the
    paged prefill's rounding). A VLM serves with media and its gates open.
    Where a MoE's token streams part, the phase reports the router margin
    (its top_k-th minus its (k+1)-th probability) of the token where they
    part, the least over the layers."""
    params = open_gates(model.init_params(cfg, seed=3, device="cpu"))
    media = ref_media(np, cfg)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size - 1, int(n))
               for n in rng.integers(8, 60, 6)]
    outs = {}
    for dev, kv in (("cuda", "dense"), ("cpu", "dense"), ("cuda", "paged"),
                    ("cpu", "paged")):
        ro = serve_mod.RolloutConfig(
            batch_size=1, group_size=1, max_prompt_len=64,
            max_response_len=24, concurrency=4, mode="copris",
            temperature=0.8, top_k=50, top_p=0.95, kv_backend=kv,
            kv_page_size=16)
        eng = serve_mod.ServeEngine(cfg, ro, eos_id=cfg.vocab_size - 1,
                                    params=params,
                                    key=serve_mod.prng.PRNGKey(9),
                                    media=media, device=dev)
        for p in prompts:
            eng.submit(serve_mod.GenerateRequest(prompt=p))
        outs[dev, kv] = {r.request_id: r for r in eng.drain()}
        eng.close()

    def compare(a, b):
        same = sum(outs[a][i].tokens == outs[b][i].tokens for i in outs[b])
        err = max(max(abs(x - y) for x, y in zip(outs[a][i].logprobs,
                                                 outs[b][i].logprobs))
                  for i in outs[b])
        return same, err

    cpu_atol = 1e-6 if cfg.block_pattern == ("attn",) \
        and not cfg.prefix_pattern else 1e-5
    pairs = {"gpu_dense_vs_cpu_dense": (("cuda", "dense"), ("cpu", "dense"),
                                        1e-3),
             "gpu_paged_vs_cpu_paged": (("cuda", "paged"), ("cpu", "paged"),
                                        1e-3),
             "gpu_paged_vs_cpu_dense": (("cuda", "paged"), ("cpu", "dense"),
                                        1e-3),
             "cpu_paged_vs_cpu_dense": (("cpu", "paged"), ("cpu", "dense"),
                                        cpu_atol)}
    res = {}
    for name, (a, b, atol) in pairs.items():
        same, err = compare(a, b)
        res[name] = dict(equal_token_streams=same, max_logp_err=err,
                         atol=atol)
        if same != len(prompts) and cfg.moe is not None:
            res[name]["router_margin_where_parted"] = router_margins(
                torch, np, model, cfg, params, prompts, outs[a], outs[b])
    extra = {}
    if cfg.moe is not None:
        extra = dict(dispatch=cfg.moe.dispatch,
                     capacity_factor=cfg.moe.capacity_factor)
    if media is not None:
        extra["media"] = list(media.shape)
    emit(phase, config=cfg.name, requests=len(prompts),
         d_model=cfg.d_model, heads=cfg.num_heads, head_dim=cfg.head_dim,
         layers=list(cfg.prefix_pattern)
         + list(cfg.block_pattern) * cfg.num_repeats, **extra, **res)
    for name, r in res.items():
        if r["equal_token_streams"] != len(prompts) \
                or not r["max_logp_err"] <= r["atol"]:
            fail(f"{phase} {name}: engines disagree on {cfg.name}")


def router_margins(torch, np, model, cfg, params, prompts, a, b):
    """For each request whose two token streams part: the least router
    margin (top_k-th minus (k+1)-th probability, over the MoE layers) at
    the position that chose the first differing token, from a CPU forward
    of the prompt and the common tokens (the dense dispatch routes each
    token alone)."""
    from repro_torch.models import moe as moe_mod
    out = {}
    orig = moe_mod.route
    for i in b:
        ta, tb = a[i].tokens, b[i].tokens
        if ta == tb:
            continue
        n = next(j for j in range(min(len(ta), len(tb)) + 1)
                 if j == min(len(ta), len(tb)) or ta[j] != tb[j])
        seq = np.concatenate([prompts[i], np.asarray(tb[:n], np.int64)])
        seen = []

        def spy(router, c, xt, _orig=orig, _seen=seen):
            r = _orig(router, c, xt)
            top = torch.topk(r[0], c.moe.top_k + 1, dim=-1).values
            _seen.append((top[:, -2] - top[:, -1])[-1].item())
            return r

        moe_mod.route = spy
        try:
            dense = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, dispatch="dense"))
            media = ref_media(np, cfg, rows=1)
            with torch.no_grad():
                model.forward_train(
                    params, dense, torch.from_numpy(seq[None]),
                    media=None if media is None else torch.from_numpy(media))
        finally:
            moe_mod.route = orig
        out[str(i)] = dict(position=len(seq) - 1, margin=min(seen))
    return out


def device_us(e):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(e, name):
            return getattr(e, name)
    return 0.0


def device_profile(torch, run):
    """Run ``run()`` under torch.profiler, recording device activity only
    (kernels, copies, memsets): recording every host op as well would slow
    the host being measured, and processing its events took longer than the
    run itself. Returns (host wall ms to the final device sync, device busy
    ms, the device events grouped by name)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None)
              == torch.autograd.DeviceType.CUDA and device_us(e) > 0]
    if not events:
        fail("the profiler recorded no device activity")
    return wall_ms, sum(device_us(e) for e in events) / 1e3, events


def profile_phase(torch, np, serve, cfg, chunks=2, phase="profile",
                  prompt_hi=512, sync_free=False):
    """Where a steady decode chunk's time goes: the device profile of
    ``chunks`` ServeEngine.step() calls after 16 requests of 64 to
    ``prompt_hi`` prompt tokens were submitted (a full pool on the dense
    cache) — host wall time per chunk, device busy time, top device
    kernels. ``sync_free``: first one more steady step whose decode chunk
    runs under :func:`sync_free_chunk` (IR403 on the card)."""
    rng = np.random.default_rng(7)
    for _ in range(16):
        serve.submit(serve_request(rng, cfg, hi=prompt_hi))
    serve.step()                        # opens the stage: the prefill
    serve.step()                        # one warm decode chunk
    serve.eng.block_until_ready()
    guarded = sync_free_chunk(torch, serve) if sync_free else None

    def run():
        for _ in range(chunks):
            serve.step()

    wall_ms, busy_ms, events = device_profile(torch, run)
    wall_ms /= chunks
    busy_ms /= chunks
    decode_ms = sum(device_us(e) for e in events
                    if "decode_kernel" in e.key) / 1e3 / chunks
    top = sorted(events, key=device_us, reverse=True)[:8]
    res = dict(what=f"{chunks} decode chunks of "
               f"{serve.eng.ro.decode_chunk} steps, pool {serve.eng.pool}, "
               f"{cfg.name} "
               f"bf16, kv_backend {serve.eng.ro.kv_backend}",
               live_slots=sum(t is not None for t in serve.eng.slots),
               wall_ms_per_chunk=wall_ms, device_busy_ms_per_chunk=busy_ms,
               decode_attn_ms_per_chunk=decode_ms,
               device_idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
               top_device_ops=[{"name": e.key[:80], "count": e.count,
                                "ms_per_chunk": device_us(e) / 1e3 / chunks}
                               for e in top])
    if guarded is not None:
        res["ir403_sync_free_decode_chunks"] = guarded
    emit(phase, **res)
    serve.close()                       # in-flight requests stay buffered
    return res


def sync_free_chunk(torch, serve) -> int:
    """IR403 on the card: one steady ServeEngine.step() whose decode chunk
    (``models/model.decode_scan``, the engine's decode and sampling
    kernels) runs under ``torch.cuda.set_sync_debug_mode("error")``, so
    any operation that makes the host wait for the card inside the chunk
    raises (the transfer of its tokens after it is outside). Returns the
    chunks that ran guarded (the step must have run one)."""
    from repro_torch.models import model
    real, ran = model.decode_scan, []

    def guarded(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = real(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        ran.append(1)
        return out

    model.decode_scan = guarded
    try:
        serve.step()
    finally:
        model.decode_scan = real
    if not ran:
        fail("IR403: the steady step ran no decode chunk")
    return len(ran)


def serve_request(rng, cfg, lo=64, hi=512):
    from repro_torch.launch.serve import GenerateRequest
    n = int(rng.integers(lo, hi + 1))
    return GenerateRequest(prompt=rng.integers(0, cfg.vocab_size - 1, n))


def profile_update(torch, tr, cfg, tc):
    """The device profile of one more update (make_train_step) on the train
    phase's last batch: wall time, device busy time and the top device
    kernels of the training half of a step (the serve phase's profile
    covers decoding)."""
    from repro_torch.core import copris, grpo
    b = tr.last_batch
    batch = {k: torch.from_numpy(b[k]).cuda()
             for k in ("tokens", "loss_mask", "behaviour_logp")}
    batch["advantages"] = grpo.group_advantages(
        torch.from_numpy(b["rewards"]).cuda(), tr.ro.group_size)
    step = copris.make_train_step(cfg, tc)
    torch.cuda.synchronize()
    wall_ms, busy_ms, events = device_profile(
        torch, lambda: step(tr.params, tr.opt_state, batch, tc.lr))
    top = sorted(events, key=device_us, reverse=True)[:10]
    return dict(what=f"one make_train_step on a packed batch "
                f"{list(batch['tokens'].shape)}, {cfg.name} bf16 compute, "
                "f32 masters, remat",
                wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
                top_device_ops=[{"name": e.key[:80], "count": e.count,
                                 "ms": device_us(e) / 1e3} for e in top])


def train_phase(torch, np, kernels, arch="llama3.2-1b", phase="train",
                steps=3, seed=0, entropy_coef=0.0, keep=None, num_layers=0,
                cut=""):
    """The main path of a training slice: sft_warmup for 4 steps, then
    ``steps`` sequential CoPRISTrainer.step() calls on ``arch`` at full
    width (bf16 compute, f32 master weights, remat, the fused loss, random
    weights from ``seed``), then the device profile of one more update.
    Every kernel's launch count (with the scans' backward kernels') is
    reset just before the steps and read just after. With an entropy bonus
    every step must have a nonzero gradient (the hybrids' phases: the
    scans' backward kernels then carry one even when all advantages are
    zero). With a dict ``keep``, the SFT-warmed weights go into it, copied
    to the host (``params``), and the steps' wall times (``step_time``).
    ``num_layers`` > 0 keeps that many layers at the full widths, for the
    reason ``cut``. Returns the launch counts."""
    from repro_torch.common.config import RolloutConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.core.copris import CoPRISTrainer
    from repro_torch.data.sft import sft_warmup
    from repro_torch.data.tasks import EOS, AdditionTask
    from repro_torch.models import model as M
    gc.collect()                        # the previous phase's trainer
    torch.cuda.empty_cache()
    cfg = get_config(arch)
    full_layers = cfg.num_layers
    if num_layers:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    task = AdditionTask(max_value=20, seed=seed)
    params = M.init_params(cfg, seed=seed, device="cuda")
    t0 = time.perf_counter()
    params, sft_loss = sft_warmup(params, cfg, task, steps=4, batch_size=32,
                                  max_len=24, lr=1e-4)
    torch.cuda.synchronize()
    sft_s = time.perf_counter() - t0
    if not np.isfinite(sft_loss):
        fail(f"{phase}: sft loss not finite: {sft_loss}")
    if keep is not None:
        from repro_torch.common.tree import tree_map
        keep["params"] = tree_map(lambda t: t.detach().cpu(), params)
    # max_len = 128 (the budget 4 + 124, rounded up to the 64-token bucket)
    # is below prompt + response for the task's 5-7 token prompts: a
    # trajectory stops at 127 - len(prompt) tokens, so groups with longer
    # prompts finish first, early termination evicts the rest, and the next
    # step resumes them. Packed batches are 32 x 128 tokens.
    ro = RolloutConfig(batch_size=8, group_size=4, max_prompt_len=4,
                       max_response_len=124, concurrency=16, mode="copris",
                       temperature=1.0)
    tc = TrainConfig(lr=1e-5, warmup_steps=1, seed=seed,
                     entropy_coef=entropy_coef)
    tr = CoPRISTrainer(cfg, ro, tc, task, eos_id=EOS, params=params)
    del params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(kernels)
    outs = []
    try:
        for _ in range(steps):
            resumed0 = tr.engine.stats_snapshot().get("resumed", 0)
            out = tr.step()
            out["resumed"] = (tr.engine.stats_snapshot()["resumed"]
                              - resumed0)
            out["rows"] = int(tr.last_batch["tokens"].shape[0]
                              * (tr.last_batch["tokens"].shape[1] - 1))
            outs.append(out)
        torch.cuda.synchronize()
        launches = read_launches(kernels, backward=True)
        prof = profile_update(torch, tr, cfg, tc)
        peak = torch.cuda.max_memory_allocated() / 1e9
    finally:
        tr.close()
    if keep is not None:
        keep["step_time"] = [o["step_time"] for o in outs]
    keys = ("reward_mean", "pg_loss", "grad_norm", "ratio_mean",
            "off_policy_frac") + (("router_aux",) if cfg.moe else ())
    extra = {}
    if num_layers:
        extra["depth_cut"] = f"{num_layers} of {full_layers} layers: {cut}"
    if cfg.moe:
        extra.update(moe_dispatch=cfg.moe.dispatch,
                     capacity_factor=cfg.moe.capacity_factor,
                     router_aux_coef=cfg.moe.router_aux_coef)
    emit(phase, arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
         heads=f"{cfg.num_heads}/{cfg.num_kv_heads} x {cfg.head_dim}",
         vocab=cfg.vocab_size, tied=cfg.tie_embeddings, sft_steps=4,
         sft_loss=sft_loss, sft_seconds=sft_s, entropy_coef=entropy_coef,
         steps=[{k: o[k] for k in keys + (
             "rollout_time", "reward_time", "update_time", "step_time",
             "resumed", "multi_stage_trajs", "buffer_unfinished", "rows",
             "mean_resp_len", "entropy", "clip_frac")} for o in outs],
         peak_mem_gb=peak, launches=launches, **extra)
    emit(f"{phase}_profile", **prof)
    for o in outs:
        bad = [k for k in keys if not np.isfinite(o[k])]
        if bad:
            fail(f"{phase} step {o['step']}: not finite: {bad}")
        if entropy_coef > 0.0 and not o["grad_norm"] > 0.0:
            fail(f"{phase} step {o['step']}: a zero gradient")
        if cfg.moe and not o["router_aux"] > 0.0:
            fail(f"{phase} step {o['step']}: router_aux "
                 f"{o['router_aux']} not > 0")
    if not all(n > 0 for n in launches.values()):
        fail(f"a kernel of {arch}'s training path never launched: "
             f"{launches}")
    for name in ("ssm_scan", "wkv6"):
        # a scan's backward: once per layer per update; its save kernel
        # once per forward under autograd, twice under remat (the step's
        # and the recompute's)
        want = {f"{name}_bwd": steps * cfg.num_layers,
                f"{name}_save": steps * cfg.num_layers * (1 + tc.remat)}
        for key, n in want.items():
            if key in launches and launches[key] != n:
                fail(f"{phase}: {key} launched {launches[key]} times in "
                     f"{steps} updates of {cfg.num_layers} layers")
    return launches


def grad_vision_phase(torch, np, kernels, num_layers=5):
    """llama-3.2-vision-90b's loss gradient at full width: one make_loss_fn
    (the fused loss, entropy 0.01) and its backward on 8 rows of 128 tokens
    with mb["media"] (8 x 1601 x 7680), float32 weights, bf16 compute,
    remat, the gates open, at one period of its layers (4 attn, 1 xattn;
    the weights and their gradients of 5 layers are ~51 GB, the optimizer
    state would not fit beside them). The VLM trains only through its
    loss: as in the reference, its rollouts carry no media. The flash
    kernels run causal (self-attention) and non-causal against the 1601
    media keys (the xattn layer), forward with the logsumexp and backward;
    every kernel of the path must launch, the gates and every
    cross-attention projection get a nonzero gradient. Returns the launch
    counts."""
    from repro_torch.common.config import TrainConfig
    from repro_torch.common.tree import leaves, unflatten
    from repro_torch.configs import get_config
    from repro_torch.core import copris
    from repro_torch.models import model as M
    gc.collect()
    torch.cuda.empty_cache()
    full = get_config("llama-3.2-vision-90b")
    cfg = dataclasses.replace(full, num_layers=num_layers)
    params = open_gates(M.init_params(cfg, seed=2, device="cuda"))
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    rng = np.random.default_rng(8)
    N, T = 8, 128
    mask = np.zeros((N, T), np.float32)
    mask[:, 16:] = 1.0
    host = dict(tokens=rng.integers(0, cfg.vocab_size - 1, (N, T)).astype(
                    np.int32), loss_mask=mask,
                behaviour_logp=((rng.standard_normal((N, T)) * 0.3 - 11.0)
                                * mask).astype(np.float32),
                advantages=rng.standard_normal(N).astype(np.float32))
    batch = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
    xa = cfg.cross_attn
    batch["media"] = torch.randn(
        N, xa.num_media_tokens, xa.d_media, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(9)) * 0.1
    loss_fn = copris.make_loss_fn(cfg, TrainConfig(entropy_coef=0.01,
                                                   remat=True))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(kernels)
    t0 = time.perf_counter()
    loss, metrics = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, flat)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches(kernels)
    g = unflatten(params, list(grads))
    xattn = [(i, layer) for i, layer in enumerate(g["layers"])
             if "xattn" in layer]
    zero = [f"layer{i}.{n}" for i, layer in xattn
            for n, t in (("xattn.gate", layer["xattn"]["gate"]),
                         ("mlp_gate", layer["mlp_gate"]),
                         *((f"xattn.{k}", layer["xattn"][k])
                           for k in ("wq", "wk", "wv", "wo")))
            if float(t.abs().max()) == 0.0]
    finite = all(bool(torch.isfinite(t).all()) for t in grads)
    emit("grad_vision", arch=cfg.name, layers=cfg.num_layers,
         depth_cut=f"{num_layers} of {full.num_layers} layers: the float32 "
         "weights and gradients of one period (~51 GB) fit the card, an "
         "optimizer's state beside them would not",
         d_model=cfg.d_model,
         heads=f"{cfg.num_heads}/{cfg.num_kv_heads} x {cfg.head_dim}",
         batch=f"{N} x {T}", media=list(batch["media"].shape),
         loss=float(loss.detach()),
         metrics={k: float(v) for k, v in metrics.items()},
         gate_grads={f"layer{i}": dict(
             gate=float(layer["xattn"]["gate"]),
             mlp_gate=float(layer["mlp_gate"])) for i, layer in xattn},
         seconds=seconds, launches=launches, zero_grads=zero,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if not (np.isfinite(float(loss.detach())) and finite):
        fail("grad_vision: loss or a gradient not finite")
    if zero:
        fail(f"grad_vision: zero gradient in {zero}")
    if not all(n > 0 for n in launches.values()):
        fail(f"a kernel of the VLM's loss gradient never launched: "
             f"{launches}")
    del params, flat, grads, g, batch
    return launches


def serve_paged_phase(torch, np, serve_mod, kernels, dense):
    """The serve phase's 24 requests again, over the paged KV cache with
    kv_page_size 16 and 256 pages: 40% of the dense-equivalent 16 x 640 / 16
    = 640, so admission blocks on pages or slots are preempted. Every kernel
    of the paged serving path must launch, every request must return."""
    serve, cfg = serve_mod.make_serve_engine(
        "llama3.2-1b", max_prompt_len=512, max_tokens=128, concurrency=16,
        temperature=0.8, top_k=50, top_p=0.95, kv_backend="paged",
        kv_page_size=16, kv_num_pages=256, seed=0)
    for p in serve_prompts(np, cfg):
        serve.submit(serve_mod.GenerateRequest(prompt=p))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(kernels)
    t0 = time.perf_counter()
    results = serve.drain()
    serve.eng.block_until_ready()
    wall = time.perf_counter() - t0
    launches = read_launches(kernels)
    by_length = read_by_length(kernels)
    stats = serve.close()
    backend = serve.eng.backend
    ntok = check_results(np, results, cfg, dense["requests"])
    pressure = stats["admission_blocked"] + stats["page_preemptions"]
    emit("serve_paged", arch=cfg.name, requests=len(results), tokens=ntok,
         seconds=wall, tokens_per_s=ntok / wall,
         dense_tokens_per_s=dense["tokens_per_s"],
         kv_page_size=backend.page_size, kv_num_pages=backend.num_pages,
         dense_equivalent_pages=backend.pool * backend.max_pages,
         admission_blocked=stats["admission_blocked"],
         page_preemptions=stats["page_preemptions"],
         pages_allocated=backend.pages_allocated,
         cow_copies=backend.cow_copies, decode_chunks=stats["decode_chunks"],
         prefill_calls=stats["prefill_calls"],
         utilization=stats["utilization"], launches=launches,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if pressure == 0:
        fail("serve_paged: no admission was blocked and no slot preempted")
    if not all(n > 0 for n in launches.values()):
        fail(f"a kernel of the paged serving path never launched: "
             f"{launches}")
    profile_phase(torch, np, serve, cfg, phase="profile_paged")


def train_paged_phase(torch, np, kernels, steps=2, num_layers=8):
    """The paged slice's main path: ``steps`` CoPRISTrainer.step() calls on
    llama3.2-1b at full width and ``num_layers`` of its 16 layers (the
    run's time; no kernel's shape depends on the depth) over the paged KV
    cache (page size 16, half
    the dense-equivalent pages: 64 for 16 slots of max_len 128) with the
    legacy fused_loss=False loss, after the train phase's short SFT warmup
    from random weights made from a seed. GRPO groups of 4 share their
    prompt's pages (one prefill per group), and each member's first write
    into the shared partial page copies it. Every kernel's launch count is
    reset just before the steps and read just after."""
    from repro_torch.common.config import RolloutConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.core.copris import CoPRISTrainer
    from repro_torch.data.sft import sft_warmup
    from repro_torch.data.tasks import EOS, AdditionTask
    from repro_torch.models import model as M
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config("llama3.2-1b"),
                              num_layers=num_layers)
    task = AdditionTask(max_value=20, seed=1)
    params, _ = sft_warmup(M.init_params(cfg, seed=1, device="cuda"), cfg,
                           task, steps=4, batch_size=32, max_len=24, lr=1e-4)
    ro = RolloutConfig(batch_size=8, group_size=4, max_prompt_len=4,
                       max_response_len=124, concurrency=16, mode="copris",
                       temperature=1.0, kv_backend="paged", kv_page_size=16,
                       kv_num_pages=64)
    tc = TrainConfig(lr=1e-5, warmup_steps=1, seed=1, fused_loss=False,
                     entropy_coef=0.0)
    tr = CoPRISTrainer(cfg, ro, tc, task, eos_id=EOS, params=params)
    del params
    backend = tr.engine.backend
    if backend.num_pages * 2 != backend.pool * backend.max_pages:
        fail(f"train_paged: {backend.num_pages} pages is not half the "
             f"dense-equivalent {backend.pool * backend.max_pages}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(kernels)
    outs = []
    try:
        for _ in range(steps):
            outs.append(tr.step())
        torch.cuda.synchronize()
        launches = read_launches(kernels)
        totals = tr.engine.stats_snapshot()
    finally:
        tr.close()
    keys = ("reward_mean", "pg_loss", "grad_norm", "ratio_mean",
            "off_policy_frac")
    emit("train_paged", arch=cfg.name, layers=cfg.num_layers,
         depth_cut=f"{num_layers} of 16 layers: the run's time (no "
         "kernel's shape depends on the depth)",
         d_model=cfg.d_model, vocab=cfg.vocab_size, fused_loss=False,
         kv_page_size=backend.page_size, kv_num_pages=backend.num_pages,
         dense_equivalent_pages=backend.pool * backend.max_pages,
         steps=[{k: o[k] for k in keys + (
             "rollout_time", "reward_time", "update_time", "step_time",
             "multi_stage_trajs", "buffer_unfinished", "mean_resp_len",
             "clip_frac")} for o in outs],
         shared_prefill_rows=totals["shared_prefill_rows"],
         prefill_rows=totals["prefill_rows"],
         admission_blocked=totals["admission_blocked"],
         page_preemptions=totals["page_preemptions"],
         pages_allocated=backend.pages_allocated,
         cow_copies=backend.cow_copies,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         launches=launches)
    for o in outs:
        bad = [k for k in keys if not np.isfinite(o[k])]
        if bad:
            fail(f"train_paged step {o['step']}: not finite: {bad}")
    if not (totals["shared_prefill_rows"] > 0 and backend.cow_copies > 0):
        fail("train_paged: no prefix sharing or no copy-on-write")
    if not all(n > 0 for n in launches.values()):
        fail(f"a kernel of the paged training path never launched: "
             f"{launches}")
    return launches


TRAIN_KEYS = ("reward_mean", "pg_loss", "grad_norm", "ratio_mean",
              "off_policy_frac")


def traj_keys(groups):
    """Each trajectory's identity and content, in batch order."""
    return [(g.group_id, t.sample_idx, tuple(t.response_tokens),
             tuple(t.stage_ids), tuple(t.roles))
            for g in groups for t in g.trajectories]


def stream_overlap(spans):
    """Device kernels given as (start_ns, end_ns, stream), by CUDA stream,
    and the device time during which kernels of two or more streams ran at
    once (a sweep over the kernels' start and end times). Returns ({stream:
    {kernels, busy_ms}}, concurrent_ms, the kernels' first-to-last span in
    ms)."""
    per_stream, edges = {}, []
    for a, b, stream in spans:
        d = per_stream.setdefault(str(stream), {"kernels": 0, "busy_ms": 0.0})
        d["kernels"] += 1
        d["busy_ms"] += (b - a) / 1e6
        edges += [(a, 1, stream), (b, -1, stream)]
    edges.sort(key=lambda x: (x[0], x[1]))     # ends before starts at a tie
    running, concurrent_ns, last = {}, 0, None
    for t, delta, stream in edges:
        if last is not None and sum(n > 0 for n in running.values()) >= 2:
            concurrent_ns += t - last
        running[stream] = running.get(stream, 0) + delta
        last = t
    span_ms = ((max(b for _, b, _ in spans) - min(a for a, _, _ in spans))
               / 1e6 if spans else 0.0)
    return per_stream, concurrent_ns / 1e6, span_ms


def overlap_profile(torch, tr):
    """torch.profiler (device activity) over one more overlapped step: the
    consumer's update on the train stream while the producer collects the
    next batch on the rollout stream. The profiler's raw device events
    (copies and fills left out by name; a kernel's ``device_resource_id``
    is its stream) give each stream's kernels and busy time and
    ``concurrent_ms``, the device time during which kernels of both
    streams ran at once. CUDA events bracket, on the stream each runs on,
    the step's update and every collect the producer starts in the step
    (the trainer's ``_train_on`` and ``_collect_stage`` wrapped for the
    step): returns the profile and those events, which are complete once
    the producer has stopped (stream_spans reads them)."""
    from torch.profiler import ProfilerActivity, profile
    spans = {"update": [], "collect": []}

    def bracket(fn, kind):
        def run(*a, **kw):
            stream = torch.cuda.current_stream()
            start = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            try:
                return fn(*a, **kw)
            finally:
                end = torch.cuda.Event(enable_timing=True)
                end.record(stream)
                spans[kind].append((stream.stream_id, start, end))
        return run

    torch.cuda.synchronize()
    origin = torch.cuda.Event(enable_timing=True)
    origin.record()
    tr._train_on = bracket(tr._train_on, "update")
    tr._collect_stage = bracket(tr._collect_stage, "collect")
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = tr.step()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        del tr._train_on, tr._collect_stage      # the methods again
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [(e.start_ns(), e.end_ns(), e.device_resource_id())
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda
               and not e.name().startswith(("Memcpy", "Memset"))]
    per_stream, concurrent_ms, span_ms = stream_overlap(kernels)
    return dict(what="one overlapped CoPRISTrainer.step() under "
                "torch.profiler (CUDA activity only)", wall_ms=wall_ms,
                update_time=out["update_time"],
                batch_wait_time=out["batch_wait_time"],
                streams=per_stream, kernel_span_ms=span_ms,
                concurrent_ms=concurrent_ms,
                concurrent_share_of_span=(concurrent_ms / span_ms
                                          if span_ms else 0.0)), \
        (origin, spans)


def stream_spans(events):
    """The update's and the collects' device-time spans from
    overlap_profile's CUDA events (ms after its origin event), each with
    its stream, and ``update_overlap_ms``: the part of the update's span
    during which a collect's span was open on another stream."""
    origin, spans = events
    timed = {kind: [(sid, origin.elapsed_time(a), origin.elapsed_time(b))
                    for sid, a, b in evs] for kind, evs in spans.items()}
    overlap = sum(max(0.0, min(u1, c1) - max(u0, c0))
                  for us, u0, u1 in timed["update"]
                  for cs, c0, c1 in timed["collect"] if cs != us)
    return dict(update_spans_ms=timed["update"],
                collect_spans_ms=timed["collect"],
                update_overlap_ms=overlap)


def overlapped_run(torch, tr, kernels, steps, profile=False):
    """``steps`` overlapped trainer steps (with ``profile``, then the
    profile of one more) with every kernel's launch count reset just before
    them; the producer is stopped (close) before the counts are read, so
    they hold every launch of the path, the producer's look-ahead collect
    included. Returns (outs, launches, the profile or None)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(kernels)
    outs, prof = [], None
    try:
        for _ in range(steps):
            out = tr.step()
            stages = tr.last_batch["stage_ids"]
            out["newest_token_stage"] = int(stages[stages >= 0].max())
            out["batch"] = tr.last_batch
            outs.append(out)
        if profile:
            prof, events = overlap_profile(torch, tr)
    finally:
        tr.close()
    torch.cuda.synchronize()
    if profile:
        prof["cuda_events"] = stream_spans(events)
    return outs, read_launches(kernels), prof


def check_overlapped(np, phase, outs, launches, max_staleness=1):
    for o in outs:
        bad = [k for k in TRAIN_KEYS if not np.isfinite(o[k])]
        if bad:
            fail(f"{phase} step {o['step']}: not finite: {bad}")
        if not 0 <= o["param_staleness"] <= max_staleness:
            fail(f"{phase} step {o['step']}: param_staleness "
                 f"{o['param_staleness']} outside [0, {max_staleness}]")
        if o["param_store_versions"] > max_staleness + 1:
            fail(f"{phase}: the ParamStore holds "
                 f"{o['param_store_versions']} versions")
        if o["newest_token_stage"] > o["step"]:
            fail(f"{phase} step {o['step']}: a trained token from stage "
                 f"{o['newest_token_stage']}")
    if not all(n > 0 for n in launches.values()):
        fail(f"a kernel of {phase}'s path never launched: {launches}")


STEP_REPORT = ("rollout_time", "reward_time", "update_time", "step_time",
               "batch_wait_time", "overlap_saved_time", "param_staleness",
               "param_store_versions", "newest_token_stage",
               "multi_stage_trajs", "mean_resp_len")


def first_layers(cfg, params, num_layers):
    """``cfg`` and the host ``params`` cut to their first ``num_layers``
    layers, on the card."""
    from repro_torch.common.tree import tree_map
    return (dataclasses.replace(cfg, num_layers=num_layers),
            tree_map(lambda t: t.cuda(),
                     dict(params, layers=params["layers"][:num_layers])))


def train_overlap_phase(torch, np, kernels, sft, steps=4, num_layers=8):
    """The overlapped pipeline at full width: llama3.2-1b in the train
    phase's configuration (B 8 x G 4, N' 16, max_len 128, bf16 compute, f32
    masters, the fused loss) at ``num_layers`` of its 16 layers (the run's
    time; no kernel's shape depends on the depth) from the first layers of
    the train phase's SFT-warmed weights (kept on the host, no second
    SFT), with overlap=True and
    max_staleness=1: ``steps`` CoPRISTrainer.step() calls, the producer
    collecting on its CUDA stream while the consumer trains on another, then
    the profile of one more step. Checks: finite metrics, param_staleness
    <= 1 every step and == 1 at least once, at most 2 ParamStore versions,
    no trained token from a stage newer than its step, every kernel of the
    path launched, and in the profiled step a collect's span on the rollout
    stream open during part of the update's span on the train stream (CUDA
    events; torch.profiler once recorded no kernel of the rollout thread's
    stream, so its per-stream counts are reported, not checked). Returns
    the launch counts."""
    from repro_torch.common.config import RolloutConfig, TrainConfig
    from repro_torch.common.tree import tree_map
    from repro_torch.configs import get_config
    from repro_torch.core.copris import CoPRISTrainer
    from repro_torch.data.tasks import EOS, AdditionTask
    gc.collect()                        # the previous phase's trainer
    torch.cuda.empty_cache()
    cfg, params = first_layers(get_config("llama3.2-1b"), sft["params"],
                               num_layers)
    ro = RolloutConfig(batch_size=8, group_size=4, max_prompt_len=4,
                       max_response_len=124, concurrency=16, mode="copris",
                       temperature=1.0)
    tc = TrainConfig(lr=1e-5, warmup_steps=1, seed=0, overlap=True,
                     max_staleness=1)
    tr = CoPRISTrainer(cfg, ro, tc, AdditionTask(max_value=20, seed=0),
                       eos_id=EOS, params=params)
    del params
    tr.batch_timeout = 600.0
    outs, launches, prof = overlapped_run(torch, tr, kernels, steps,
                                          profile=True)
    peak = torch.cuda.max_memory_allocated() / 1e9
    emit("train_overlap", arch=cfg.name, layers=cfg.num_layers,
         depth_cut=f"{num_layers} of 16 layers: the run's time (no "
         "kernel's shape depends on the depth; sequential_step_time is the "
         "train phase's, at 16)",
         d_model=cfg.d_model, vocab=cfg.vocab_size, max_staleness=1,
         steps=[{k: o[k] for k in TRAIN_KEYS + STEP_REPORT} for o in outs],
         sequential_step_time=sft["step_time"], peak_mem_gb=peak,
         launches=launches)
    emit("train_overlap_profile", **prof)
    sft["overlap_steps"] = [{k: o[k] for k in STEP_REPORT} for o in outs]
    check_overlapped(np, "train_overlap", outs, launches)
    if not any(o["param_staleness"] == 1 for o in outs):
        fail("train_overlap: no batch was collected one update behind")
    ev = prof["cuda_events"]
    if not ev["update_overlap_ms"] > 0.0:
        fail(f"train_overlap: in the profiled step no collect ran on another "
             f"stream during the update: {ev}")
    return launches


def train_disaggregated_phase(torch, np, kernels, sft, steps=3,
                              num_layers=8):
    """The disaggregated trainer at full width: llama3.2-1b in the
    train_overlap phase's configuration, at ``num_layers`` of its 16
    layers (the run's time), from the same SFT-warmed weights,
    with overlap=True, disaggregated=True, train and rollout on cuda:0:
    every published version is the reshard's copy onto the rollout device
    (a copy stream, fenced by the store's event). Checks: at every stage
    (the construction's version 0 and after each step) the store's
    freshest version equals the consumer's params bit for bit, the
    overlapped pipeline's checks, reshard_time > 0 each step, every
    kernel of the path launched. Reports reshard_time (the copies' span
    on the copy stream, CUDA events) and the step, rollout and update
    times beside train_overlap's. Returns the launch counts."""
    from repro_torch.common.config import RolloutConfig, TrainConfig
    from repro_torch.common.tree import leaves, tree_map
    from repro_torch.configs import get_config
    from repro_torch.core.copris import CoPRISTrainer
    from repro_torch.data.tasks import EOS, AdditionTask
    gc.collect()
    torch.cuda.empty_cache()
    cfg, params = first_layers(get_config("llama3.2-1b"), sft["params"],
                               num_layers)
    ro = RolloutConfig(batch_size=8, group_size=4, max_prompt_len=4,
                       max_response_len=124, concurrency=16, mode="copris",
                       temperature=1.0)
    tc = TrainConfig(lr=1e-5, warmup_steps=1, seed=0, overlap=True,
                     max_staleness=1, disaggregated=True)
    tr = CoPRISTrainer(cfg, ro, tc, AdditionTask(max_value=20, seed=0),
                       eos_id=EOS, params=params, rollout_device="cuda:0")
    del params
    tr.batch_timeout = 600.0

    def store_is_consumer():
        torch.cuda.synchronize()
        stored = tr.param_store.get(tr.stage)
        torch.cuda.synchronize()
        return all(torch.equal(a, b.detach())
                   for a, b in zip(leaves(stored), leaves(tr.params)))

    same = [store_is_consumer()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(kernels)
    outs = []
    try:
        for _ in range(steps):
            out = tr.step()
            stages = tr.last_batch["stage_ids"]
            out["newest_token_stage"] = int(stages[stages >= 0].max())
            outs.append(out)
            same.append(store_is_consumer())
    finally:
        tr.close()
    torch.cuda.synchronize()
    launches = read_launches(kernels)
    keys = STEP_REPORT + ("reshard_time", "dropped_versions")
    sft["disaggregated_steps"] = [{k: o[k] for k in STEP_REPORT + (
        "reshard_time",)} for o in outs]
    emit("train_disaggregated", arch=cfg.name, layers=cfg.num_layers,
         depth_cut=f"{num_layers} of 16 layers: the run's time (no "
         "kernel's shape depends on the depth)",
         d_model=cfg.d_model, vocab=cfg.vocab_size, max_staleness=1,
         train_device=str(tr.device), rollout_device=str(tr.rollout_device),
         steps=[{k: o[k] for k in TRAIN_KEYS + keys} for o in outs],
         store_equals_consumer=same,
         train_overlap_steps=sft.get("overlap_steps"),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         launches=launches)
    check_overlapped(np, "train_disaggregated", outs, launches)
    if not all(same):
        fail(f"train_disaggregated: the store's version differs from the "
             f"consumer's params at a stage: {same}")
    if not all(o["reshard_time"] > 0.0 for o in outs):
        fail("train_disaggregated: a step without a timed reshard")
    return launches


# the kernels each side of the two-sided trainer runs: the update's
# attention forward (with lse) and backward and the fused loss kernels
# (V 128256 > FUSED_VOCAB_THRESHOLD); the collect's prefill, decode and
# sampling
TWO_SIDED_KERNELS = {
    "train": ("flash_attn", "flash_attn_bwd", "fused_is_grpo_fwd",
              "fused_is_grpo_bwd_dh", "fused_is_grpo_bwd_dw"),
    "rollout": ("flash_attn", "decode_attn", "fused_sample")}
TWO_SIDED_TIMEOUT_S = 600


def side_kernels():
    """The wrappers of every kernel of TWO_SIDED_KERNELS, by name."""
    from repro_torch.hopper import decode_attn, flash_attn, fused_sample
    from repro_torch.hopper import fused_is_grpo as fio
    return {"flash_attn": flash_attn.flash_attention,
            "flash_attn_bwd": flash_attn.flash_attention_bwd,
            "decode_attn": decode_attn.decode_attention,
            "fused_sample": fused_sample.sample_rows,
            "fused_is_grpo_fwd": fio.fused_is_grpo_fwd_rows,
            "fused_is_grpo_bwd_dh": fio.fused_is_grpo_bwd_dh_rows,
            "fused_is_grpo_bwd_dw": fio.fused_is_grpo_bwd_dw_rows}


def fingerprints(torch, tree):
    """Two 64-bit sums of each leaf's bits (a DTensor's local shard: the
    whole leaf on a (1, 1) mesh), computed on the card: its 32-bit words,
    and the words times odd position weights, both wrapping. A change of
    any one word always changes the second; two trees with equal pairs are
    equal but for a 2^-64 coincidence."""
    from repro_torch.common.tree import leaves
    out = []
    for t in leaves(tree):
        t = t.to_local() if hasattr(t, "to_local") else t
        w = t.detach().reshape(-1).view(torch.int32).to(torch.int64)
        pos = torch.arange(1, 2 * w.numel(), 2, device=w.device)
        out.append([int(w.sum()), int((w * pos).sum())])
    return out


def two_sided_rank(rank, folder):
    """One process of ``train_disaggregated_mesh``: rank 0 trains on a
    (1, 1) mesh, rank 1 collects on another, both on cuda:0, in a process
    group of two (NCCL for the meshes' own one-rank groups, gloo for the
    weights' transfer and the batches: NCCL refuses two ranks of one
    communicator on one card). Writes its record to ``folder``."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    from repro_torch.common.config import RolloutConfig, TrainConfig
    from repro_torch.common.tree import tree_map
    from repro_torch.configs import get_config
    from repro_torch.core.copris import CoPRISTrainer
    from repro_torch.data.tasks import EOS, AdditionTask
    from repro_torch.launch.mesh import make_disaggregated_meshes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    folder = Path(folder)
    spec = json.loads((folder / "spec.json").read_text())
    dist.init_process_group("nccl", init_method=f"file://{folder}/store",
                            rank=rank, world_size=2)
    try:
        train, rollout = make_disaggregated_meshes((1, 1), (1, 1))
        group = dist.new_group([0, 1], backend="gloo")
        params = (tree_map(lambda t: t.cuda(), torch.load(
            folder / "weights.pt")) if rank == 0 else None)
        cfg = dataclasses.replace(get_config("llama3.2-1b"),
                                  num_layers=spec["num_layers"])
        tr = CoPRISTrainer(cfg,
                           RolloutConfig(**spec["ro"]),
                           TrainConfig(**spec["tc"]),
                           AdditionTask(max_value=20, seed=0), eos_id=EOS,
                           params=params, train_mesh=train,
                           rollout_mesh=rollout, transfer_group=group)
        del params
        kernels = {name: fn for name, fn in side_kernels().items()
                   if name in TWO_SIDED_KERNELS[tr.role]}
        rec = dict(role=tr.role, arch=cfg.name, layers=cfg.num_layers,
                   stages={}, acquired=[], outs=[], observed=[], trace=None)
        # adaptive N': the train side owns the controller; record what it
        # observes
        ctrl = tr._concurrency_ctrl
        if ctrl is not None:
            observe = ctrl.observe

            def recorded_observe(**kw):
                rec["observed"].append(kw)
                return observe(**kw)
            ctrl.observe = recorded_observe
        store = tr.param_store
        if tr.role == "rollout":
            acquire = store.acquire

            def recorded():
                p, v = acquire()
                rec["acquired"].append([v, fingerprints(torch, p)])
                return p, v
            store.acquire = recorded
        else:
            rec["stages"][tr.stage] = fingerprints(torch, tr.params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(kernels)
        t0 = time.perf_counter()
        try:
            for _ in range(spec["steps"]):
                out = tr.step()
                rec["outs"].append({k: v for k, v in out.items()
                                    if isinstance(v, (int, float))})
                if tr.role == "train":
                    rec["stages"][tr.stage] = fingerprints(torch, tr.params)
        finally:
            tr.close()
        torch.cuda.synchronize()
        if ctrl is not None:
            rec["trace"] = list(ctrl.trace)
        rec.update(wall_s=time.perf_counter() - t0,
                   launches=read_launches(kernels),
                   stats=store.stats_snapshot(),
                   transport=dist.get_backend(group),
                   bytes_per_version=store._reshard.bytes_sent,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    finally:
        dist.destroy_process_group()
    (folder / f"rank{rank}.json").write_text(json.dumps(rec))
    return 0


def train_disaggregated_mesh_phase(torch, np, sft, steps=3, num_layers=4):
    """Train and rollout on meshes of their own, in two processes on the
    one card: llama3.2-1b at full width and ``num_layers`` of its 16 layers
    (the run's time limit: the rollout side's engine on a mesh is
    host-bound, ~20 s a collect at full depth) in the train_disaggregated
    phase's configuration from the same SFT-warmed weights' first layers
    (written once to the checkout's build directory, read by the train
    process), overlap and
    disaggregated, max_staleness 1, adaptive N' (the train side's
    controller observes each update and sends the next target to the
    rollout side, a slot pool of 24, targets in [8, 24] from 16); rank 0
    trains on a (1, 1) mesh, rank 1
    collects on another (``make_disaggregated_meshes``), every version
    crossing through the cross-mesh transfer on a gloo group (pinned host
    staging), each batch on a gloo group of its own. ``steps`` steps on
    each side. Checks: each collect's version obeys the gate (collect i
    under a version in [i - 1, i], the train side's param_staleness the
    same schedule), each version the rollout side acquired has the
    fingerprints (two 64-bit sums of every leaf's bits) of the train
    side's params at that stage, finite losses, every kernel of
    TWO_SIDED_KERNELS launched on its side; adaptive N': the controller's
    trace equals a controller fed the observations it recorded, each
    collect ran under the target set after update j, i - 2 <= j <= i (the
    initial target before any), and the train side reports each collect's
    target as ``concurrency_target``. Reports the transfer's bytes
    and reshard_time per version on each side, and the step, rollout and
    update times beside train_disaggregated's. Returns the launches
    summed over both sides."""
    folder = ROOT / "build" / "two_sided"
    shutil.rmtree(folder, ignore_errors=True)
    folder.mkdir(parents=True)
    spec = dict(steps=steps, num_layers=num_layers, ro=dict(
        batch_size=8, group_size=4, max_prompt_len=4, max_response_len=124,
        concurrency=16, mode="copris", temperature=1.0,
        adaptive_concurrency=True, concurrency_min=8, concurrency_max=24),
        tc=dict(lr=1e-5, warmup_steps=1, seed=0, overlap=True,
                max_staleness=1, disaggregated=True))
    (folder / "spec.json").write_text(json.dumps(spec))
    torch.save(dict(sft["params"], layers=sft["params"]["layers"][
        :num_layers]), folder / "weights.pt")
    gc.collect()
    torch.cuda.empty_cache()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                               "--two-sided-rank", str(r), str(folder)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in (0, 1)]
    t0 = time.perf_counter()
    logs = []
    try:
        for p in procs:
            left = TWO_SIDED_TIMEOUT_S - (time.perf_counter() - t0)
            logs.append(p.communicate(timeout=max(1.0, left))[0])
    except subprocess.TimeoutExpired:
        logs.append("timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    (folder / "weights.pt").unlink()
    codes = [p.returncode for p in procs]
    if codes != [0, 0]:
        fail(f"train_disaggregated_mesh: the ranks exited {codes} after "
             f"{wall:.0f} s: {[log[-3000:] for log in logs]}")
    train, roll = (json.loads((folder / f"rank{r}.json").read_text())
                   for r in (0, 1))
    stages = {int(v): f for v, f in train["stages"].items()}
    outs = train["outs"]
    schedule = [o["step"] - o["param_staleness"] for o in outs]
    collected = [o["params_version"] for o in roll["outs"]]
    equal = [f == stages.get(v) for v, f in roll["acquired"]]
    keys = ("step_time", "rollout_time", "update_time", "reward_time",
            "batch_wait_time", "reshard_time", "rollout_reshard_time",
            "param_staleness", "dropped_versions", "param_store_versions",
            "concurrency_target")
    # adaptive N': the trace replayed, each collect's target and its bound
    from repro_torch.common.config import RolloutConfig
    from repro_torch.core.scheduler import AdaptiveConcurrencyController
    replay = AdaptiveConcurrencyController(RolloutConfig(**spec["ro"]))
    for kw in train["observed"]:
        replay.observe(**kw)
    trace = train["trace"] or []
    targets = [o["concurrency_target"] for o in roll["outs"]]
    stale = spec["tc"]["max_staleness"]
    within = [t in {trace[j + 1] for j in range(max(0, i - stale - 1),
                                                 min(i + 1, len(trace) - 1))}
              | ({trace[0]} if i - stale - 1 < 0 and trace else set())
              for i, t in enumerate(targets)]
    emit("train_disaggregated_mesh", nvidia_smi=card_name_and_limit(),
         arch=train["arch"], layers=train["layers"], processes=2,
         depth_cut=f"{train['layers']} of 16 layers: the run's time limit "
         "(the rollout side's engine on a mesh is host-bound: ~20 s a "
         "collect at 16 layers; train_disaggregated runs all 16)",
         adaptive={"trace": trace, "replayed_trace": replay.trace,
                   "collect_targets": targets, "within_gate": within,
                   "observed": train["observed"]},
         meshes={"train": {"data": 1, "model": 1},
                 "rollout": {"data": 1, "model": 1}},
         transport=f"{train['transport']} (CUDA leaves staged through "
         "pinned host memory; NCCL refuses two ranks of one communicator "
         "on one card)",
         bytes_per_version=train["bytes_per_version"],
         # the train side's span of each publish (pack, host copy, send)
         # and the rollout side's (landed bytes to placed shards), seconds
         reshard_time_train=train["stats"]["reshard_time"],
         reshard_time_rollout=roll["stats"]["reshard_time"],
         versions=train["stats"]["published"],
         steps=[{k: o.get(k) for k in TRAIN_KEYS + keys} for o in outs],
         rollout_steps=[{k: o.get(k) for k in (
             "collect_idx", "params_version", "wall_time", "reward_time",
             "rollout_reshard_time", "generated")} for o in roll["outs"]],
         schedule=schedule, acquired_equal=equal,
         train_disaggregated_steps=sft.get("disaggregated_steps"),
         wall_s={"train": train["wall_s"], "rollout": roll["wall_s"],
                 "phase": wall},
         peak_mem_gb={"train": train["peak_mem_gb"],
                      "rollout": roll["peak_mem_gb"]},
         launches={"train": train["launches"], "rollout": roll["launches"]})
    for o in outs:
        if not np.isfinite(o["pg_loss"]):
            fail(f"train_disaggregated_mesh: step {o['step']}: loss "
                 f"{o['pg_loss']}")
    if collected != schedule or not all(
            i - 1 <= v <= i for i, v in enumerate(schedule)):
        fail(f"train_disaggregated_mesh: collects under versions "
             f"{collected}, trained as {schedule}: outside the gate")
    if len(equal) != steps or not all(equal):
        fail(f"train_disaggregated_mesh: an acquired version differs from "
             f"the train side's params at its stage: {equal}")
    for side, names in TWO_SIDED_KERNELS.items():
        got = (train if side == "train" else roll)["launches"]
        if not all(got.get(n, 0) > 0 for n in names):
            fail(f"train_disaggregated_mesh: a kernel of the {side} side "
                 f"never launched: {got}")
    if len(train["observed"]) != steps or trace != replay.trace \
            or not all(within) \
            or targets != [o["concurrency_target"] for o in outs]:
        fail(f"train_disaggregated_mesh: adaptive N': trace {trace} "
             f"(replayed {replay.trace}), collects under {targets} "
             f"(within the gate {within}), reported "
             f"{[o['concurrency_target'] for o in outs]}")
    return {n: train["launches"].get(n, 0) + roll["launches"].get(n, 0)
            for n in set(train["launches"]) | set(roll["launches"])}


WARM_FLEX_TIMEOUT_S = 400
# gemma2-2b's heads, window and softcap, at which the library call is a
# compiled flex_attention
GEMMA2_SHAPE = dict(H=8, KV=4, hd=256, win=4096, cap=50.0)


def warm_flex():
    """The compiled flex_attention calls of gemma2-2b's kernel checks (its
    softcap: the library call is flex_attention), run once in a process of
    its own while the parent builds the kernels, with the kernels' plain
    versions in their place (nothing here needs a built library): the
    generated kernels land in the inductor and Triton caches under build/
    (the parent's TORCHINDUCTOR_CACHE_DIR and TRITON_CACHE_DIR), where the
    parent's checks of the same shapes find them. Nothing it measures is
    kept."""
    sys.path.insert(0, str(ROOT / "src"))
    import types

    import torch
    import torch.nn.functional as F

    from repro_torch.hopper import decode_attn, flash_attn, paged_decode_attn
    torch.backends.cuda.matmul.allow_tf32 = False
    fa = types.SimpleNamespace(**vars(flash_attn))
    fa.flash_attention = flash_attn.flash_attention_plain
    fa.flash_attention_bwd = flash_attn.flash_attention_bwd_plain
    da = types.SimpleNamespace(**vars(decode_attn))
    da.decode_attention = decode_attn.decode_attention_plain
    pa = types.SimpleNamespace(**vars(paged_decode_attn))
    pa.paged_decode_attention = paged_decode_attn.paged_decode_attention_plain
    timer = Timer(torch)
    g = dict(GEMMA2_SHAPE)
    H, KV, hd = g.pop("H"), g.pop("KV"), g.pop("hd")
    check_flash_lse(torch, F, timer, fa, H=H, KV=KV, hd=hd, phase="warm",
                    **g)
    check_flash_bwd(torch, F, timer, fa, H=H, KV=KV, hd=hd, phase="warm",
                    **g)
    check_flash_prefill(torch, F, timer, fa, H, KV, hd, phase="warm", **g)
    check_decode_wide(torch, F, timer, da, pa, H, KV, hd, tag="warm", **g)
    return 0


def warm_flex_phase(warm):
    """Waits for :func:`warm_flex` (started beside the build) and reports
    it; the checks compile for themselves where it failed."""
    r = warm.finish()
    emit("warm_flex", returncode=None if r is None else r[0],
         subprocess_seconds=warm.seconds,
         stderr_tail="timed out" if r is None else r[2][-2000:] if r[0]
         else "")


def pal205_phase():
    """PAL205 on the card: each built library's kernels (ptxas's static
    shared memory, registers, spills, from the build log) against this
    card's limits (``repro_torch.analysis.irlint.kernel_budgets``); fails
    on an error finding or a library without a build log."""
    from repro_torch.analysis import irlint
    found, budgets = irlint.kernel_budgets()
    emit("pal205", limits=irlint.card_limits(), libraries=budgets,
         findings=[f"{f.severity}: {f.message}" for f in found])
    if any(f.severity == "error" for f in found) \
            or None in budgets.values():
        fail(f"PAL205: {[f.message for f in found]}")


def card_name_and_limit():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def update_batch(np, cfg, rows=32, T=128, seed=7):
    """A seeded update batch of ``rows`` x ``T`` tokens (the train phase's
    packed shape): random tokens, a loss span per row, behaviour log-probs
    near a uniform policy's, normal advantages."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((rows, T), np.float32)
    for n in range(rows):
        mask[n, rng.integers(4, 16):rng.integers(64, T)] = 1.0
    return dict(
        tokens=rng.integers(0, cfg.vocab_size, (rows, T)).astype(np.int32),
        loss_mask=mask,
        behaviour_logp=((rng.standard_normal((rows, T)) * 0.3 - 1.0
                         - np.log(cfg.vocab_size)) * mask).astype(np.float32),
        advantages=rng.standard_normal(rows).astype(np.float32))


def as_float(v):
    """A metric's value (a DTensor one gathered first)."""
    return float(v.full_tensor() if hasattr(v, "full_tensor") else v)


def leaf_rel(a, b):
    """max |a - b| over max |b| (max |a - b| where b is all zero)."""
    scale = float(b.abs().max())
    diff = float((a.float() - b.float()).abs().max())
    return diff / scale if scale > 0.0 else diff


def local_leaves(tree):
    from repro_torch.common.tree import leaves
    return [(t.to_local() if hasattr(t, "to_local") else t).detach()
            for t in leaves(tree)]


def train_sharded_phase(torch, np, kernels, steps=2, keep=None):
    """The sharded update on the card: llama3.2-1b at full width and
    depth (f32 masters, bf16 compute, remat, the fused loss, entropy
    0.01), ``steps`` make_train_step updates on seeded 32 x 128 batches
    (the train phase's packed shape), once unsharded and once on a (1, 1)
    ("data", "model") mesh in a NCCL process group of world size 1:
    params, AdamW state and batch as DTensors placed by launch/sharding,
    the flash and fused-loss kernels on the local shards through
    local_map. Checks each leaf's update (params after minus before) and
    AdamW moments against the unsharded run's, within 1e-4 of the leaf's
    largest element (the train references' gradient tolerance), pg_loss
    atol 1e-4 and grad_norm rtol 1e-5, and the flash forward and backward
    and the loss's forward, dh and dw launched in the sharded run. Reports
    both runs' update times and the peak memory above what each held
    before its updates. Returns the sharded run's launch counts; ``keep``
    (a dict) receives its peak, ``peak_gb``."""
    from repro_torch.common.config import TrainConfig
    from repro_torch.common.partitioning import set_activation_mesh
    from repro_torch.common.tree import leaves, tree_map
    from repro_torch.configs import get_config
    from repro_torch.core.copris import make_train_step
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_single_mesh
    from repro_torch.models import model as M
    from repro_torch.optim import adam
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("llama3.2-1b")
    tc = TrainConfig(lr=1e-5, entropy_coef=0.01, remat=True)
    base = M.init_params(cfg, seed=3, device="cuda")
    batches = [{k: torch.from_numpy(v).cuda()
                for k, v in update_batch(np, cfg, seed=20 + i).items()}
               for i in range(steps)]
    step = make_train_step(cfg, tc)
    mesh = make_single_mesh()

    def run(sharded):
        params = tree_map(lambda t: t.detach().clone().requires_grad_(),
                          base)
        if sharded:
            set_activation_mesh(mesh)
            params = shd.shard_params(params, mesh, cfg)
        opt = adam.init(params)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(kernels)
        times, metrics = [], []
        try:
            for b in batches:
                if sharded:
                    b = shd.shard_batch(b, mesh)
                t0 = time.perf_counter()
                params, opt, m = step(params, opt, b, tc.lr)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                metrics.append({k: as_float(v) for k, v in m.items()})
        finally:
            set_activation_mesh(None)
        return dict(params=local_leaves(params), m=local_leaves(opt["m"]),
                    v=local_leaves(opt["v"]), times=times, metrics=metrics,
                    launches=read_launches(kernels),
                    peak_gb=(torch.cuda.max_memory_allocated() - held) / 1e9)

    plain = run(False)
    try:
        sharded = run(True)
    finally:
        # NCCL's buffers out of the way of the later phases (gemma2-2b's
        # update peaks within 4 GB of the card's memory)
        torch.distributed.destroy_process_group()
    base_leaves = [t.detach() for t in leaves(base)]
    errs = {"update": [leaf_rel(a - p0, b - p0) for a, b, p0 in zip(
                sharded["params"], plain["params"], base_leaves)],
            "m": [leaf_rel(a, b) for a, b in zip(sharded["m"], plain["m"])],
            "v": [leaf_rel(a, b) for a, b in zip(sharded["v"], plain["v"])]}
    worst = {k: max(v) for k, v in errs.items()}
    loss_err = max(abs(a["pg_loss"] - b["pg_loss"])
                   for a, b in zip(sharded["metrics"], plain["metrics"]))
    gn_err = max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                 for a, b in zip(sharded["metrics"], plain["metrics"]))
    launches = sharded["launches"]
    if keep is not None:
        keep["peak_gb"] = sharded["peak_gb"]
    emit("train_sharded", arch=cfg.name, layers=cfg.num_layers,
         d_model=cfg.d_model, vocab=cfg.vocab_size,
         mesh={"data": 1, "model": 1}, backend="nccl", updates=steps,
         batch="32 x 128", rel_tol=1e-4, worst_leaf_rel_err=worst,
         bit_equal_leaves={k: sum(e == 0.0 for e in v)
                           for k, v in errs.items()},
         leaves=len(errs["m"]), pg_loss_err=loss_err, grad_norm_rel_err=gn_err,
         metrics_sharded=sharded["metrics"], metrics_unsharded=plain["metrics"],
         update_s_sharded=sharded["times"], update_s_unsharded=plain["times"],
         update_peak_gb_sharded=sharded["peak_gb"],
         update_peak_gb_unsharded=plain["peak_gb"],
         launches=launches, launches_unsharded=plain["launches"])
    needed = ("flash_attn", "flash_attn_bwd", "fused_is_grpo_fwd",
              "fused_is_grpo_bwd_dh", "fused_is_grpo_bwd_dw")
    if not all(launches[k] > 0 for k in needed):
        fail(f"train_sharded: a kernel never ran on the local shards: "
             f"{launches}")
    if not (max(worst.values()) <= 1e-4 and loss_err <= 1e-4
            and gn_err <= 1e-5):
        fail(f"train_sharded: the sharded update disagrees with the "
             f"unsharded one: {worst}, loss {loss_err}, grad_norm {gn_err}")
    return launches


# train_sharded_phase's update counted by the dry run: its arch, batch and
# TrainConfig, two steps on a fake (1, 1) mesh (a fake world of one)
DRYRUN_TRAIN_SHARDED = """
import json
from repro_torch.common.config import InputShape, TrainConfig
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D
mesh = D.dry_mesh(1, 1)
cfg = get_config("llama3.2-1b")
tc = TrainConfig(lr=1e-5, entropy_coef=0.01, remat=True)
with D.fake_mode():
    step, args, meta = D.input_specs(
        cfg, InputShape("train_sharded", 128, 32, "train"), mesh, tcfg=tc)
_, cost, secs = D.count_step(step, args, mesh, repeat=2)
print(json.dumps({"kernels": cost["kernels"], "memory": cost["memory"],
                  "flops": cost["flops"], "bytes": cost["bytes"],
                  "roofline": D.roofline(cost), "trace_s": secs}))
"""


DRYRUN_CLI = ["-m", "repro_torch.launch.dryrun", "--arch", "llama3.2-1b",
              "--shape", "decode_32k", "--weight-sync"]


def dryrun_constants(torch):
    """The constants the kernel wrappers' fake branches copy from the
    kernels' sources (the backward scans' boundary interval and channels a
    block) and from the card (its SMs, the loss forward's grid), each
    beside what the built library and the card report. Fails on any
    difference."""
    from repro_torch.hopper import build
    from repro_torch.hopper import fused_is_grpo as fio
    from repro_torch.hopper import rwkv6_scan, ssm_scan
    ssm, wkv = build.library("ssm_scan"), build.library("wkv6")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    pairs = {"fused_is_grpo.H100_SMS": (fio.H100_SMS, sms)}
    for N in ssm_scan._STATE_DIMS:
        pairs[f"ssm_scan.BWD_CHANNELS[{N}]"] = (
            ssm_scan.BWD_CHANNELS[N], ssm.ssm_scan_bwd_channels(N))
        for dt in ssm_scan._DTYPES.values():
            pairs[f"ssm_scan.BWD_CHUNK N {N} dtype {dt}"] = (
                ssm_scan.BWD_CHUNK, ssm.ssm_scan_bwd_chunk(N, dt, None))
    for hd in rwkv6_scan._HEAD_DIMS:
        for dt in rwkv6_scan._DTYPES.values():
            pairs[f"rwkv6_scan.BWD_CHUNK hd {hd} dtype {dt}"] = (
                rwkv6_scan.BWD_CHUNK, wkv.wkv6_bwd_chunk(hd, dt, None))
    wrong = {k: v for k, v in pairs.items() if v[0] != v[1]}
    if wrong:
        fail(f"dryrun: the fake branches' constants differ from the "
             f"library's and the card's (copied, reported): {wrong}")
    return {k: v[1] for k, v in pairs.items()}


def dryrun_start():
    """The dry run's two subprocesses (see :func:`dryrun_phase`), started
    now, each with a timeout of 120 s."""
    return {"mesh256": Background(DRYRUN_CLI, 120),
            "train_sharded": Background(["-c", DRYRUN_TRAIN_SHARDED], 120)}


def dryrun_phase(torch, measured_launches, measured_peak_gb, started=None):
    """The dry run (``repro_torch.launch.dryrun``: fake process group, fake
    tensors, the kernels charged and never launched) in two CPU
    subprocesses (``started`` by :func:`dryrun_start` earlier: the full run
    starts them beside the reference phases, which time nothing; None:
    started now), each with a timeout of 120 s: (a) its CLI on
    llama3.2-1b at decode_32k with the weight sync on the fake 16 x 16
    mesh of 256 ranks, both records ok, decode_attn charged once a layer;
    (b) ``train_sharded``'s update (two steps) on a fake (1, 1) mesh, its
    kernels' charges equal to ``measured_launches`` (train_sharded's) and
    its peak within 10% of ``measured_peak_gb``. The fake branches'
    constants are held against the library and the card
    (:func:`dryrun_constants`). Also reports the card's total_memory
    beside the dry run's constant for it."""
    started = started or dryrun_start()
    constants = dryrun_constants(torch)
    outs = {}
    for name, bg in started.items():
        outs[name] = bg.finish()
        if outs[name] is None:
            fail(f"dryrun: the {name} subprocess passed its 120 s timeout")
    wall = max(bg.seconds for bg in started.values())
    rc, out, err = outs["mesh256"]
    recs = [json.loads(line) for line in out.splitlines()
            if line.startswith('{"arch"')]
    rc_b, out_b, err_b = outs["train_sharded"]
    dry = json.loads(out_b.splitlines()[-1]) if rc_b == 0 else {}
    charged = {k: dry.get("kernels", {}).get(k, {}).get("launches", 0)
               for k in measured_launches}
    peak_gb = dry.get("memory", {}).get("peak_bytes", 0) / 1e9
    from repro_torch.launch import dryrun
    emit("dryrun", command=" ".join(DRYRUN_CLI), subprocess_seconds=wall,
         constants=constants,
         records=[{k: r.get(k) for k in (
             "arch", "shape", "mesh", "status", "chips", "trace_s",
             "dominant", "roofline", "flops_per_device",
             "collective_bytes", "memory", "kernels",
             "sync_bytes_per_version", "error")} for r in recs],
         train_sharded={"charged_launches": charged,
                        "measured_launches": measured_launches,
                        "predicted_peak_gb": peak_gb,
                        "measured_peak_gb": measured_peak_gb,
                        "peak_ratio": peak_gb / measured_peak_gb
                        if measured_peak_gb else None,
                        "memory": dry.get("memory"),
                        "kernels": dry.get("kernels"),
                        "roofline_s": dry.get("roofline"),
                        "trace_s": dry.get("trace_s")},
         card_total_memory=torch.cuda.get_device_properties(0).total_memory,
         dryrun_card_memory=dryrun.CARD_MEMORY_BYTES,
         stderr_tail={k: v[2][-2000:] for k, v in outs.items() if v[0]})
    if rc != 0 or len(recs) != 2 or not all(
            r["status"] == "ok" for r in recs):
        fail(f"dryrun: the 256-rank dry run exited {rc} with records "
             f"{[(r.get('shape'), r.get('status')) for r in recs]}")
    decode = recs[0].get("kernels", {}).get("decode_attn", {})
    if decode.get("launches") != 16:
        fail(f"dryrun: decode_attn charged {decode} at decode_32k, not once "
             f"for each of llama3.2-1b's 16 layers")
    if rc_b != 0 or charged != measured_launches:
        fail(f"dryrun: train_sharded's update on a fake (1, 1) mesh exited "
             f"{rc_b}, charged {charged} against the measured "
             f"{measured_launches}")
    if not abs(peak_gb - measured_peak_gb) <= 0.1 * measured_peak_gb:
        fail(f"dryrun: predicted peak {peak_gb} GB against train_sharded's "
             f"{measured_peak_gb} GB, beyond 10%")


def serve_sharded_phase(torch, np, serve_mod, kernels, num_layers=4):
    """Sharded serving on the card: llama3.2-1b at full width and
    ``num_layers`` of its 16 layers (the run's time: the engine on a mesh
    is host-bound, ~1 s a steady chunk at 16 layers; no kernel's shape
    depends on the depth), the ``serve`` phase's engine settings and 24
    requests, served unsharded and then on a (1, 1) ("data", "model") mesh
    in a NCCL process group of world size 1: the weights made already in
    the serve layout (DTensors), the slot cache laid out by
    cache_placements, prefill, decode and sampling on the local shards
    through local_map, every host read gathered. The sharded run's tokens
    and logps must equal the unsharded run's bit for bit, and the flash,
    decode and sampling kernels must have launched on the shards. Then
    each engine's steady-chunk profile (``profile_phase``). Destroys its
    process group."""
    from repro_torch.common import tree
    from repro_torch.launch.mesh import make_single_mesh

    def run(mesh, phase):
        gc.collect()
        torch.cuda.empty_cache()
        serve, cfg = serve_mod.make_serve_engine(
            "llama3.2-1b", max_prompt_len=512, max_tokens=128,
            concurrency=16, temperature=0.8, top_k=50, top_p=0.95, seed=0,
            num_layers=num_layers, mesh=mesh)
        for p in serve_prompts(np, cfg):
            serve.submit(serve_mod.GenerateRequest(prompt=p))
        torch.cuda.synchronize()
        reset_launches(kernels)
        t0 = time.perf_counter()
        results = serve.drain()
        serve.eng.block_until_ready()
        wall = time.perf_counter() - t0
        launches = read_launches(kernels)
        stats = serve.close()
        ntok = check_results(np, results, cfg, len(results))
        prof = profile_phase(torch, np, serve, cfg, phase=phase)
        layout = [str(t.placements) for t in tree.leaves(
            serve.eng.cache)[:2]] if mesh is not None else None
        return dict(cfg=cfg, results=results, wall=wall, ntok=ntok,
                    launches=launches, stats=stats, profile=prof,
                    layout=layout)

    plain = run(None, "serve_sharded_profile_unsharded")
    mesh = make_single_mesh()
    try:
        got = run(mesh, "serve_sharded_profile")
    finally:
        torch.distributed.destroy_process_group()
    cfg, results = got["cfg"], got["results"]
    want = {r.request_id: r for r in plain["results"]}
    differ = [r.request_id for r in results
              if (r.tokens, r.logprobs) != (want[r.request_id].tokens,
                                            want[r.request_id].logprobs)]
    emit("serve_sharded", arch=cfg.name, layers=cfg.num_layers,
         d_model=cfg.d_model, vocab=cfg.vocab_size,
         depth_cut=f"{cfg.num_layers} of 16 layers: the run's time (the "
         "engine on a mesh is host-bound; no kernel's shape depends on the "
         "depth)",
         mesh={"data": 1, "model": 1}, backend="nccl",
         requests=len(results), tokens=got["ntok"], seconds=got["wall"],
         tokens_per_s=got["ntok"] / got["wall"],
         tokens_per_s_unsharded=plain["ntok"] / plain["wall"],
         decode_chunks=got["stats"]["decode_chunks"],
         launches=got["launches"],
         bit_equal_requests=len(results) - len(differ), differ=differ,
         cache_layout=got["layout"],
         wall_ms_per_chunk=got["profile"]["wall_ms_per_chunk"],
         device_busy_ms_per_chunk=got["profile"]["device_busy_ms_per_chunk"],
         wall_ms_per_chunk_unsharded=plain["profile"]["wall_ms_per_chunk"],
         device_busy_ms_per_chunk_unsharded=plain["profile"][
             "device_busy_ms_per_chunk"])
    if differ:
        fail(f"serve_sharded: requests {differ} differ from the unsharded "
             "engine's tokens or logps")
    if not all(n > 0 for n in got["launches"].values()):
        fail(f"serve_sharded: a kernel never ran on the local shards: "
             f"{got['launches']}")
    return got["launches"]


# the block kinds of sharded serving beside attn: (name, arch, layers
# served of its full depth, the kernels its path launches)
SHARDED_KINDS = (
    ("hymba", "hymba-1.5b", 4, ("flash_attn", "decode_attn", "ssm_scan",
                                "fused_sample")),
    ("rwkv6", "rwkv6-1.6b", 4, ("wkv6", "fused_sample")),
    ("deepseek", "deepseek-moe-16b", 4, ("flash_attn", "decode_attn",
                                         "fused_sample")),
    ("vision", "llama-3.2-vision-90b", 5, ("flash_attn", "decode_attn",
                                           "fused_sample")))
KINDS_CUT = ("sharded serving is held to the unsharded engine at each block "
             "kind's published widths; the depth changes no kernel shape, "
             "and the run's time limit binds")


def kind_run(torch, np, serve_mod, arch, layers, kernels, *, pool,
             requests, mesh=None, profile=""):
    """``requests`` requests of 64-256 prompt tokens and 32 new tokens
    served by ``arch`` at full width and ``layers`` layers (random bf16
    weights from seed 0, pool ``pool``, decode_chunk 8), unsharded or on
    ``mesh``: the results, the kernels' launches, the wall time, the cache
    leaves' layouts and, with ``profile`` (a phase name), the steady-chunk
    profile of ``profile_phase``."""
    from repro_torch.common import tree
    gc.collect()
    torch.cuda.empty_cache()
    serve, cfg = serve_mod.make_serve_engine(
        arch, max_prompt_len=256, max_tokens=32, concurrency=pool,
        temperature=0.8, top_k=50, top_p=0.95, seed=0, num_layers=layers,
        mesh=mesh)
    rng = np.random.default_rng(3)
    for k in rng.integers(64, 257, requests):
        serve.submit(serve_mod.GenerateRequest(
            prompt=rng.integers(0, cfg.vocab_size - 1, int(k))))
    torch.cuda.synchronize()
    reset_launches(kernels)
    t0 = time.perf_counter()
    results = serve.drain()
    serve.eng.block_until_ready()
    wall = time.perf_counter() - t0
    launches = read_launches(kernels)
    serve.close()
    check_results(np, results, cfg, requests)
    out = dict(cfg=cfg, results={r.request_id: (r.tokens, r.logprobs)
                                 for r in results},
               tokens=sum(len(r.tokens) for r in results), seconds=wall,
               launches=launches)
    if mesh is not None:
        from repro_torch.launch.sharding import cache_placements
        cache = serve.eng.cache
        out["layout"] = sorted({f"{n}: {t.placements}" for layer in cache
                                for n, t in layer.items()})
        out["layout_as_rules"] = all(
            tuple(t.placements) == cache_placements(
                (i, n), tuple(t.shape), cfg, mesh, shard_seq=pool == 1)
            for i, layer in enumerate(cache) for n, t in layer.items())
    if profile:
        out["profile"] = profile_phase(torch, np, serve, cfg, phase=profile,
                                       prompt_hi=256)
    del serve
    return out


def serve_sharded_kinds_phase(torch, np, serve_mod, kernels, profile=False):
    """Sharded serving of every block kind on the card, on (1, 1) NCCL
    meshes of a process group of world size 1 (each destroyed after its
    run): hymba-1.5b, rwkv6-1.6b, deepseek-moe-16b and
    llama-3.2-vision-90b (its media) at full width and the depths of
    SHARDED_KINDS, 6 requests each through RolloutEngine(mesh=) (a
    ServeEngine on a mesh, the weights made in the serve layout), pool 4;
    then one-slot pools (the cache in the ``shard_seq`` layout) of rwkv6
    and hymba, 2 requests; then llama3.2-1b at 4 of its 16 layers on the
    (1, 1, 1) ("data", "kvg", "model") GQA serve mesh. Each run's tokens
    and logps must equal the unsharded engine's at the same pool bit for
    bit, and every kernel of its path must have launched on the shards
    (``ssm_scan``, ``wkv6``, ``decode_attn``, ``flash_attn`` and
    ``fused_sample`` as the kind runs them). With ``profile``, each run's
    steady-chunk host and device times beside the unsharded ones
    (``chip_phases.py serve_sharded_kinds``). Emits one line a run;
    returns {run: launches}."""
    from repro_torch.launch.mesh import make_gqa_serve_mesh, make_single_mesh
    cases = [(name, arch, layers, names, 4, 6, make_single_mesh)
             for name, arch, layers, names in SHARDED_KINDS]
    cases += [(name + "_shard_seq", arch, layers, names, 1, 2,
               make_single_mesh)
              for name, arch, layers, names in SHARDED_KINDS[:2]]
    cases.append(("llama_kvg", "llama3.2-1b", 4,
                  ("flash_attn", "decode_attn", "fused_sample"), 4, 6,
                  lambda: make_gqa_serve_mesh(1, 1, 1)))
    out = {}
    for name, arch, layers, names, pool, n, make in cases:
        mine = {k: kernels[k] for k in names}
        prof = f"profile_kinds_{name}" if profile else ""
        plain = kind_run(torch, np, serve_mod, arch, layers, mine, pool=pool,
                         requests=n, profile=prof and prof + "_unsharded")
        mesh = make()
        try:
            sharded = kind_run(torch, np, serve_mod, arch, layers, mine,
                               pool=pool, requests=n, mesh=mesh,
                               profile=prof)
            cfg = sharded["cfg"]
            mesh_shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
        finally:
            torch.distributed.destroy_process_group()
        differ = [i for i, r in sharded["results"].items()
                  if r != plain["results"][i]]
        phase = f"serve_sharded_{name}"
        extra = {}
        if profile:
            extra = {k: sharded["profile"][k] for k in (
                "wall_ms_per_chunk", "device_busy_ms_per_chunk",
                "device_idle_share")}
            extra.update({f"{k}_unsharded": plain["profile"][k] for k in (
                "wall_ms_per_chunk", "device_busy_ms_per_chunk",
                "device_idle_share")})
        emit(phase, arch=arch, layers=layers, d_model=cfg.d_model,
             heads=f"{cfg.num_heads}/{cfg.num_kv_heads} x {cfg.head_dim}",
             kinds=sorted(set(cfg.prefix_pattern + cfg.block_pattern)),
             mesh=mesh_shape, backend="nccl", pool=pool,
             shard_seq=pool == 1,
             depth_cut=f"{layers} of {serve_mod.get_config(arch).num_layers}"
             f" layers: {KINDS_CUT}",
             requests=n, tokens=sharded["tokens"],
             seconds=sharded["seconds"],
             seconds_unsharded=plain["seconds"],
             bit_equal_requests=n - len(differ), differ=differ,
             launches=sharded["launches"],
             launches_unsharded=plain["launches"],
             cache_layout=sharded["layout"], **extra)
        if differ:
            fail(f"{phase}: requests {differ} differ from the unsharded "
                 "engine's tokens or logps")
        if not all(v > 0 for v in sharded["launches"].values()):
            fail(f"{phase}: a kernel never ran on the shards: "
                 f"{sharded['launches']}")
        if not sharded["layout_as_rules"]:
            fail(f"{phase}: the cache is not laid out as cache_placements "
                 f"says (shard_seq={pool == 1}): {sharded['layout']}")
        out[phase] = sharded["launches"]
    return out


def sharded_init_memory(torch, mesh, cfg):
    """The peak memory of making llama3.2-1b's training params on ``mesh``
    two ways: the whole float32 model first, then shard_params (before
    init_sharded_params), and init_sharded_params (each piece distributed
    as it is made). Bytes above what was allocated before each, and
    whether the two give the same shards."""
    from repro_torch.common import tree
    from repro_torch.launch import sharding as shd
    from repro_torch.models import model as M

    def peak(make):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = make()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base

    before, peak_before = peak(lambda: shd.shard_params(
        M.init_params(cfg, seed=3, device="cuda"), mesh, cfg))
    before = [t.to_local() for t in tree.leaves(before)]
    after, peak_after = peak(lambda: shd.init_sharded_params(cfg, mesh,
                                                             seed=3))
    same = all(torch.equal(a.to_local(), b)
               for a, b in zip(tree.leaves(after), before))
    del before
    params_bytes = sum(t.to_local().numel() * t.to_local().element_size()
                       for t in tree.leaves(after))
    return after, dict(peak_bytes_whole_then_shard=peak_before,
                       peak_bytes_init_sharded=peak_after,
                       params_bytes=params_bytes, same_shards=same)


def copris_sharded_phase(torch, np, kernels, steps=2, num_layers=4):
    """The CoPRIS trainer on one mesh on the card: llama3.2-1b at full
    width and ``num_layers`` of its 16 layers (the run's time limit; the
    sharded path's shapes do not depend on the depth, and
    ``train_sharded`` runs the update at full depth) (f32 masters, bf16
    compute, remat, the fused loss,
    entropy 0.01 for a gradient from random weights), ``steps`` sequential
    CoPRISTrainer steps unsharded and then with ``train_mesh`` a (1, 1)
    NCCL mesh: params made by init_sharded_params and sharded AdamW state,
    the sharded update, each version redistributed to the serve layout,
    the sharded rollout engine. Rollout tokens must be equal step for
    step, each leaf's update within 1e-4 of its largest element
    (train_sharded's rule), the rollout and update kernels launched on
    the local shards. Reports both arms' step, rollout and update times,
    and the sharded init's peak memory against the whole model's first
    (sharded_init_memory). Destroys its process group."""
    from repro_torch.common import tree
    from repro_torch.common.config import RolloutConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.core.copris import CoPRISTrainer
    from repro_torch.data.tasks import EOS, AdditionTask
    from repro_torch.launch.mesh import make_single_mesh
    from repro_torch.models import model as M
    gc.collect()
    torch.cuda.empty_cache()
    full = get_config("llama3.2-1b")
    cfg = dataclasses.replace(full, num_layers=num_layers)
    ro = RolloutConfig(batch_size=8, group_size=4, max_prompt_len=4,
                       max_response_len=32, concurrency=16, mode="copris",
                       temperature=1.0)
    tc = TrainConfig(lr=1e-5, warmup_steps=1, seed=3, entropy_coef=0.01)
    base = tree.tree_map(lambda t: t.detach().cpu(),
                         M.init_params(cfg, seed=3, device="cuda"))

    def run(mesh, params):
        tr = CoPRISTrainer(cfg, ro, tc, AdditionTask(max_value=20, seed=3),
                           eos_id=EOS, params=params, train_mesh=mesh)
        reset_launches(kernels)
        outs, trajs = [], []
        try:
            for _ in range(steps):
                outs.append(tr.step())
                trajs.append(traj_keys(tr.last_groups))
            launches = read_launches(kernels, backward=True)
            new = local_leaves(tr.params)
        finally:
            tr.close()
        return dict(outs=outs, trajs=trajs, launches=launches,
                    params=[t.cpu() for t in new])

    plain = run(None, tree.tree_map(lambda t: t.cuda(), base))
    gc.collect()
    torch.cuda.empty_cache()
    mesh = make_single_mesh()
    try:
        params, init_mem = sharded_init_memory(torch, mesh, full)
        # the trainer shards the same values itself; the init's shards
        # are checked above
        del params
        sharded = run(mesh, tree.tree_map(lambda t: t.cuda(), base))
    finally:
        torch.distributed.destroy_process_group()
    p0 = tree.leaves(base)
    rel = [leaf_rel(a - b0, b - b0) for a, b, b0 in zip(
        sharded["params"], plain["params"], p0)]
    equal_tokens = [a == b for a, b in zip(sharded["trajs"], plain["trajs"])]
    keys = ("step_time", "rollout_time", "update_time", "reshard_time",
            "reward_mean", "pg_loss", "grad_norm", "mean_resp_len")
    launches = sharded["launches"]
    emit("copris_sharded", arch=cfg.name, layers=cfg.num_layers,
         depth_cut=f"{cfg.num_layers} of {full.num_layers} layers: the "
         "run's time limit (train_sharded runs the update at full depth)",
         d_model=cfg.d_model, vocab=cfg.vocab_size,
         mesh={"data": 1, "model": 1}, backend="nccl", steps=steps,
         rollout="batch 8 x group 4, response <= 32, concurrency 16",
         tokens_equal_by_step=equal_tokens,
         worst_leaf_update_rel_err=max(rel),
         bit_equal_leaves=sum(e == 0.0 for e in rel), leaves=len(rel),
         rel_tol=1e-4,
         steps_sharded=[{k: o[k] for k in keys} for o in sharded["outs"]],
         steps_unsharded=[{k: o[k] for k in keys} for o in plain["outs"]],
         launches=launches, launches_unsharded=plain["launches"],
         sharded_init=init_mem)
    if not all(equal_tokens):
        fail(f"copris_sharded: rollout tokens differ from the unsharded "
             f"trainer's: {equal_tokens}")
    if not max(rel) <= 1e-4:
        fail(f"copris_sharded: a leaf's update {max(rel)} from the "
             "unsharded one (1e-4 of its largest element)")
    if not init_mem["same_shards"]:
        fail("copris_sharded: init_sharded_params differs from "
             "shard_params(init_params)")
    if not all(n > 0 for n in launches.values()):
        fail(f"copris_sharded: a kernel never ran on the local shards: "
             f"{launches}")
    return launches


def leaf_names(tree, prefix=""):
    """Each leaf's dotted path, in the order of common.tree.leaves."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def moe_ep_arm(torch, np, cfg, dispatch, base, batch, tc, mesh):
    """make_loss_fn and its gradient with ``dispatch``: "shardmap" on the
    mesh (params and batch as DTensors), "sparse" unsharded."""
    from repro_torch.common.partitioning import set_activation_mesh
    from repro_torch.common.tree import leaves, tree_map
    from repro_torch.core.copris import make_loss_fn
    from repro_torch.launch import sharding as shd
    from repro_torch.models.moe_shardmap import apply_moe_shardmap
    c = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                         dispatch=dispatch))
    params = tree_map(lambda t: t.detach().clone().requires_grad_(), base)
    b = batch
    if dispatch == "shardmap":
        set_activation_mesh(mesh)
        params = shd.shard_params(params, mesh, cfg)
        b = shd.shard_batch(batch, mesh)
    x0 = apply_moe_shardmap.exchanges
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        loss, metrics = make_loss_fn(c, tc)(params, b)
        grads = torch.autograd.grad(loss, leaves(params))
        torch.cuda.synchronize()
    finally:
        set_activation_mesh(None)
    return dict(seconds=time.perf_counter() - t0,
                loss=as_float(loss.detach()),
                metrics={k: as_float(v) for k, v in metrics.items()},
                grads=local_leaves(grads),
                exchanges=apply_moe_shardmap.exchanges - x0)


def moe_ep_errors(ep, sp, names):
    errs = [leaf_rel(a, b) for a, b in zip(ep["grads"], sp["grads"])]
    worst = max(range(len(errs)), key=errs.__getitem__)
    return dict(loss_err=abs(ep["loss"] - sp["loss"]),
                max_metric_err=max(abs(ep["metrics"][k] - sp["metrics"][k])
                                   for k in sp["metrics"]),
                max_grad_err_rel=errs[worst], worst_leaf=names[worst],
                bit_equal_leaves=sum(e == 0.0 for e in errs),
                router_aux_shardmap=ep["metrics"]["router_aux"],
                router_aux_sparse=sp["metrics"]["router_aux"],
                exchanges=ep["exchanges"],
                seconds_shardmap=ep["seconds"],
                seconds_sparse=sp["seconds"])


def moe_ep_runs(torch, np, full, num_layers, tc, mesh, kernels):
    """train_moe_ep's two dtypes: {dtype: moe_ep_errors, "launches": the
    bf16 shardmap run's launch counts}."""
    from repro_torch.models import model as M
    out = {}
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(full, num_layers=num_layers, dtype=dtype)
        base = M.init_params(cfg, seed=4, device="cuda")
        names = leaf_names(base)
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in update_batch(np, cfg, seed=30).items()}
        sp = moe_ep_arm(torch, np, cfg, "sparse", base, batch, tc, mesh)
        reset_launches(kernels)
        ep = moe_ep_arm(torch, np, cfg, "shardmap", base, batch, tc, mesh)
        if dtype == "bfloat16":
            out["launches"] = read_launches(kernels)
        out[dtype] = moe_ep_errors(ep, sp, names)
        del base, sp, ep
        gc.collect()
        torch.cuda.empty_cache()
    return out


def train_moe_ep_phase(torch, np, kernels, num_layers=3):
    """The expert-parallel dispatch on the card: deepseek-moe-16b at its
    dense first layer and two MoE layers, full width (64 experts top-6, 2
    shared; the fused loss, entropy 0.01, remat), make_loss_fn and its
    gradient on a seeded 32 x 128 batch with dispatch="shardmap" on the
    (1, 1) mesh (tokens routed per rank, two all-to-all exchanges a layer
    through the NCCL group) against dispatch="sparse" unsharded, from the
    same weights. With one rank and T <= 65536 the per-rank capacity and
    aux are the sparse dispatch's and the exchange is a copy. In bf16
    compute (the main path, whose launches are counted: every kernel must
    have run, and the exchanges) and in float32 compute, loss and metrics
    (router_aux among them) must agree within 1e-4 and each gradient leaf
    within 1e-4 of its largest element (the train references'
    tolerance); the bit-equal leaves are reported. Returns the launch
    counts of the bf16 shardmap run."""
    from repro_torch.common.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_single_mesh
    gc.collect()
    torch.cuda.empty_cache()
    full = get_config("deepseek-moe-16b")
    tc = TrainConfig(lr=1e-5, entropy_coef=0.01, remat=True)
    mesh = make_single_mesh()
    try:
        out = moe_ep_runs(torch, np, full, num_layers, tc, mesh, kernels)
    finally:
        torch.distributed.destroy_process_group()
    launches = out.pop("launches")
    emit("train_moe_ep", arch=full.name, layers=num_layers,
         depth_cut=f"{num_layers} of {full.num_layers} layers: the full "
         "depth's training state (~262 GB) does not fit the card",
         d_model=full.d_model, experts=full.moe.num_experts,
         top_k=full.moe.top_k, capacity_factor=full.moe.capacity_factor,
         mesh={"data": 1, "model": 1}, batch="32 x 128", atol=1e-4,
         grad_rtol=1e-4, bf16=out["bfloat16"],
         float32=out["float32"], launches=launches)
    bf, f32 = out["bfloat16"], out["float32"]
    if not all(o["exchanges"] > 0 for o in out.values()):
        fail(f"train_moe_ep: no exchange in a shardmap run: {out}")
    if not all(n > 0 for n in launches.values()):
        fail(f"train_moe_ep: a kernel never launched: {launches}")
    if not all(o["loss_err"] <= 1e-4 and o["max_metric_err"] <= 1e-4
               and o["max_grad_err_rel"] <= 1e-4 for o in (bf, f32)):
        fail(f"train_moe_ep: shardmap disagrees with sparse: {out}")
    return launches


MULTIHOST = ["-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "1", "-m", "repro_torch.launch.multihost",
             "--arch", "llama3.2-1b", "--steps", "2", "--global-batch", "8",
             "--seq-len", "512", "--microbatches", "1"]


def multihost_phase(np, started=None):
    """The sharded launcher as a user starts it: torchrun with one process
    (--standalone: its rendezvous on a free local port) running
    repro_torch.launch.multihost on llama3.2-1b at full width, 2 updates of
    a global batch of 8 x 512 on a (1, 1) mesh over NCCL. It must exit 0
    with two finite losses. ``started``: the :class:`Background` run of
    MULTIHOST started earlier (the full run starts it beside the reference
    phases, which time nothing; its rank 0 reports its own peak memory);
    None: run it now."""
    started = started or Background(MULTIHOST, 600)
    r = started.finish()
    if r is None:
        fail("multihost: past its 600 s timeout")
    rc, out, err = r
    losses = [float(m.group(1))
              for m in re.finditer(r"step \d+: loss (\S+)", out)]
    mem = re.search(r"init peak memory (\d+) bytes, params and AdamW "
                    r"state (\d+) bytes", out)
    emit("multihost", command=" ".join(MULTIHOST), returncode=rc,
         losses=losses, subprocess_seconds=started.seconds,
         init_peak_bytes_rank0=int(mem.group(1)) if mem else None,
         params_and_adamw_bytes_rank0=int(mem.group(2)) if mem else None,
         init="sharding.init_sharded_params",
         stderr_tail=err[-3000:] if rc else "")
    if rc != 0 or len(losses) != 2 \
            or not all(np.isfinite(losses)) or mem is None:
        fail(f"multihost: exit {rc}, losses {losses}, init memory line "
             f"{mem}")


def train_multiturn_phase(torch, np, kernels, sft, steps=2, extra_sft=8):
    """Multi-turn environments at full width: llama3.2-1b from the train
    phase's SFT-warmed weights with MultiTurnMathTask(max_value=9,
    num_turns=2), max_response_len 64, overlap=True, ``steps`` steps. A
    model turn that stops yields its slot to the AsyncEnvWorker; its
    observation is appended with role 0 and the next dispatch re-prefills
    it. After the train phase's 4 SFT steps no turn ends with EOS within 64
    tokens, so every turn would stop at length and end its episode: the
    SFT on AdditionTask (the per-turn answer format: digits, then EOS; the
    multi-turn task has no demonstrations) goes on for ``extra_sft`` steps
    first. Checks: env_steps > 0 and env_turns > 0; observation positions
    of the trained batches with loss mask 0, behaviour log-prob 0 and stage
    -1; every kernel of the path launched. Returns the launch counts."""
    from repro_torch.common.config import RolloutConfig, TrainConfig
    from repro_torch.common.tree import tree_map
    from repro_torch.configs import get_config
    from repro_torch.core.copris import CoPRISTrainer
    from repro_torch.data.sft import sft_warmup
    from repro_torch.data.tasks import EOS, AdditionTask, MultiTurnMathTask
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("llama3.2-1b")
    params, sft_loss = sft_warmup(
        tree_map(lambda t: t.cuda(), sft["params"]), cfg,
        AdditionTask(max_value=20, seed=0), steps=extra_sft, batch_size=32,
        max_len=24, lr=1e-4)
    ro = RolloutConfig(batch_size=8, group_size=4, max_prompt_len=16,
                       max_response_len=64, concurrency=16, mode="copris",
                       temperature=1.0)
    tc = TrainConfig(lr=1e-5, warmup_steps=1, seed=0, overlap=True,
                     max_staleness=1)
    tr = CoPRISTrainer(cfg, ro, tc,
                       MultiTurnMathTask(max_value=9, num_turns=2, seed=0),
                       eos_id=EOS, params=params)
    del params
    tr.batch_timeout = 600.0
    outs, launches, _ = overlapped_run(torch, tr, kernels, steps)
    obs_positions = 0
    bad_obs = 0
    for o in outs:
        b = o["batch"]
        env_pos = (b["response_mask"] > 0) & (b["loss_mask"] == 0)
        obs_positions += int(env_pos.sum())
        bad_obs += int((b["behaviour_logp"][env_pos] != 0.0).sum()
                       + (b["stage_ids"][env_pos] != -1).sum())
    emit("train_multiturn", arch=cfg.name, task="MultiTurnMathTask(9, 2)",
         max_response_len=64, extra_sft_steps=extra_sft,
         extra_sft_loss=sft_loss,
         steps=[{k: o[k] for k in TRAIN_KEYS + STEP_REPORT + (
             "env_steps", "env_turns", "env_failures", "env_timeouts",
             "env_wait_time")} for o in outs],
         observation_positions=obs_positions,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         launches=launches)
    check_overlapped(np, "train_multiturn", outs, launches)
    if not (sum(o["env_steps"] for o in outs) > 0
            and sum(o["env_turns"] for o in outs) > 0):
        fail("train_multiturn: no environment step or no second turn")
    if obs_positions == 0 or bad_obs:
        fail(f"train_multiturn: {obs_positions} observation positions, "
             f"{bad_obs} with a behaviour log-prob or a stage")
    return launches


def reference_overlap_phase(torch, np, cfg, steps=3):
    """The overlapped GPU trainer against a sequential CPU trainer that
    replays its schedule: the reduced config in float32 (vocab 8192, as in
    train_reference). The GPU run (overlap=True, max_staleness=1) records
    each batch's params_version; the CPU run's collects take
    ``param_store.get(v)`` for the recorded v. Equal tokens, stages and
    roles on every trajectory; losses and metrics atol 1e-4, grad_norm rtol
    1e-5, final params atol 1e-4 (train_reference's tolerances)."""
    from repro_torch.common.config import RolloutConfig, TrainConfig
    from repro_torch.common.tree import leaves, tree_map
    from repro_torch.core.copris import CoPRISTrainer
    from repro_torch.data.tasks import EOS, AdditionTask
    from repro_torch.models import model as M
    ro = RolloutConfig(batch_size=4, group_size=2, max_prompt_len=16,
                       max_response_len=24, concurrency=8, mode="copris")
    base = M.init_params(cfg, seed=6, device="cpu")
    runs, schedule = {}, None
    for dev in ("cuda", "cpu"):
        tc = TrainConfig(lr=1e-5, warmup_steps=1, seed=6, entropy_coef=0.01,
                         overlap=dev == "cuda")
        tr = CoPRISTrainer(cfg, ro, tc, AdditionTask(max_value=20, seed=6),
                           eos_id=EOS, device=dev,
                           params=tree_map(lambda t: t.to(dev), base))
        tr.batch_timeout = 300.0
        if schedule is not None:
            store, versions = tr.param_store, iter(schedule)
            store.acquire = lambda: (lambda v: (store.get(v), v))(
                next(versions))
        outs, trajs, logps = [], [], []
        try:
            for _ in range(steps):
                outs.append(tr.step())
                trajs += traj_keys(tr.last_groups)
                logps += [t.behaviour_logps for grp in tr.last_groups
                          for t in grp.trajectories]
        finally:
            tr.close()
        if schedule is None:
            schedule = [o["step"] - o["param_staleness"] for o in outs]
        runs[dev] = dict(outs=outs, trajs=trajs, logps=logps,
                         params=[p.detach().cpu() for p in leaves(tr.params)])
    g, c = runs["cuda"], runs["cpu"]
    tokens_equal = g["trajs"] == c["trajs"]
    logp_err = max(float(np.max(np.abs(np.asarray(x) - np.asarray(y))))
                   for x, y in zip(g["logps"], c["logps"]) if len(x) == len(y))
    metric_keys = ("pg_loss", "ratio_mean", "approx_kl", "entropy",
                   "clip_frac", "reward_mean", "off_policy_frac")
    m_err = max(abs(a[k] - b[k]) for a, b in zip(g["outs"], c["outs"])
                for k in metric_keys)
    gn_err = max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                 for a, b in zip(g["outs"], c["outs"]))
    p_err = max(float((a - b).abs().max())
                for a, b in zip(g["params"], c["params"]))
    emit("reference_overlap", config=cfg.name, vocab=cfg.vocab_size,
         steps=steps, schedule=schedule,
         trajectories=len(g["trajs"]),
         tokens_equal=tokens_equal, max_logp_err=logp_err,
         max_metric_err=m_err, metrics=list(metric_keys), atol=1e-4,
         grad_norm_rel_err=gn_err, grad_norm_rtol=1e-5,
         max_param_err=p_err, param_atol=1e-4)
    if schedule == list(range(steps)):
        fail("reference_overlap: the GPU run never overlapped")
    if not (tokens_equal and m_err <= 1e-4 and gn_err <= 1e-5
            and p_err <= 1e-4):
        fail("reference_overlap: the overlapped GPU trainer disagrees with "
             "the CPU replay of its schedule")


def reference_multiturn_phase(torch, np, cfg):
    """Multi-turn engines on the reduced config in float32, the same
    weights (20 SFT steps on the CPU, so turns end with EOS) and stage key
    on three engines: GPU dense, GPU paged (8 pages of 16 for 8 slots of
    max_len 128: admission blocks and preempts), CPU dense. On the common
    (group_id, sample_idx) keys: equal response tokens, roles and
    turn_starts, behaviour log-probs within 1e-5."""
    from repro_torch.common.config import RolloutConfig
    from repro_torch.common.tree import tree_map
    from repro_torch.core.rollout import RolloutEngine
    from repro_torch.data.sft import sft_warmup
    from repro_torch.data.tasks import EOS, AdditionTask, MultiTurnMathTask
    from repro_torch.models import model as M
    from repro_torch.sampling import prng
    base, _ = sft_warmup(M.init_params(cfg, seed=7, device="cpu"), cfg,
                         AdditionTask(max_value=20, seed=7), steps=20,
                         batch_size=32, max_len=24, lr=1e-3)
    base = tree_map(lambda t: t.detach(), base)
    res = {}
    for name, dev, paged in (("gpu_dense", "cuda", False),
                             ("gpu_paged", "cuda", True),
                             ("cpu_dense", "cpu", False)):
        task = MultiTurnMathTask(max_value=9, num_turns=2, seed=3)
        ro = RolloutConfig(batch_size=4, group_size=2, max_prompt_len=16,
                           max_response_len=64, concurrency=8, mode="copris",
                           decode_chunk=8,
                           kv_backend="paged" if paged else "dense",
                           kv_page_size=16, kv_num_pages=8)
        eng = RolloutEngine(cfg, ro, task.sample_prompt, eos_id=EOS,
                            env_factory=task.make_env, device=dev)
        try:
            groups, st = eng.collect(tree_map(lambda t: t.to(dev), base), 0,
                                     prng.PRNGKey(11))
        finally:
            eng.env_worker.shutdown()
        res[name] = ({(g.group_id, t.sample_idx): t for g in groups
                      for t in g.trajectories}, st)
    ref, ref_st = res["cpu_dense"]
    out = {}
    ok = True
    for name in ("gpu_dense", "gpu_paged"):
        got, st = res[name]
        common = sorted(set(got) & set(ref))
        same = all(got[k].response_tokens == ref[k].response_tokens
                   and got[k].roles == ref[k].roles
                   and got[k].turn_starts == ref[k].turn_starts
                   for k in common)
        err = max((float(np.max(np.abs(np.asarray(got[k].behaviour_logps)
                                       - np.asarray(ref[k].behaviour_logps))))
                   for k in common if got[k].response_tokens
                   == ref[k].response_tokens), default=0.0)
        multi = sum(ref[k].num_turns > 1 for k in common)
        out[name] = dict(common=len(common), multi_turn=multi, equal=same,
                         max_logp_err=err, env_steps=st["env_steps"],
                         env_turns=st["env_turns"], evicted=st["evicted"],
                         admission_blocked=st["admission_blocked"],
                         page_preemptions=st["page_preemptions"])
        ok = ok and same and err <= 1e-5 and common and multi > 0
    emit("reference_multiturn", config=cfg.name, engines=out,
         cpu_dense=dict(env_steps=ref_st["env_steps"],
                        env_turns=ref_st["env_turns"]), atol=1e-5)
    pressure = out["gpu_paged"]
    if not (pressure["admission_blocked"] + pressure["page_preemptions"]
            > 0):
        fail("reference_multiturn: the paged engine saw no page pressure")
    if not ok:
        fail("reference_multiturn: a GPU engine disagrees with the CPU one")


def serve_arch_phase(torch, np, serve_mod, arch, kernels, phase, *,
                     kv_backend="dense", kv_num_pages=0, num_layers=0,
                     cut=""):
    """``arch`` served at full width with random bf16 weights made from a
    seed: pool 16, decode_chunk 8, 24 requests of 64-512 prompt tokens and
    128 new tokens each, over the dense cache or the paged one with
    ``kv_num_pages`` pages of 16; at full depth, or at ``num_layers`` of
    its layers for the reason ``cut`` (listed in the phase's line as
    ``depth_cut``). Every kernel of the path must launch and every
    request return; a paged run must show page pressure. Then the profile
    phase's two steady decode chunks. Returns the launch counts."""
    gc.collect()
    torch.cuda.empty_cache()
    serve, cfg = serve_mod.make_serve_engine(
        arch, max_prompt_len=512, max_tokens=128, concurrency=16,
        temperature=0.8, top_k=50, top_p=0.95, kv_backend=kv_backend,
        kv_page_size=16, kv_num_pages=kv_num_pages, seed=0,
        num_layers=num_layers)
    full = serve_mod.get_config(arch)
    if (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab_size) != (
            full.d_model, full.num_heads, full.num_kv_heads, full.head_dim,
            full.d_ff, full.vocab_size) \
            or cfg.num_layers != (num_layers or full.num_layers):
        fail(f"{phase}: not the full {arch} width: {cfg}")
    prompts = serve_prompts(np, cfg, n=24)
    for p in prompts:
        serve.submit(serve_mod.GenerateRequest(prompt=p))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(kernels)
    t0 = time.perf_counter()
    results = serve.drain()
    serve.eng.block_until_ready()
    wall = time.perf_counter() - t0
    launches = read_launches(kernels)
    by_length = read_by_length(kernels)
    stats = serve.close()
    backend = serve.eng.backend
    ntok = check_results(np, results, cfg, len(prompts))
    extra = {}
    if backend.is_paged:
        extra = dict(kv_page_size=backend.page_size,
                     kv_num_pages=backend.num_pages,
                     dense_equivalent_pages=backend.pool * backend.max_pages,
                     admission_blocked=stats["admission_blocked"],
                     page_preemptions=stats["page_preemptions"],
                     pages_allocated=backend.pages_allocated)
    if num_layers:
        extra["depth_cut"] = f"{num_layers} of {full.num_layers} layers: {cut}"
    emit(phase, arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
         heads=f"{cfg.num_heads}/{cfg.num_kv_heads} x {cfg.head_dim}",
         vocab=cfg.vocab_size, kv_backend=kv_backend,
         requests=len(results), tokens=ntok, seconds=wall,
         tokens_per_s=ntok / wall, decode_chunks=stats["decode_chunks"],
         prefill_calls=stats["prefill_calls"],
         utilization=stats["utilization"], launches=launches,
         launches_by_length=by_length,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, **extra)
    if backend.is_paged and \
            stats["admission_blocked"] + stats["page_preemptions"] == 0:
        fail(f"{phase}: no admission was blocked and no slot preempted")
    if not all(n > 0 for n in launches.values()):
        fail(f"a kernel of the {phase} path never launched: {launches}")
    profile_phase(torch, np, serve, cfg, phase=f"profile_{phase}")
    return launches, by_length


def copris_arch_phase(torch, np, model, runs, *, cut=""):
    """Two RolloutEngine.collect stages on each of ``runs`` ((arch,
    resume strategy, kernels, phase, layers: 0 for all, else that many of
    the config's layers for the reason ``cut``)) at full width with random bf16
    weights: hymba-1.5b resumes with kv_snapshot (the snapshot carries the
    ssm / conv state beside the K/V), rwkv6-1.6b, paper-qwen-7b and
    deepseek-moe-16b re-prefill. max_len 256 < the 192 + 128 budget, so a
    group's stop length depends on its prompt: groups finish at different
    times, early termination evicts, the next stage resumes."""
    from repro_torch.common.config import RolloutConfig
    from repro_torch.configs import get_config
    from repro_torch.core.rollout import RolloutEngine
    from repro_torch.sampling import prng
    for arch, strategy, kernels, phase, num_layers in runs:
        gc.collect()
        torch.cuda.empty_cache()
        cfg = full = get_config(arch)
        if num_layers:
            cfg = dataclasses.replace(cfg, num_layers=num_layers)
        params = model.init_params(cfg, seed=2, device="cuda",
                                   compute_dtype=torch.bfloat16)
        ro = RolloutConfig(batch_size=4, group_size=4, max_prompt_len=192,
                           max_response_len=128, concurrency=16,
                           mode="copris", temperature=0.8, top_k=50,
                           top_p=0.95, resume_strategy=strategy)
        rng = np.random.default_rng(5)

        def source():
            n = int(rng.integers(64, 193))
            return rng.integers(0, cfg.vocab_size - 1, n), None

        eng = RolloutEngine(cfg, ro, source, eos_id=cfg.vocab_size - 1,
                            max_len=256)
        stages = []
        for stage in range(2):
            reset_launches(kernels)
            groups, st = eng.collect(params, stage,
                                     prng.PRNGKey(200 + stage))
            stages.append(dict(stage=stage, groups=len(groups),
                               generated=st["generated"],
                               evicted=st["evicted"], resumed=st["resumed"],
                               snapshot_resumes=st.get("snapshot_resumes",
                                                       0),
                               buffered_partials=eng.buffer.num_unfinished,
                               wall_time=st["wall_time"],
                               launches=read_launches(kernels)))
            for g in groups:
                for t in g.trajectories:
                    t.check_invariants()
                    if not all(np.isfinite(lp) and lp <= 0.0
                               for lp in t.behaviour_logps):
                        fail(f"{phase} {arch}: logp not finite or > 0")
        extra = ({"depth_cut": f"{num_layers} of {full.num_layers} layers: "
                  f"{cut}"} if num_layers else {})
        emit(phase, arch=arch, resume_strategy=strategy, stages=stages,
             layers=cfg.num_layers, **extra)
        if stages[0]["evicted"] == 0 or stages[1]["resumed"] == 0:
            fail(f"{phase} {arch}: evicted {stages[0]['evicted']}, "
                 f"resumed {stages[1]['resumed']}")
        if strategy == "kv_snapshot" and stages[1]["snapshot_resumes"] == 0:
            fail(f"{phase} {arch}: no kv_snapshot resume")
        if not all(n > 0 for n in stages[0]["launches"].values()):
            fail(f"{phase} {arch}: a kernel never launched")
        del params, eng


def serve_prompts(np, cfg, n=24):
    """The serve phases' ``n`` requests: prompts of 64-512 tokens."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size - 1, int(k))
            for k in rng.integers(64, 513, n)]


def check_results(np, results, cfg, n_requests):
    """Every request returned, with 1-128 in-vocab tokens and finite logps
    <= 0; returns the number of generated tokens."""
    if sorted(r.request_id for r in results) != list(range(n_requests)):
        fail("serve did not return every request")
    ntok = 0
    for r in results:
        ntok += len(r.tokens)
        if not (1 <= len(r.tokens) <= 128 and len(r.logprobs) == len(r.tokens)):
            fail(f"request {r.request_id}: bad length {len(r.tokens)}")
        if not all(0 <= t < cfg.vocab_size for t in r.tokens):
            fail(f"request {r.request_id}: token out of vocab")
        if not all(np.isfinite(lp) and lp <= 0.0 for lp in r.logprobs):
            fail(f"request {r.request_id}: logp not finite or > 0")
    return ntok


def tc_registers(build, libraries):
    """ptxas's registers and spill bytes (stores, loads) of each tensor-core
    kernel (a name ending in _tc) of ``libraries``, from the log kept beside
    each built library."""
    import re
    out = {}
    for name in libraries:
        log = build.library_log(name)
        for entry, body in re.findall(
                r"Compiling entry function '(\S+)'(.*?)(?=Compiling entry|\Z)",
                log, re.S):
            short = re.search(r"(?:[a-z]+_)+tc(?=I)", entry)
            regs = re.search(r"Used (\d+) registers", body)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", body)
            if short and regs and spill:
                key = f"{name}:{short.group(0)}"
                out.setdefault(key, []).append(
                    [int(regs.group(1)), int(spill.group(1)),
                     int(spill.group(2))])
    return out


def scan_registers(build):
    """ptxas's registers, spill bytes (stores, loads) and static shared
    memory of each scan kernel (csrc/ssm_scan.cu, csrc/wkv6.cu: the
    forward's decode and prefill kernels, the prefill kernels that store
    the backward's boundary states, and the backward kernels), by
    instantiation: {"wkv6_scan_kernel<bf16,64>": [regs, st, ld, smem]};
    for the backward kernels, which take all theirs dynamically, the bytes
    they launch with (as their queries report them)."""
    import ctypes
    import re
    out = {}

    def smem_of(query):
        def smem(dtype, n):
            v = ctypes.c_int()
            query(n, int(dtype == "bf16"), ctypes.addressof(v))
            return [v.value]
        return smem

    smem_bwd = {
        "ssm_scan_bwd_kernel": smem_of(
            build.library("ssm_scan").ssm_scan_bwd_chunk),
        "wkv6_bwd_kernel": smem_of(build.library("wkv6").wkv6_bwd_chunk)}
    for name in ("ssm_scan", "wkv6"):
        log = build.library_log(name)
        for entry, body in re.findall(
                r"Compiling entry function '(\S+)'(.*?)(?=Compiling entry|\Z)",
                log, re.S):
            m = re.search(r"((?:ssm|wkv6)_(?:step|scan|scan_save|scan_bwd|bwd)"
                          r"_kernel)I(f|13__nv_bfloat16)Li(\d+)E", entry)
            regs = re.search(r"Used (\d+) registers", body)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", body)
            smem = re.search(r"(\d+) bytes smem", body)
            if m and regs and spill:
                dtype = "f32" if m.group(2) == "f" else "bf16"
                nbytes = (smem_bwd[m.group(1)](dtype, int(m.group(3)))
                          if m.group(1) in smem_bwd
                          else [int(smem.group(1)) if smem else 0])
                out[f"{m.group(1)}<{dtype},{m.group(3)}>"] = [
                    int(regs.group(1)), int(spill.group(1)),
                    int(spill.group(2)), *nbytes]
    return out


SPLIT_COUNTS = ("simt_launches", "decode_launches", "prefill_launches",
                "save_launches", "bwd_launches")


def max_sm_clock_mhz():
    """The card's maximum SM clock (nvidia-smi), in MHz."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])


def reset_launches(kernels):
    for fn in kernels.values():
        fn.launches = 0
        for key in SPLIT_COUNTS:
            if hasattr(fn, key):
                setattr(fn, key, 0)


def read_by_length(kernels):
    """The scans' launches since reset_launches, split by sequence length:
    {name: {"T=1": decode launches, "T>1": prefill launches}}."""
    return {name: {"T=1": fn.decode_launches, "T>1": fn.prefill_launches}
            for name, fn in kernels.items() if hasattr(fn, "decode_launches")}


def read_launches(kernels, backward=False):
    """Launches of each kernel since reset_launches (with ``backward``, the
    scans' backward kernels too, as "<name>_bwd", and their save kernels,
    the forward under autograd, as "<name>_save"). Every phase that reads
    them runs in bf16, so none may have gone to an f32 SIMT flash or loss
    kernel: those wrappers' launches are then all tensor-core launches."""
    simt = {name: fn.simt_launches for name, fn in kernels.items()
            if getattr(fn, "simt_launches", 0)}
    if simt:
        fail(f"an f32 SIMT kernel ran on a bf16 path: {simt}")
    out = {name: fn.launches for name, fn in kernels.items()}
    if backward:
        for name, fn in kernels.items():
            if hasattr(fn, "bwd_launches"):
                out[f"{name}_bwd"] = fn.bwd_launches
                out[f"{name}_save"] = fn.save_launches
    return out


def main() -> int:
    # the compiled flex_attention of the library timings (never the port's)
    # caches its generated kernels in the checkout's build directory
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / "build" / sub))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from the root of a repository checkout "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.common import tree
    from repro_torch.common.config import RolloutConfig, TrainConfig
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import copris
    from repro_torch.core.rollout import RolloutEngine
    from repro_torch.hopper import build, decode_attn, flash_attn, fused_sample
    from repro_torch.hopper import fused_is_grpo as fio
    from repro_torch.hopper import fused_logprob as flp
    from repro_torch.hopper import paged_decode_attn, rwkv6_scan, ssm_scan
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import model
    from repro_torch.optim import adam
    from repro_torch.sampling import prng

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    sm_mhz = max_sm_clock_mhz()
    emit("device", nvidia_smi=smi, kind=kind,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, max_sm_clock_mhz=sm_mhz)

    # 2. build; the flash libraries' bf16 kernels and the loss library's
    # bf16 bwd_dh kernels issue wgmma (HGMMA). Beside it, on the cores the
    # build leaves idle, gemma2-2b's compiled flex_attention library calls
    # (warm_flex: their generated kernels cached under build/)
    warm = Background([str(ROOT / "chip_smoke.py"), "--warm-flex"],
                      WARM_FLEX_TIMEOUT_S)
    t0 = time.perf_counter()
    secs = build.build_all()
    hgmma = {name: sum("HGMMA" in x for x in build.sass(name).splitlines())
             for name in ("flash_attn", "flash_attn_bwd", "fused_is_grpo")}
    emit("build", seconds=time.perf_counter() - t0, per_source=secs,
         hgmma_instructions=hgmma,
         tensor_core_registers=tc_registers(build, hgmma),
         scan_registers=scan_registers(build))
    if not all(hgmma.values()):
        fail(f"a tensor-core library has no HGMMA (wgmma) instruction: "
             f"{hgmma}")
    pal205_phase()
    # the flex_attention library calls compiled beside the build: done
    # before any kernel is timed
    warm_flex_phase(warm)

    # 3. kernel checks at the main path's shapes
    timer = Timer(torch)
    checks = {"flash_attn": check_flash_prefill(
                  torch, F, timer, flash_attn, 32, 8, 64,
                  phase="check_flash_attn"),
              "decode_attn": check_decode(torch, F, timer, decode_attn),
              # the length split of sharded serving at llama's shape (REP
              # 4 x 64) and granite-34b's (MQA: REP 48 x 128)
              "decode_split": {
                  "llama3.2-1b": check_decode_split(
                      torch, timer, decode_attn, 32, 8, 64, "llama"),
                  "granite-34b": check_decode_split(
                      torch, timer, decode_attn, 48, 1, 128, "granite")},
              "fused_sample": check_sample(torch, timer, fused_sample, prng),
              "fused_sample_train": check_sample_train(
                  torch, timer, fused_sample, prng, build, sm_mhz),
              "paged_decode_attn": check_paged_decode(
                  torch, timer, paged_decode_attn, decode_attn),
              "flash_attn_lse": check_flash_lse(torch, F, timer, flash_attn),
              "flash_attn_bwd": check_flash_bwd(torch, F, timer, flash_attn),
              **check_fused_is_grpo(torch, timer, fio),
              "fused_logprob": check_fused_logprob(torch, timer, flp),
              # the hybrid serve phases' shapes: hymba's heads (25/5) and
              # window, both vocabs
              "flash_attn_rep5": check_flash_prefill(
                  torch, F, timer, flash_attn, 25, 5, 64, win=1024,
                  phase="check_flash_attn_rep5"),
              **dict(zip(("decode_attn_rep5", "paged_decode_attn_rep5"),
                         check_decode_wide(
                             torch, F, timer, decode_attn, paged_decode_attn,
                             25, 5, 64, win=1024, tag="rep5"))),
              **{f"fused_sample_{V}": check_sample(
                  torch, timer, fused_sample, prng, V=V,
                  phase=f"check_fused_sample_{V}") for V in (32001, 65536)}}
    scans = {"ssm_scan": check_ssm_scan(torch, timer, ssm_scan, sm_mhz),
             "wkv6": check_wkv6(torch, timer, rwkv6_scan)}
    checks.update({name: r["decode"] for name, r in scans.items()})
    # the scans' backward kernels at the hybrid updates' shape
    checks["ssm_scan_bwd"] = check_ssm_scan_bwd(torch, timer, ssm_scan,
                                                sm_mhz)
    checks["wkv6_bwd"] = check_wkv6_bwd(torch, timer, rwkv6_scan, sm_mhz)
    # the hybrid updates' shapes of the attention and loss kernels: hymba's
    # 25/5 heads with its window of 1024; the loss at hymba's d 1600 against
    # the tied V 32001 and at rwkv6's d 2048 against the untied (2048, 65536)
    hybrid_checks = {
        "hymba-1.5b": {
            "flash_attn": check_flash_lse(
                torch, F, timer, flash_attn, H=25, KV=5, win=1024,
                phase="check_flash_attn_lse_hymba"),
            "flash_attn_bwd": check_flash_bwd(
                torch, F, timer, flash_attn, H=25, KV=5, win=1024,
                phase="check_flash_attn_bwd_hymba"),
            **check_fused_is_grpo(torch, timer, fio, d=1600, V=32001,
                                  tied=True, suffix="_hymba")},
        "rwkv6-1.6b": check_fused_is_grpo(torch, timer, fio, d=2048, V=65536,
                                          tied=False, suffix="_rwkv6")}
    torch.cuda.empty_cache()
    # the wide heads' shapes (head_dim 128 and 256) and the other archs the
    # serve and train phases below run: paper-qwen-7b's train and prefill
    # shapes (28/4 heads of 128: REP 7), gemma2-2b's (8/4 of 256, softcap
    # 50, its local window of 4096), qwen3-14b's prefill (40/8 of 128: REP
    # 5), granite-34b's (48/1 of 128: MQA), musicgen-medium's train and
    # prefill shapes (24/24 of 64: REP 1); dense and paged decode at each
    # arch's ratio; sampling at V 152064 and 256000; the loss at
    # paper-qwen-7b's d 3584 / untied V 152064 and gemma2-2b's d 2304 /
    # tied V 256000 with its logit softcap of 30
    wide_checks = {}
    for arch, tag, H, KV, hd, win, cap, trained in (
            ("paper-qwen-7b", "qwen7b", 28, 4, 128, 0, 0.0, True),
            ("gemma2-2b", "gemma2", 8, 4, 256, 4096, 50.0, True),
            ("qwen3-14b", "qwen3_14b", 40, 8, 128, 0, 0.0, False),
            ("granite-34b", "granite", 48, 1, 128, 0, 0.0, False),
            ("musicgen-medium", "musicgen", 24, 24, 64, 0, 0.0, True)):
        c = {}
        if trained:
            c["flash_attn"] = check_flash_lse(
                torch, F, timer, flash_attn, H=H, KV=KV, win=win, hd=hd,
                cap=cap, phase=f"check_flash_attn_lse_{tag}")
            c["flash_attn_bwd"] = check_flash_bwd(
                torch, F, timer, flash_attn, H=H, KV=KV, win=win, hd=hd,
                cap=cap, phase=f"check_flash_attn_bwd_{tag}")
        c["flash_attn_prefill"] = check_flash_prefill(
            torch, F, timer, flash_attn, H, KV, hd, win=win, cap=cap,
            phase=f"check_flash_attn_prefill_{tag}")
        c["decode_attn"], c["paged_decode_attn"] = check_decode_wide(
            torch, F, timer, decode_attn, paged_decode_attn, H, KV, hd,
            win=win, cap=cap, tag=tag)
        wide_checks[arch] = c
        torch.cuda.empty_cache()
    wide_checks["paper-qwen-7b"]["fused_sample"] = check_sample(
        torch, timer, fused_sample, prng, V=152064,
        phase="check_fused_sample_152064")
    wide_checks["gemma2-2b"]["fused_sample"] = check_sample(
        torch, timer, fused_sample, prng, V=256000,
        phase="check_fused_sample_256000")
    wide_checks["paper-qwen-7b"].update(check_fused_is_grpo(
        torch, timer, fio, d=3584, V=152064, tied=False, suffix="_qwen7b"))
    torch.cuda.empty_cache()
    wide_checks["gemma2-2b"].update(check_fused_is_grpo(
        torch, timer, fio, d=2304, V=256000, tied=True, cap=30.0,
        suffix="_gemma2"))
    torch.cuda.empty_cache()
    # the MoE and VLM archs' shapes, all heads of 128: deepseek-moe-16b's
    # update and prefill (16/16: REP 1), qwen3-moe-235b-a22b's prefill
    # (64/4: REP 16) and llama-3.2-vision-90b's (64/8: REP 8), dense and
    # paged decode at each ratio; sampling at V 102400 and 151936; the loss
    # at deepseek-moe-16b's d 2048 / untied V 102400; and the vision
    # model's cross-attention, non-causal against 1601 media tokens
    moe_checks = {}
    for arch, tag, H, KV, trained in (
            ("deepseek-moe-16b", "deepseek", 16, 16, True),
            ("qwen3-moe-235b-a22b", "qwen3_moe", 64, 4, False),
            ("llama-3.2-vision-90b", "vision", 64, 8, False)):
        c = {}
        if trained:
            c["flash_attn"] = check_flash_lse(
                torch, F, timer, flash_attn, H=H, KV=KV, hd=128,
                phase=f"check_flash_attn_lse_{tag}")
            c["flash_attn_bwd"] = check_flash_bwd(
                torch, F, timer, flash_attn, H=H, KV=KV, hd=128,
                phase=f"check_flash_attn_bwd_{tag}")
        c["flash_attn_prefill"] = check_flash_prefill(
            torch, F, timer, flash_attn, H, KV, 128,
            phase=f"check_flash_attn_prefill_{tag}")
        c["decode_attn"], c["paged_decode_attn"] = check_decode_wide(
            torch, F, timer, decode_attn, paged_decode_attn, H, KV, 128,
            tag=tag)
        moe_checks[arch] = c
        torch.cuda.empty_cache()
    moe_checks["deepseek-moe-16b"]["fused_sample"] = check_sample(
        torch, timer, fused_sample, prng, V=102400,
        phase="check_fused_sample_102400")
    moe_checks["qwen3-moe-235b-a22b"]["fused_sample"] = check_sample(
        torch, timer, fused_sample, prng, V=151936,
        phase="check_fused_sample_151936")
    moe_checks["deepseek-moe-16b"].update(check_fused_is_grpo(
        torch, timer, fio, d=2048, V=102400, tied=False, suffix="_deepseek"))
    vlm_checks = {"llama-3.2-vision-90b": {
        **moe_checks.pop("llama-3.2-vision-90b"),
        **check_flash_cross(torch, F, timer, flash_attn)}}
    torch.cuda.empty_cache()
    kernels = {"flash_attn": flash_attn.flash_attention,
               "decode_attn": decode_attn.decode_attention,
               "fused_sample": fused_sample.sample_rows}
    train_kernels = {
        **kernels, "flash_attn_bwd": flash_attn.flash_attention_bwd,
        "fused_is_grpo_fwd": fio.fused_is_grpo_fwd_rows,
        "fused_is_grpo_bwd_dh": fio.fused_is_grpo_bwd_dh_rows,
        "fused_is_grpo_bwd_dw": fio.fused_is_grpo_bwd_dw_rows}
    serve_paged_kernels = {
        "flash_attn": flash_attn.flash_attention,
        "paged_decode_attn": paged_decode_attn.paged_decode_attention,
        "fused_sample": fused_sample.sample_rows}
    train_paged_kernels = {
        **serve_paged_kernels,
        "flash_attn_bwd": flash_attn.flash_attention_bwd,
        "fused_logprob": flp.fused_logprob_rows,
        "fused_is_grpo_bwd_dh": fio.fused_is_grpo_bwd_dh_rows,
        "fused_is_grpo_bwd_dw": fio.fused_is_grpo_bwd_dw_rows}
    hymba_kernels = {**kernels, "ssm_scan": ssm_scan.selective_scan}
    hymba_paged_kernels = {**serve_paged_kernels,
                           "ssm_scan": ssm_scan.selective_scan}
    rwkv_kernels = {"fused_sample": fused_sample.sample_rows,
                    "wkv6": rwkv6_scan.wkv6}
    loss_kernels = {"fused_is_grpo_fwd": fio.fused_is_grpo_fwd_rows,
                    "fused_is_grpo_bwd_dh": fio.fused_is_grpo_bwd_dh_rows,
                    "fused_is_grpo_bwd_dw": fio.fused_is_grpo_bwd_dw_rows}
    hymba_train_kernels = {
        **hymba_kernels, **loss_kernels,
        "flash_attn_bwd": flash_attn.flash_attention_bwd}
    rwkv_train_kernels = {**rwkv_kernels, **loss_kernels}

    # the sharded launcher under torchrun and the dry run's two CPU
    # subprocesses, beside the reference phases, which time nothing: all
    # three are done before the serve phases time anything
    multihost = Background(MULTIHOST, 600)
    dry = dryrun_start()

    # 4. GPU engine vs CPU engine on the reduced config, serving and training
    reference_phase(torch, np, serve_mod, model,
                    get_smoke_config("llama3.2-1b"))
    # hymba reduced to 5 heads of 64 (the attention kernels' head sizes)
    # over 1 KV head, window 64; rwkv6 reduced to 16 heads of 32
    for cfg_r in (dataclasses.replace(get_smoke_config("hymba-1.5b"),
                                      d_model=320, head_dim=64),
                  get_smoke_config("rwkv6-1.6b")):
        reference_phase(torch, np, serve_mod, model, cfg_r,
                        phase="reference_hybrid")
    train_reference_phase(
        torch, np, copris, model, tree, adam,
        dataclasses.replace(get_smoke_config("llama3.2-1b"),
                            vocab_size=8192, dtype="float32"))
    # the hybrid families' updates, scans forward and backward: hymba
    # reduced as above, rwkv6's reduced config
    for cfg_r in (dataclasses.replace(get_smoke_config("hymba-1.5b"),
                                      d_model=320, head_dim=64),
                  get_smoke_config("rwkv6-1.6b")):
        train_reference_case(
            torch, np, copris, model, tree, adam,
            dataclasses.replace(cfg_r, vocab_size=8192, dtype="float32"),
            TrainConfig(lr=1e-3, entropy_coef=0.01, remat=True),
            "train_reference_hybrid")
    # the wide heads on the card against the CPU, float32, 2 layers:
    # paper-qwen-7b's 7/1 heads of 128 and gemma2-2b's local/global pair
    # with 2/1 heads of 256, both softcaps and a window of 32 (below the
    # engine's prompts and the train batch's 64 positions)
    for cfg_r in (dataclasses.replace(get_smoke_config("paper-qwen-7b"),
                                      num_heads=7, num_kv_heads=1,
                                      head_dim=128),
                  dataclasses.replace(get_smoke_config("gemma2-2b"),
                                      num_heads=2, num_kv_heads=1,
                                      head_dim=256, sliding_window=32)):
        reference_phase(torch, np, serve_mod, model, cfg_r,
                        phase="reference_wide")
        train_reference_case(
            torch, np, copris, model, tree, adam,
            dataclasses.replace(cfg_r, vocab_size=8192, dtype="float32"),
            TrainConfig(lr=1e-3, entropy_coef=0.01, remat=True),
            "train_reference_wide")
    # the overlapped trainer against a CPU replay of its schedule, and the
    # multi-turn engines on the card against the CPU's
    reference_overlap_phase(
        torch, np, dataclasses.replace(get_smoke_config("llama3.2-1b"),
                                       vocab_size=8192, dtype="float32"))
    reference_multiturn_phase(
        torch, np, dataclasses.replace(get_smoke_config("llama3.2-1b"),
                                       dtype="float32"))
    # the MoE and VLM block kinds on the card against the CPU, float32:
    # deepseek-moe-16b reduced (a dense layer, then a MoE layer of 4
    # experts top-2 and a shared one; 8/8 heads of 64) and
    # qwen3-moe-235b-a22b reduced (4 experts top-2, qk_norm, 16/1 heads of
    # 32), with their published capacity-bounded dispatch at its default
    # factor (the reduced configs' own is the dense one); then
    # llama-3.2-vision-90b reduced to one period of its pattern (4 attn,
    # 1 xattn; 8/1 heads of 64; 16 media tokens), media in the engine's
    # prefills and in mb["media"]
    for arch in ("deepseek-moe-16b", "qwen3-moe-235b-a22b"):
        cfg_r = get_smoke_config(arch)
        cfg_r = dataclasses.replace(cfg_r, moe=dataclasses.replace(
            cfg_r.moe, dispatch="sparse"))
        reference_phase(torch, np, serve_mod, model, cfg_r,
                        phase="reference_moe")
        train_reference_case(
            torch, np, copris, model, tree, adam,
            dataclasses.replace(cfg_r, vocab_size=8192),
            TrainConfig(lr=1e-3, entropy_coef=0.01, remat=True),
            "train_reference_moe")
    cfg_v = get_config("llama-3.2-vision-90b").reduced(num_layers=5)
    reference_phase(torch, np, serve_mod, model, cfg_v,
                    phase="reference_vlm")
    train_reference_case(
        torch, np, copris, model, tree, adam,
        dataclasses.replace(cfg_v, vocab_size=8192),
        TrainConfig(lr=1e-3, entropy_coef=0.01, remat=True),
        "train_reference_vlm")

    multihost_phase(np, multihost)
    for bg in dry.values():             # their results are read later
        bg.finish()

    # 5. serve at full width (the main path)
    serve, cfg = serve_mod.make_serve_engine(
        "llama3.2-1b", max_prompt_len=512, max_tokens=128, concurrency=16,
        temperature=0.8, top_k=50, top_p=0.95, seed=0)
    if (cfg.num_layers, cfg.d_model, cfg.vocab_size) != (16, 2048, 128256):
        fail(f"not the full llama3.2-1b width: {cfg}")
    prompts = serve_prompts(np, cfg)
    for p in prompts:
        serve.submit(serve_mod.GenerateRequest(prompt=p))
    torch.cuda.synchronize()
    reset_launches(kernels)
    t0 = time.perf_counter()
    results = serve.drain()
    serve.eng.block_until_ready()
    wall = time.perf_counter() - t0
    serve_launches = read_launches(kernels)
    stats = serve.close()
    ntok = check_results(np, results, cfg, len(prompts))
    dense_serve = dict(requests=len(prompts), tokens_per_s=ntok / wall)
    emit("serve", arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
         vocab=cfg.vocab_size, requests=len(results), tokens=ntok,
         seconds=wall, tokens_per_s=ntok / wall,
         decode_chunks=stats["decode_chunks"],
         prefill_calls=stats["prefill_calls"],
         utilization=stats["utilization"], launches=serve_launches,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if not all(n > 0 for n in serve_launches.values()):
        fail(f"a kernel of the serving path never launched: {serve_launches}")

    dense_serve["profile"] = profile_phase(torch, np, serve, cfg,
                                           sync_free=True)
    serve_paged_phase(torch, np, serve_mod, serve_paged_kernels, dense_serve)
    # the same requests at 4 layers, unsharded and on a (1, 1) mesh:
    # bit-equal
    new_serve_launches = {"serve_sharded": serve_sharded_phase(
        torch, np, serve_mod, kernels)}

    # 6. CoPRIS collect: early termination buffers partials, then resumes
    params = serve.params
    del serve
    ro = RolloutConfig(batch_size=4, group_size=4, max_prompt_len=448,
                       max_response_len=256, concurrency=16, mode="copris",
                       temperature=0.8, top_k=50, top_p=0.95)
    prng_np = np.random.default_rng(1)

    def source():
        n = int(prng_np.integers(64, 449))
        return prng_np.integers(0, cfg.vocab_size - 1, n), None

    # max_len 512 < prompt + response budget: a group's stop length depends
    # on its prompt length, so groups finish at different times
    eng = RolloutEngine(cfg, ro, source, eos_id=cfg.vocab_size - 1,
                        max_len=512)
    stages = []
    for stage in range(2):
        reset_launches(kernels)
        groups, st = eng.collect(params, stage, prng.PRNGKey(100 + stage))
        stages.append(dict(stage=stage, groups=len(groups),
                           generated=st["generated"], evicted=st["evicted"],
                           resumed=st["resumed"],
                           buffered_partials=eng.buffer.num_unfinished,
                           multi_stage_trajs=st["multi_stage_trajs"],
                           wall_time=st["wall_time"],
                           launches=read_launches(kernels)))
        for g in groups:
            for t in g.trajectories:
                t.check_invariants()
                if not all(np.isfinite(lp) and lp <= 0.0
                           for lp in t.behaviour_logps):
                    fail("copris: logp not finite or > 0")
    emit("copris", stages=stages)
    if stages[0]["evicted"] == 0 or stages[0]["buffered_partials"] == 0:
        fail("copris stage 0 buffered no partials")
    if stages[1]["resumed"] == 0:
        fail("copris stage 1 resumed nothing")

    del params, eng

    # 6b. the hybrid families served at full width, then two CoPRIS stages
    # (the paged hymba at 8 of its 32 layers, the dense one at 16: with
    # its profile the paged one took 55 s at full depth, the run's longest
    # serve phase; the MoE and VLM phases took the run from ~600 to 687 s
    # on an H100 80GB HBM3 at 700 W, then the sharded and disaggregated
    # phases added ~90 s, so the paged hymba went from 16 to 8 layers, the
    # dense one from 32 to 16 and the paged paper-qwen-7b and deepseek
    # from 14 to 7; no kernel's shape depends on the depth. The sharded
    # serving phases added ~66 s and the decode library's build ~20 s, to
    # 933 s on an H100 80GB HBM3 at 700 W, over PR 25's 826: so rwkv6 is
    # served, and both hybrids are trained and run two CoPRIS stages, at
    # half depth, and paper-qwen-7b, gemma2-2b and deepseek-moe-16b are
    # served, and run their CoPRIS stages, at half depth too, gemma2-2b
    # trained at 14 of 26)
    # PR 30's sharded and two-sided phases took the run to 853-905 s on an
    # H100 80GB HBM3 at 700 W (its aim ~600 s): its phase stamps put ~270 s
    # in the serve, CoPRIS and train phases of the hybrid, wide-head and
    # MoE archs and ~84 s in the two mesh phases, so every depth below
    # (and copris_sharded's, train_disaggregated_mesh's) was halved again
    time_cut = "the run's time (no kernel's shape depends on the depth)"
    hymba_launches, hymba_by_length = serve_arch_phase(
        torch, np, serve_mod, "hymba-1.5b", hymba_kernels, "serve_hymba",
        num_layers=8, cut=time_cut)
    # 40% of the dense-equivalent 16 x 640 / 16 = 640 pages
    serve_arch_phase(torch, np, serve_mod, "hymba-1.5b",
                     hymba_paged_kernels, "serve_hymba_paged",
                     kv_backend="paged", kv_num_pages=256, num_layers=4,
                     cut=time_cut)
    rwkv_launches, rwkv_by_length = serve_arch_phase(
        torch, np, serve_mod, "rwkv6-1.6b", rwkv_kernels, "serve_rwkv6",
        num_layers=6, cut=time_cut)
    copris_arch_phase(torch, np, model, (
        ("hymba-1.5b", "kv_snapshot", hymba_kernels, "copris_hybrid", 8),
        ("rwkv6-1.6b", "reprefill", rwkv_kernels, "copris_hybrid", 6)),
        cut=time_cut)

    # a serve engine and its RolloutEngine form a reference cycle (the
    # engine's prompt source is a bound method of the serve engine): collect
    # them, so the train phases' peak memory counts their own tensors only
    gc.collect()
    torch.cuda.empty_cache()

    # 7. train at full width, over the dense cache with the fused loss, then
    # overlapped and multi-turn, then over the paged cache with the legacy
    # loss
    sft = {}
    train_launches = train_phase(torch, np, train_kernels, keep=sft)
    # the f32 SIMT kernels' launches in the train phase (0: bf16)
    train_simt = {name: fn.simt_launches
                  for name, fn in train_kernels.items()
                  if hasattr(fn, "simt_launches")}
    # the overlapped pipeline and multi-turn environments, from the train
    # phase's SFT-warmed weights
    new_launches = {
        "train_overlap": train_overlap_phase(torch, np, train_kernels, sft),
        "train_multiturn": train_multiturn_phase(torch, np, train_kernels,
                                                 sft)}
    # the disaggregated trainer from the same weights, in one process,
    # then on two meshes of their own in two processes
    new_launches["train_disaggregated"] = train_disaggregated_phase(
        torch, np, train_kernels, sft)
    new_launches["train_disaggregated_mesh"] = \
        train_disaggregated_mesh_phase(torch, np, sft)
    del sft
    train_paged_launches = train_paged_phase(torch, np, train_paged_kernels)
    train_simt["fused_logprob"] = flp.fused_logprob_rows.simt_launches

    # 7b. the hybrid families trained at full width, half depth: the scans'
    # forward and backward kernels
    hymba_train = train_phase(torch, np, hymba_train_kernels,
                              arch="hymba-1.5b", phase="train_hymba",
                              steps=2, seed=2, entropy_coef=0.01,
                              num_layers=16, cut=time_cut)
    rwkv_train = train_phase(torch, np, rwkv_train_kernels,
                             arch="rwkv6-1.6b", phase="train_rwkv6",
                             steps=2, seed=2, entropy_coef=0.01,
                             num_layers=12, cut=time_cut)

    # 7c. the wide-head archs through the same entry points: paper-qwen-7b
    # (the paper's model: 28/4 heads of 128) served at 7 of its 28
    # layers over the dense cache and at 4 over the paged one, two CoPRIS
    # stages at 7, trained at 4 of its 28 layers; gemma2-2b (8/4 of 256,
    # softcaps, local window) served over the dense cache and trained at 6
    # of its 26 layers (its paged decode is held
    # to the dense kernel bit for bit in the kernel checks); qwen3-14b
    # (40/8 of 128, qk_norm) served at 10 of its 40 layers; granite-34b
    # (48/1 of 128) at 12 of its 88; musicgen-medium (24/24 of 64, V 2048:
    # the full-logits loss) served and trained at 12 of its 48
    musicgen_train_kernels = {
        **kernels, "flash_attn_bwd": flash_attn.flash_attention_bwd}
    # the paged paper-qwen-7b, qwen3-14b and musicgen-medium at half depth:
    # the whole run took 647 s with the last two at full depth and 633 s
    # with them at half depth and the paged paper-qwen-7b at full depth,
    # over the ~600 s it aims at; no kernel's shape depends on the depth
    wide = {}
    wide["serve_qwen7b"] = serve_arch_phase(
        torch, np, serve_mod, "paper-qwen-7b", kernels, "serve_qwen7b",
        num_layers=7, cut=time_cut)[0]
    wide["serve_qwen7b_paged"] = serve_arch_phase(
        torch, np, serve_mod, "paper-qwen-7b", serve_paged_kernels,
        "serve_qwen7b_paged", kv_backend="paged", kv_num_pages=256,
        num_layers=4, cut=time_cut)[0]
    copris_arch_phase(torch, np, model, (
        ("paper-qwen-7b", "reprefill", kernels, "copris_qwen7b", 7),),
        cut=time_cut)
    wide["train_qwen7b"] = train_phase(
        torch, np, train_kernels, arch="paper-qwen-7b", phase="train_qwen7b",
        steps=2, seed=2, entropy_coef=0.01, num_layers=4,
        cut="the full depth's training state (~122 GB) does not fit the card")
    wide["serve_gemma2"] = serve_arch_phase(
        torch, np, serve_mod, "gemma2-2b", kernels, "serve_gemma2",
        num_layers=6, cut=time_cut)[0]
    wide["train_gemma2"] = train_phase(
        torch, np, train_kernels, arch="gemma2-2b", phase="train_gemma2",
        steps=2, seed=2, entropy_coef=0.01, num_layers=6, cut=time_cut)
    wide["serve_qwen3_14b"] = serve_arch_phase(
        torch, np, serve_mod, "qwen3-14b", kernels, "serve_qwen3_14b",
        num_layers=10, cut=time_cut)[0]
    wide["serve_granite"] = serve_arch_phase(
        torch, np, serve_mod, "granite-34b", kernels, "serve_granite",
        num_layers=12,
        cut="the full depth's bf16 weights (93.9 GB) do not fit the card")[0]
    wide["serve_musicgen"] = serve_arch_phase(
        torch, np, serve_mod, "musicgen-medium", kernels, "serve_musicgen",
        num_layers=12, cut=time_cut)[0]
    # one step: a rollout of 48 layers at 124 tokens took ~22 s
    wide["train_musicgen"] = train_phase(
        torch, np, musicgen_train_kernels, arch="musicgen-medium",
        phase="train_musicgen", steps=1, seed=2, entropy_coef=0.01,
        num_layers=12, cut=time_cut)
    new_launches.update(wide)

    # 7d. the MoE and VLM archs through the same entry points, each freed
    # before the next: deepseek-moe-16b served at 7 of its 28 layers over
    # the dense cache and at 4 over the paged one, two CoPRIS stages at 7,
    # trained at 1 + 2 of its layers (the dense first
    # layer and two MoE layers, full width); qwen3-moe-235b-a22b served at
    # 8 of its 94 layers; llama-3.2-vision-90b served at 10 of its 100
    # layers (two periods: two xattn layers) with its media, and its loss
    # gradient with mb["media"] at 5
    moe_vlm = {}
    moe_vlm["serve_deepseek"] = serve_arch_phase(
        torch, np, serve_mod, "deepseek-moe-16b", kernels,
        "serve_deepseek", num_layers=7, cut=time_cut)[0]
    moe_vlm["serve_deepseek_paged"] = serve_arch_phase(
        torch, np, serve_mod, "deepseek-moe-16b", serve_paged_kernels,
        "serve_deepseek_paged", kv_backend="paged", kv_num_pages=256,
        num_layers=4, cut=time_cut)[0]
    copris_arch_phase(torch, np, model, (
        ("deepseek-moe-16b", "reprefill", kernels, "copris_deepseek", 7),),
        cut=time_cut)
    moe_vlm["train_deepseek"] = train_phase(
        torch, np, train_kernels, arch="deepseek-moe-16b",
        phase="train_deepseek", steps=2, seed=2, entropy_coef=0.01,
        num_layers=3, cut="the full depth's training state (16.4 B "
        "parameters at ~16 bytes each, ~262 GB) does not fit the card")
    # the sharded update on a (1, 1) NCCL mesh against the unsharded one,
    # then the expert-parallel dispatch; each destroys its process group
    sharded_peak = {}
    new_launches["train_sharded"] = train_sharded_phase(
        torch, np, train_kernels, keep=sharded_peak)
    # the dry run (its CPU subprocesses ran beside the reference phases):
    # 256 fake ranks, and train_sharded's update counted
    dryrun_phase(torch, new_launches["train_sharded"],
                 sharded_peak["peak_gb"], started=dry)
    # the CoPRIS trainer on one (1, 1) mesh against the unsharded one
    new_launches["copris_sharded"] = copris_sharded_phase(torch, np,
                                                          train_kernels)
    new_launches.update(new_serve_launches)
    new_launches["train_moe_ep"] = train_moe_ep_phase(torch, np, {
        "flash_attn": flash_attn.flash_attention,
        "flash_attn_bwd": flash_attn.flash_attention_bwd, **loss_kernels})
    moe_vlm["serve_qwen3_moe"] = serve_arch_phase(
        torch, np, serve_mod, "qwen3-moe-235b-a22b", kernels,
        "serve_qwen3_moe", num_layers=8,
        cut="the full depth's bf16 weights (~470 GB, 4.97 GB a layer) do "
        "not fit the card")[0]
    moe_vlm["serve_vision"] = serve_arch_phase(
        torch, np, serve_mod, "llama-3.2-vision-90b", kernels,
        "serve_vision", num_layers=10,
        cut="the full depth's bf16 weights (~178 GB, 1.71 GB a layer) do "
        "not fit the card")[0]
    moe_vlm["grad_vision"] = grad_vision_phase(torch, np, {
        "flash_attn": flash_attn.flash_attention,
        "flash_attn_bwd": flash_attn.flash_attention_bwd, **loss_kernels})
    # sharded serving of every block kind, shard_seq and the GQA serve mesh
    new_launches.update(serve_sharded_kinds_phase(torch, np, serve_mod, {
        **kernels, "ssm_scan": ssm_scan.selective_scan,
        "wkv6": rwkv6_scan.wkv6}))

    # 8. kernels line: launches from the train phase, from train_paged for
    # the paged decode and the fused log-prob, from serve_hymba and
    # serve_rwkv6 for the two scans, from train_hymba and train_rwkv6 for
    # their backward and save kernels; times from the checks at the train
    # phase's shapes (flash forward with lse, its backward, the loss
    # kernels, the scans' backward and save kernels) and at the serve
    # phases' (decode, paged
    # decode, sampling, and the scans' decode shape); the flash and loss
    # rows carry the hybrid updates' shapes under "train_hybrid"
    src = {"flash_attn": ("src/repro_torch/csrc/flash_attn.cu",
                          "src/repro/kernels/flash_attn/flash_attn.py:103",
                          "flash_attn_lse"),
           "flash_attn_bwd": ("src/repro_torch/csrc/flash_attn_bwd.cu",
                              "src/repro/models/attention.py:149",
                              "flash_attn_bwd"),
           "decode_attn": ("src/repro_torch/csrc/decode_attn.cu",
                           "src/repro/kernels/decode_attn/decode_attn.py:100",
                           "decode_attn"),
           "paged_decode_attn": (
               "src/repro_torch/csrc/paged_decode_attn.cu",
               "src/repro/kernels/paged_decode_attn/paged_decode_attn.py:136",
               "paged_decode_attn"),
           "fused_sample": ("src/repro_torch/csrc/fused_sample.cu",
                            "src/repro/kernels/fused_sample/fused_sample.py"
                            ":265", "fused_sample_train"),
           "fused_is_grpo_fwd": (
               "src/repro_torch/csrc/fused_is_grpo.cu",
               "src/repro/kernels/fused_is_grpo/fused_is_grpo.py:192",
               "fused_is_grpo_fwd"),
           "fused_is_grpo_bwd_dh": (
               "src/repro_torch/csrc/fused_is_grpo.cu",
               "src/repro/kernels/fused_is_grpo/fused_is_grpo.py:228",
               "fused_is_grpo_bwd_dh"),
           "fused_is_grpo_bwd_dw": (
               "src/repro_torch/csrc/fused_is_grpo.cu",
               "src/repro/kernels/fused_is_grpo/fused_is_grpo.py:249",
               "fused_is_grpo_bwd_dw"),
           "fused_logprob": (
               "src/repro_torch/csrc/fused_is_grpo.cu",
               "src/repro/kernels/fused_logprob/fused_logprob.py:73",
               "fused_logprob"),
           "ssm_scan": ("src/repro_torch/csrc/ssm_scan.cu",
                        "src/repro/kernels/ssm_scan/ssm_scan.py:72",
                        "ssm_scan"),
           "wkv6": ("src/repro_torch/csrc/wkv6.cu",
                    "src/repro/kernels/rwkv6_scan/rwkv6_scan.py:68", "wkv6"),
           # the Pallas scans are forward only: JAX differentiates the
           # lax.scan references
           "ssm_scan_bwd": ("src/repro_torch/csrc/ssm_scan.cu",
                            "src/repro/models/ssm.py:73", "ssm_scan_bwd"),
           "wkv6_bwd": ("src/repro_torch/csrc/wkv6.cu",
                        "src/repro/models/rwkv6.py:64", "wkv6_bwd"),
           # the forward under autograd: the prefill kernels storing the
           # backward's boundary states
           "ssm_scan_save": ("src/repro_torch/csrc/ssm_scan.cu",
                             "src/repro/kernels/ssm_scan/ssm_scan.py:72",
                             "ssm_scan_save"),
           "wkv6_save": ("src/repro_torch/csrc/wkv6.cu",
                         "src/repro/kernels/rwkv6_scan/rwkv6_scan.py:68",
                         "wkv6_save")}
    checks["ssm_scan_save"] = checks["ssm_scan_bwd"]["save_kernel"]
    checks["wkv6_save"] = checks["wkv6_bwd"]["save_kernel"]
    launches = {**train_launches,
                "paged_decode_attn": train_paged_launches["paged_decode_attn"],
                "fused_logprob": train_paged_launches["fused_logprob"],
                "ssm_scan": hymba_launches["ssm_scan"],
                "wkv6": rwkv_launches["wkv6"],
                "ssm_scan_bwd": hymba_train["ssm_scan_bwd"],
                "wkv6_bwd": rwkv_train["wkv6_bwd"],
                "ssm_scan_save": hymba_train["ssm_scan_save"],
                "wkv6_save": rwkv_train["wkv6_save"]}
    train_of = {"hymba-1.5b": hymba_train, "rwkv6-1.6b": rwkv_train}
    by_length = {"ssm_scan": hymba_by_length["ssm_scan"],
                 "wkv6": rwkv_by_length["wkv6"]}
    rows = []
    for name, (source_path, replaces, check) in src.items():
        c = checks[check]
        row = {"name": name, "route": "cuda", "source": source_path,
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": c["max_abs_err"], "ms": c["ms"],
               "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
               "bound_by": c["bound_by"], "library_ms": c["library_ms"]}
        if name in train_simt:
            # launches: the bf16 tensor-core kernels; the f32 SIMT apart
            row["simt_launches"] = train_simt[name]
        by_phase = {phase: n[name] for phase, n in new_launches.items()
                    if name in n}
        if by_phase:
            # the launches of the overlapped and multi-turn phases, counted
            # as train's
            row["launches_by_phase"] = by_phase
        for key in ("library_err", "vs_library", "bound_f32_fma_ms",
                    "int_ops_per_draw", "bytes_bound_ms", "bound_pipe",
                    "bounds_ms", "bit_equal_launches", "same_basis_ms",
                    "fwd_ms", "boundary_bytes", "lse_err", "with_lse_ms",
                    "without_lse_ms"):
            if key in c:
                row[key] = c[key]
        if name == "decode_attn":
            # the slices of a length-split cache, merged, against the whole
            row["length_split"] = checks["decode_split"]
        hybrid = {arch: dict(c[name], launches=train_of[arch][name])
                  for arch, c in hybrid_checks.items() if name in c}
        if hybrid:
            # the same kernel at the hybrid updates' shapes, with the
            # launches of train_hymba / train_rwkv6
            row["train_hybrid"] = {
                arch: {key: r[key] for key in (
                    "shape", "launches", "max_abs_err", "ms", "plain_ms",
                    "bound_ms", "bound_by", "library_ms")}
                for arch, r in hybrid.items()}
        # the same kernel at the wide heads', the MoEs' and the VLM's
        # shapes, each with the launches of the phase that runs that shape
        for key, arch_checks, phases in (
                ("wide_heads", wide_checks, wide),
                ("moe", moe_checks, moe_vlm), ("vlm", vlm_checks, moe_vlm)):
            entries = arch_rows(name, arch_checks, phases)
            if entries:
                row[key] = entries
        if name in by_length:
            row["launches_by_length"] = by_length[name]
            pre = scans[name]["prefill"]
            row["prefill"] = {key: pre[key] for key in (
                "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "bound_by", "bound_pipe", "bounds_ms")}
        rows.append(row)
    # the whole run's seconds, phase by phase (what follows is printing)
    emit("attribution", nvidia_smi=smi, **attribution())
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# the checks that stand in a kernel's row of the kernels line, under the
# labels there: its own shape ("check"), prefill, and the cross-attention's
ROW_CHECKS = {"flash_attn": (("flash_attn", "check"),
                             ("flash_attn_prefill", "prefill"),
                             ("cross_fwd", "cross_attention"),
                             ("cross_decode", "cross_decode")),
              "flash_attn_bwd": (("flash_attn_bwd", "check"),
                                 ("cross_bwd", "cross_attention"))}
ROW_KEYS = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library", "library_ms", "library_err", "library_failed",
            "library_options", "default_options_failed", "vs_library",
            "bit_equal_launches", "diff_from_dense_kernel", "dense_kernel_ms",
            "sdpa_without_softcap_ms", "lse_err")


def arch_rows(name, arch_checks, phases):
    """{arch: {label: the check's numbers, with the launches of the phase
    that runs that shape}} of kernel ``name`` over ``arch_checks`` ({arch:
    {check key: result}}); ``phases`` holds each phase's launch counts. A
    check with no phase in ARCH_LAUNCHES is on no path of this run
    (launches null)."""
    rows = {}
    for arch, c in arch_checks.items():
        entry = {}
        for key, label in ROW_CHECKS.get(name, ((name, "check"),)):
            if key not in c:
                continue
            phase = ARCH_LAUNCHES.get((arch, key))
            entry[label] = dict(
                {k: c[key][k] for k in ROW_KEYS if k in c[key]},
                launches=phases[phase][name] if phase else None,
                launches_of=phase)
        if entry:
            rows[arch] = entry
    return rows


# which phase's launches stand beside an arch's check in the kernels line:
# (arch, check) -> phase; a check with no phase (the paged decode of every
# arch but paper-qwen-7b and deepseek-moe-16b) is not on any path of this
# run. The flash counts of serve_vision and grad_vision are those of the
# self- and the cross-attention together (one wrapper)
ARCH_LAUNCHES = {
    ("paper-qwen-7b", "flash_attn"): "train_qwen7b",
    ("paper-qwen-7b", "flash_attn_prefill"): "serve_qwen7b",
    ("paper-qwen-7b", "flash_attn_bwd"): "train_qwen7b",
    ("paper-qwen-7b", "decode_attn"): "serve_qwen7b",
    ("paper-qwen-7b", "paged_decode_attn"): "serve_qwen7b_paged",
    ("paper-qwen-7b", "fused_sample"): "serve_qwen7b",
    ("paper-qwen-7b", "fused_is_grpo_fwd"): "train_qwen7b",
    ("paper-qwen-7b", "fused_is_grpo_bwd_dh"): "train_qwen7b",
    ("paper-qwen-7b", "fused_is_grpo_bwd_dw"): "train_qwen7b",
    ("gemma2-2b", "flash_attn"): "train_gemma2",
    ("gemma2-2b", "flash_attn_prefill"): "serve_gemma2",
    ("gemma2-2b", "flash_attn_bwd"): "train_gemma2",
    ("gemma2-2b", "decode_attn"): "serve_gemma2",
    ("gemma2-2b", "fused_sample"): "serve_gemma2",
    ("gemma2-2b", "fused_is_grpo_fwd"): "train_gemma2",
    ("gemma2-2b", "fused_is_grpo_bwd_dh"): "train_gemma2",
    ("gemma2-2b", "fused_is_grpo_bwd_dw"): "train_gemma2",
    ("qwen3-14b", "flash_attn_prefill"): "serve_qwen3_14b",
    ("qwen3-14b", "decode_attn"): "serve_qwen3_14b",
    ("granite-34b", "flash_attn_prefill"): "serve_granite",
    ("granite-34b", "decode_attn"): "serve_granite",
    ("musicgen-medium", "flash_attn"): "train_musicgen",
    ("musicgen-medium", "flash_attn_prefill"): "serve_musicgen",
    ("musicgen-medium", "flash_attn_bwd"): "train_musicgen",
    ("musicgen-medium", "decode_attn"): "serve_musicgen",
    ("deepseek-moe-16b", "flash_attn"): "train_deepseek",
    ("deepseek-moe-16b", "flash_attn_prefill"): "serve_deepseek",
    ("deepseek-moe-16b", "flash_attn_bwd"): "train_deepseek",
    ("deepseek-moe-16b", "decode_attn"): "serve_deepseek",
    ("deepseek-moe-16b", "paged_decode_attn"): "serve_deepseek_paged",
    ("deepseek-moe-16b", "fused_sample"): "serve_deepseek",
    ("deepseek-moe-16b", "fused_is_grpo_fwd"): "train_deepseek",
    ("deepseek-moe-16b", "fused_is_grpo_bwd_dh"): "train_deepseek",
    ("deepseek-moe-16b", "fused_is_grpo_bwd_dw"): "train_deepseek",
    ("qwen3-moe-235b-a22b", "flash_attn_prefill"): "serve_qwen3_moe",
    ("qwen3-moe-235b-a22b", "decode_attn"): "serve_qwen3_moe",
    ("qwen3-moe-235b-a22b", "fused_sample"): "serve_qwen3_moe",
    ("llama-3.2-vision-90b", "flash_attn_prefill"): "serve_vision",
    ("llama-3.2-vision-90b", "decode_attn"): "serve_vision",
    ("llama-3.2-vision-90b", "cross_fwd"): "grad_vision",
    ("llama-3.2-vision-90b", "cross_decode"): "serve_vision",
    ("llama-3.2-vision-90b", "cross_bwd"): "grad_vision",
}

SERVE_SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.95)
TRAIN_SAMPLING = dict(temperature=1.0)


def parent_library(build, parent, name, argtypes):
    """Kernel source ``name`` of the checkout at ``parent`` built with this
    tree's nvcc flags into ``parent``/build/ab and loaded with ctypes."""
    import ctypes
    csrc = Path(parent) / "src" / "repro_torch" / "csrc"
    out = Path(parent) / "build" / "ab" / f"{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(csrc), "-o",
                    str(out), str(csrc / f"{name}.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(out))
    for fn_name, args in argtypes.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    return lib


def sass_of(build, lib_path):
    """``cuobjdump -sass`` of the shared library at ``lib_path``."""
    tool = Path(build._nvcc()).with_name("cuobjdump")
    return subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout


def sass_functions(text):
    """{kernel: its instructions} of a ``cuobjdump -sass`` listing: names
    without their translation unit's anonymous-namespace prefix (which
    hashes the file), instructions without addresses and encodings, branch
    labels numbered within the function."""
    out = {}
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        block = re.sub(r"_GLOBAL__N__\w+?_cu_\w{8}", "", block)
        lines = block.splitlines()
        labels, body = {}, []
        for line in lines[1:]:
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
            if m:
                body.append(re.sub(r"\.L_x_\d+", lambda x: labels.setdefault(
                    x.group(0), f"L{len(labels)}"), m.group(1)))
        out[lines[0].strip()] = "\n".join(body)
    return out


def with_libraries(build, libs, fn):
    """``fn()`` with the wrappers' loaded libraries replaced by ``libs``
    ({source name: CDLL}): the same Python wrapper launches another tree's
    kernel through the same C entry point."""
    saved = {name: build.library(name) for name in libs}
    build._LIBRARIES.update(libs)
    try:
        return fn()
    finally:
        build._LIBRARIES.update(saved)


def ab_attention_loss(torch, timer, build, parent, in_turns):
    """llama3.2-1b's attention and loss kernels of this tree against those
    of the checkout at ``parent``, through this tree's wrappers (the C entry
    points must be the same: a parent before the decode kernel took
    ``start`` and ``lse`` cannot be timed so), timed in turns: flash
    forward with lse at the
    train shape and without at the prefill shape, its backward, dense and
    paged decode at the serve shape, the three loss kernels at d 2048 / V
    128256. Then, per library, the kernels whose SASS is the same in both
    trees and those that differ (the wgmma.cuh changes must leave the loss
    library's SASS as it was)."""
    from repro_torch.hopper import decode_attn, flash_attn
    from repro_torch.hopper import fused_is_grpo as fio
    from repro_torch.hopper import paged_decode_attn
    names = ("flash_attn", "flash_attn_bwd", "decode_attn",
             "paged_decode_attn", "fused_is_grpo")
    old = {name: parent_library(build, parent, name, build.KERNELS[name])
           for name in names}
    g = torch.Generator(device="cuda").manual_seed(31)

    def ab(label, call, shape):
        a = with_libraries(build, old, call)
        b = call()
        torch.cuda.synchronize()
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        emit(f"ab_{label}", shape=shape, same_bits_as_parent=same,
             **in_turns(lambda: with_libraries(build, old, call), call))

    B, S, H, KV, hd = TRAIN_B, TRAIN_S, 32, 8, 64
    q, k, v, do = (torch.randn(B, S, n, hd, device="cuda", generator=g)
                   .bfloat16() for n in (H, KV, KV, H))
    out, lse = flash_attn.flash_attention(q, k, v, return_lse=True)
    ab("flash_attn_lse", lambda: flash_attn.flash_attention(
        q, k, v, return_lse=True), f"q {list(q.shape)} kv {list(k.shape)}")
    ab("flash_attn_bwd", lambda: flash_attn.flash_attention_bwd(
        q, k, v, out, lse, do), f"q {list(q.shape)} kv {list(k.shape)}")
    qp, kp_, vp_ = (torch.randn(16, PREFILL_T, n, hd, device="cuda",
                                generator=g).bfloat16() for n in (H, KV, KV))
    ab("flash_attn_prefill", lambda: flash_attn.flash_attention(
        qp, kp_, vp_), f"q {list(qp.shape)} kv {list(kp_.shape)}")
    L, ps = 640, 16
    qd = torch.randn(16, 1, H, hd, device="cuda", generator=g).bfloat16()
    kc, vc = (torch.randn(16, L, KV, hd, device="cuda", generator=g)
              .bfloat16() for _ in range(2))
    lens = torch.randint(65, L + 1, (16,), device="cuda", generator=g,
                         dtype=torch.int32)
    kpool, vpool, bt = scatter_pages(torch, kc, vc, lens, ps, g)
    ab("decode_attn", lambda: decode_attn.decode_attention(qd, kc, vc, lens),
       f"q {list(qd.shape)} cache {list(kc.shape)}")
    ab("paged_decode_attn", lambda: paged_decode_attn.paged_decode_attention(
        qd, kpool, vpool, bt, ps, lens), f"pools {list(kpool.shape)}")
    R, d, V = TRAIN_B * TRAIN_S, 2048, 128256
    h = torch.randn(R, d, device="cuda", generator=g).bfloat16()
    w = (torch.randn(V, d, device="cuda", generator=g) * 0.02).T
    t = torch.randint(0, V, (R,), device="cuda", generator=g,
                      dtype=torch.int32)
    beh = torch.randn(R, device="cuda", generator=g) * 0.3 - 11.0
    adv = torch.randn(R, device="cuda", generator=g)
    kw = dict(logit_softcap=0.0, clip_low=0.2, clip_high=0.28, use_is=True,
              is_ratio_cap=10.0, entropy_coef=0.0)
    fwd = fio.fused_is_grpo_fwd_rows(h, w, t, beh, adv, **kw)
    lse_l, ent = fwd[3], fwd[4]
    ca = torch.randn(R, device="cuda", generator=g)
    ce = torch.randn(R, device="cuda", generator=g) * 0.1
    dl, _ = fio.fused_is_grpo_bwd_dh_rows(h, w, t, lse_l, lse_l - ent, ca, ce)
    dw = torch.empty_like(w)
    shape = f"hidden [{R}, {d}] bf16, w = embed.T of [{V}, {d}] f32"
    ab("fused_is_grpo_fwd", lambda: fio.fused_is_grpo_fwd_rows(
        h, w, t, beh, adv, **kw), shape)
    ab("fused_is_grpo_bwd_dh", lambda: fio.fused_is_grpo_bwd_dh_rows(
        h, w, t, lse_l, lse_l - ent, ca, ce), shape)
    ab("fused_is_grpo_bwd_dw", lambda: fio.fused_is_grpo_bwd_dw_rows(
        h, dl, dw).clone(), shape)
    ab_dir = Path(parent) / "build" / "ab"
    for name in names:
        before = sass_functions(sass_of(build, ab_dir / f"{name}.so"))
        after = sass_functions(build.sass(name))
        common = sorted(set(before) & set(after))
        emit("ab_sass_functions", library=name,
             same=sum(before[f] == after[f] for f in common),
             differ=[f for f in common if before[f] != after[f]],
             only_parent=len(set(before) - set(after)),
             only_change=len(set(after) - set(before)))


def ab_backward(torch, timer, build, old_scan, old_wkv, in_turns, g):
    """The scans' backward kernels of this tree against the parent's
    (called as the parent's wrappers called them: a scratch that their own
    first pass fills with the boundary states) at the hybrid updates'
    shape, bf16, in turns: this tree's reading the boundaries its forward
    stored (``ms``, the main path's), and with the forward that stores
    them run first on a copy of the state (``with_forward``: the save
    kernel plus the backward, what ``launch_bwd`` does given none).
    Summation orders changed, so the bits may differ: each tree's excess
    over the tolerance against the plain backward."""
    from repro_torch.hopper import rwkv6_scan, ssm_scan
    stream = torch.cuda.current_stream().cuda_stream
    f32 = dict(device="cuda", dtype=torch.float32)
    B, T = TRAIN_B, TRAIN_S

    di, N = 3200, 16
    args = ssm_inputs(torch, B, T, di, N, torch.bfloat16, g, model_A=True)
    dy = torch.randn(B, T, di, device="cuda", generator=g).bfloat16()
    x, dt, A_log, Bc, Cc, D, s0 = args

    def old_ssm():
        cb = 320 // (N // 4)
        nblk = (di + cb - 1) // cb
        chunk = old_scan.ssm_scan_bwd_chunk(N, 1, None)
        nchk = (T + chunk - 1) // chunk
        dx, ddt = torch.empty_like(x), torch.empty_like(x)
        pbc = torch.empty(nblk, B, T, 2, N, **f32)
        pA, pD = torch.empty(B, di, N, **f32), torch.empty(B, di, **f32)
        ds0 = torch.empty(B, di, N, **f32)
        ckpt = torch.empty(B, nchk, di, N, **f32)
        build.check(old_scan.ssm_scan_bwd(
            x.data_ptr(), dt.data_ptr(), A_log.data_ptr(), Bc.data_ptr(),
            Cc.data_ptr(), D.data_ptr(), s0.data_ptr(), dy.data_ptr(), 0,
            dx.data_ptr(), ddt.data_ptr(), pbc.data_ptr(), pA.data_ptr(),
            pD.data_ptr(), ds0.data_ptr(), ckpt.data_ptr(), B, T, di, N,
            Bc.stride(0), Bc.stride(1), Cc.stride(0), Cc.stride(1), 1,
            stream), "parent ssm_scan_bwd")
        bc = pbc.sum(0)
        return (dx, ddt, pA.sum(0), bc[:, :, 0].to(Bc.dtype),
                bc[:, :, 1].to(Cc.dtype), pD.sum(0), ds0)

    ckpt = ssm_scan.boundaries(x, N)
    ssm_scan.launch(*args[:6], s0.clone(), ckpt=ckpt)
    ab_bwd_pair(torch, "ssm_scan_bwd",
                f"x, dt, dy [{B}, {T}, {di}] bf16, state [{B}, {di}, {N}]",
                old_ssm, lambda: ssm_scan.launch_bwd(*args, dy, ckpt=ckpt),
                lambda: ssm_scan.launch_bwd(*args, dy),
                ssm_scan.selective_scan_bwd_plain(*args, dy), in_turns)

    H, hd = 32, 64
    r, k, v = (torch.randn(B, T, H, hd, device="cuda", generator=g)
               .mul(0.5).bfloat16() for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn(
        B, T, H, hd, device="cuda", generator=g) * 0.5 - 1.0)).bfloat16()
    u = torch.randn(H, hd, device="cuda", generator=g) * 0.3
    s0 = torch.randn(B, H, hd, hd, device="cuda", generator=g) * 0.2
    dy = torch.randn(B, T, H, hd, device="cuda", generator=g).bfloat16()

    def old_wkv_bwd():
        chunk = old_wkv.wkv6_bwd_chunk(hd, None)
        nchk = (T + chunk - 1) // chunk
        dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
        pu = torch.empty(B, H, hd, **f32)
        ds0 = torch.empty(B, H, hd, hd, **f32)
        ck = torch.empty(B, H, max(nchk - 1, 1), hd, hd, **f32)
        build.check(old_wkv.wkv6_bwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), s0.data_ptr(), dy.data_ptr(), 0, dr.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), pu.data_ptr(),
            ds0.data_ptr(), ck.data_ptr(), B, T, H, hd, 1, stream),
            "parent wkv6_bwd")
        return dr, dk, dv, dw, pu.sum(0), ds0

    ckpt = rwkv6_scan.boundaries(r)
    rwkv6_scan.launch(r, k, v, w, u, s0.clone(), ckpt=ckpt)
    ab_bwd_pair(torch, "wkv6_bwd",
                f"r, k, v, w, dy [{B}, {T}, {H}, {hd}] bf16",
                old_wkv_bwd,
                lambda: rwkv6_scan.launch_bwd(r, k, v, w, u, s0, dy,
                                              ckpt=ckpt),
                lambda: rwkv6_scan.launch_bwd(r, k, v, w, u, s0, dy),
                rwkv6_scan.wkv6_bwd_plain(r, k, v, w, u, s0, dy), in_turns)


def ab_bwd_pair(torch, name, shape, old, new, new_with_forward, want,
                in_turns):
    a, b, c = old(), new(), new_with_forward()
    torch.cuda.synchronize()
    emit(f"ab_{name}", shape=shape,
         same_bits_as_parent=all(torch.equal(x, y) for x, y in zip(a, b)),
         with_forward_same_bits=all(torch.equal(x, y) for x, y in zip(b, c)),
         excess_over_tol_parent=bwd_excess(torch, a, want)[0],
         excess_over_tol=bwd_excess(torch, b, want)[0],
         **in_turns(old, new),
         with_forward=in_turns(old, new_with_forward))


def ab_main(parent) -> int:
    """``python3 chip_smoke.py --ab PARENT``: this tree's attention kernels
    (flash forward and backward, dense and paged decode) and loss kernels
    at llama3.2-1b's shapes, with their SASS compared function by function
    (ab_attention_loss), then its sampling kernel,
    selective scan (decode and prefill) and WKV6 (decode and prefill)
    against those of the checkout at PARENT (both built here), timed in
    turns (parent, change, change, parent) at the main paths' shapes, with
    the SASS opcode counts of both trees' scan kernels; the scans' backward
    kernels at the hybrid updates' shape (ab_backward) and the scan
    libraries' SASS function by function (their serve kernels must keep
    theirs); then this tree's
    sampling kernel over cluster sizes {4, 6, 7, 8, 16} (with the clusters
    the card holds at once) and through the wrapper's own choice, at 1, 3
    and 16 rows of the three served vocabularies, in both sampling
    configurations."""
    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.hopper import build, fused_sample, rwkv6_scan, ssm_scan
    from repro_torch.sampling import prng
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0))
    build.build_all()
    # the parent's forward and backward entry points take this tree's
    # arguments; its wkv6_bwd_chunk its own, without the dtype
    P, I = build.P, build.I
    old_sample, old_scan, old_wkv = (
        parent_library(build, parent, name, {
            fn: build.KERNELS[name][fn], **bwd})
        for name, fn, bwd in (
            ("fused_sample", "fused_sample_rows", {}),
            ("ssm_scan", "ssm_scan_fwd", {
                "ssm_scan_bwd": (P,) * 16 + (I,) * 9 + (P,),
                "ssm_scan_bwd_chunk": (I, I, P)}),
            ("wkv6", "wkv6_fwd", {
                "wkv6_bwd": (P,) * 15 + (I,) * 5 + (P,),
                "wkv6_bwd_chunk": (I, P)})))
    timer = Timer(torch)
    stream = torch.cuda.current_stream().cuda_stream

    # what each tree's forward scan kernels issue (static SASS opcode counts)
    ab_dir = Path(parent) / "build" / "ab"
    sass = {"parent": (sass_of(build, ab_dir / "wkv6.so")
                       + sass_of(build, ab_dir / "ssm_scan.so")),
            "change": build.sass("wkv6") + build.sass("ssm_scan")}
    for tree in ("parent", "change"):
        for marker in ("wkv6_step_kernelI13__nv_bfloat16Li64E",
                       "wkv6_scan_kernelI13__nv_bfloat16Li64E",
                       "ssm_step_kernelI13__nv_bfloat16Li16E",
                       "ssm_scan_kernelI13__nv_bfloat16Li16E"):
            emit("ab_sass", tree=tree, kernel=marker, opcodes=dict(sorted(
                sass_opcodes(sass[tree], marker).items())))

    def old_sample_rows(keys, logits, temperature=1.0, top_k=-1, top_p=1.0):
        R, V = logits.shape
        tok = torch.empty(R, dtype=torch.int32, device="cuda")
        logp = torch.empty(R, device="cuda")
        greedy = temperature <= 0
        build.check(old_sample.fused_sample_rows(
            keys.data_ptr(), logits.data_ptr(), tok.data_ptr(),
            logp.data_ptr(), R, V, temperature, top_k, top_p, int(greedy),
            fused_sample.cluster_size("cuda", R, V, greedy), stream),
            "parent fused_sample_rows")
        return tok, logp

    def in_turns(old, new):
        ts = [timer(f) for f in (old, new, new, old)]
        return dict(parent_ms=(ts[0] + ts[3]) / 2, ms=(ts[1] + ts[2]) / 2,
                    turns_ms=ts)

    ab_attention_loss(torch, timer, build, parent, in_turns)

    g = torch.Generator(device="cuda").manual_seed(12)
    for label, V, kw in (("serve", 128256, SERVE_SAMPLING),
                         ("serve", 32001, SERVE_SAMPLING),
                         ("serve", 65536, SERVE_SAMPLING),
                         ("train", 128256, TRAIN_SAMPLING)):
        logits = torch.randn(16, V, device="cuda", generator=g) * 2.0
        keys = prng.split(prng.PRNGKey(5), 16).to("cuda")
        same = torch.equal(old_sample_rows(keys, logits, **kw)[0],
                           fused_sample.sample_rows(keys, logits, **kw)[0])
        emit("ab_fused_sample", config=label, rows=16, vocab=V,
             same_tokens=same, **in_turns(
                 lambda: old_sample_rows(keys, logits, **kw),
                 lambda: fused_sample.sample_rows(keys, logits, **kw)))

    B, di, N = 16, 3200, 16
    for label, T in (("decode", 1), ("prefill", PREFILL_T)):
        x, dt, A_log, Bc, Cc, D, s0 = ssm_inputs(
            torch, B, T, di, N, torch.bfloat16, g, model_A=True)
        work = s0.clone()

        def old_scan_call(state):
            y = torch.empty_like(x)
            build.check(old_scan.ssm_scan_fwd(
                x.data_ptr(), dt.data_ptr(), A_log.data_ptr(), Bc.data_ptr(),
                Cc.data_ptr(), D.data_ptr(), state.data_ptr(), y.data_ptr(),
                B, T, di, N, Bc.stride(0), Bc.stride(1), Cc.stride(0),
                Cc.stride(1), 1, 0, stream), "parent ssm_scan_fwd")
            return y

        y_old = old_scan_call(s0.clone())
        y_new, _ = ssm_scan.selective_scan(x, dt, A_log, Bc, Cc, D,
                                           s0.clone())
        emit(f"ab_ssm_scan_{label}", shape=f"x, dt [{B}, {T}, {di}] bf16, "
             f"state [{B}, {di}, {N}] f32",
             max_diff_from_parent=float((y_old.float() - y_new.float())
                                        .abs().max()),
             **in_turns(lambda: old_scan_call(work),
                        lambda: ssm_scan.selective_scan(
                            x, dt, A_log, Bc, Cc, D, work)))

    H, hd = 32, 64
    for label, T in (("decode", 1), ("prefill", PREFILL_T)):
        r, k, v = (torch.randn(B, T, H, hd, device="cuda", generator=g)
                   .mul(0.5).bfloat16() for _ in range(3))
        w = torch.exp(-torch.exp(torch.randn(
            B, T, H, hd, device="cuda", generator=g) * 0.5 - 1.0)).bfloat16()
        u = torch.randn(H, hd, device="cuda", generator=g) * 0.3
        s0 = torch.randn(B, H, hd, hd, device="cuda", generator=g) * 0.2
        work = s0.clone()

        def old_wkv_call(state):
            y = torch.empty_like(r)
            build.check(old_wkv.wkv6_fwd(
                r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), state.data_ptr(), y.data_ptr(), B, T, H, hd,
                1, 0, stream), "parent wkv6_fwd")
            return y

        y_old = old_wkv_call(s0.clone())
        y_new, _ = rwkv6_scan.wkv6(r, k, v, w, u, s0.clone())
        emit(f"ab_wkv6_{label}", shape=f"r, k, v, w [{B}, {T}, {H}, {hd}] "
             f"bf16, state [{B}, {H}, {hd}, {hd}] f32",
             max_diff_from_parent=float((y_old.float() - y_new.float())
                                        .abs().max()),
             **in_turns(lambda: old_wkv_call(work),
                        lambda: rwkv6_scan.wkv6(r, k, v, w, u, work)))

    ab_backward(torch, timer, build, old_scan, old_wkv, in_turns, g)
    # the scan libraries function by function: the serve instantiations
    # (decode and prefill kernels) must keep their SASS
    for name in ("ssm_scan", "wkv6"):
        before = sass_functions(sass_of(build, ab_dir / f"{name}.so"))
        after = sass_functions(build.sass(name))
        common = sorted(set(before) & set(after))
        serve = [f for f in common if re.search(r"(step|scan)_kernel", f)
                 and "bwd" not in f]
        emit("ab_sass_functions", library=name,
             same=sum(before[f] == after[f] for f in common),
             differ=[f for f in common if before[f] != after[f]],
             serve_kernels=len(serve),
             serve_same_sass=all(before[f] == after[f] for f in serve),
             only_parent=sorted(set(before) - set(after)),
             only_change=sorted(set(after) - set(before)))

    totals = {}
    for label, kw in (("serve", SERVE_SAMPLING), ("train", TRAIN_SAMPLING)):
        for V in (128256, 32001, 65536):
            for R in (1, 3, 16):
                logits = torch.randn(R, V, device="cuda", generator=g) * 2.0
                keys = prng.split(prng.PRNGKey(R), R).to("cuda")
                ms, resident = {}, {}
                for C in (4, 6, 7, 8, 16):
                    key = f"C{C}"
                    resident[key] = fused_sample.max_clusters("cuda", V, C)
                    ms[key] = timer(lambda: fused_sample.launch(
                        keys, logits, cluster=C,
                        **{"top_k": -1, "top_p": 1.0, **kw}))
                    if R == 16:
                        totals[key] = totals.get(key, 0) + ms[key]
                ms["wrapper"] = timer(
                    lambda: fused_sample.sample_rows(keys, logits, **kw))
                emit("sweep_fused_sample", config=label, rows=R, vocab=V,
                     ms=ms, fastest=min(ms, key=ms.get),
                     wrapper_takes=f"C{fused_sample.cluster_size('cuda', R, V)}",
                     clusters_resident=resident)
    emit("sweep_fused_sample_total", what="sum over both configurations "
         "and the three vocabularies at 16 rows", ms=totals,
         fastest=min(totals, key=totals.get))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ab"] and len(sys.argv) == 3:
        sys.exit(ab_main(sys.argv[2]))
    if sys.argv[1:2] == ["--two-sided-rank"] and len(sys.argv) == 4:
        sys.exit(two_sided_rank(int(sys.argv[2]), sys.argv[3]))
    if sys.argv[1:] == ["--warm-flex"]:
        sys.exit(warm_flex())
    sys.exit(main())
