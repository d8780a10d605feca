#!/usr/bin/env python3
"""On-GPU smoke run of the PyTorch port (src/repro_torch): the serving path
and the CoPRIS training loop at the full width of llama3.2-1b, over the dense
and the paged KV cache, sequential and overlapped (rollout on its own CUDA
stream), with single-turn tasks and multi-turn environments, serving,
rollouts and training of the hybrid hymba-1.5b and the attention-free
rwkv6-1.6b at full width, and the archs with wide heads (head_dim 128 and
256, any GQA ratio): the paper's own paper-qwen-7b, gemma2-2b, qwen3-14b and
granite-34b, with musicgen-medium, through the port's hand-written kernels.

    python3 chip_smoke.py          # from the root of a checkout, one GPU
    python3 chip_smoke.py --ab DIR # llama3.2-1b's attention and loss
                                   # kernels (and their SASS), sampling,
                                   # the selective scan and WKV6 (decode and
                                   # prefill) against the checkout at DIR,
                                   # and the sweep of the sampling kernel's
                                   # cluster sizes

Phases, each printed as one JSON line (with ``t_s``, the seconds since the
start):

1. device  — the card's name and power limit (nvidia-smi);
2. build   — nvcc builds every kernel source from csrc/, in parallel;
   cuobjdump counts the HGMMA (wgmma) instructions of the two flash
   libraries and of the loss library (its bf16 forward, dl, dh and dw
   kernels), which must have some; ptxas's registers and spills of the
   tensor-core kernels (every kernel named ``*_tc``) and of the scan
   kernels, forward and backward (with their shared memory);
3. kernel checks — each kernel against its plain PyTorch version at the
   main paths' shapes (serving: prefill, dense and paged decode and
   sampling, each also at the hybrid paths' shapes, hymba's H/KV = 5 and
   window and the vocabularies of 32001 and 65536; the selective scan and
   WKV6 at their decode and prefill shapes, plus the JAX kernel tests'
   cases, each scan's decode kernel beside its prefill kernel at T = 1,
   the selective scan bounded by the largest of its bytes, its FMA-pipe
   operations and its exponentials on the MUFU pipe; the scans' backward
   kernels at the JAX kernel tests' f32 cases and at the hybrid updates'
   shape, bf16 (32 rows of 127 steps), bit-equal across two launches and
   bounded the same way;
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
   softcap of 30; every flash backward bit-equal across two launches,
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
4. reference — the GPU engine (kernels, float32) against the same engine on
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
   and a window of 32; then "reference_overlap": the overlapped
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
   then "profile": torch.profiler over two steady decode chunks (host time,
   device busy time, the decode attention kernels' time, top device
   kernels);
   then "serve_paged": the same 24 requests over the paged KV cache with
   40% of the dense-equivalent pages: page pressure (blocked admissions or
   preemptions) and every request returned; then "profile_paged": the
   profile phase's two chunks over the paged cache;
6. copris  — two RolloutEngine.collect stages: the first buffers partials
   (early termination), the second resumes them;
   then "serve_hymba", "serve_hymba_paged" (40% of the pages) and
   "serve_rwkv6": 24 requests each at full width, each with its profile;
   then "copris_hybrid": two stages on each family (hymba resuming from
   kv_snapshot, rwkv6 by re-prefill), evicting and resuming;
7. train   — sft_warmup, then three CoPRISTrainer.step() calls on
   llama3.2-1b at full width (bf16 compute, f32 masters): finite reward,
   loss, grad norm, ratio and off-policy share; rollout, reward and update
   times, resumed partials, peak memory; every kernel launched; then
   "train_profile": torch.profiler over one more update (device busy
   time, top device kernels); then "train_overlap": from the train
   phase's SFT-warmed weights (kept on the host), four overlapped steps
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
   "train_paged": two CoPRISTrainer.step()
   calls at full width over the paged KV cache with half the
   dense-equivalent pages and the legacy fused_loss=False loss: prefix
   sharing, copy-on-write, finite metrics, every kernel of that path
   launched; then "train_hymba" and "train_rwkv6": sft_warmup, then two
   CoPRISTrainer.step() calls on each family at full width, as "train"
   runs llama: finite metrics, step times, peak memory, every kernel of the
   path launched (the scans' backward kernels and, for hymba, the flash
   backward among them), each with the profile of one more update;
   then the wide-head archs through the same entry points, one at a time,
   each freed before the next: "serve_qwen7b" (paper-qwen-7b at full
   depth) and "serve_qwen7b_paged" (14 of its 28 layers, 40% of the
   pages), "copris_qwen7b" (two
   stages), "train_qwen7b" (4 of its 28 layers at full width: SFT, then
   two steps with the fused loss at d 3584 / V 152064), "serve_gemma2"
   and "train_gemma2" (full depth: head_dim 256, the softcaps, the local
   window), "serve_qwen3_14b" (20 of its 40 layers, qk_norm),
   "serve_granite" (24 of its 88 layers: the full depth's bf16 weights do
   not fit the card), "serve_musicgen" and "train_musicgen" (24 of its 48
   layers, V 2048: the full-logits loss; one step; the three half depths
   keep the run near 600 s); the train phases with an entropy bonus of
   0.01, so every step has a gradient; each serve phase with its profile,
   each train phase with an update's profile;
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
   launches, and the wide-head checks under "wide_heads", each with the
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
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor cores
PEAK_F32_FLOPS = 67e12              # H100 SXM float32 outside tensor cores


T0 = time.perf_counter()


def emit(phase, **kw):
    """One phase's JSON line, with the seconds since the script started."""
    print(json.dumps({"phase": phase, "t_s": time.perf_counter() - T0, **kw}),
          flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: {msg}")


def bound(nbytes, flops, peak_flops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    nbytes = 2 * (2 * q.numel() + 2 * live * KV * hd) + 4 * B
    flops = 4 * H * hd * live
    b_ms, b_by = bound(nbytes, flops, PEAK_BF16_FLOPS)
    res = dict(shape=f"q {list(q.shape)} cache {list(kc.shape)} bf16, "
               f"sum(cache_len)={live}",
               max_abs_err=err, atol=atol, ms=kernel_ms, plain_ms=plain_ms,
               library_ms=library_ms, vs_library=kernel_ms / library_ms,
               bound_ms=b_ms, bound_by=b_by, timer_floor_ms=timer.floor_ms)
    emit("check_decode_attn", **res)
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
    # live K/V (no window on llama), q, out, the block table and lengths
    nbytes = 2 * (2 * q.numel() + 2 * live * KV * hd) + 4 * bt.numel() + 4 * B
    flops = 4 * H * hd * live
    b_ms, b_by = bound(nbytes, flops, PEAK_BF16_FLOPS)
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
    nbytes = 2 * (2 * q.numel() + 2 * k.numel())
    flops = 4 * B * H * hd * (S * (S + 1) // 2)
    b_ms, b_by = bound(nbytes, flops, PEAK_BF16_FLOPS)
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
    nbytes = 2 * (2 * q.numel() + 2 * live * KV * hd) + 4 * B
    flops = 4 * H * hd * live
    b_ms, b_by = bound(nbytes, flops, PEAK_BF16_FLOPS)
    pb_ms, pb_by = bound(nbytes + 4 * bt.numel(), flops, PEAK_BF16_FLOPS)
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
        x, dt, A_log, Bc, Cc, D, s0 = args
        nbytes = (2 * (3 * x.numel() + Bc.numel() + Cc.numel())
                  + 4 * (A_log.numel() + D.numel()) + 8 * s0.numel())
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
            f"state [{B}, {di}, {N}] f32", nbytes, 7 * B * T * di * N,
            exps=exps, mufu_rate=mufu_rate, exp_count=exps, sms=sms,
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
        r, s0 = args[0], args[5]
        nbytes = 2 * 5 * r.numel() + 4 * args[4].numel() + 8 * s0.numel()
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
            f"{hd}] f32", nbytes, 6 * B * T * H * hd * hd, **extra)
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


def bwd_check(torch, timer, name, kernel, plain, cases, train_args,
              train_shape, nbytes, flops, exps, mufu_rate):
    """One backward scan kernel (``kernel(*args, dy, dstate)``, the launch
    that autograd makes) against its plain version: at the JAX kernel
    tests' float32 cases with a nonzero final-state gradient, then at the
    update's shape in bf16 (a zero final-state gradient, as training
    gives), where it is timed beside the plain version and launched a
    second time to show the same bits. Bound: the largest of the bytes (every
    input read once, every gradient written once), the float32 operations
    on the FMA pipe at 67 TFLOP/s (an FMA counted as two) and ``exps``
    exponentials on the MUFU pipe; no single PyTorch call computes it."""
    worst = -1.0
    for args in cases:
        excess, _ = bwd_excess(torch, kernel(*args), plain(*args))
        worst = max(worst, excess)
    if worst > 0.0:
        fail(f"{name} disagrees with its plain version at the kernel tests' "
             f"cases by {worst} beyond the tolerance")
    got = kernel(*train_args)
    want = plain(*train_args)
    again = kernel(*train_args)
    torch.cuda.synchronize()
    excess, err = bwd_excess(torch, got, want)
    same_bits = all(torch.equal(a, b) for a, b in zip(got, again))
    if excess > 0.0 or not same_bits:
        fail(f"{name} at the update's shape: {excess} beyond the tolerance, "
             f"bit-equal across launches: {same_bits}")
    del got, want, again
    kernel_ms = timer(lambda: kernel(*train_args))
    plain_ms = timer(lambda: plain(*train_args), iters=3, warmup=1)
    bounds = {"bytes": nbytes / PEAK_BYTES_PER_S * 1e3,
              "fma": flops / PEAK_F32_FLOPS * 1e3,
              "mufu": exps / mufu_rate * 1e3}
    pipe = max(bounds, key=bounds.get)
    res = dict(shape=train_shape, max_abs_err=err,
               tol="f32 1e-4 of each gradient's largest element; bf16 2 "
                   "ulps + that", excess_over_tol=excess,
               excess_over_tol_cases=worst, bit_equal_launches=same_bits,
               ms=kernel_ms, plain_ms=plain_ms, library_ms=None,
               library="none: no single PyTorch call computes it",
               bound_ms=bounds[pipe],
               bound_by="bytes" if pipe == "bytes" else "operations",
               bound_pipe=None if pipe == "bytes" else pipe,
               bounds_ms=bounds, bytes=nbytes, flops=flops, exp_count=exps,
               timer_floor_ms=timer.floor_ms)
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
    nbytes = (2 * (5 * B * T * di + 4 * B * T * N) + 4 * 2 * (di * N + di)
              + 4 * 2 * B * di * N)
    return bwd_check(
        torch, timer, "ssm_scan_bwd", ssm_scan.launch_bwd,
        ssm_scan.selective_scan_bwd_plain, cases, train,
        f"x, dt, dy [{B}, {T}, {di}] bf16, B, C [{B}, {T}, {N}] views, "
        f"state [{B}, {di}, {N}] f32", nbytes, 20 * B * T * di * N,
        B * T * di * N, mufu_rate)


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
    nbytes = 2 * 9 * B * T * H * hd + 4 * 2 * H * hd + 4 * 2 * B * H * hd * hd
    return bwd_check(
        torch, timer, "wkv6_bwd", rwkv6_scan.launch_bwd,
        rwkv6_scan.wkv6_bwd_plain, cases, train,
        f"r, k, v, w, dy [{B}, {T}, {H}, {hd}] bf16, state [{B}, {H}, {hd}, "
        f"{hd}] f32", nbytes, 14 * B * T * H * hd * hd, 0, mufu_rate)


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
    nbytes = 2 * (2 * q.numel() + 2 * k.numel()) + 4 * B * H * S
    flops = 4 * B * H * hd * (S * (S + 1) // 2)
    b_ms, b_by = bound(nbytes, flops, PEAK_BF16_FLOPS)
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
    # read q, out, dout, k, v, lse; write dq, dk, dv
    nbytes = 2 * (4 * q.numel() + 4 * k.numel()) + 4 * B * H * S
    # QK^T, dO V^T, dS K, P^T dO, dS^T Q: 5 causal products
    flops = 10 * B * H * hd * (S * (S + 1) // 2)
    b_ms, b_by = bound(nbytes, flops, PEAK_BF16_FLOPS)
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


# bf16 passes of 2 R d V in the tensor-core loss kernels (split_gemm.cuh):
# the forwards' logits h w_hi + h w_mid and dw's dl_hi^T h + dl_mid^T h take
# 2; bwd_dh 5, the logits and dl_hi w_hi + dl_hi w_mid + dl_mid w_hi for dh
SPLIT_TC_PASSES = 2
BWD_DH_TC_PASSES = 5


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
    rows_io = 4 * R
    op = 2 * R * d * V
    shape = (f"hidden [{R}, {d}] bf16, "
             + (f"w = embed.T of [{V}, {d}] f32, " if tied
                else f"w = lm_head [{d}, {V}] f32, ")
             + (f"logit softcap {cap}, " if cap else "") + "tensor cores, ")
    f_bytes = 2 * R * d + 4 * V * d + 3 * rows_io + 5 * rows_io
    b_f = bound(f_bytes, SPLIT_TC_PASSES * op, PEAK_BF16_FLOPS)
    b_f_f32 = bound(f_bytes, op, PEAK_F32_FLOPS)
    # bwd_dh: recompute logits + dh = dl w^T; writes dl (R, V) and dh
    dh_bytes = 2 * R * d + 4 * V * d + 7 * rows_io + 4 * R * V + 4 * R * d
    b_dh = bound(dh_bytes, BWD_DH_TC_PASSES * op, PEAK_BF16_FLOPS)
    b_dh_f32 = bound(dh_bytes, 2 * op, PEAK_F32_FLOPS)
    # bwd_dw: dw = h^T dl; reads h and dl, writes dw (V, d)
    dw_bytes = 2 * R * d + 4 * R * V + 4 * V * d
    b_dw = bound(dw_bytes, SPLIT_TC_PASSES * op, PEAK_BF16_FLOPS)
    b_dw_f32 = bound(dw_bytes, op, PEAK_F32_FLOPS)
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
    nbytes = 2 * R * d + 4 * V * d + 4 * R + 8 * R
    b_ms, b_by = bound(nbytes, SPLIT_TC_PASSES * 2 * R * d * V,
                       PEAK_BF16_FLOPS)
    b_f32 = bound(nbytes, 2 * R * d * V, PEAK_F32_FLOPS)
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


def train_reference_case(torch, np, copris, model, tree, adam, cfg, tc,
                         phase):
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
    base = model.init_params(cfg, seed=5, device="cpu")
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
    # no attention projection and no scan parameter left at zero gradient
    watched = {"attn": ("wq", "wk", "wv", "wo"), "ssm": ("A_log", "D"),
               "tm": ("u", "w_base")}
    zero_attn = [f"layer{i}.{block}.{n}"
                 for i, layer in enumerate(gpu_grads["layers"])
                 for block, names in watched.items() if block in layer
                 for n in names
                 if float(layer[block][n].abs().max()) == 0.0]
    emit(phase, config=cfg.name, vocab=cfg.vocab_size,
         fused_loss=tc.fused_loss, metrics=sorted(res["cpu"]["metrics"]),
         batch=f"{N} x {T}", loss_gpu=res["cuda"]["loss"],
         loss_cpu=res["cpu"]["loss"], loss_err=loss_err,
         max_metric_err=m_err, max_grad_err_rel=g_err, grad_rtol=1e-4,
         grad_norm_gpu=res["cuda"]["grad_norm"],
         grad_norm_cpu=res["cpu"]["grad_norm"], grad_norm_rel_err=gn_err,
         grad_norm_rtol=1e-5, zero_watched_grads=zero_attn, atol=1e-4)
    if zero_attn:
        fail(f"attention or scan weights got zero gradient on the GPU: "
             f"{zero_attn}")
    if not (loss_err <= 1e-4 and m_err <= 1e-4 and g_err <= 1e-4
            and gn_err <= 1e-5):
        fail(f"{phase}: GPU train step disagrees with the CPU train step")


def reference_phase(torch, np, serve_mod, model, cfg, phase="reference"):
    """Engine on the GPU (kernels) vs the same engine on the CPU (plain
    versions) on a reduced config in float32, same weights and keys, over
    the dense and the paged KV cache; and the CPU paged engine against the
    CPU dense one (the same plain arithmetic: logps within 1e-6, or 1e-5
    where a recurrent state carries the paged prefill's rounding)."""
    params = model.init_params(cfg, seed=3, device="cpu")
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
                                    device=dev)
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

    cpu_atol = 1e-6 if cfg.block_pattern == ("attn",) else 1e-5
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
    emit(phase, config=cfg.name, requests=len(prompts),
         d_model=cfg.d_model, heads=cfg.num_heads, head_dim=cfg.head_dim,
         **res)
    for name, r in res.items():
        if r["equal_token_streams"] != len(prompts) \
                or not r["max_logp_err"] <= r["atol"]:
            fail(f"{phase} {name}: engines disagree on {cfg.name}")


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


def profile_phase(torch, np, serve, cfg, chunks=2, phase="profile"):
    """Where a steady decode chunk's time goes: the device profile of
    ``chunks`` ServeEngine.step() calls after 16 requests were submitted
    (a full pool on the dense cache) — host wall time per chunk, device
    busy time, top device kernels."""
    rng = np.random.default_rng(7)
    for _ in range(16):
        serve.submit(serve_request(rng, cfg))
    serve.step()                        # opens the stage: the prefill
    serve.step()                        # one warm decode chunk
    serve.eng.block_until_ready()

    def run():
        for _ in range(chunks):
            serve.step()

    wall_ms, busy_ms, events = device_profile(torch, run)
    wall_ms /= chunks
    busy_ms /= chunks
    decode_ms = sum(device_us(e) for e in events
                    if "decode_kernel" in e.key) / 1e3 / chunks
    top = sorted(events, key=device_us, reverse=True)[:8]
    emit(phase, what=f"{chunks} decode chunks of "
         f"{serve.eng.ro.decode_chunk} steps, pool 16, {cfg.name} bf16, "
         f"kv_backend {serve.eng.ro.kv_backend}",
         live_slots=sum(t is not None for t in serve.eng.slots),
         wall_ms_per_chunk=wall_ms, device_busy_ms_per_chunk=busy_ms,
         decode_attn_ms_per_chunk=decode_ms,
         device_idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
         top_device_ops=[{"name": e.key[:80], "count": e.count,
                          "ms_per_chunk": device_us(e) / 1e3 / chunks}
                         for e in top])
    serve.close()                       # in-flight requests stay buffered


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
            "off_policy_frac")
    extra = {}
    if num_layers:
        extra["depth_cut"] = f"{num_layers} of {full_layers} layers: {cut}"
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
    if not all(n > 0 for n in launches.values()):
        fail(f"a kernel of {arch}'s training path never launched: "
             f"{launches}")
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


def train_paged_phase(torch, np, kernels, steps=2):
    """This slice's main path: ``steps`` CoPRISTrainer.step() calls on
    llama3.2-1b at full width over the paged KV cache (page size 16, half
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
    cfg = get_config("llama3.2-1b")
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


def train_overlap_phase(torch, np, kernels, sft, steps=4):
    """The overlapped pipeline at full width: llama3.2-1b in the train
    phase's configuration (B 8 x G 4, N' 16, max_len 128, bf16 compute, f32
    masters, the fused loss) from the train phase's SFT-warmed weights
    (kept on the host, no second SFT), with overlap=True and
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
    cfg = get_config("llama3.2-1b")
    ro = RolloutConfig(batch_size=8, group_size=4, max_prompt_len=4,
                       max_response_len=124, concurrency=16, mode="copris",
                       temperature=1.0)
    tc = TrainConfig(lr=1e-5, warmup_steps=1, seed=0, overlap=True,
                     max_staleness=1)
    tr = CoPRISTrainer(cfg, ro, tc, AdditionTask(max_value=20, seed=0),
                       eos_id=EOS,
                       params=tree_map(lambda t: t.cuda(), sft["params"]))
    tr.batch_timeout = 600.0
    outs, launches, prof = overlapped_run(torch, tr, kernels, steps,
                                          profile=True)
    peak = torch.cuda.max_memory_allocated() / 1e9
    emit("train_overlap", arch=cfg.name, layers=cfg.num_layers,
         d_model=cfg.d_model, vocab=cfg.vocab_size, max_staleness=1,
         steps=[{k: o[k] for k in TRAIN_KEYS + STEP_REPORT} for o in outs],
         sequential_step_time=sft["step_time"], peak_mem_gb=peak,
         launches=launches)
    emit("train_overlap_profile", **prof)
    check_overlapped(np, "train_overlap", outs, launches)
    if not any(o["param_staleness"] == 1 for o in outs):
        fail("train_overlap: no batch was collected one update behind")
    ev = prof["cuda_events"]
    if not ev["update_overlap_ms"] > 0.0:
        fail(f"train_overlap: in the profiled step no collect ran on another "
             f"stream during the update: {ev}")
    return launches


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


def copris_arch_phase(torch, np, model, runs):
    """Two RolloutEngine.collect stages on each of ``runs`` ((arch,
    resume strategy, kernels, phase)) at full width with random bf16
    weights: hymba-1.5b resumes with kv_snapshot (the snapshot carries the
    ssm / conv state beside the K/V), rwkv6-1.6b and paper-qwen-7b
    re-prefill. max_len 256 < the 192 + 128 budget, so a group's stop
    length depends on its prompt: groups finish at different times, early
    termination evicts, the next stage resumes."""
    from repro_torch.common.config import RolloutConfig
    from repro_torch.configs import get_config
    from repro_torch.core.rollout import RolloutEngine
    from repro_torch.sampling import prng
    for arch, strategy, kernels, phase in runs:
        gc.collect()
        torch.cuda.empty_cache()
        cfg = get_config(arch)
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
        emit(phase, arch=arch, resume_strategy=strategy, stages=stages)
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
    forward's decode and prefill kernels and the backward kernels), by
    instantiation: {"wkv6_scan_kernel<bf16,64>": [regs, st, ld, smem]};
    for the backward kernels, which take all theirs dynamically, the bytes
    they launch with (as their chunk queries report them)."""
    import ctypes
    import re
    out = {}

    def smem_of(query, *args):
        n = ctypes.c_int()
        query(*args, ctypes.addressof(n))
        return n.value

    smem_bwd = {
        "ssm_scan_bwd_kernel": lambda dtype, n: smem_of(
            build.library("ssm_scan").ssm_scan_bwd_chunk, n,
            dtype == "bf16"),
        "wkv6_bwd_kernel": lambda dtype, hd: smem_of(
            build.library("wkv6").wkv6_bwd_chunk, hd)}
    for name in ("ssm_scan", "wkv6"):
        log = build.library_log(name)
        for entry, body in re.findall(
                r"Compiling entry function '(\S+)'(.*?)(?=Compiling entry|\Z)",
                log, re.S):
            m = re.search(r"((?:ssm|wkv6)_(?:step|scan|scan_bwd|bwd)"
                          r"_kernel)I(f|13__nv_bfloat16)Li(\d+)E", entry)
            regs = re.search(r"Used (\d+) registers", body)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", body)
            smem = re.search(r"(\d+) bytes smem", body)
            if m and regs and spill:
                dtype = "f32" if m.group(2) == "f" else "bf16"
                nbytes = (smem_bwd[m.group(1)](dtype, int(m.group(3)))
                          if m.group(1) in smem_bwd
                          else int(smem.group(1)) if smem else 0)
                out[f"{m.group(1)}<{dtype},{m.group(3)}>"] = [
                    int(regs.group(1)), int(spill.group(1)),
                    int(spill.group(2)), nbytes]
    return out


SPLIT_COUNTS = ("simt_launches", "decode_launches", "prefill_launches",
                "bwd_launches")


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
    scans' backward kernels too, as "<name>_bwd"). Every phase that reads
    them runs in bf16, so none may have gone to an f32 SIMT flash or loss
    kernel: those wrappers' launches are then all tensor-core launches."""
    simt = {name: fn.simt_launches for name, fn in kernels.items()
            if getattr(fn, "simt_launches", 0)}
    if simt:
        fail(f"an f32 SIMT kernel ran on a bf16 path: {simt}")
    out = {name: fn.launches for name, fn in kernels.items()}
    if backward:
        out.update({f"{name}_bwd": fn.bwd_launches
                    for name, fn in kernels.items()
                    if hasattr(fn, "bwd_launches")})
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
    from repro_torch.configs import get_smoke_config
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
    # bf16 bwd_dh kernels issue wgmma (HGMMA)
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

    # 3. kernel checks at the main path's shapes
    timer = Timer(torch)
    checks = {"flash_attn": check_flash_prefill(
                  torch, F, timer, flash_attn, 32, 8, 64,
                  phase="check_flash_attn"),
              "decode_attn": check_decode(torch, F, timer, decode_attn),
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

    profile_phase(torch, np, serve, cfg)
    serve_paged_phase(torch, np, serve_mod, serve_paged_kernels, dense_serve)

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
    hymba_launches, hymba_by_length = serve_arch_phase(
        torch, np, serve_mod, "hymba-1.5b", hymba_kernels, "serve_hymba")
    # 40% of the dense-equivalent 16 x 640 / 16 = 640 pages
    serve_arch_phase(torch, np, serve_mod, "hymba-1.5b",
                       hymba_paged_kernels, "serve_hymba_paged",
                       kv_backend="paged", kv_num_pages=256)
    rwkv_launches, rwkv_by_length = serve_arch_phase(
        torch, np, serve_mod, "rwkv6-1.6b", rwkv_kernels, "serve_rwkv6")
    copris_arch_phase(torch, np, model, (
        ("hymba-1.5b", "kv_snapshot", hymba_kernels, "copris_hybrid"),
        ("rwkv6-1.6b", "reprefill", rwkv_kernels, "copris_hybrid")))

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
    del sft
    train_paged_launches = train_paged_phase(torch, np, train_paged_kernels)
    train_simt["fused_logprob"] = flp.fused_logprob_rows.simt_launches

    # 7b. the hybrid families trained at full width: the scans' forward
    # and backward kernels
    hymba_train = train_phase(torch, np, hymba_train_kernels,
                              arch="hymba-1.5b", phase="train_hymba",
                              steps=2, seed=2, entropy_coef=0.01)
    rwkv_train = train_phase(torch, np, rwkv_train_kernels,
                             arch="rwkv6-1.6b", phase="train_rwkv6",
                             steps=2, seed=2, entropy_coef=0.01)

    # 7c. the wide-head archs through the same entry points: paper-qwen-7b
    # (the paper's model: 28/4 heads of 128) served at full depth over the
    # dense cache and at 14 of its 28 layers over the paged one, two CoPRIS
    # stages, trained at 4 of its 28 layers; gemma2-2b (8/4 of 256, softcaps, local window) served over
    # the dense cache and trained at full depth (its paged decode is held
    # to the dense kernel bit for bit in the kernel checks); qwen3-14b
    # (40/8 of 128, qk_norm) served at 20 of its 40 layers; granite-34b
    # (48/1 of 128) at 24 of its 88; musicgen-medium (24/24 of 64, V 2048:
    # the full-logits loss) served and trained at 24 of its 48
    musicgen_train_kernels = {
        **kernels, "flash_attn_bwd": flash_attn.flash_attention_bwd}
    # the paged paper-qwen-7b, qwen3-14b and musicgen-medium at half depth:
    # the whole run took 647 s with the last two at full depth and 633 s
    # with them at half depth and the paged paper-qwen-7b at full depth,
    # over the ~600 s it aims at; no kernel's shape depends on the depth
    time_cut = "the run's time (no kernel's shape depends on the depth)"
    wide = {}
    wide["serve_qwen7b"] = serve_arch_phase(
        torch, np, serve_mod, "paper-qwen-7b", kernels, "serve_qwen7b")[0]
    wide["serve_qwen7b_paged"] = serve_arch_phase(
        torch, np, serve_mod, "paper-qwen-7b", serve_paged_kernels,
        "serve_qwen7b_paged", kv_backend="paged", kv_num_pages=256,
        num_layers=14, cut=time_cut)[0]
    copris_arch_phase(torch, np, model, (
        ("paper-qwen-7b", "reprefill", kernels, "copris_qwen7b"),))
    wide["train_qwen7b"] = train_phase(
        torch, np, train_kernels, arch="paper-qwen-7b", phase="train_qwen7b",
        steps=2, seed=2, entropy_coef=0.01, num_layers=4,
        cut="the full depth's training state (~122 GB) does not fit the card")
    wide["serve_gemma2"] = serve_arch_phase(
        torch, np, serve_mod, "gemma2-2b", kernels, "serve_gemma2")[0]
    wide["train_gemma2"] = train_phase(
        torch, np, train_kernels, arch="gemma2-2b", phase="train_gemma2",
        steps=2, seed=2, entropy_coef=0.01)
    wide["serve_qwen3_14b"] = serve_arch_phase(
        torch, np, serve_mod, "qwen3-14b", kernels, "serve_qwen3_14b",
        num_layers=20, cut=time_cut)[0]
    wide["serve_granite"] = serve_arch_phase(
        torch, np, serve_mod, "granite-34b", kernels, "serve_granite",
        num_layers=24,
        cut="the full depth's bf16 weights (93.9 GB) do not fit the card")[0]
    wide["serve_musicgen"] = serve_arch_phase(
        torch, np, serve_mod, "musicgen-medium", kernels, "serve_musicgen",
        num_layers=24, cut=time_cut)[0]
    # one step: a rollout of 48 layers at 124 tokens took ~22 s
    wide["train_musicgen"] = train_phase(
        torch, np, musicgen_train_kernels, arch="musicgen-medium",
        phase="train_musicgen", steps=1, seed=2, entropy_coef=0.01,
        num_layers=24, cut=time_cut)
    new_launches.update(wide)

    # 8. kernels line: launches from the train phase, from train_paged for
    # the paged decode and the fused log-prob, from serve_hymba and
    # serve_rwkv6 for the two scans, from train_hymba and train_rwkv6 for
    # their backward kernels; times from the checks at the train phase's
    # shapes (flash forward with lse, its backward, the loss kernels, the
    # scans' backward kernels) and at the serve phases' (decode, paged
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
                        "src/repro/models/rwkv6.py:64", "wkv6_bwd")}
    launches = {**train_launches,
                "paged_decode_attn": train_paged_launches["paged_decode_attn"],
                "fused_logprob": train_paged_launches["fused_logprob"],
                "ssm_scan": hymba_launches["ssm_scan"],
                "wkv6": rwkv_launches["wkv6"],
                "ssm_scan_bwd": hymba_train["ssm_scan_bwd"],
                "wkv6_bwd": rwkv_train["wkv6_bwd"]}
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
                    "bounds_ms", "bit_equal_launches"):
            if key in c:
                row[key] = c[key]
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
        wide_rows = {}
        for arch, c in wide_checks.items():
            entry = {}
            for key, label in ((name, "check"),
                               (f"{name}_prefill", "prefill")):
                if key not in c:
                    continue
                phase = WIDE_LAUNCHES.get((arch, key))
                entry[label] = dict(
                    {k: c[key].get(k) for k in (
                        "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library", "library_ms",
                        "library_err", "library_failed", "library_options",
                        "default_options_failed", "vs_library",
                        "bit_equal_launches",
                        "diff_from_dense_kernel", "dense_kernel_ms",
                        "sdpa_without_softcap_ms") if k in c[key]},
                    launches=wide[phase][name] if phase else None,
                    launches_of=phase)
            if entry:
                wide_rows[arch] = entry
        if wide_rows:
            # the same kernel at the wide heads' shapes, with the launches
            # of the phase that runs that shape on the main path
            row["wide_heads"] = wide_rows
        if name in by_length:
            row["launches_by_length"] = by_length[name]
            pre = scans[name]["prefill"]
            row["prefill"] = {key: pre[key] for key in (
                "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "bound_by", "bound_pipe", "bounds_ms")}
        rows.append(row)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# which phase's launches stand beside a wide-head check in the kernels line:
# (arch, check) -> phase; a check with no phase (the paged decode of every
# arch but paper-qwen-7b) is not on any path of this run
WIDE_LAUNCHES = {
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
        block = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "", block)
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
    points are the same), timed in turns: flash forward with lse at the
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


def ab_main(parent) -> int:
    """``python3 chip_smoke.py --ab PARENT``: this tree's attention kernels
    (flash forward and backward, dense and paged decode) and loss kernels
    at llama3.2-1b's shapes, with their SASS compared function by function
    (ab_attention_loss), then its sampling kernel,
    selective scan (decode and prefill) and WKV6 (decode and prefill)
    against those of the checkout at PARENT (both built here), timed in
    turns (parent, change, change, parent) at the main paths' shapes, with
    the SASS opcode counts of both trees' scan kernels; then this tree's
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
    # the parent's forward entry points take this tree's arguments
    old_sample, old_scan, old_wkv = (
        parent_library(build, parent, name, {fn: build.KERNELS[name][fn]})
        for name, fn in (("fused_sample", "fused_sample_rows"),
                         ("ssm_scan", "ssm_scan_fwd"), ("wkv6", "wkv6_fwd")))
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
    sys.exit(main())
