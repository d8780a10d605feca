#!/usr/bin/env python3
"""On-GPU smoke run of the PyTorch port (src/repro_torch): the serving path
at the full width of llama3.2-1b, through the port's hand-written kernels.

    python3 chip_smoke.py          # from the root of a checkout, one GPU

Phases, each printed as one JSON line:

1. device  — the card's name and power limit (nvidia-smi);
2. build   — nvcc builds every kernel of the path from csrc/, in parallel;
3. kernel checks — each kernel against its plain PyTorch version at the
   main path's shapes, with its time, the plain version's, one library
   call's where PyTorch has one, and the least time the card could take;
4. reference — the GPU engine (kernels, float32) against the same engine on
   the CPU (plain versions) on the reduced config: equal tokens;
5. serve   — make_serve_engine("llama3.2-1b") with random bf16 weights made
   from a seed serves 48 requests; every kernel's launch count must be > 0;
   then "profile": torch.profiler over two steady decode chunks (host time,
   device busy time, top device kernels);
6. copris  — two RolloutEngine.collect stages: the first buffers partials
   (early termination), the second resumes them;
7. kernels — one {"kernels": [...]} line for the three kernels;

then the card's nvidia-smi line and, last, {"ok": true, "device": {...}}.
Any failed check raises, so the run exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor cores
PEAK_F32_FLOPS = 67e12              # H100 SXM float32 outside tensor cores


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: {msg}")


def bound(nbytes, flops, peak_flops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Timer:
    """Median device time of a callable, one CUDA-event pair per call, with
    the L2 cache flushed (a 64 MB write) before every call, so inputs come
    from device memory as they do on the main path."""

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(64 << 20, dtype=torch.uint8,
                                     device="cuda")

    def __call__(self, fn, iters=10, warmup=2):
        torch = self.torch
        for _ in range(warmup):
            fn()
        ts = []
        for _ in range(iters):
            self.flush_buf.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        return statistics.median(ts)


def check_flash(torch, F, timer, flash_attn):
    B, S, H, KV, hd = 16, 512, 32, 8, 64       # initial fill: 16 rows x 512
    g = torch.Generator(device="cuda").manual_seed(10)
    q = torch.randn(B, S, H, hd, device="cuda", generator=g).bfloat16()
    k = torch.randn(B, S, KV, hd, device="cuda", generator=g).bfloat16()
    v = torch.randn(B, S, KV, hd, device="cuda", generator=g).bfloat16()
    out = flash_attn.flash_attention(q, k, v, causal=True)
    ref = flash_attn.flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    atol = 2e-2
    if not err <= atol:
        fail(f"flash_attn disagrees with its plain version: {err} > {atol}")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kernel_ms = timer(lambda: flash_attn.flash_attention(q, k, v, causal=True))
    plain_ms = timer(lambda: flash_attn.flash_attention_plain(
        q, k, v, causal=True), iters=3, warmup=1)
    library_ms = timer(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    nbytes = 2 * (2 * q.numel() + 2 * k.numel())
    flops = 4 * B * H * hd * (S * (S + 1) // 2)
    b_ms, b_by = bound(nbytes, flops, PEAK_BF16_FLOPS)
    res = dict(shape=f"q {list(q.shape)} kv {list(k.shape)} bf16 causal",
               max_abs_err=err, atol=atol, ms=kernel_ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)
    emit("check_flash_attn", **res)
    return res


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
               library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)
    emit("check_decode_attn", **res)
    return res


def check_sample(torch, timer, fused_sample, prng):
    R, V = 16, 128256                          # serve pool x llama vocab
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
               library_ms=None, bound_ms=b_ms, bound_by=b_by)
    emit("check_fused_sample", **res)
    return res


def reference_phase(torch, np, serve_mod, model, get_smoke_config):
    """Engine on the GPU (kernels) vs the same engine on the CPU (plain
    versions), reduced llama3.2-1b in float32, same weights and keys."""
    cfg = get_smoke_config("llama3.2-1b")
    params = model.init_params(cfg, seed=3, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size - 1, int(n))
               for n in rng.integers(8, 60, 6)]
    outs = {}
    for dev in ("cuda", "cpu"):
        ro = serve_mod.RolloutConfig(
            batch_size=1, group_size=1, max_prompt_len=64,
            max_response_len=24, concurrency=4, mode="copris",
            temperature=0.8, top_k=50, top_p=0.95)
        eng = serve_mod.ServeEngine(cfg, ro, eos_id=cfg.vocab_size - 1,
                                    params=params,
                                    key=serve_mod.prng.PRNGKey(9),
                                    device=dev)
        for p in prompts:
            eng.submit(serve_mod.GenerateRequest(prompt=p))
        outs[dev] = {r.request_id: r for r in eng.drain()}
        eng.close()
    same = sum(outs["cuda"][i].tokens == outs["cpu"][i].tokens
               for i in outs["cpu"])
    lp_err = max(max(abs(a - b) for a, b in zip(outs["cuda"][i].logprobs,
                                                outs["cpu"][i].logprobs))
                 for i in outs["cpu"])
    emit("reference", config=cfg.name, requests=len(prompts),
         equal_token_streams=same, max_logp_err=lp_err, atol=1e-3)
    if same != len(prompts) or not lp_err <= 1e-3:
        fail("GPU engine disagrees with the CPU engine on the reduced config")


def profile_phase(torch, np, serve, cfg, chunks=2):
    """Where a steady decode chunk's time goes: torch.profiler over
    ``chunks`` ServeEngine.step() calls with a full pool of 16 requests —
    host wall time per chunk, device busy time, top device kernels."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(7)
    for _ in range(16):
        serve.submit(serve_request(rng, cfg))
    serve.step()                        # opens the stage: the prefill
    serve.step()                        # one warm decode chunk
    serve.eng.block_until_ready()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(chunks):
            serve.step()
        serve.eng.block_until_ready()
        wall_ms = (time.perf_counter() - t0) * 1e3 / chunks

    def dev_us(e):
        for name in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, name):
                return getattr(e, name)
        return 0.0

    # device kernels only: host ops also carry the time of the kernels they
    # launched, which would count every kernel twice
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None)
              == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in events) / 1e3 / chunks
    top = sorted(events, key=dev_us, reverse=True)[:8]
    emit("profile", what=f"{chunks} decode chunks of "
         f"{serve.eng.ro.decode_chunk} steps, pool 16, llama3.2-1b bf16",
         wall_ms_per_chunk=wall_ms, device_busy_ms_per_chunk=busy_ms,
         device_idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
         top_device_ops=[{"name": e.key[:80], "count": e.count,
                          "ms_per_chunk": dev_us(e) / 1e3 / chunks}
                         for e in top])
    serve.close()                       # in-flight requests stay buffered


def serve_request(rng, cfg, lo=64, hi=512):
    from repro_torch.launch.serve import GenerateRequest
    n = int(rng.integers(lo, hi + 1))
    return GenerateRequest(prompt=rng.integers(0, cfg.vocab_size - 1, n))


def reset_launches(kernels):
    for fn in kernels.values():
        fn.launches = 0


def read_launches(kernels):
    return {name: fn.launches for name, fn in kernels.items()}


def main() -> int:
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

    from repro_torch.common.config import RolloutConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.rollout import RolloutEngine
    from repro_torch.hopper import build, decode_attn, flash_attn, fused_sample
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import model
    from repro_torch.sampling import prng

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, kind=kind,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # 2. build
    t0 = time.perf_counter()
    secs = build.build_all()
    emit("build", seconds=time.perf_counter() - t0, per_source=secs)

    # 3. kernel checks at the main path's shapes
    timer = Timer(torch)
    checks = {"flash_attn": check_flash(torch, F, timer, flash_attn),
              "decode_attn": check_decode(torch, F, timer, decode_attn),
              "fused_sample": check_sample(torch, timer, fused_sample, prng)}
    kernels = {"flash_attn": flash_attn.flash_attention,
               "decode_attn": decode_attn.decode_attention,
               "fused_sample": fused_sample.sample_rows}

    # 4. GPU engine vs CPU engine on the reduced config
    reference_phase(torch, np, serve_mod, model, get_smoke_config)

    # 5. serve at full width (the main path)
    serve, cfg = serve_mod.make_serve_engine(
        "llama3.2-1b", max_prompt_len=512, max_tokens=128, concurrency=16,
        temperature=0.8, top_k=50, top_p=0.95, seed=0)
    if (cfg.num_layers, cfg.d_model, cfg.vocab_size) != (16, 2048, 128256):
        fail(f"not the full llama3.2-1b width: {cfg}")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size - 1, int(n))
               for n in rng.integers(64, 513, 48)]
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
    if sorted(r.request_id for r in results) != list(range(len(prompts))):
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

    # 7. kernels line
    src = {"flash_attn": ("src/repro_torch/csrc/flash_attn.cu",
                          "src/repro/kernels/flash_attn/flash_attn.py:79"),
           "decode_attn": ("src/repro_torch/csrc/decode_attn.cu",
                           "src/repro/kernels/decode_attn/decode_attn.py:74"),
           "fused_sample": ("src/repro_torch/csrc/fused_sample.cu",
                            "src/repro/kernels/fused_sample/fused_sample.py"
                            ":231")}
    rows = []
    for name, (source_path, replaces) in src.items():
        c = checks[name]
        rows.append({"name": name, "route": "cuda", "source": source_path,
                     "replaces": replaces, "launches": serve_launches[name],
                     "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                     "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                     "bound_by": c["bound_by"],
                     "library_ms": c["library_ms"]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
