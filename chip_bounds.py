#!/usr/bin/env python3
"""The in-bounds half of PAL205 on the card: every hand kernel family of
the port at the reference's PAL205 harness shapes
(``repro.analysis.irlint``'s ``_harness_*``: the shapes only, copied; the
paged cache at the port's largest page, 32 positions, for the same lengths
and sentinel entries), run under ``compute-sanitizer --tool memcheck``.
The reference proves its Pallas index maps in bounds over the grid; the
port's kernels compute their addresses in CUDA C++, so the proof here is
that no access of any kernel falls outside an allocation on the card.

    python3 chip_bounds.py             # one H100; builds the kernels first

The script builds every library (``hopper/build.build_all``), runs the
families once plainly (each output finite), then runs itself again with
``--families`` under memcheck, with PyTorch's caching allocator off
(``PYTORCH_NO_CUDA_MEMORY_CACHING=1``: every tensor an allocation of its
own, so a read or write past a tensor is outside any allocation). It
prints a line a family and one ``{"memcheck": ...}`` line with the
sanitizer's error count, then the card's name and power limit and, last,
``{"ok": true, "device": {...}}``. It fails when ``compute-sanitizer`` is
missing or does not run, when it reports an error, or when a family fails.
The sanitizer's whole output goes to ``build/chip_bounds_memcheck.log``.

Families: decode_attn (B 2, H 8, KV 2, hd 128, L 2048, lengths 2048 and
1024, bf16); paged_decode_attn (the same heads, 28 pages of 32, 16 pages a
row, lengths 379 and 256, sentinel entries past them); flash_attn forward
with lse and backward (1 x 1024 x 4 heads of 128, bf16, causal);
fused_logprob and fused_is_grpo forward, backward dh and dw (R 512, d 1024,
V 4096; bf16 hidden on the tensor cores and float32 hidden on the SIMT
kernels); fused_sample (64 rows x V 4096, temperature 0.8, top-k 50,
top-p 0.9); ssm_scan forward (the prefill kernel and the decode kernel)
and its backward under autograd (B 2, T 512, di 512, N 16, float32); wkv6
likewise (B 1, T 512, H 4, hd 64, float32).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MEMCHECK_TIMEOUT_S = 900
FAMILIES = ("decode_attn", "paged_decode_attn", "flash_attn",
            "fused_logprob", "fused_is_grpo", "fused_sample", "ssm_scan",
            "wkv6")


def families(torch):
    """{name: thunk} in the order of FAMILIES: each runs its family's
    wrappers on tensors on the card and returns the outputs to check."""
    from repro_torch.hopper import (decode_attn, flash_attn, fused_logprob,
                                    fused_sample, paged_decode_attn,
                                    rwkv6_scan, ssm_scan)
    from repro_torch.hopper import fused_is_grpo as fio
    device = "cuda"
    g = torch.Generator(device=device).manual_seed(0)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, device=device, generator=g)
                * scale).to(dtype)

    bf16 = torch.bfloat16

    def decode():
        B, H, KV, hd, L = 2, 8, 2, 128, 2048
        q = randn(B, 1, H, hd, dtype=bf16)
        k, v = randn(B, L, KV, hd, dtype=bf16), randn(B, L, KV, hd,
                                                      dtype=bf16)
        cl = torch.tensor([L, L // 2], dtype=torch.int32, device=device)
        return [decode_attn.decode_attention(q, k, v, cl)]

    def paged():
        B, H, KV, hd, NP, ps, mp = 2, 8, 2, 128, 28, 32, 16
        q = randn(B, 1, H, hd, dtype=bf16)
        k, v = (randn(NP, ps, KV, hd, dtype=bf16) for _ in range(2))
        # rows of 12 and 8 pages, then the sentinel NP
        bt = torch.full((B, mp), NP, dtype=torch.int32)
        bt[0, :12] = torch.arange(12)
        bt[1, :8] = torch.arange(12, 20)
        cl = torch.tensor([12 * ps - 5, 8 * ps], dtype=torch.int32)
        return [paged_decode_attn.paged_decode_attention(
            q, k, v, bt.to(device), ps, cl.to(device))]

    def flash():
        q, k, v = (randn(1, 1024, 4, 128, dtype=bf16) for _ in range(3))
        out, lse = flash_attn.flash_attention(q, k, v, return_lse=True)
        dout = randn(1, 1024, 4, 128, dtype=bf16)
        return [out, lse, *flash_attn.flash_attention_bwd(q, k, v, out, lse,
                                                          dout)]

    R, d, V = 512, 1024, 4096

    def rows():
        w = randn(d, V, scale=0.02)
        t = torch.randint(0, V, (R,), device=device, generator=g)
        return w, t

    def logprob():
        w, t = rows()
        return [o for dt in (bf16, torch.float32)
                for o in fused_logprob.fused_logprob_rows(
                    randn(R, d, dtype=dt), w, t)]

    def is_grpo():
        w, t = rows()
        beh, adv = randn(R, scale=0.3) - 11.0, randn(R)
        out = []
        for dt in (bf16, torch.float32):
            h = randn(R, d, dtype=dt)
            _, _, _, lse, ent = fwd = fio.fused_is_grpo_fwd_rows(
                h, w, t, beh, adv, logit_softcap=30.0, entropy_coef=0.01)
            dl, dh = fio.fused_is_grpo_bwd_dh_rows(
                h, w, t, lse, lse - ent, randn(R), randn(R, scale=0.1),
                logit_softcap=30.0)
            out += [*fwd, dl, dh,
                    fio.fused_is_grpo_bwd_dw_rows(h, dl, torch.empty_like(w))]
        return out

    def sample():
        keys = torch.randint(0, 2**31, (64, 2), device=device,
                             generator=g).to(torch.uint32)
        return list(fused_sample.sample_rows(
            keys, randn(64, 4096), temperature=0.8, top_k=50, top_p=0.9))

    def scan():
        B, T, di, N = 2, 512, 512, 16
        x, dt = randn(B, T, di), randn(B, T, di, scale=0.1).abs()
        A_log, D = randn(di, N, scale=0.5), randn(di)
        Bc, Cc = randn(B, T, N), randn(B, T, N)
        s0 = randn(B, di, N, scale=0.1)
        y, s = ssm_scan.selective_scan(x, dt, A_log, Bc, Cc, D, s0.clone())
        y1, s1 = ssm_scan.selective_scan(
            *(a[:, :1].contiguous() for a in (x, dt)), A_log,
            *(a[:, :1].contiguous() for a in (Bc, Cc)), D, s0.clone())
        ins = [a.clone().requires_grad_() for a in (x, dt, A_log, Bc, Cc, D,
                                                     s0)]
        with torch.enable_grad():
            yg, sg = ssm_scan.selective_scan(*ins)
            (yg.square().sum() + sg.sum()).backward()
        return [y, s, y1, s1, *(a.grad for a in ins)]

    def wkv():
        B, T, H, hd = 1, 512, 4, 64
        r, k, v = (randn(B, T, H, hd, scale=0.3) for _ in range(3))
        w = torch.sigmoid(randn(B, T, H, hd)) * 0.5 + 0.45
        u, s0 = randn(H, hd, scale=0.3), randn(B, H, hd, hd, scale=0.2)
        y, s = rwkv6_scan.wkv6(r, k, v, w, u, s0.clone())
        y1, s1 = rwkv6_scan.wkv6(
            *(a[:, :1].contiguous() for a in (r, k, v, w)), u, s0.clone())
        ins = [a.clone().requires_grad_() for a in (r, k, v, w, u, s0)]
        with torch.enable_grad():
            yg, sg = rwkv6_scan.wkv6(*ins)
            (yg.square().sum() + sg.sum()).backward()
        return [y, s, y1, s1, *(a.grad for a in ins)]

    return {"decode_attn": decode, "paged_decode_attn": paged,
            "flash_attn": flash, "fused_logprob": logprob,
            "fused_is_grpo": is_grpo, "fused_sample": sample,
            "ssm_scan": scan, "wkv6": wkv}


def run_families() -> int:
    """Every family once on the card; a JSON line each. Exit 1 on a
    non-finite output."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    bad = []
    for name, thunk in families(torch).items():
        t0 = time.perf_counter()
        outs = thunk()
        torch.cuda.synchronize()
        finite = all(bool(torch.isfinite(o.float()).all()) for o in outs
                     if o is not None and o.is_floating_point())
        print(json.dumps({"family": name, "outputs": len(outs),
                          "finite": finite,
                          "seconds": time.perf_counter() - t0}), flush=True)
        if not finite:
            bad.append(name)
    if bad:
        print(f"chip_bounds: non-finite outputs in {bad}", file=sys.stderr)
        return 1
    return 0


def sanitizer() -> str:
    for path in (shutil.which("compute-sanitizer"),
                 "/usr/local/cuda/bin/compute-sanitizer",
                 "/usr/local/cuda/compute-sanitizer/compute-sanitizer"):
        if path and os.path.exists(path):
            return path
    return ""


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_bounds: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_bounds: run from the root of a repository checkout "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    tool = sanitizer()
    if not tool:
        print("chip_bounds: compute-sanitizer not found (PATH, "
              "/usr/local/cuda/bin): the memcheck pass cannot run",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.hopper import build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    secs = build.build_all()
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "per_source": secs}), flush=True)
    me = [sys.executable, str(ROOT / "chip_bounds.py"), "--families"]
    plain = subprocess.run(me, cwd=ROOT, capture_output=True, text=True,
                           timeout=600)
    print(plain.stdout, end="", flush=True)
    if plain.returncode != 0:
        print(f"chip_bounds: the families failed without the sanitizer "
              f"({plain.returncode}): {plain.stderr[-3000:]}",
              file=sys.stderr)
        return 1
    env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1")
    log = ROOT / "build" / "chip_bounds_memcheck.log"
    t0 = time.perf_counter()
    try:
        run = subprocess.run(
            [tool, "--tool", "memcheck", "--error-exitcode", "99",
             "--print-limit", "50", *me], cwd=ROOT, env=env,
            capture_output=True, text=True, timeout=MEMCHECK_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        print(f"chip_bounds: memcheck timed out after {e.timeout} s",
              file=sys.stderr)
        return 1
    wall = time.perf_counter() - t0
    log.write_text(run.stdout + "\n--- stderr ---\n" + run.stderr)
    summary = re.findall(r"ERROR SUMMARY: (\d+) error", run.stdout
                         + run.stderr)
    ran = [json.loads(x)["family"] for x in run.stdout.splitlines()
           if x.startswith('{"family"')]
    errors = int(summary[-1]) if summary else None
    # the sanitizer's own refusals ("Error: Device not supported ..."): then
    # no kernel was checked, whatever the error count says
    refused = re.findall(r"=+ Error: (.*)", run.stdout + run.stderr)
    print(json.dumps({"memcheck": {
        "tool": tool, "exit_code": run.returncode, "errors": errors,
        "sanitizer_refused": refused,
        "families": ran, "seconds": wall,
        "caching_allocator": "off (PYTORCH_NO_CUDA_MEMORY_CACHING=1)",
        "log": str(log.relative_to(ROOT))}}), flush=True)
    if errors is None or run.returncode != 0 or errors != 0 or refused \
            or tuple(ran) != FAMILIES:
        print(f"chip_bounds: memcheck did not pass: exit "
              f"{run.returncode}, errors {errors}, families {ran}; tail:\n"
              f"{(run.stdout + run.stderr)[-4000:]}", file=sys.stderr)
        return 1
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--families"]:
        sys.exit(run_families())
    sys.exit(main())
