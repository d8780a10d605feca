"""Run some phases of ``chip_smoke.py`` alone on one GPU, for a quick
check of the paths they drive: the kernels are built from the checkout,
then each named phase runs as in the full script and prints its JSON line.

    python3 chip_phases.py [moe_ep] [sharded] [disagg] [multihost]
                           [decode_split] [serve_sharded] [copris_sharded]
                           [serve_sharded_kinds] [dryrun] [disagg_mesh]
                           [pal205]

``moe_ep``: ``train_moe_ep``; ``sharded``: ``train_sharded``; ``disagg``:
``train`` (its SFT-warmed weights), ``train_overlap`` and
``train_disaggregated``; ``multihost``: the torchrun launcher;
``decode_split``: the dense decode kernel's lse and the length split's
checks; ``serve_sharded``: the ``serve`` phase (its profile included,
with IR403's guarded decode chunk), then ``serve_sharded``; ``pal205``:
each built library's kernels against the card's limits; ``copris_sharded``: the trainer on a (1, 1) mesh
against the unsharded one; ``serve_sharded_kinds``: sharded serving of
hymba, rwkv6, deepseek-moe and the VLM, the one-slot ``shard_seq`` pools
and the GQA serve mesh, each run with its steady-chunk host and device
times beside the unsharded engine's; ``dryrun``: ``train_sharded``, then
the ``dryrun`` phase against it; ``disagg_mesh``: ``train``,
``train_disaggregated``, then ``train_disaggregated_mesh`` (train and
rollout in two processes on meshes of their own). With no name, the first
four. The last line is
``ALL OK`` when every phase passed; a failing phase exits non-zero, as in
``chip_smoke.py``.
"""
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.hopper import build, decode_attn, flash_attn, fused_sample  # noqa: E402
from repro_torch.hopper import fused_is_grpo as fio  # noqa: E402


def main(names):
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    build.build_all()
    print("build", time.perf_counter() - t0, flush=True)
    kernels = {"flash_attn": flash_attn.flash_attention,
               "decode_attn": decode_attn.decode_attention,
               "fused_sample": fused_sample.sample_rows}
    loss_kernels = {"fused_is_grpo_fwd": fio.fused_is_grpo_fwd_rows,
                    "fused_is_grpo_bwd_dh": fio.fused_is_grpo_bwd_dh_rows,
                    "fused_is_grpo_bwd_dw": fio.fused_is_grpo_bwd_dw_rows}
    train_kernels = {**kernels,
                     "flash_attn_bwd": flash_attn.flash_attention_bwd,
                     **loss_kernels}
    for name in names or ["moe_ep", "sharded", "disagg", "multihost"]:
        t = time.perf_counter()
        if name == "moe_ep":
            cs.train_moe_ep_phase(torch, np, {
                "flash_attn": flash_attn.flash_attention,
                "flash_attn_bwd": flash_attn.flash_attention_bwd,
                **loss_kernels})
        elif name == "sharded":
            cs.train_sharded_phase(torch, np, train_kernels)
        elif name == "dryrun":
            keep = {}
            launches = cs.train_sharded_phase(torch, np, train_kernels,
                                              keep=keep)
            cs.dryrun_phase(torch, launches, keep["peak_gb"])
        elif name == "disagg":
            sft = {}
            cs.train_phase(torch, np, train_kernels, keep=sft)
            cs.train_overlap_phase(torch, np, train_kernels, sft)
            cs.train_disaggregated_phase(torch, np, train_kernels, sft)
        elif name == "disagg_mesh":
            sft = {}
            cs.train_phase(torch, np, train_kernels, keep=sft)
            cs.train_disaggregated_phase(torch, np, train_kernels, sft)
            cs.train_disaggregated_mesh_phase(torch, np, sft)
        elif name == "multihost":
            cs.multihost_phase(np)
        elif name == "pal205":
            cs.pal205_phase()
        elif name == "decode_split":
            import torch.nn.functional as F
            timer = cs.Timer(torch)
            cs.check_decode(torch, F, timer, decode_attn)
            cs.check_decode_split(torch, timer, decode_attn, 32, 8, 64,
                                  "llama")
            cs.check_decode_split(torch, timer, decode_attn, 48, 1, 128,
                                  "granite")
        elif name == "serve_sharded":
            serve_dense_then_sharded(kernels)
        elif name == "copris_sharded":
            cs.copris_sharded_phase(torch, np, train_kernels)
        elif name == "serve_sharded_kinds":
            from repro_torch.hopper import rwkv6_scan, ssm_scan
            from repro_torch.launch import serve as serve_mod
            cs.serve_sharded_kinds_phase(
                torch, np, serve_mod, {**kernels,
                                       "ssm_scan": ssm_scan.selective_scan,
                                       "wkv6": rwkv6_scan.wkv6},
                profile=True)
        else:
            raise SystemExit(f"chip_phases: unknown phase {name}")
        print("phase", name, time.perf_counter() - t, flush=True)
    print("ALL OK", flush=True)


def serve_dense_then_sharded(kernels):
    """The ``serve`` phase's 24 requests (and its steady-chunk profile,
    with IR403's guarded chunk), then ``serve_sharded``."""
    from repro_torch.launch import serve as serve_mod
    serve, cfg = serve_mod.make_serve_engine(
        "llama3.2-1b", max_prompt_len=512, max_tokens=128, concurrency=16,
        temperature=0.8, top_k=50, top_p=0.95, seed=0)
    for p in cs.serve_prompts(np, cfg):
        serve.submit(serve_mod.GenerateRequest(prompt=p))
    t0 = time.perf_counter()
    results = serve.drain()
    serve.eng.block_until_ready()
    wall = time.perf_counter() - t0
    ntok = cs.check_results(np, results, cfg, len(results))
    cs.profile_phase(torch, np, serve, cfg, sync_free=True)
    print("serve", ntok / wall, "tokens/s", flush=True)
    del serve
    cs.serve_sharded_phase(torch, np, serve_mod, kernels)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("chip_phases: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    main(sys.argv[1:])
