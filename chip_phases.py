"""Run some phases of ``chip_smoke.py`` alone on one GPU, for a quick
check of the paths they drive: the kernels are built from the checkout,
then each named phase runs as in the full script and prints its JSON line.

    python3 chip_phases.py [moe_ep] [sharded] [disagg] [multihost]

``moe_ep``: ``train_moe_ep``; ``sharded``: ``train_sharded``; ``disagg``:
``train`` (its SFT-warmed weights), ``train_overlap`` and
``train_disaggregated``; ``multihost``: the torchrun launcher. With no
name, all four. The last line is ``ALL OK`` when every phase passed; a
failing phase exits non-zero, as in ``chip_smoke.py``.
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
        elif name == "disagg":
            sft = {}
            cs.train_phase(torch, np, train_kernels, keep=sft)
            cs.train_overlap_phase(torch, np, train_kernels, sft)
            cs.train_disaggregated_phase(torch, np, train_kernels, sft)
        elif name == "multihost":
            cs.multihost_phase(np)
        else:
            raise SystemExit(f"chip_phases: unknown phase {name}")
        print("phase", name, time.perf_counter() - t, flush=True)
    print("ALL OK", flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("chip_phases: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    main(sys.argv[1:])
