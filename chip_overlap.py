#!/usr/bin/env python3
"""Sequential against overlapped CoPRIS training steps on one GPU, in turns.

    python3 chip_overlap.py        # from the root of a checkout, one GPU

llama3.2-1b at full width in chip_smoke.py's train configuration (B 8 x G 4,
N' 16, max_len 128, bf16 compute, f32 masters, the fused loss), from random
weights made from a seed and 4 SFT steps. Six arms in turns, each a fresh
CoPRISTrainer from the same SFT-warmed weights (kept on the host) running 3
steps: sequential, overlapped (overlap=True, max_staleness=1), overlapped,
sequential, sequential, overlapped. An arm's first overlapped step has
nothing to overlap with, so the medians take steps 2 and 3 of each arm:
step wall time, rollout time, update time. Then the multi-turn probe: one
collect of MultiTurnMathTask(max_value=9, num_turns=2) episodes at
max_response_len 64 from the 4-step SFT weights and after 8 more SFT steps
(environment steps, second turns, mean response length): whether the model
ends a turn with EOS. Prints one JSON line per arm and per probe, the
card's nvidia-smi line, and last {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ARMS = ("seq", "ovl", "ovl", "seq", "seq", "ovl")
STEPS = 3


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_overlap: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_overlap: run from the root of a repository checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.common.config import RolloutConfig, TrainConfig
    from repro_torch.common.tree import tree_map
    from repro_torch.configs import get_config
    from repro_torch.core.copris import CoPRISTrainer
    from repro_torch.core.rollout import RolloutEngine
    from repro_torch.data.sft import sft_warmup
    from repro_torch.data.tasks import EOS, AdditionTask, MultiTurnMathTask
    from repro_torch.hopper import build
    from repro_torch.models import model as M
    from repro_torch.sampling import prng

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    build.build_all()
    cfg = get_config("llama3.2-1b")
    params, _ = sft_warmup(M.init_params(cfg, seed=0, device="cuda"), cfg,
                           AdditionTask(max_value=20, seed=0), steps=4,
                           batch_size=32, max_len=24, lr=1e-4)
    host = tree_map(lambda t: t.detach().cpu(), params)
    del params
    ro = RolloutConfig(batch_size=8, group_size=4, max_prompt_len=4,
                       max_response_len=124, concurrency=16, mode="copris",
                       temperature=1.0)
    keys = ("step_time", "rollout_time", "update_time", "batch_wait_time",
            "overlap_saved_time", "param_staleness")
    rows = []
    for arm in ARMS:
        gc.collect()
        torch.cuda.empty_cache()
        tc = TrainConfig(lr=1e-5, warmup_steps=1, seed=0,
                         overlap=arm == "ovl", max_staleness=1)
        tr = CoPRISTrainer(cfg, ro, tc, AdditionTask(max_value=20, seed=0),
                           eos_id=EOS,
                           params=tree_map(lambda t: t.cuda(), host))
        tr.batch_timeout = 600.0
        torch.cuda.synchronize()
        try:
            outs = [tr.step() for _ in range(STEPS)]
        finally:
            tr.close()
        del tr
        if not all(np.isfinite(o["pg_loss"]) for o in outs):
            raise SystemExit(f"chip_overlap: {arm}: a loss not finite")
        row = {"arm": arm, **{k: [o[k] for o in outs] for k in keys}}
        rows.append(row)
        print(json.dumps(row), flush=True)
    for arm in ("seq", "ovl"):
        steady = {k: [r[k][i] for r in rows if r["arm"] == arm
                      for i in range(1, STEPS)]
                  for k in ("step_time", "rollout_time", "update_time")}
        print(json.dumps({"arm": arm, "steady_steps": len(steady["step_time"]),
                          **{f"{k}_median": float(np.median(v))
                             for k, v in steady.items()},
                          "step_time": steady["step_time"]}), flush=True)

    gc.collect()
    torch.cuda.empty_cache()
    params = tree_map(lambda t: t.cuda(), host)
    for extra in (0, 8):
        if extra:
            params, _ = sft_warmup(params, cfg,
                                   AdditionTask(max_value=20, seed=0),
                                   steps=extra, batch_size=32, max_len=24,
                                   lr=1e-4)
        task = MultiTurnMathTask(max_value=9, num_turns=2, seed=0)
        eng = RolloutEngine(
            cfg, RolloutConfig(batch_size=8, group_size=4, max_prompt_len=16,
                               max_response_len=64, concurrency=16,
                               mode="copris", temperature=1.0),
            task.sample_prompt, eos_id=EOS, env_factory=task.make_env)
        t0 = time.perf_counter()
        try:
            groups, st = eng.collect(params, 0, prng.PRNGKey(1))
        finally:
            eng.env_worker.shutdown()
        lens = [len(t.response_tokens) for g in groups for t in g.trajectories]
        print(json.dumps({"probe": "multiturn", "sft_steps": 4 + extra,
                          "env_steps": st["env_steps"],
                          "env_turns": st["env_turns"],
                          "mean_resp_len": float(np.mean(lens)),
                          "seconds": time.perf_counter() - t0}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
