"""Where a traced step's device time and idle time go, by the program's own
spans.

    python3 chipbench/program_spans.py --workload qwen7b.short \
        --seeds 1,2,3

In one process, for each seed: the cell's warm-up steps as a run makes
them, then one step under ``torch.profiler`` with the benchmark's spans
wrapped around it as ``--trace 1`` wraps them. Prints on standard error a
table of the program's spans (``repro_torch.*``, ``common/tracing.py``):
count, host seconds, and the device and idle seconds whose innermost span
each is, with the unattributed remainder; and one JSON line a seed on
standard output: the step's own times, the trace's busy and idle time as
``benchlib/trace.py`` reduces it, the share of the busy time that the
program's spans account for, the readings of ``benchlib/program_trace.py``,
the engine's prefill and decode counters over the step beside the
benchmark's own count of the cached positions the decode read, and checks
that no span's mirror on the device's timeline was taken for a device
operation. The benchmark's runs do not run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent / "src"))

COUNTERS = ("prefill_tokens", "reprefill_tokens", "prefill_positions",
            "decode_kv_positions", "decode_chunks", "decode_steps")


def trace_step(cell, seed: int, device: str = "cuda", log=print) -> dict:
    """Warm the cell up from ``seed``, trace one step, and return what the
    module docstring lists."""
    import torch
    from torch.autograd import DeviceType

    from benchlib import harness, program_trace, trace
    seeds = harness.derive_seeds(seed)
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    trainer, _, _ = harness.warm_up(cell, seeds, device, log=log)
    try:
        spans = harness._Spans(trainer)
        sync()
        s0 = trainer.engine.stats_snapshot()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        spans.on = True
        with torch.profiler.profile(activities=acts) as prof:
            with spans.rf(harness.SPAN + "step"):
                out = trainer.step()
            sync()
        spans.on = False
        s1 = trainer.engine.stats_snapshot()
    finally:
        trainer.close()
    summary = trace.from_profiler(prof, harness.SPAN, "step")
    pt = program_trace.from_profiler(prof, summary.lo, summary.hi,
                                     other_prefixes=(harness.SPAN,))
    mirrors = sum(1 for ev in prof.profiler.kineto_results.events()
                  if ev.name().startswith(program_trace.PREFIX)
                  and ev.device_type() == DeviceType.CUDA)
    del prof
    counters = {k: s1.get(k, 0) - s0.get(k, 0) for k in COUNTERS}
    window = summary.window_s
    return {
        "seed": seed, "device": (torch.cuda.get_device_name() if cuda
                                 else "cpu"),
        "torch": torch.__version__,
        "step_time": out["step_time"], "rollout_time": out["rollout_time"],
        "update_time": out["update_time"],
        "window_s": window, "busy_s": summary.busy_s,
        "device_idle_share": (100.0 * (1.0 - summary.busy_s / window)
                              if window > 0 else None),
        "attributed_share": 100.0 * pt.attributed_share(),
        "device_ops": len(pt.ops),
        "ops_with_launch": pt.linked,
        "span_mirrors_on_device": mirrors,
        # a mirror kept as an operation would show as this "kernel"
        "mirrors_taken_for_ops": summary.by_kernel.get("repro_torch", 0.0),
        "readings": program_trace.readings(pt, cell.traffic["decode_chunk"]),
        "counters": counters,
        "harness_positions": spans.positions,
        "spans": pt.table(),
    }


def fmt_table(table: dict) -> list:
    lines = [f"{'span':<24}{'count':>7}{'host s':>10}{'device s':>10}"
             f"{'idle s':>10}"]
    for name, r in table.items():
        lines.append(f"{name:<24}{r.get('count', ''):>7}"
                     f"{r.get('host_s', float('nan')):>10.4f}"
                     f"{r['device_s']:>10.4f}{r['idle_s']:>10.4f}")
    return lines


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args()
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    from benchlib.spec import load_cell
    cell = load_cell(args.workload)
    for seed in [int(x) for x in args.seeds.split(",") if x]:
        t0 = time.perf_counter()
        res = trace_step(cell, seed,
                         log=lambda *a, **k: print(*a, file=sys.stderr))
        res["seconds"] = time.perf_counter() - t0
        for line in fmt_table(res["spans"]):
            print(line, file=sys.stderr)
        print(json.dumps(res), flush=True)
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
