"""The readings that the limits of a cell's comparison are set from.

    python3 chipbench/readings.py --workload qwen7b.short \
        --seeds 1,2,3 [--control 1,2,3] [--faults half,token] \
        [--fault-seeds 1,2,3]

In one process, at the cell's own size: for each seed, the program's warm-up
steps and the step after them, as a run keeps them, and the reference
following them (the sound readings, the lower end
of each limit); for each ``--control`` seed, the control, the reference
computed in float8 put in the program's place on the same batches; for each
fault and fault seed, the program with the fault planted
(``benchlib/faults.py``). Prints one JSON line a reading. The benchmark's
runs do not run this.
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


def _ints(s):
    return [int(x) for x in s.split(",") if x] if s else []


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    args = ap.parse_args()
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    from benchlib import check, harness, reference
    from benchlib.faults import FAULTS
    from benchlib.spec import load_cell
    cell = load_cell(args.workload)
    cfg, mix, dev = cell.config, cell.traffic, "cuda"

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def emit(kind, seed, nums, info, secs):
        print(json.dumps({"kind": kind, "seed": seed, "numbers": nums,
                          "info": info, "seconds": secs}), flush=True)

    def program(seeds):
        trainer, batches, prog = harness.warm_up(cell, seeds, dev)
        harness.keep_step(trainer, trainer.step(), batches, prog)
        trainer.close()
        return batches, prog

    def follow(seeds, batches, **kw):
        return reference.follow(cfg, mix, cell.train, seeds["weights"],
                                batches, dev,
                                delta_after=harness.WARMUP_STEPS, **kw)

    control = set(_ints(args.control))
    for seed in _ints(args.seeds):
        t0 = time.perf_counter()
        seeds = harness.derive_seeds(seed)
        batches, prog = program(seeds)
        free()
        ref = follow(seeds, batches)
        nums, info = check.numbers(prog, ref)
        emit("sound", seed, nums, info, time.perf_counter() - t0)
        if seed in control:
            t0 = time.perf_counter()
            low = follow(seeds, batches, mode="fp8")
            ref_c = dict(ref, logp_gaps=abs(low["logps"] - ref["logps"]))
            nums, info = check.numbers(low, ref_c)
            emit("control", seed, nums, info, time.perf_counter() - t0)
        del ref, batches
        free()
    for name in [f for f in args.faults.split(",") if f]:
        for seed in _ints(args.fault_seeds):
            t0 = time.perf_counter()
            seeds = harness.derive_seeds(seed)
            with FAULTS[name]():
                batches, prog = program(seeds)
            free()
            ref = follow(seeds, batches)
            nums, info = check.numbers(prog, ref)
            emit(name, seed, nums, info, time.perf_counter() - t0)


if __name__ == "__main__":
    main()
