"""Run one cell of the benchmark of ``repro_torch`` on this machine's card.

    python3 chipbench/run.py --workload qwen7b.short --seed 7 \
        --seconds 51 --trace 0

Prints the response lengths and every number compared with its limit on
standard error, and as the last line of standard output one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``
(``busy_s`` and ``window_s`` of the traced window with ``--trace 1``),
``breakdown`` with ``--trace 1``, and ``checks`` last. Exits 2, printing no
result, where no card (or too few) is there, and 3 where a module of JAX or
of the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent


def _environment():
    """Every build and kernel cache inside the checkout, at fixed paths; no
    library loads JAX by itself; the CUDA allocator grows its segments in
    place, as a deployment near the card's memory sets it (with fixed
    segments a cell's stage-start prefill can find 13 GiB reserved but
    free in pieces too small for it, and fail)."""
    build = CHECKOUT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(CHECKOUT / "src"))
    from benchlib.spec import load_cell
    cell = load_cell(args.workload)
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"error: the cell needs {cell.chips} CUDA device(s), "
              f"{have} found", file=sys.stderr)
        return 2
    from benchlib import harness
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"error: modules loaded that no run may load: {bad}",
              file=sys.stderr)
        return 3
    for line in harness.fmt_checks(result["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
