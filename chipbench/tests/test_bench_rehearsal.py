"""A CPU rehearsal of a cell at a tiny size: a whole run with the look for
a card skipped, ``correct`` true; with each fault planted under the timed
path, ``correct`` false; the float8 control read above the limits; the
run's refusals."""
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

import tiny
from benchlib import check, harness, reference, spec
from benchlib.faults import FAULTS

REPO = Path(__file__).resolve().parents[2]


def _run(tmp_path, seed, trace=False, device="cpu"):
    root = tiny.make(tmp_path)
    cell = spec.load_cell("tiny.cell", root)
    lines = []
    res = harness.run(cell, seed, 0.5, trace, t_start=time.perf_counter(),
                      device=device,
                      log=lambda *a, **k: lines.append(" ".join(map(str, a))))
    return res, lines


def test_rehearsal_is_correct(tmp_path):
    res, lines = _run(tmp_path, 3_000_000_123)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"train_tok_per_s", "step_s", "mfu",
                                   "setup_s"}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert res["attempted"] > 0 and res["failed"] == 0
    assert any(line.startswith("lengths ") for line in lines)
    # the window's first step is followed beside the warm-up steps
    assert any(line.startswith("reference followed 3 steps")
               for line in lines)


def test_traced_rehearsal_reads_per_layer_metrics(tmp_path):
    res, _ = _run(tmp_path, 17, trace=True)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    for name in ("rollout_s_per_step", "update_s_per_step", "step_s_max",
                 "slot_utilization", "rollout_ms_per_decode_step",
                 "step_mfu", "device_idle_share"):
        assert name in m, name
    # no device on the CPU: the kernels' readers find nothing and are silent
    assert "decode_attn_roofline" not in m
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_fault_makes_the_run_incorrect(tmp_path, fault):
    with FAULTS[fault]():
        res, _ = _run(tmp_path, 7)
    assert not res["correct"], res["checks"]


def test_control_reads_above_the_limits(tmp_path):
    """The reference in float8, put in the program's place, fails a
    number."""
    root = tiny.make(tmp_path)
    cell = spec.load_cell("tiny.cell", root)
    seeds = harness.derive_seeds(11)
    trainer, batches, _ = harness.warm_up(cell, seeds, "cpu",
                                          log=lambda *a, **k: None)
    harness.keep_step(trainer, trainer.step(), batches, _)
    trainer.close()
    args = (cell.config, cell.traffic, cell.train, seeds["weights"],
            batches, "cpu")
    ref = reference.follow(*args, delta_after=harness.WARMUP_STEPS)
    low = reference.follow(*args, delta_after=harness.WARMUP_STEPS,
                           mode="fp8")
    nums, _ = check.numbers(low, dict(
        ref, logp_gaps=abs(low["logps"] - ref["logps"])))
    ok, checks = check.judge(nums, cell.limits)
    assert not ok, checks


def test_run_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    sys.path.insert(0, str(REPO / "chipbench"))
    import run
    rc = run.main(["--workload", "qwen7b.short", "--seed", "1",
                   "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_run_fails_without_the_program(tmp_path):
    shutil.copytree(REPO / "chipbench", tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "chipbench/run.py", "--workload",
                        "qwen7b.short", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.mark.cuda
def test_tiny_cell_on_the_card(tmp_path, card):
    res, _ = _run(tmp_path, 23, device=card)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
