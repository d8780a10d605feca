"""A tiny cell written from files alone into a copy of the benchmark's
folder: a 2-layer model at d 64 with a 8192-token vocabulary (enough for
the program's fused loss), 2 groups of 4 on 8 slots."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CONFIG = {
    "name": "tiny-test", "source": "a test of the benchmark",
    "arch": "paper-qwen-7b", "hidden_size": 64, "intermediate_size": 128,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
    "num_hidden_layers": 2, "vocab_size": 8192, "rope_theta": 1000000.0,
    "rms_norm_eps": 1e-06, "tie_word_embeddings": False,
    "eos_token_id": 8000, "compute_dtype": "bfloat16",
    "param_dtype": "float32", "reduced": [],
    "eos_design": {"h0": 0.2528},
}
TRAFFIC = {"name": "tinymix", "prompt_len": [8, 16], "response_mean": 8,
           "response_cap": 24, "batch_size": 2, "group_size": 4,
           "concurrency": 8, "decode_chunk": 4}
# limits of the tiny cell, from its own sound readings (bf16 on the CPU
# reads up to 0.035 on grad_gap at d 64) and its control's
LIMITS = {"loss_gap": 0.02, "grad_gap": 0.1, "delta_gap": 0.02,
          "logp_gap": 0.05, "logp_gap_p99": 0.5}


def make(tmp: Path) -> Path:
    """A copy of the benchmark's folder with the tiny cell added."""
    root = tmp / "chipbench"
    shutil.copytree(ROOT, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    shutil.copy(ROOT.parent / "BENCHMARK.json", root / "benchmark.json")
    wl = json.loads((ROOT / "workloads" / "qwen7b.short.json").read_text())
    wl.update(config="tiny-test", traffic="tinymix", limits=LIMITS)
    wl.pop("eos_h0", None)             # the tiny configuration's own h0
    wl["train"]["microbatches"] = 2
    (root / "configs" / "tiny-test.json").write_text(json.dumps(CONFIG))
    (root / "traffic" / "tinymix.json").write_text(json.dumps(TRAFFIC))
    (root / "workloads" / "tiny.cell.json").write_text(json.dumps(wl))
    return root
