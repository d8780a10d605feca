"""The PyTorch port's examples (``examples/torch_*.py``): the quickstart
runs on the CPU as a user starts it, in a process of its own, and prints
its last line; every example parses and has the counterpart of one of the
JAX package's examples. (Their imports are held to the port's rule in
``tests/test_torch_hygiene.py``.)
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "serve_batch", "train_grpo_copris",
            "copris_vs_sync", "train_multiturn")


def test_quickstart_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    res = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_quickstart.py"),
         "--device", "cpu"], capture_output=True, text=True, env=env,
        timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    assert lines[-1] == "quickstart OK"
    assert any(line.startswith("decoded 4 tokens:") for line in lines)


@pytest.mark.parametrize("name", EXAMPLES)
def test_each_reference_example_has_a_port(name):
    assert (ROOT / "examples" / f"{name}.py").exists()
    port = ROOT / "examples" / f"torch_{name}.py"
    tree = ast.parse(port.read_text(), filename=str(port))
    doc = ast.get_docstring(tree)
    assert doc and "--device cpu" in doc
