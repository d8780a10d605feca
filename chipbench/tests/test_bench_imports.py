"""No module that the harness or the reference loads is JAX or the JAX
package (top-level names compared whole: the program's package only begins
with the JAX package's name), and the reference loads nothing of the
program."""
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[1]
JAX = {"jax", "jaxlib", "flax", "repro"}

PRELUDE = f"""
import sys, json
sys.path.insert(0, {str(REPO / 'chipbench')!r})
sys.path.insert(0, {str(HERE)!r})
sys.path.insert(0, {str(REPO / 'src')!r})
"""


def _tops(code, tmp_path):
    p = subprocess.run([sys.executable, "-c", PRELUDE + code + """
print(json.dumps(sorted({n.split('.', 1)[0] for n in sys.modules})))
"""], capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_reference_loads_no_jax_and_nothing_of_the_program(tmp_path):
    tops = _tops("""
import benchlib.reference, benchlib.check, benchlib.weights
import benchlib.task, benchlib.flops, benchlib.trace, benchlib.spec
""", tmp_path)
    assert not tops & (JAX | {"repro_torch"}), tops & (JAX | {"repro_torch"})


def test_harness_run_loads_no_jax(tmp_path):
    tops = _tops(f"""
import time, tiny
from pathlib import Path
from benchlib import harness, spec
root = tiny.make(Path({str(tmp_path)!r}))
cell = spec.load_cell("tiny.cell", root)
harness.run(cell, 5, 0.2, True, t_start=time.perf_counter(), device="cpu",
            log=lambda *a, **k: None)
""", tmp_path)
    assert "repro_torch" in tops
    assert not tops & JAX, tops & JAX
