"""Package rules of the PyTorch port.

* no file under src/repro_torch/, none of the port's examples
  (examples/torch_*.py), and neither chip_smoke.py nor chip_overlap.py,
  imports jax or the JAX package (`repro` / `repro.*`);
* importing every repro_torch module loads neither jax nor repro;
* on a machine without CUDA, entry points raise unless asked for the CPU.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _port_files():
    files = sorted(PORT.rglob("*.py"))
    files += sorted((ROOT / "examples").glob("torch_*.py"))
    for script in ("chip_smoke.py", "chip_overlap.py"):
        if (ROOT / script).exists():
            files.append(ROOT / script)
    return files


def test_port_files_import_no_jax_or_repro():
    files = _port_files()
    assert len(files) > 15
    assert len([f for f in files if f.name.startswith("torch_")]) == 5
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_import_all_modules_loads_no_jax():
    mods = sorted(
        ".".join(("repro_torch",) + p.relative_to(PORT).with_suffix("").parts)
        .replace(".__init__", "")
        for p in PORT.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules\n"
            "             if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is usable here")
    from repro_torch.configs import get_config
    from repro_torch.core.rollout import RolloutEngine
    from repro_torch.common.config import RolloutConfig
    from repro_torch.launch.serve import make_serve_engine
    from repro_torch.models import model as M
    with pytest.raises(RuntimeError, match="CUDA"):
        make_serve_engine("tiny")
    with pytest.raises(RuntimeError, match="CUDA"):
        M.init_params(get_config("tiny"))
    with pytest.raises(RuntimeError, match="CUDA"):
        RolloutEngine(get_config("tiny"), RolloutConfig(concurrency=2),
                      lambda: None, eos_id=0)


def test_no_kernels_path_in_port():
    """Kernel wrappers live under hopper/ and sources under csrc/: the
    analysis self-scan applies the Pallas rules to any path with kernels/."""
    assert not [p for p in PORT.rglob("*") if "kernels" in p.parts]
    for name in ("flash_attn", "decode_attn", "fused_sample",
                 "fused_is_grpo"):
        assert (PORT / "csrc" / f"{name}.cu").exists()
        assert (PORT / "hopper" / f"{name}.py").exists()
    assert (PORT / "csrc" / "flash_attn_bwd.cu").exists()
