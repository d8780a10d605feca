"""Cells found by name in files of their own.

A cell is ``workloads/<name>.json`` (its configuration, traffic mix, chips,
training settings, the limits of its comparison and, where its mix's
contexts need one, its own EOS scale ``eos_h0``); a configuration is
``configs/<name>.json``; a traffic mix ``traffic/<name>.json``; a per-layer
metric ``metrics/<name>.py`` with a ``read(ctx)`` function. Adding a cell
or a metric adds files and touches none that exist.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]      # the benchmark's folder


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    root: Path

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    @property
    def train(self) -> dict:
        return dict(self.workload["train"])

    @property
    def limits(self) -> dict:
        return dict(self.workload["limits"])


def _load(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no such benchmark file: {path}")
    return json.loads(path.read_text())


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration and traffic mix, read from
    the files under ``root``."""
    wl = _load(root / "workloads" / f"{name}.json")
    cfg = _load(root / "configs" / f"{wl['config']}.json")
    mix = _load(root / "traffic" / f"{wl['traffic']}.json")
    if "eos_h0" in wl:                 # weights.py: the cell's own EOS scale
        mix["eos_h0"] = wl["eos_h0"]
    return Cell(name=name, workload=wl, config=cfg, traffic=mix, root=root)


def cell_names(root: Path = ROOT):
    return sorted(p.stem for p in (root / "workloads").glob("*.json"))


def metric_reader(name: str, root: Path = ROOT):
    """``read(ctx)`` of per-layer metric ``name`` (``metrics/<name>.py``),
    or None when the benchmark has no reader of that name."""
    path = root / "metrics" / f"{name}.py"
    if not path.is_file():
        return None
    spec = importlib.util.spec_from_file_location(
        f"chipbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def benchmark_entries(root: Path = ROOT):
    """(end-to-end metrics, per-layer metrics) of ``BENCHMARK.json`` beside
    the benchmark's folder, or of ``benchmark.json`` inside ``root`` (a
    test's copy); each a list of dicts."""
    for path in (root.parent / "BENCHMARK.json", root / "benchmark.json"):
        if path.is_file():
            spec = json.loads(path.read_text())
            return spec["end_to_end"], spec["per_layer"]
    raise FileNotFoundError(f"no BENCHMARK.json beside {root}")

