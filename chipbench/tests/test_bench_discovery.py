"""A cell, its configuration, traffic mix and metrics found by name in
files alone; BENCHMARK.json held to the benchmark's contract."""
import json
import re
from pathlib import Path

import pytest
import torch

import tiny
from benchlib import harness, spec
from benchlib import weights as W

REPO = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_cell_found_from_files_alone(tmp_path):
    root = tiny.make(tmp_path)
    assert "tiny.cell" in spec.cell_names(root)
    cell = spec.load_cell("tiny.cell", root)
    assert cell.config["name"] == "tiny-test"
    assert cell.traffic["concurrency"] == 8
    assert cell.chips == 1 and cell.train["microbatches"] == 2
    assert set(cell.limits) == {"loss_gap", "grad_gap", "delta_gap",
                                "logp_gap", "logp_gap_p99"}
    # a metric is a reader of its own, found by name; a later one is a file
    (root / "metrics" / "later_metric.py").write_text(
        "def read(ctx):\n    return 41.0 + ctx\n")
    assert spec.metric_reader("later_metric", root)(1) == 42.0
    assert spec.metric_reader("no_such_metric", root) is None
    with pytest.raises(FileNotFoundError):
        spec.load_cell("no.such.cell", root)


def test_benchmark_json_keeps_the_contract():
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["chipbench"]
    assert 1 <= b["run_seconds"] <= 51
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert spec.metric_reader(m["name"]) is not None, m["name"]
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    cfgs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        path = REPO / c["file"]
        assert c["file"].startswith("chipbench/") and path.is_file()
        assert json.loads(path.read_text())["reduced"] == c["reduced"]
    assert 1 <= len(b["workloads"]) <= 24
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200 and w["config"] in cfgs
        cell = spec.load_cell(w["name"])
        assert cell.workload["config"] == w["config"]
        assert cell.workload["traffic"] == w["traffic"]
        assert cell.config["name"] == w["config"]


@pytest.mark.parametrize("name", spec.cell_names())
def test_config_files_are_the_programs_configs(name):
    """The program runs the file's sizes (its registry entry, depth cut as
    the file says), and the benchmark's weights have the program's tree."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.common.tree import leaves
    cell = spec.load_cell(name)
    cfg = cell.config
    port = harness.port_config(cfg)
    base = get_config(cfg["arch"])
    for key in ("d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
                "vocab_size", "rms_eps", "tie_embeddings"):
        assert getattr(port, key) == getattr(base, key), key
    assert port.rope_theta == cfg["rope_theta"]     # the file's, published
    assert base.num_layers == cfg["published"]["num_hidden_layers"]
    meta = M.init_params(port, device="meta")
    shapes = {W.path_name(p): s for p, s, _ in W.leaf_specs(cfg)}
    assert len(shapes) == len(leaves(meta))
    for path, shape, _ in W.leaf_specs(cfg):
        assert tuple(W.get_path(meta, path).shape) == shape


def test_initial_leaf_is_the_made_leaf():
    cfg = dict(tiny.CONFIG)
    tree = W.make_params(cfg, tiny.TRAFFIC, 5, "cpu")
    for i, (path, _, _) in enumerate(W.leaf_specs(cfg)):
        assert torch.equal(W.initial_leaf(cfg, tiny.TRAFFIC, 5, "cpu", i),
                           W.get_path(tree, path)), path
