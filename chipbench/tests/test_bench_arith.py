"""The benchmark's arithmetic held to hand counts: the union of device
intervals, idle gaps and what they are charged to, kernel names, the
per-layer readers' rates and rooflines, and the FLOP formulas (held to
the program's op counter at a small shape)."""
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import tiny
from benchlib import check, flops, harness, spec
from benchlib.trace import (TraceSummary, charge_gaps, gaps, kernel_ident,
                            union_length)


def test_union_counts_overlap_once():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.8)]
    assert union_length(iv) == 4.0
    assert union_length(iv, 1.5, 5.5) == 2.0
    assert union_length([]) == 0.0


def test_gaps_and_their_spans():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0)]
    assert gaps(iv, -1.0, 7.0) == [(-1.0, 0.0), (3.0, 5.0), (6.0, 7.0)]
    spans = [("step", -1.0, 7.0), ("collect", 2.5, 5.5),
             ("replay", 3.5, 4.5)]
    got = charge_gaps(gaps(iv, -1.0, 7.0), spans)
    assert got == {"step": 2.0, "replay": 2.0}
    assert charge_gaps([(10.0, 11.0)], spans) == {"none": 1.0}


def test_kernel_identifiers():
    assert kernel_ident("void repro::decode_kernel<__nv_bfloat16, 128, 7>"
                        "(__nv_bfloat16 const*, int)") == "decode_kernel"
    assert kernel_ident("bwd_dh_tc(sg::View<float>, int)") == "bwd_dh_tc"
    assert kernel_ident("void (anonymous namespace)::bwd_dw_tc<128>("
                        "int)") == "bwd_dw_tc"
    assert kernel_ident("void at::native::(anonymous namespace)::"
                        "vectorized_elementwise_kernel<4>(int)") == \
        "vectorized_elementwise_kernel"
    assert kernel_ident("Memcpy HtoD (Pageable -> Device)") == "Memcpy"


def test_trace_summary_busy_and_breakdown():
    ops = [("void decode_kernel<float>(float*)", 0.0, 1.0),
           ("bwd_dh_tc(int)", 0.5, 2.0), ("sm90_gemm", 3.0, 4.0)]
    s = TraceSummary(ops, [("step", 0.0, 5.0), ("update", 2.0, 5.0)],
                     0.0, 5.0)
    assert s.window_s == 5.0 and s.busy_s == 3.0
    assert s.kernel_seconds(["decode_kernel", "bwd_dh_tc"]) == 2.5
    b = s.breakdown()
    assert b["device_ops"][0] == ["bwd_dh_tc", 1.5]
    assert b["idle_gaps"] == [["update", 2.0]]


def _ctx(**kw):
    cfg = spec.load_cell("qwen7b.short").config
    base = dict(cfg=cfg, flops=flops, steps=[], stats={}, trace=None,
                traced=None, peak_window=0, window_s=1.0)
    base.update(kw)
    return SimpleNamespace(**base)


def _read(name, ctx):
    return spec.metric_reader(name)(ctx)


def test_readers_by_hand():
    steps = [{"rollout_time": 2.0, "update_time": 1.0, "step_time": 3.5},
             {"rollout_time": 4.0, "update_time": 3.0, "step_time": 7.5}]
    ctx = _ctx(steps=steps, stats={"decode_steps": 300, "slot_steps": 1000,
                                   "active_slot_steps": 250},
               peak_window=3 * 2 ** 30)
    assert _read("rollout_s_per_step", ctx) == 3.0
    assert _read("update_s_per_step", ctx) == 2.0
    assert _read("step_s_max", ctx) == 7.5
    assert _read("slot_utilization", ctx) == 25.0
    assert _read("rollout_ms_per_decode_step", ctx) == 20.0
    assert _read("peak_mem_gib", ctx) == 3.0
    for name in ("decode_attn_roofline", "fused_is_grpo_roofline",
                 "step_mfu", "device_idle_share"):
        assert _read(name, ctx) is None            # nothing traced: silent


def test_rooflines_by_hand():
    cfg = spec.load_cell("qwen7b.short").config
    # 1e6 cached positions read by 1000 active rows in 4 layers:
    # 4 * (1e6 * 2 * 4 * 128 * 2 + 1000 * 2 * 28 * 128 * 2) bytes
    need = 4 * (1e6 * 2048 + 1000 * 14336)
    assert flops.decode_attn_bytes(cfg, 10 ** 6, 1000) == need
    ops = [("void decode_kernel<bf16>(int)", 0.0, 0.002),
           ("bwd_dw_tc(int)", 0.5, 0.6)]
    tr = TraceSummary(ops, [("step", 0.0, 1.0)], 0.0, 1.0)
    batch = {"loss_mask": torch.ones(2, 500).numpy(),
             "total_lens": [700, 900], "prompt_lens": [600, 400]}
    ctx = _ctx(trace=tr, traced={"positions": 10 ** 6, "rows": 1000,
                                 "batch": batch})
    assert math.isclose(_read("decode_attn_roofline", ctx),
                        100 * need / 3.35e12 / 0.002)
    f = 6 * 1000 * 3584 * 152064
    assert math.isclose(_read("fused_is_grpo_roofline", ctx),
                        100 * f / 989e12 / 0.1)
    mf = (flops.trajectory_flops(cfg, 700, 100)
          + flops.trajectory_flops(cfg, 900, 500))
    assert mf == harness.batch_flops(cfg, batch)
    assert math.isclose(_read("step_mfu", ctx), 100 * mf / 989e12)
    assert math.isclose(_read("device_idle_share", ctx), 100 * (1 - 0.102))


def test_flop_formulas_by_hand():
    cfg = spec.load_cell("qwen7b.short").config
    d, f, V = 3584, 18944, 152064
    per_layer = d * 28 * 128 + 2 * d * 4 * 128 + 28 * 128 * d + 3 * d * f
    assert flops.layer_matmul_params(cfg) == 4 * per_layer
    # L = 3: pairs (1 + 2 + 3) = 6, 4 hd H FLOPs each, 4 layers
    assert flops.attention_flops(cfg, 3) == 4 * 6 * 4 * 128 * 28
    # a prompt of 1000 and a response of 24: the layers at all 1024
    # positions, the unembedding at the 24 rows that sample or score a
    # response token; forward once in the rollout, three times' worth in
    # the update
    fwd = 2 * 4 * per_layer * 1024 + 4 * 2 * 128 * 28 * 1024 * 1025 \
        + 2 * d * V * 24
    assert flops.forward_flops(cfg, 1024, 24) == fwd
    assert flops.trajectory_flops(cfg, 1024, 24) == 4 * fwd
    # the update's unembedding, forward and backward, is the fused loss's
    assert 3 * 2 * d * V * 24 == flops.loss_kernel_flops(cfg, 24)


def test_logp_p99_catches_a_few_slots():
    """A fault in one slot of 64 moves the mean gap by little and the
    99th percentile by all of it."""
    gaps = np.full(6400, 0.0127)
    gaps[:100] = 1.42                            # one slot's tokens
    ref = {"first_raw": [1.0, 1.0], "first_grad": [1.0, 1.0],
           "delta": [1.0, 1.0], "loss": [0.0], "logp_gaps": gaps}
    prog = {"first_grad": [1.0, 1.0], "delta": [1.0, 1.0], "loss": [0.0]}
    nums, _ = check.numbers(prog, ref)
    assert nums["logp_gap"] < 0.05 < nums["logp_gap_p99"]
    ok, checks = check.judge(nums, {"loss_gap": 0.1, "grad_gap": 0.1,
                                    "delta_gap": 0.1, "logp_gap": 0.05,
                                    "logp_gap_p99": 0.5})
    assert not ok and checks["logp_gap_p99"]["value"] > 1.0


@pytest.mark.parametrize("S", [8, 24, 100])
def test_flops_match_the_programs_op_counter(S):
    """At the tiny size the forward's products, counted op by op by the
    program's OpCost, are the formula's dense products plus the causal
    attention computed whole in one block (S x S scores and mixes)."""
    from repro_torch.launch.op_cost import OpCost
    from repro_torch.models import model as M
    from benchlib import weights as W
    cfg = dict(tiny.CONFIG, compute_dtype="float32")
    port = harness.port_config(cfg)
    params = W.make_params(cfg, tiny.TRAFFIC, 3, "cpu")
    tokens = torch.randint(0, cfg["vocab_size"], (1, S))
    with torch.no_grad(), OpCost() as oc:
        M.forward_train(params, port, tokens)
    got = oc.record()["flops"]
    dense = (2 * flops.layer_matmul_params(cfg) * S
             + 2 * cfg["hidden_size"] * cfg["vocab_size"] * S)
    whole = cfg["num_hidden_layers"] * 4 * S * S * 16 * 4
    assert got == dense + whole
    causal = flops.forward_flops(cfg, S, S)
    assert causal == dense + cfg["num_hidden_layers"] * 2 * 16 * 4 * S * (S + 1)
