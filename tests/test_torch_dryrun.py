"""The port's dry run (``repro_torch.launch.dryrun``) against the reference's
(``repro.launch.dryrun``), on a (2, 2) ("data", "model") mesh with the
smoke configs, and once at full width on the fake 16 x 16 mesh.

Each side runs in a subprocess of its own (timeout 300 s), the three at
once: the reference on ``Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
...)`` (Auto axes: ``jax.make_mesh`` gives Explicit ones, on which the
reference's prefill and train steps raise), the port on a fake group of 4
ranks with every plain version of a hand kernel patched to raise on a
fake tensor (so no fake tensor reaches one on any of these steps).

What is held, and to what:

* llama3.2-1b at decode_32k, prefill_32k and train_4k: ``params``,
  ``active_params``, ``model_flops_total`` and the skip set equal;
  ``memory.argument_size_in_bytes`` within 1%; decode's
  ``flops_per_device`` within 1%.
* prefill and train FLOPs, the difference stated by formula (rank 0, B_l
  rows and H_l heads a rank, L layers, k microbatches, T tokens a rank a
  microbatch, d, f_l the rank's MLP width, V_l its vocabulary):
  - attention: the reference's chunked attention computes every block of
    the padded square (blocks of 512 queries x 2048 keys), 2 products of
    2 hd FLOPs a (query, key) pair forward, and in training 11 in all
    (forward 2, the remat's forward 2, its backward's dq pass 3 and dk/dv
    pass 4); the kernels compute the causal pairs only, 2 products a pair
    forward and 5 backward (their charges, ``flash_cost``);
  - the reference looks its embedding up as a one-hot product
    (``embed_impl="onehot"``, 2 T V_l d, and in training its weight
    gradient once more), the port by rows;
  - in training XLA drops the remat's recompute of the MLP's output
    product (2 T f_l d a layer), whose result the backward never reads;
    ``torch.utils.checkpoint`` reruns the whole block;
  - in training ``DTensor`` runs the q projection's input and weight
    gradients with dq whole over "model" (2 T d (H hd) (1 - 1/tp) a layer
    beyond a sharded product, tp the "model" size), and the unembedding's
    weight gradient whole (T V d (1 - 1/tp) a microbatch).
  The rest must agree within 2%.
* rwkv6-1.6b at long_500k: ok on both sides, the WKV6 kernel charged once
  a layer. The FLOPs, the difference stated by formula (one token, d,
  f_l and H_l as above, hd the WKV head size):
  - at batch 1 XLA splits over the idle "data" axis every projection but
    the decay LoRA's second product and the channel mix's key (an
    all-reduce after), the port's serve layout runs them whole on each
    "data" rank: half of 2 d (5 r_mix) twice (the mixing LoRA), 2 d r_dec
    (the decay LoRA's first), 4 2 d d/tp (r, k, v, g), 2 d/tp d (the
    output), 2 d d/tp and 2 f_l d (the channel mix's receptance and
    value), a layer;
  - the WKV kernel is charged 6 operations a (head, i, j) (``wkv_cost``),
    the reference counts its one product, 2.
  The rest must agree within 1%.
* the weight sync: all-gather only, its bytes within 1% of the
  reference's, ``sync_bytes_per_version`` equal.
* deepseek-moe-16b's smoke config with the expert-parallel dispatch (the
  reference's shardmap dispatch fails on this tree, so a formula): each
  MoE layer exchanges tokens twice forward, twice in the remat's forward
  and twice backward per microbatch, each all-to-all ep x capacity x
  e_local x d float32 values.
* hymba-1.5b (at ``reduced(max_d_model=320)``, head_dim 64, which the
  kernels take) and rwkv6-1.6b train and prefill steps: the scans'
  forward (with the backward's boundary states) and backward kernels and
  the attention kernels charged, and no plain version reached; so too
  the VLM's prefill at one period of 5 layers (the cross-attention's
  non-causal flash) and gemma2-2b's (window, softcaps).
* at full width: llama3.2-1b decode_32k on the fake 256-rank mesh through
  the CLI: ok, decode_attn charged once for each of its 16 layers.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

LLAMA_SHAPES = ("decode_32k", "prefill_32k", "train_4k", "long_500k")
KEYS = ("arch", "shape", "status", "flops_per_device", "collective_bytes",
        "memory", "params", "active_params", "model_flops_total",
        "sync_bytes_per_version", "meta", "kernels")

REF_CODE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import jax
import numpy as np
from jax.sharding import Mesh
from repro.configs import get_smoke_config
from repro.launch.dryrun import run_one, run_reshard

mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
out = [run_one("llama3.2-1b", s, mesh=mesh, verbose=False,
               cfg_override=get_smoke_config("llama3.2-1b"))
       for s in %(shapes)r]
out.append(run_one("rwkv6-1.6b", "long_500k", mesh=mesh, verbose=False,
                   cfg_override=get_smoke_config("rwkv6-1.6b")))
out.append(run_reshard("llama3.2-1b", mesh=mesh, verbose=False,
                       cfg_override=get_smoke_config("llama3.2-1b")))
print(json.dumps([{k: r.get(k) for k in %(keys)r} for r in out]))
""" % {"shapes": LLAMA_SHAPES, "keys": KEYS}

PORT_CODE = r"""
import dataclasses
import json
import torch
from repro_torch.common.config import InputShape, TrainConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.hopper import build
from repro_torch.launch import dryrun as D


def refuse(name, fn):
    def plain(*args, **kwargs):
        ts = [a for a in list(args) + list(kwargs.values())
              if isinstance(a, torch.Tensor)]
        if any(build.is_fake(t) for t in ts):
            raise AssertionError(f"a fake tensor reached {name}")
        return fn(*args, **kwargs)
    return plain


# every plain version of a hand kernel, and the plain attention the model
# module holds, refuses a fake tensor
import repro_torch.hopper.decode_attn as da
import repro_torch.hopper.flash_attn as fa
import repro_torch.hopper.fused_is_grpo as fio
import repro_torch.hopper.fused_logprob as flp
import repro_torch.hopper.rwkv6_scan as wk
import repro_torch.hopper.ssm_scan as ss
import repro_torch.models.attention as att
for mod, names in ((fa, ("flash_attention_plain", "flash_attention_bwd_plain")),
                   (da, ("decode_attention_plain",)),
                   (fio, ("fwd_plain", "bwd_plain", "stats_plain")),
                   (flp, ("fused_logprob_plain",)),
                   (ss, ("selective_scan_plain", "selective_scan_bwd_plain")),
                   (wk, ("wkv6_plain", "wkv6_bwd_plain")),
                   (att, ("chunked_attention", "decode_attention",
                          "flash_attention_bwd_plain"))):
    for n in names:
        setattr(mod, n, refuse(n, getattr(mod, n)))

mesh = D.dry_mesh(2, 2)
smoke = get_smoke_config("llama3.2-1b")
out = [D.run_one("llama3.2-1b", s, mesh=mesh, cfg_override=smoke,
                 verbose=False) for s in %(shapes)r]
out.append(D.run_one("rwkv6-1.6b", "long_500k", mesh=mesh, verbose=False,
                     cfg_override=get_smoke_config("rwkv6-1.6b")))
out.append(D.run_reshard("llama3.2-1b", mesh=mesh, cfg_override=smoke,
                         verbose=False))
ds = get_smoke_config("deepseek-moe-16b")
ds = dataclasses.replace(ds, moe=dataclasses.replace(ds.moe,
                                                     dispatch="sparse"))
rec = D.run_one("deepseek-moe-16b", "train_4k", mesh=mesh, cfg_override=ds,
                verbose=False)
rec["moe"] = dataclasses.asdict(D.dryrun_config(ds).moe)
out.append(rec)
# the scans' kinds: one microbatch of 8 x 256 for training, the smoke
# prefill at 32k
small = InputShape("train_small", 256, 8, "train")
for arch, cfg in (("hymba-1.5b",
                   get_config("hymba-1.5b").reduced(max_d_model=320)),
                  ("rwkv6-1.6b", get_smoke_config("rwkv6-1.6b"))):
    with D.fake_mode():
        step, args, _ = D.input_specs(
            D.dryrun_config(cfg), small, mesh,
            tcfg=TrainConfig(microbatches=1, remat=True))
    _, cost, _ = D.count_step(step, args, mesh)
    out.append({"arch": arch, "shape": "train_small", "status": "ok",
                "kernels": cost["kernels"]})
    out.append(D.run_one(arch, "prefill_32k", mesh=mesh, cfg_override=cfg,
                         verbose=False))
# the VLM at one period (its xattn layer: non-causal flash against the
# media) and gemma2-2b (window, softcaps): prefill
for arch, cfg in (("llama-3.2-vision-90b", get_config(
        "llama-3.2-vision-90b").reduced(num_layers=5)),
                  ("gemma2-2b", get_smoke_config("gemma2-2b"))):
    out.append(D.run_one(arch, "prefill_32k", mesh=mesh, cfg_override=cfg,
                         verbose=False))
print(json.dumps([{k: r.get(k) for k in %(keys)r + ("moe",)}
                  for r in out]))
""" % {"shapes": LLAMA_SHAPES, "keys": KEYS}

FULL = ["-m", "repro_torch.launch.dryrun", "--arch", "llama3.2-1b",
        "--shape", "decode_32k"]


@pytest.fixture(scope="module")
def runs():
    """{"ref", "port", "full"}: the three subprocesses' records, run at
    once."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    procs = {name: subprocess.Popen([sys.executable, *argv], cwd=ROOT,
                                    env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for name, argv in (("ref", ["-c", REF_CODE]),
                                ("port", ["-c", PORT_CODE]), ("full", FULL))}
    out = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=300)
            assert proc.returncode == 0, (name, stderr[-3000:])
            out[name] = stdout
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    recs = {name: json.loads(out[name].strip().splitlines()[-1])
            for name in ("ref", "port")}
    recs["full"] = [json.loads(line) for line in out["full"].splitlines()
                    if line.startswith('{"arch"')]
    return recs


def _rec(recs, arch, shape):
    (r,) = [r for r in recs if r["arch"] == arch and r["shape"] == shape]
    return r


def _pad(n, block):
    return -(-n // block) * block


@pytest.mark.parametrize("shape", LLAMA_SHAPES)
def test_llama_counts_and_skips_equal(runs, shape):
    ref = _rec(runs["ref"], "llama3.2-1b", shape)
    port = _rec(runs["port"], "llama3.2-1b", shape)
    assert port["status"] == ref["status"]
    assert (shape == "long_500k") == (port["status"] == "skip")
    if port["status"] == "ok":
        for k in ("params", "active_params", "model_flops_total"):
            assert port[k] == ref[k], k
        a = ref["memory"]["argument_size_in_bytes"]
        assert port["memory"]["argument_size_in_bytes"] == \
            pytest.approx(a, rel=0.01)


def test_llama_decode_flops(runs):
    ref = _rec(runs["ref"], "llama3.2-1b", "decode_32k")
    port = _rec(runs["port"], "llama3.2-1b", "decode_32k")
    assert port["flops_per_device"] == pytest.approx(
        ref["flops_per_device"], rel=0.01)
    assert port["kernels"]["decode_attn"]["launches"] == 2


@pytest.mark.parametrize("shape", ["prefill_32k", "train_4k"])
def test_llama_flops_by_formula(runs, shape):
    from repro_torch.common.config import INPUT_SHAPES
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("llama3.2-1b")
    ref = _rec(runs["ref"], "llama3.2-1b", shape)
    port = _rec(runs["port"], "llama3.2-1b", shape)
    tp = dp = 2
    L, d, hd = cfg.num_layers, cfg.d_model, cfg.head_dim
    q_width = cfg.num_heads * hd
    f_l, V_l = cfg.d_ff // tp, cfg.vocab_size // tp
    s = INPUT_SHAPES[shape]
    k = port["meta"].get("microbatches", 1)
    B_l, H_l = s.global_batch // k // dp, cfg.num_heads // tp
    unit = 2 * hd * B_l * H_l          # FLOPs of one product a pair
    kernel_flops = sum(c["flops"] for c in port["kernels"].values())
    if shape == "prefill_32k":
        S = s.seq_len
        pairs = S * (S + 1) // 2
        assert kernel_flops == L * 2 * unit * pairs
        ref_attn = L * 2 * unit * _pad(S, 512) * _pad(S, 2048)
        onehot = 2 * B_l * S * V_l * d
        ref_rest = ref["flops_per_device"] - ref_attn - onehot
        port_rest = port["flops_per_device"] - kernel_flops
    else:
        S = s.seq_len - 1                  # the loss's inputs
        T = B_l * S
        pairs = S * (S + 1) // 2
        assert kernel_flops == L * k * (2 * 2 + 5) * unit * pairs
        ref_attn = L * k * 11 * unit * _pad(S, 512) * _pad(S, 2048)
        onehot = k * 2 * (2 * T * V_l * d)
        remat_out = L * k * 2 * T * f_l * d
        whole = (L * k * 2 * T * 2 * d * q_width * (1 - 1 / tp)
                 + k * 2 * T * cfg.vocab_size * d * (1 - 1 / tp))
        ref_rest = ref["flops_per_device"] - ref_attn - onehot
        port_rest = port["flops_per_device"] - kernel_flops - remat_out \
            - whole
    assert port_rest == pytest.approx(ref_rest, rel=0.02)


def test_rwkv6_long_context(runs):
    ref = _rec(runs["ref"], "rwkv6-1.6b", "long_500k")
    port = _rec(runs["port"], "rwkv6-1.6b", "long_500k")
    assert ref["status"] == port["status"] == "ok"
    assert port["meta"]["shard_seq"] is True
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("rwkv6-1.6b")
    tp = 2
    L, d, f_l, rw = cfg.num_layers, cfg.d_model, cfg.d_ff // tp, cfg.rwkv
    hd = rw.head_dim
    H_l = d // hd // tp
    kernel_flops = port["kernels"]["wkv6"]["flops"]
    assert port["kernels"]["wkv6"]["launches"] == L
    assert kernel_flops == L * 6 * H_l * hd * hd
    # one token (T = 1): the products XLA splits over the idle "data" axis
    # and the port runs whole on each "data" rank, a layer
    split = (2 * d * 5 * rw.mix_lora + 2 * 5 * rw.mix_lora * d
             + 2 * d * rw.decay_lora + 4 * 2 * d * (d // tp)
             + 2 * (d // tp) * d + 2 * d * (d // tp) + 2 * f_l * d)
    port_rest = port["flops_per_device"] - kernel_flops - L * split // 2
    ref_rest = ref["flops_per_device"] - L * 2 * H_l * hd * hd
    assert port_rest == pytest.approx(ref_rest, rel=0.01)


def test_weight_sync_all_gather_only(runs):
    ref = _rec(runs["ref"], "llama3.2-1b", "weight_sync")
    port = _rec(runs["port"], "llama3.2-1b", "weight_sync")
    kinds = {k for k, v in port["collective_bytes"].items()
             if k != "total" and v > 0}
    assert kinds == {"all-gather"}, port["collective_bytes"]
    assert port["collective_bytes"]["all-gather"] == pytest.approx(
        ref["collective_bytes"]["all-gather"], rel=0.01)
    assert port["sync_bytes_per_version"] == ref["sync_bytes_per_version"]


def test_moe_all_to_all_by_formula(runs):
    rec = _rec(runs["port"], "deepseek-moe-16b", "train_4k")
    moe = rec["moe"]
    assert moe["dispatch"] == "shardmap"
    from repro_torch.common.config import INPUT_SHAPES
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("deepseek-moe-16b")
    s = INPUT_SHAPES["train_4k"]
    k = rec["meta"]["microbatches"]
    ranks, ep = 4, 2
    E, e_local = moe["num_experts"], moe["num_experts"] // ep
    tokens = s.global_batch // k * (s.seq_len - 1)   # a microbatch's
    T = -(-tokens // ranks)            # a rank's, padded to the whole grid
    cap = max(1, int(moe["capacity_factor"] * T * moe["top_k"] / E))
    moe_layers = cfg.num_layers - len(cfg.prefix_pattern)
    exchange = ep * cap * e_local * cfg.d_model * 4
    assert rec["collective_bytes"]["all-to-all"] == \
        moe_layers * k * (2 + 2 + 2) * exchange


@pytest.mark.parametrize("arch", ["hymba-1.5b", "rwkv6-1.6b"])
def test_scan_kinds_charge_their_kernels(runs, arch):
    train = _rec(runs["port"], arch, "train_small")["kernels"]
    prefill = _rec(runs["port"], arch, "prefill_32k")
    assert prefill["status"] == "ok"
    scan = "ssm_scan" if arch == "hymba-1.5b" else "wkv6"
    layers = 2
    # the forward that stores the boundary states twice a layer (forward,
    # remat), the backward once
    assert train[scan]["launches"] == 2 * layers
    assert train[f"{scan}_bwd"]["launches"] == layers
    assert prefill["kernels"][scan]["launches"] == layers
    if arch == "hymba-1.5b":
        assert train["flash_attn"]["launches"] == 2 * layers
        assert train["flash_attn_bwd"]["launches"] == layers


@pytest.mark.parametrize("arch,layers", [("llama-3.2-vision-90b", 5),
                                         ("gemma2-2b", 2)])
def test_attention_kinds_charge_flash(runs, arch, layers):
    rec = _rec(runs["port"], arch, "prefill_32k")
    assert rec["status"] == "ok"
    assert rec["kernels"]["flash_attn"]["launches"] == layers


def test_full_width_decode_on_256_ranks(runs):
    (rec,) = runs["full"]
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["kernels"]["decode_attn"]["launches"] == 16
    assert rec["memory"]["total_nonalias"] > 0
