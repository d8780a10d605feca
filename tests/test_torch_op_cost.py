"""The port's per-op cost counter (``repro_torch.launch.op_cost``) against
the reference's HLO cost walker (``repro.launch.hlo_cost.parse_hlo_cost``).

Small torch programs are counted by ``OpCost`` and held against
``parse_hlo_cost`` of the same jnp program compiled on one CPU device: a
matmul (FLOPs and bytes equal), twelve matmuls in a Python loop against a
``lax.fori_loop`` of twelve (FLOPs equal: eager execution runs the body
once a trip, the walker scales it by the trip count), and a transpose made
contiguous (the same traffic, in ``layout_bytes`` only). On a fake (16, 16)
mesh of 256 ranks (``launch/dryrun``'s fake process group, in a
subprocess of its own, since the group is the process's default one): a
Shard x Replicate matmul costs 2 (local m n k) on rank 0, a redistribute
its all-gather's output bytes, and a c10d ``all_to_all_single`` its
output bytes under all-to-all. A flash attention call on fake tensors is
one charged ``flash_attn`` launch with its formula and runs none of
``chunked_attention``'s ops; the kernels that no dry-run step launches
refuse fake tensors.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.launch.hlo_cost import parse_hlo_cost  # noqa: E402
from repro_torch.launch.op_cost import OpCost  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _hlo_cost(fn, *args):
    return parse_hlo_cost(jax.jit(fn).lower(*args).compile().as_text())


def _counted(fn, *args):
    with OpCost() as c:
        fn(*args)
    return c.record()


def _arrays(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _matmul():
    a, b = _arrays((8, 16), (16, 32))
    got = _counted(torch.mm, torch.from_numpy(a), torch.from_numpy(b))
    want = _hlo_cost(lambda x, y: x @ y, a, b)
    assert got["flops"] == want["flops"] == 2 * 8 * 32 * 16
    assert got["bytes"] == want["bytes"] == (8 * 16 + 16 * 32 + 8 * 32) * 4
    assert got["collectives"]["total"] == want["collectives"]["total"] == 0


def _loop():
    x, w = _arrays((8, 16), (16, 16))

    def torch_loop(x, w):
        for _ in range(12):
            x = x @ w
        return x

    got = _counted(torch_loop, torch.from_numpy(x), torch.from_numpy(w))
    want = _hlo_cost(lambda x, w: jax.lax.fori_loop(
        0, 12, lambda i, x: x @ w, x), x, w)
    assert got["flops"] == want["flops"] == 12 * 2 * 8 * 16 * 16


def _transpose():
    (x,) = _arrays((16, 32))
    got = _counted(lambda t: t.t().contiguous(), torch.from_numpy(x))
    want = _hlo_cost(lambda t: jnp.transpose(t), x)
    # the same traffic (read once, written once); the CPU compiler fuses
    # the reference's transpose into a loop fusion, which its walker counts
    # under bytes
    assert got["flops"] == want["flops"] == 0
    assert got["bytes"] == 0
    assert got["layout_bytes"] == want["bytes"] + want["layout_bytes"] \
        == 2 * 16 * 32 * 4


def _fake_flash():
    from repro_torch.hopper import flash_attn
    from repro_torch.launch import dryrun
    B, S, H, KV, hd = 2, 128, 4, 2, 64
    with dryrun.fake_mode():
        q = torch.empty(B, S, H, hd, dtype=torch.bfloat16, device="meta")
        k = torch.empty(B, S, KV, hd, dtype=torch.bfloat16, device="meta")
        v = torch.empty_like(k)
    n0 = flash_attn.flash_attention.launches
    with OpCost() as c:
        out = flash_attn.flash_attention(q, k, v)
    rec = c.record(out)
    flops, nbytes = flash_attn.flash_cost(q.shape, k.shape, 2)
    assert flops == 4 * B * H * hd * (S * (S + 1) // 2)
    assert rec["kernels"] == {"flash_attn": {"launches": 1, "flops": flops,
                                             "bytes": nbytes}}
    assert rec["flops"] == flops and rec["bytes"] == nbytes
    # only the kernel's output was allocated: no op of the plain version
    assert set(c.op_names) <= {"empty", "empty_like"}, c.op_names
    assert tuple(out.shape) == (B, S, H, hd)
    assert flash_attn.flash_attention.launches == n0    # a charge, no launch


CASES = {"matmul": _matmul, "loop_of_12": _loop,
         "transpose_contiguous": _transpose, "fake_flash": _fake_flash}

# the fake-mesh cases: one subprocess (a fake default group of 256 ranks)
MESH_CODE = r"""
import json
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard
from repro_torch.launch import dryrun
from repro_torch.launch.op_cost import OpCost

mesh = dryrun.dry_mesh(16, 16)
with dryrun.fake_mode():
    a = dryrun.fake_dtensor((64, 4096), torch.bfloat16, mesh,
                            (Shard(0), Replicate()))
    b = dryrun.fake_dtensor((4096, 8192), torch.bfloat16, mesh,
                            (Replicate(), Shard(1)))
    x = dryrun.fake_dtensor((64, 512), torch.float32, mesh,
                            (Shard(0), Replicate()))
    send = torch.empty(1024, 64, device="meta")
out = {}
with OpCost() as c:
    y = a @ b
out["matmul"] = c.record()
out["matmul_local"] = list(y.to_local().shape)
with OpCost() as c:
    x.redistribute(mesh, (Replicate(), Replicate()))
out["redistribute"] = c.record()
with OpCost() as c:
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.get_group("model"))
out["all_to_all"] = c.record()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def mesh_records():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", MESH_CODE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", list(CASES))
def test_op_cost_against_hlo_cost(case):
    CASES[case]()


@pytest.mark.parametrize("case", ["sharded_matmul", "redistribute",
                                  "all_to_all"])
def test_op_cost_on_fake_mesh(mesh_records, case):
    if case == "sharded_matmul":
        rec = mesh_records["matmul"]
        # rank 0's shards: (64 / 16) x 4096 @ 4096 x (8192 / 16)
        assert mesh_records["matmul_local"] == [4, 512]
        assert rec["flops"] == 2 * 4 * 512 * 4096
        assert rec["collectives"]["total"] == 0
    elif case == "redistribute":
        coll = mesh_records["redistribute"]["collectives"]
        assert coll["all-gather"] == 64 * 512 * 4
        assert coll["total"] == coll["all-gather"]
    else:
        coll = mesh_records["all_to_all"]["collectives"]
        assert coll["all-to-all"] == 1024 * 64 * 4
        assert coll["total"] == coll["all-to-all"]


@pytest.mark.parametrize("kernel", ["sample_rows", "paged_decode_attention"])
def test_uncharged_kernels_refuse_fake_tensors(kernel):
    """A kernel that no dry-run step launches has no charge: a fake
    tensor raises there, and never runs its plain version."""
    from repro_torch.hopper import fused_sample, paged_decode_attn
    from repro_torch.launch import dryrun
    with dryrun.fake_mode():
        if kernel == "sample_rows":
            keys = torch.empty(3, 2, dtype=torch.uint32, device="meta")
            logits = torch.empty(3, 64, device="meta")
            call = (lambda: fused_sample.sample_rows(keys, logits))
        else:
            q = torch.empty(2, 1, 4, 64, device="meta")
            pool = torch.empty(8, 16, 2, 64, device="meta")
            table = torch.empty(2, 4, dtype=torch.int32, device="meta")
            lens = torch.empty(2, dtype=torch.int32, device="meta")
            call = (lambda: paged_decode_attn.paged_decode_attention(
                q, pool, pool, table, 16, lens))
    with pytest.raises(ValueError, match="fake tensors"):
        call()


def _csrc_int(source, name):
    """The value of ``constexpr int name = ...;`` in csrc/``source``."""
    import re
    text = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
            / "csrc" / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


@pytest.mark.parametrize("const", ["ssm_chunk", "wkv_chunk", "ssm_channels"])
def test_fake_branch_constants_match_the_sources(const):
    """The constants the scans' fake branches size their scratch by are the
    kernels' own (on the card ``chip_smoke.py`` holds them against the
    built libraries and the card's SM count)."""
    from repro_torch.hopper import rwkv6_scan, ssm_scan
    if const == "ssm_chunk":
        assert ssm_scan.BWD_CHUNK == _csrc_int("ssm_scan.cu", "kBwdChunk")
    elif const == "wkv_chunk":
        assert rwkv6_scan.BWD_CHUNK == _csrc_int("wkv6.cu", "kBwdChunk")
    else:
        threads = _csrc_int("ssm_scan.cu", "kBwdThreads")
        # BwdSmem<T, N>::CB: kBwdThreads / (N / 4 lanes a channel)
        assert ssm_scan.BWD_CHANNELS == {N: threads // (N // 4)
                                         for N in ssm_scan._STATE_DIMS}
