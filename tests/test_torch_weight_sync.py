"""The port's versioned weight sync (``repro_torch.core.weight_sync``).

* the ParamStore contract of ``tests/test_weight_sync.py``, against the
  port's store: acquire gives the freshest version, versions are strictly
  monotonic, stale versions are dropped, acquire before the first publish
  raises, an empty window is rejected, ``wait_for``; publish stores a copy,
  so an update in place does not reach a published version;
* config validation: ``disaggregated`` requires ``overlap``; the trainer's
  ``restore`` republishes through the store;
* the disaggregated reshard (``make_param_resharder``): a bit-exact copy
  onto the rollout device, or on a mesh a redistribute to the serving
  placements; the disaggregated trainer (tiny, 3 overlapped steps, its
  collects pinned one update behind): the store's freshest version is the
  consumer's params bit for bit at every stage, and its params end equal
  to the same run without the reshard; ``launch/train.py --overlap
  --disaggregated`` on the CPU;
* on the card (marked ``cuda``, skipped elsewhere; the decision is taken
  inside the fixture): a version acquired on a second stream while the
  first keeps updating the masters in place reads exactly the published
  values, and a decode chunk on one stream while a loop of GEMMs runs on
  another gives the tokens it gives alone, and the reshard's
  ``reshard_time`` is its copies' span on the copy stream, not the update
  queued before them. This file imports no JAX, so
  the GPU machine runs it:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_weight_sync.py
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.common.config import RolloutConfig, TrainConfig  # noqa: E402
from repro_torch.common.tree import leaves  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.copris import CoPRISTrainer  # noqa: E402
from repro_torch.core.weight_sync import (ParamStore,  # noqa: E402
                                          make_param_resharder)
from repro_torch.data.tasks import EOS, AdditionTask  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.sampling import prng  # noqa: E402

torch.set_num_threads(1)


def _w(v):
    return {"w": torch.tensor(float(v))}


def _val(params):
    return float(params["w"])


# -- the ParamStore contract ---------------------------------------------------


def test_param_store_publish_acquire_freshest():
    ps = ParamStore(max_versions=3)
    assert ps.latest_version == -1
    for v in range(3):
        ps.publish(_w(v), v)
    params, version = ps.acquire()
    assert version == 2 and _val(params) == 2.0
    assert ps.versions() == (0, 1, 2)
    assert ps.stats["published"] == 3 and ps.stats["acquired"] == 1
    assert ps.stats["reshard_time"] == 0.0


def test_param_store_version_monotonicity():
    ps = ParamStore(max_versions=4)
    ps.publish(_w(0), 5)
    with pytest.raises(ValueError, match="monotonic"):
        ps.publish(_w(1), 5)              # same version, no replace
    with pytest.raises(ValueError, match="monotonic"):
        ps.publish(_w(1), 3)              # older version
    # checkpoint-restore swaps the weights behind the unchanged version
    ps.publish(_w(7), 5, replace=True)
    params, version = ps.acquire()
    assert version == 5 and _val(params) == 7.0
    with pytest.raises(ValueError, match="monotonic"):
        ps.publish(_w(2), 4, replace=True)   # replace can't rewind


def test_param_store_drop_stale():
    ps = ParamStore(max_versions=2)
    for v in range(5):
        ps.publish(_w(v), v)
    assert ps.versions() == (3, 4)        # bounded window, oldest dropped
    assert ps.stats["dropped"] == 3
    assert _val(ps.get(4)) == 4.0
    with pytest.raises(KeyError):
        ps.get(0)                          # superseded weights are gone
    _, version = ps.acquire()
    assert version == 4


def test_param_store_acquire_before_publish():
    with pytest.raises(RuntimeError, match="before the first publish"):
        ParamStore().acquire()


def test_param_store_rejects_empty_window():
    with pytest.raises(ValueError, match="max_versions"):
        ParamStore(max_versions=0)


def test_param_store_wait_for():
    ps = ParamStore(max_versions=2)
    ps.publish(_w(0), 0)
    assert ps.wait_for(0, timeout=0.1)
    assert not ps.wait_for(1, timeout=0.05)     # not there yet
    t = threading.Timer(0.05, lambda: ps.publish(_w(1), 1))
    t.start()
    try:
        assert ps.wait_for(1, timeout=5.0)      # unblocked by the publish
    finally:
        t.join(timeout=5.0)
    assert not t.is_alive()


def test_param_store_publish_stores_a_copy():
    """The trainer updates its masters in place: a published version must
    not move with them."""
    ps = ParamStore(max_versions=2)
    live = {"w": torch.zeros(4), "b": [torch.ones(2)]}
    ps.publish(live, 0)
    with torch.no_grad():
        live["w"].add_(3.0)
        live["b"][0].mul_(5.0)
    params, _ = ps.acquire()
    assert params["w"].tolist() == [0.0] * 4
    assert params["b"][0].tolist() == [1.0, 1.0]
    assert not params["w"].requires_grad


def test_disaggregated_requires_overlap():
    with pytest.raises(ValueError, match="requires overlap"):
        TrainConfig(disaggregated=True)
    TrainConfig(overlap=True, disaggregated=True)      # valid config


def test_restore_republishes_through_the_store():
    cfg = get_config("tiny")
    params = M.init_params(cfg, seed=0, device="cpu")
    other = M.init_params(cfg, seed=1, device="cpu")
    tr = CoPRISTrainer(cfg, RolloutConfig(batch_size=2, group_size=2,
                                          concurrency=2),
                       TrainConfig(), AdditionTask(), eos_id=EOS,
                       params=params, device="cpu")
    try:
        tr.restore(params=other, stage=3)
        got, version = tr.param_store.acquire()
        assert version == 3 and tr.stage == 3
        assert all(torch.equal(a, b)
                   for a, b in zip(leaves(got), leaves(other)))
        with pytest.raises(ValueError, match="monotonic"):
            tr.restore(stage=2)
    finally:
        tr.close()


# -- the disaggregated reshard ----------------------------------------------------


def test_param_resharder_is_a_bit_exact_copy():
    """Device sides: every leaf copied onto the rollout device, same
    dtype, same bits, no aliasing of the masters; as the store's reshard
    its time lands in ``reshard_time``."""
    cfg = get_config("tiny")
    params = M.init_params(cfg, seed=0, device="cpu")
    reshard, out = make_param_resharder(cfg, params, "cpu", "cpu")
    assert out == torch.device("cpu")
    copy, elapsed = reshard(params)
    assert elapsed() > 0.0
    for a, b in zip(leaves(copy), leaves(params)):
        assert a.dtype == b.dtype and a.device == b.device
        assert a.data_ptr() != b.data_ptr()
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32
                           else a, b.view(torch.int32)
                           if b.dtype == torch.float32 else b)
    ps = ParamStore(max_versions=2, reshard=reshard)
    ps.publish(params, 0)
    with torch.no_grad():
        leaves(params)[0].add_(1.0)
    got, _ = ps.acquire()
    assert not torch.equal(leaves(got)[0], leaves(params)[0])
    assert ps.stats_snapshot()["reshard_time"] > 0.0


def test_param_resharder_on_a_mesh_redistributes_to_serving():
    """Mesh sides (one mesh for both): each DTensor leaf goes from its
    training placements to the serve_tp_only ones, on a copy, the values
    unchanged bit for bit."""
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_single_mesh
    cfg = get_config("tiny")
    params = M.init_params(cfg, seed=0, device="cpu")
    mesh = make_single_mesh("cpu")
    try:
        sharded = shd.shard_params(params, mesh, cfg)
        reshard, out = make_param_resharder(cfg, sharded, mesh, mesh)
        copy, elapsed = reshard(sharded)
        assert elapsed() >= 0.0
        want = shd.params_placements(params, mesh, cfg=cfg,
                                     serve_tp_only=True)
        for a, b, pl, full in zip(leaves(copy), leaves(sharded),
                                  leaves_of_placements(want, params),
                                  leaves(params)):
            assert tuple(a.placements) == pl
            assert a.to_local().data_ptr() != b.to_local().data_ptr()
            assert torch.equal(a.full_tensor(), full)
        with pytest.raises(NotImplementedError, match="disaggregated"):
            make_param_resharder(cfg, sharded, mesh, "cpu")
    finally:
        torch.distributed.destroy_process_group()


def leaves_of_placements(pl_tree, like):
    """The placements of ``pl_tree`` in the leaf order of ``like``."""
    if isinstance(like, dict):
        return [x for k in sorted(like)
                for x in leaves_of_placements(pl_tree[k], like[k])]
    if isinstance(like, list):
        return [x for i, v in enumerate(like)
                for x in leaves_of_placements(pl_tree[i], v)]
    return [pl_tree]


_RO = dict(batch_size=4, group_size=2, max_prompt_len=16,
           max_response_len=12, concurrency=8, mode="copris")


def _overlapped(disaggregated, steps=3):
    """A tiny overlapped run, its collects pinned to the version one
    update behind (the store's ``acquire`` replaced by ``get`` of that
    version), so two runs collect the same batches. Returns (outs, whether
    the store's freshest version was the consumer's params at each stage,
    the final params)."""
    cfg = get_config("tiny")
    tr = CoPRISTrainer(
        cfg, RolloutConfig(**_RO),
        TrainConfig(lr=2e-4, warmup_steps=2, overlap=True,
                    disaggregated=disaggregated, seed=0),
        AdditionTask(max_value=9, seed=0), eos_id=EOS,
        params=M.init_params(cfg, seed=0, device="cpu"), device="cpu")
    tr.batch_timeout = 120.0
    store, nxt = tr.param_store, iter(range(1 << 30))

    def pinned():
        v = max(0, next(nxt) - 1)
        assert store.wait_for(v, timeout=120.0)
        return store.get(v), v

    store.acquire = pinned

    def same():
        return all(torch.equal(a, b.detach()) for a, b in
                   zip(leaves(store.get(tr.stage)), leaves(tr.params)))

    stages, outs = [same()], []
    try:
        for _ in range(steps):
            outs.append(tr.step())
            stages.append(same())
        final = [t.detach().clone() for t in leaves(tr.params)]
    finally:
        tr.close()
    return outs, stages, final


def test_disaggregated_trainer_store_is_the_consumers_params():
    outs, stages, final = _overlapped(True)
    assert stages == [True] * 4
    for o in outs:
        assert np.isfinite(o["pg_loss"]) and o["reshard_time"] >= 0.0
        assert o["param_staleness"] <= 1
    assert outs[0]["reshard_time"] > 0.0
    # the reshard is a copy: the same run without it ends on the same bits
    _, _, plain = _overlapped(False)
    assert all(torch.equal(a, b) for a, b in zip(final, plain))


def test_train_launcher_runs_disaggregated(tmp_path):
    import json

    from repro_torch.launch import train as train_launch
    train_launch.main(["--arch", "tiny", "--device", "cpu", "--steps", "2",
                       "--sft-warmup", "3", "--overlap", "--disaggregated",
                       "--rollout-device", "cpu", "--max-response", "16",
                       "--eval-every", "0", "--out", str(tmp_path)])
    rows = [json.loads(line) for line in
            open(tmp_path / "metrics.jsonl").read().splitlines()]
    assert len(rows) == 2
    assert all(r["reshard_time"] >= 0.0 and np.isfinite(r["pg_loss"])
               for r in rows)


# -- streams on the card -------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (run on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _busy(a, n=40):
    """A loop of GEMMs queued on the current stream (tens of ms)."""
    for _ in range(n):
        a = torch.tanh(a @ a)
    return a


@pytest.mark.cuda
def test_snapshot_integrity_across_streams(dev):
    """Publish on the train stream right behind a long queue of work that
    writes the masters, acquire on the rollout stream, keep updating the
    masters in place: the acquired version holds exactly the values at
    publish time."""
    train, rollout = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    g = torch.Generator(device="cpu").manual_seed(0)
    masters = {"w": torch.randn(2048, 2048, generator=g).to(dev)}
    torch.cuda.synchronize()
    ps = ParamStore(max_versions=2)
    busy = torch.randn(4096, 4096, generator=g).to(dev) * 1e-3
    with torch.cuda.stream(train):
        _busy(busy)                           # delays everything behind it
        masters["w"].add_(1.0)
        want = masters["w"].cpu()             # syncs the train stream only
        _busy(busy)
        ps.publish(masters, 0)
        for _ in range(20):                   # in place, after the clone
            masters["w"].mul_(1.5)
    with torch.cuda.stream(rollout):
        got, version = ps.acquire()
        read = got["w"] * 1.0                 # a kernel on the rollout stream
        out = read.cpu()
    assert version == 0
    assert torch.equal(out, want)
    torch.cuda.synchronize()
    assert torch.equal(got["w"].cpu(), want)


@pytest.mark.cuda
def test_param_resharder_times_the_copy_stream(dev):
    """On the card the reshard's copies wait for the update queued before
    them, land bit for bit, and ``reshard_time`` is their own span on the
    copy stream: above zero and below the queued work it waited for."""
    cfg = get_config("tiny")
    params = M.init_params(cfg, seed=0, device=dev)
    reshard, _ = make_param_resharder(cfg, params, dev, dev)
    ps = ParamStore(max_versions=2, reshard=reshard)
    busy = torch.randn(4096, 4096, device=dev) * 1e-3
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "01")
    e0.record()
    _busy(busy)
    with torch.no_grad():
        leaves(params)[0].add_(1.0)           # the update, behind the GEMMs
    e1.record()
    ps.publish(params, 0)
    want = [t.detach().clone() for t in leaves(params)]
    st = ps.stats_snapshot()
    got, _ = ps.acquire()
    assert all(torch.equal(a, b) for a, b in zip(leaves(got), want))
    assert 0.0 < st["reshard_time"] < e0.elapsed_time(e1) / 1e3


@pytest.mark.cuda
def test_decode_chunk_beside_gemms_on_another_stream(dev):
    """A rollout collect on one stream while GEMMs run on another samples
    the same tokens, with the same logps, as the same collect alone."""
    from repro_torch.core.rollout import RolloutEngine
    cfg = get_config("llama3.2-1b").reduced()
    params = M.init_params(cfg, seed=0, device=dev)
    ro = RolloutConfig(batch_size=2, group_size=2, max_prompt_len=16,
                       max_response_len=32, concurrency=4, mode="copris",
                       decode_chunk=8)

    def collect(stream):
        rng = np.random.default_rng(3)

        def source():
            return rng.integers(0, cfg.vocab_size - 1, 12), None

        with torch.cuda.stream(stream):
            eng = RolloutEngine(cfg, ro, source, eos_id=cfg.vocab_size - 1,
                                device=dev)
            groups, _ = eng.collect(params, 0, prng.PRNGKey(5))
        return {(g.group_id, t.sample_idx): (t.response_tokens,
                                             t.behaviour_logps)
                for g in groups for t in g.trajectories}

    rollout, other = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    alone = collect(rollout)
    busy = torch.randn(4096, 4096, device=dev) * 1e-3
    torch.cuda.synchronize()
    with torch.cuda.stream(other):
        for _ in range(10):
            _busy(busy)
    beside = collect(rollout)
    torch.cuda.synchronize()
    assert len(alone) == 4 and beside == alone
