"""The port's versioned weight sync (``repro_torch.core.weight_sync``).

* the ParamStore contract of ``tests/test_weight_sync.py``, against the
  port's store: acquire gives the freshest version, versions are strictly
  monotonic, stale versions are dropped, acquire before the first publish
  raises, an empty window is rejected, ``wait_for``; publish stores a copy,
  so an update in place does not reach a published version;
* config validation: ``disaggregated`` requires ``overlap``; the trainer's
  ``restore`` republishes through the store;
* on the card (marked ``cuda``, skipped elsewhere; the decision is taken
  inside the fixture): a version acquired on a second stream while the
  first keeps updating the masters in place reads exactly the published
  values, and a decode chunk on one stream while a loop of GEMMs runs on
  another gives the tokens it gives alone. This file imports no JAX, so
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
from repro_torch.core.weight_sync import ParamStore  # noqa: E402
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
