"""The port's overlapped (one-step async) CoPRIS trainer, on the CPU.

* ``overlap=False`` reproduces the sequential loop (inlined below from the
  port's own engine, loss and AdamW) bit for bit: tokens, logps, stages,
  rewards, losses and the final parameters;
* ``overlap=True`` is a producer/consumer pipeline: the staleness accounting
  of ``tests/test_async_trainer.py`` with ``max_staleness`` 1 and 2, the
  adaptive-concurrency smoke test, a single owner for ``collect``, an
  idempotent ``close()``, and a producer exception raised from ``step()``;
* parity against JAX by schedule replay: an overlapped port run records
  each batch's ``params_version``; the JAX sequential trainer replays that
  schedule with its ``param_store.acquire`` returning
  ``param_store.get(v)`` for the recorded v (the test patches the
  instance; nothing in the JAX package changes). Same trajectory keys and
  tokens; ``pg_loss`` and ``ratio_mean`` atol 1e-5, the tolerance of
  ``test_trainer_step_matches_jax_trainer``; the final parameters atol
  1e-6, the tolerance of ``tests/test_torch_train``'s AdamW step (the
  entropy bonus of 0.01 gives every step a gradient, so the updates are
  not all zero);
* the kernels' Python side under two threads: launch counts stay exact, and
  a library's first build runs once.
"""
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.common.config import RolloutConfig as JRolloutConfig  # noqa: E402
from repro.common.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import copris as jcopris  # noqa: E402
from repro.data.tasks import AdditionTask as JAdditionTask  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.common.config import RolloutConfig, TrainConfig  # noqa: E402
from repro_torch.common.tree import leaves, tree_map  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import grpo  # noqa: E402
from repro_torch.core.copris import CoPRISTrainer, make_train_step  # noqa: E402
from repro_torch.core.importance import pack_groups  # noqa: E402
from repro_torch.core.reward_worker import AsyncRewardWorker  # noqa: E402
from repro_torch.core.rollout import RolloutEngine  # noqa: E402
from repro_torch.data.tasks import EOS, AdditionTask  # noqa: E402
from repro_torch.hopper import build  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import adam, schedule  # noqa: E402
from repro_torch.sampling import prng  # noqa: E402

torch.set_num_threads(1)
CFG = get_config("tiny")
RO = dict(batch_size=4, group_size=2, max_prompt_len=16, max_response_len=12,
          concurrency=8, mode="copris")
TC = dict(lr=2e-4, warmup_steps=2, microbatches=1, entropy_coef=0.01)
N_STEPS = 4


@pytest.fixture(scope="module")
def init_params():
    return M.init_params(CFG, seed=0, device="cpu")


def _copy(params):
    return tree_map(lambda t: t.detach().clone(), params)


def _trainer(params, *, overlap, max_staleness=1, seed=0, task=None, **ro):
    task = task if task is not None else AdditionTask(max_value=9, seed=seed)
    tc = TrainConfig(**TC, overlap=overlap, max_staleness=max_staleness,
                     seed=seed)
    tr = CoPRISTrainer(CFG, RolloutConfig(**{**RO, **ro}), tc, task,
                       eos_id=EOS, params=_copy(params), device="cpu")
    tr.batch_timeout = 120.0
    return tr


def _traj_keys(groups):
    return [(g.group_id, t.sample_idx, tuple(t.response_tokens),
             tuple(t.behaviour_logps), tuple(t.stage_ids))
            for g in groups for t in g.trajectories]


def _reference_run(params, n_steps, seed=0):
    """The sequential loop, inlined: split the key per step, collect under
    the CURRENT params stamped with the train stage, gather rewards, pack,
    GRPO + AdamW."""
    task = AdditionTask(max_value=9, seed=seed)
    ro = RolloutConfig(**RO)
    tc = TrainConfig(**TC, seed=seed)
    key = prng.split(prng.PRNGKey(tc.seed))[0]
    params = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    opt_state = adam.init(params)
    worker = AsyncRewardWorker(task.reward)
    engine = RolloutEngine(CFG, ro, task.sample_prompt, eos_id=EOS,
                           on_finish=worker.submit, device="cpu")
    train_step = make_train_step(CFG, tc)
    outs = []
    try:
        for stage in range(n_steps):
            key, k_roll = prng.split(key)
            groups, _ = engine.collect(params, stage, k_roll)
            worker.gather(groups)
            batch = pack_groups(groups, max_len=engine.max_len)
            tb = {k: torch.from_numpy(batch[k])
                  for k in ("tokens", "loss_mask", "behaviour_logp")}
            tb["advantages"] = grpo.group_advantages(
                torch.from_numpy(batch["rewards"]), ro.group_size)
            lr = schedule.warmup_constant(stage, lr=tc.lr,
                                          warmup_steps=tc.warmup_steps)
            params, opt_state, metrics = train_step(params, opt_state, tb, lr)
            outs.append(dict(trajs=_traj_keys(groups),
                             rewards=batch["rewards"].copy(),
                             pg_loss=float(metrics["pg_loss"]),
                             ratio_mean=float(metrics["ratio_mean"])))
    finally:
        worker.shutdown()
    return params, outs


# -- overlap=False bit-identity ------------------------------------------------


def test_overlap_off_bit_identity_with_sequential_loop(init_params):
    ref_params, ref = _reference_run(init_params, N_STEPS)
    tr = _trainer(init_params, overlap=False)
    try:
        for i in range(N_STEPS):
            out = tr.step()
            assert _traj_keys(tr.last_groups) == ref[i]["trajs"], f"step {i}"
            np.testing.assert_array_equal(tr.last_batch["rewards"],
                                          ref[i]["rewards"])
            assert out["pg_loss"] == ref[i]["pg_loss"], f"step {i}"
            assert out["ratio_mean"] == ref[i]["ratio_mean"], f"step {i}"
            assert out["param_staleness"] == 0
            assert out["overlap_saved_time"] == 0.0
            assert out["batch_wait_time"] == 0.0
    finally:
        tr.close()
    assert all(torch.equal(a, b) for a, b in zip(leaves(tr.params),
                                                 leaves(ref_params)))


# -- overlap=True pipeline -----------------------------------------------------


def test_overlap_staleness_accounting(init_params):
    tr = _trainer(init_params, overlap=True, max_staleness=1)
    outs = []
    try:
        for _ in range(N_STEPS):
            out = tr.step()
            outs.append(out)
            train_stage = out["step"]
            stages = tr.last_batch["stage_ids"]
            resp = stages >= 0
            # every trained token was sampled under a policy no NEWER than
            # the training stage, and the params snapshot lag is bounded
            assert (stages[resp] <= train_stage).all()
            assert 0 <= out["param_staleness"] <= tr.max_staleness
            hist = out["staleness_hist"]
            assert all(g >= 0 for g in hist)
            assert sum(hist.values()) == int(resp.sum())
            off = sum(c for g, c in hist.items() if g > 0)
            assert out["off_policy_frac"] == pytest.approx(
                off / max(1, int(resp.sum())))
            assert np.isfinite(out["pg_loss"]) and out["batch_wait_time"] >= 0
    finally:
        tr.close()
    assert [o["step"] for o in outs] == list(range(N_STEPS))
    # the pipeline overlapped: a batch collected under params one update
    # behind the ones that trained on it
    assert any(o["param_staleness"] == 1 for o in outs[1:])


def test_multi_step_staleness_pipeline(init_params):
    """max_staleness=2: every consumed batch's params gap stays <= 2 and the
    ParamStore holds at most K+1 versions (older ones dropped)."""
    tr = _trainer(init_params, overlap=True, max_staleness=2)
    n = 6
    try:
        outs = [tr.step() for _ in range(n)]
    finally:
        tr.close()
    assert [o["step"] for o in outs] == list(range(n))
    for o in outs:
        assert 0 <= o["param_staleness"] <= 2
        assert np.isfinite(o["pg_loss"])
        assert o["param_store_versions"] <= 3       # K + 1 window
    # one publish per optimizer update (plus the construction version)
    assert tr.param_store.stats["published"] == n + 1
    assert tr.param_store.latest_version == n
    stages = tr.last_batch["stage_ids"]
    resp = stages >= 0
    assert (stages[resp] <= outs[-1]["step"]).all()
    assert (stages[resp] >= outs[-1]["step"] - 2 - 1).all()


def test_adaptive_concurrency_trainer_smoke(init_params):
    """Each stage's collect runs under the controller's current target,
    within the configured bounds; the controller's trace covers every
    stage; the slot pool is sized to the adaptive upper bound."""
    tr = _trainer(init_params, overlap=True, adaptive_concurrency=True,
                  concurrency_min=2, concurrency_max=16)
    assert tr.engine.pool == 16
    try:
        outs = [tr.step() for _ in range(4)]
    finally:
        tr.close()
    for o in outs:
        assert 2 <= o["concurrency_target"] <= 16
    trace = tr._concurrency_ctrl.trace
    assert len(trace) >= len(outs)
    assert all(2 <= t <= 16 for t in trace)


def test_collect_is_single_owner(init_params):
    tr = _trainer(init_params, overlap=False)
    eng = tr.engine
    assert eng._collect_guard.acquire(blocking=False)
    try:
        with pytest.raises(RuntimeError, match="single thread"):
            eng.collect(tr.params, 0, prng.PRNGKey(0))
    finally:
        eng._collect_guard.release()
        tr.close()


def test_close_is_idempotent_and_stops_the_producer(init_params):
    tr = _trainer(init_params, overlap=True)
    tr.step()
    producer = tr._producer
    assert producer.is_alive()
    tr.close()
    tr.close()
    assert not producer.is_alive()
    assert tr._batches.empty()
    with pytest.raises(RuntimeError, match="closed"):
        tr.step()


class _FailingTask(AdditionTask):
    """Serves ``ok`` prompts, then raises from ``sample_prompt``."""

    def __init__(self, ok):
        super().__init__(max_value=9, seed=0)
        self.ok = ok

    def sample_prompt(self):
        if self.ok <= 0:
            raise ValueError("prompt source broke")
        self.ok -= 1
        return super().sample_prompt()


def test_producer_exception_raised_from_step(init_params):
    tr = _trainer(init_params, overlap=True, task=_FailingTask(0))
    try:
        with pytest.raises(RuntimeError, match="producer failed") as ei:
            tr.step()
        assert isinstance(ei.value.__cause__, ValueError)
        tr._producer.join(timeout=10.0)
        assert not tr._producer.is_alive()
        with pytest.raises(RuntimeError, match="producer failed"):
            tr.step()                   # the run does not carry on
    finally:
        tr.close()


# -- parity against JAX by schedule replay ---------------------------------------


def test_overlapped_run_replayed_on_jax_sequential_trainer():
    cfg_j = jget_config("tiny")
    pt = M.init_params(CFG, seed=0, device="cpu")
    pj = jax.tree.map(jnp.asarray, convert.params_to_jax(pt, CFG))
    tc = dict(TC, seed=0)
    tr = _trainer(pt, overlap=True, max_staleness=1)
    try:
        outs = []
        groups = []
        for _ in range(N_STEPS):
            outs.append(tr.step())
            groups.append(_traj_keys(tr.last_groups))
    finally:
        tr.close()
    schedule_ = [o["step"] - o["param_staleness"] for o in outs]
    assert schedule_ != list(range(N_STEPS)), "the run did not overlap"

    jt = jcopris.CoPRISTrainer(cfg_j, JRolloutConfig(**RO),
                               JTrainConfig(**tc),
                               JAdditionTask(max_value=9, seed=0),
                               eos_id=EOS, params=pj)
    versions = iter(schedule_)
    store = jt.param_store

    def replay_acquire():
        v = next(versions)
        return store.get(v), v

    store.acquire = replay_acquire
    try:
        for i, o in enumerate(outs):
            oj = jt.step()
            got = _traj_keys(jt.last_groups)
            assert [k[:3] + k[4:] for k in got] == \
                [k[:3] + k[4:] for k in groups[i]], f"step {i}"
            for a, b in zip(got, groups[i]):
                np.testing.assert_allclose(a[3], b[3], atol=1e-5)
            assert oj["param_staleness"] == o["param_staleness"]
            for k in ("pg_loss", "ratio_mean"):
                np.testing.assert_allclose(o[k], oj[k], atol=1e-5,
                                           err_msg=f"{k} step {i}")
            assert oj["grad_norm"] > 0.0
        final_j = convert.params_from_jax(jax.device_get(jt.params), CFG,
                                          "cpu")
    finally:
        jt.close()
    moved = 0
    for a, b, p0 in zip(leaves(tr.params), leaves(final_j), leaves(pt)):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), atol=1e-6)
        moved += int((b != p0).sum())
    assert moved > 1000


# -- the kernels' Python side under two threads ---------------------------------


def test_launch_counts_exact_under_threads():
    def wrapper():
        pass

    wrapper.launches = wrapper.simt_launches = 0
    n_threads, n = 16, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [build.count(wrapper, "simt_launches")
                            for _ in range(n)]) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == wrapper.simt_launches == n_threads * n


def test_first_build_of_a_library_runs_once(monkeypatch):
    """Two threads that first use one source: one nvcc run, one library."""
    runs = []

    def start(name):
        runs.append(name)
        time.sleep(0.2)                 # nvcc takes seconds
        return None                      # "already built" after this

    class Lib:
        def __getattr__(self, name):
            fn = lambda *a: 0            # noqa: E731
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(build, "_start", start)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: Lib())
    monkeypatch.setattr(build, "_LIBRARIES", {})
    got = []
    threads = [threading.Thread(
        target=lambda: got.append(build.library("flash_attn")))
        for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
    assert not any(t.is_alive() for t in threads)
    assert runs == ["flash_attn"]
    assert len(got) == 4 and all(lib is got[0] for lib in got)
