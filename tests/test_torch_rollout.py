"""The port's rollout engine and serving facade on `tiny`, on the CPU.

* decode_chunk invariance inside the port (bit-identical trajectories);
* cross-framework: the port's and the JAX engine's trajectories agree on
  converted weights with the same stage key (tokens equal, logps within
  atol 1e-5);
* ServeEngine.drain returns every request;
* a copris stage buffers partials and the next stage resumes them.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.common.config import RolloutConfig as JRolloutConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.rollout import RolloutEngine as JRolloutEngine  # noqa: E402
from repro.data.tasks import EOS, AdditionTask  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.common.config import RolloutConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.tasks import MultiTurnMathTask  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.rollout import (RolloutEngine,  # noqa: E402
                                      prefill_pad_dims)
from repro_torch.launch.serve import (GenerateRequest,  # noqa: E402
                                      make_serve_engine)
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.sampling import kv_cache as kvc  # noqa: E402
from repro_torch.sampling import prng  # noqa: E402

torch.set_num_threads(1)
CFG = get_config("tiny")


@pytest.fixture(scope="module")
def jax_params():
    return JM.init_params(jax.random.PRNGKey(0), jget_config("tiny"))


@pytest.fixture(scope="module")
def params(jax_params):
    return params_from_jax(jax.device_get(jax_params), CFG, device="cpu")


def _ro(cls, mode, chunk, **kw):
    base = dict(batch_size=3, group_size=2, max_prompt_len=16,
                max_response_len=24, concurrency=4, mode=mode,
                decode_chunk=chunk)
    base.update(kw)
    return cls(**base)


def _run(params, mode, chunk, **kw):
    task = AdditionTask(max_value=20, seed=9)
    eng = RolloutEngine(CFG, _ro(RolloutConfig, mode, chunk, **kw),
                        task.sample_prompt, eos_id=EOS, device="cpu")
    return eng.collect(params, 0, prng.PRNGKey(42))


def _traj_map(groups):
    return {(g.group_id, t.sample_idx): t
            for g in groups for t in g.trajectories}


@pytest.mark.parametrize("mode", ["copris", "sync"])
def test_decode_chunk_invariance(params, mode):
    base, _ = _run(params, mode, 1)
    got, _ = _run(params, mode, 4)
    b, g = _traj_map(base), _traj_map(got)
    common = set(b) & set(g)
    assert b and len(common) >= len(b) // 2
    for key in common:
        assert b[key].response_tokens == g[key].response_tokens, key
        assert b[key].behaviour_logps == g[key].behaviour_logps, key
        assert b[key].finish_reason == g[key].finish_reason, key
    if mode == "sync":
        assert set(b) == set(g)


@pytest.mark.parametrize("mode,chunk", [("copris", 4), ("sync", 1)])
def test_engine_matches_jax_engine(params, jax_params, mode, chunk):
    """Same task prompts, same stage key, converted weights."""
    got, st = _run(params, mode, chunk)
    task = AdditionTask(max_value=20, seed=9)
    jeng = JRolloutEngine(jget_config("tiny"),
                          _ro(JRolloutConfig, mode, chunk),
                          task.sample_prompt, eos_id=EOS)
    ref, jst = jeng.collect(jax_params, 0, jax.random.PRNGKey(42))
    g, r = _traj_map(got), _traj_map(ref)
    assert set(g) == set(r)
    for key in r:
        assert g[key].response_tokens == r[key].response_tokens, key
        np.testing.assert_allclose(g[key].behaviour_logps,
                                   r[key].behaviour_logps, atol=1e-5)
        assert g[key].finish_reason == r[key].finish_reason, key
    assert st["generated"] == jst["generated"]


@pytest.mark.parametrize("resume", ["reprefill", "kv_snapshot"])
def test_copris_buffers_partials_and_resumes(params, resume):
    """Groups whose prompt leaves less room (max_len cap) finish first:
    early termination must buffer the rest, and the next stage resumes
    them (re-prefilled, or from their dense KV snapshot) with the new
    stage's id on the new tokens."""
    rng = np.random.default_rng(0)

    def source():
        n = int(rng.integers(3, 40))
        return rng.integers(0, CFG.vocab_size - 1, n).astype(np.int32), None

    ro = RolloutConfig(batch_size=2, group_size=2, max_prompt_len=40,
                       max_response_len=40, concurrency=8, mode="copris",
                       decode_chunk=4, temperature=1.0,
                       resume_strategy=resume)
    eng = RolloutEngine(CFG, ro, source, eos_id=CFG.vocab_size - 1,
                        max_len=64, device="cpu")
    g1, s1 = eng.collect(params, 0, prng.PRNGKey(1))
    assert len(g1) == 2 and s1["evicted"] > 0
    assert eng.buffer.num_unfinished > 0
    g2, s2 = eng.collect(params, 1, prng.PRNGKey(2))
    assert s2["resumed"] > 0
    if resume == "kv_snapshot":
        assert s2["snapshot_resumes"] > 0
    multi = [t for g in g2 for t in g.trajectories if t.num_stages > 1]
    for t in multi:
        t.check_invariants()
        assert t.stage_ids[0] == 0 and t.stage_ids[-1] == 1


def test_serve_drain_returns_every_request():
    serve, cfg = make_serve_engine("tiny", max_prompt_len=8, max_tokens=12,
                                   concurrency=3, seed=0, device="cpu")
    rng = np.random.default_rng(1)
    rids = [serve.submit(GenerateRequest(
        prompt=rng.integers(0, cfg.vocab_size, 8))) for _ in range(7)]
    out = serve.drain()
    assert sorted(r.request_id for r in out) == rids
    for r in out:
        assert 1 <= len(r.tokens) <= 12 and len(r.logprobs) == len(r.tokens)
        assert all(0 <= t < cfg.vocab_size for t in r.tokens)
        assert all(np.isfinite(lp) and lp <= 0 for lp in r.logprobs)
        assert r.finish_reason in ("eos", "length")
    stats = serve.close()
    assert stats["generated"] > 0


def test_serve_is_deterministic():
    def run():
        serve, cfg = make_serve_engine("tiny", max_prompt_len=8,
                                       max_tokens=10, concurrency=2, seed=3,
                                       top_k=8, top_p=0.9, device="cpu")
        rng = np.random.default_rng(2)
        for _ in range(4):
            serve.submit(GenerateRequest(
                prompt=rng.integers(0, cfg.vocab_size, 8)))
        return sorted((r.request_id, tuple(r.tokens)) for r in serve.drain())
    assert run() == run()


def test_dense_insert_rows_drops_padding():
    cache = TM.init_cache(CFG, 3, 16, device="cpu")
    scratch = TM.init_cache(CFG, 2, 8, device="cpu")
    for layer in scratch:
        layer["k"][0] = 1.0
        layer["k"][1] = 2.0
    kvc.dense_insert_rows(cache, scratch, np.array([2, 0, 3, 3]),
                          np.array([0, 1, 0, 1]))
    k = cache[0]["k"]
    assert (k[2, :8] == 1).all() and (k[0, :8] == 2).all()
    assert (k[1] == 0).all() and (k[:, 8:] == 0).all()   # slot 3 dropped


def test_paged_backend_and_envs_are_later_slices(params):
    """Both are ported now (tests/test_torch_paged.py,
    tests/test_torch_multiturn.py): the engine takes an ``env_factory``,
    a stopped turn parks on its environment without a slot, and its
    observation (role 0) is followed by a resumed model turn."""
    task = MultiTurnMathTask(max_value=9, num_turns=2, seed=3)
    eng = RolloutEngine(CFG, _ro(RolloutConfig, "copris", 4,
                                 max_response_len=64),
                        task.sample_prompt, eos_id=EOS,
                        env_factory=task.make_env, device="cpu")
    try:
        groups, st = eng.collect(params, 0, prng.PRNGKey(1))
    finally:
        eng.env_worker.shutdown()
    assert st["env_steps"] > 0 and st["env_turns"] > 0
    resumed = [t for g in groups for t in g.trajectories
               if t.num_turns > 1 and t.roles[-1] == 1]
    assert resumed, "no parked turn resumed after its observation"
    for t in resumed:
        t.check_invariants()
        obs = t.turn_starts[1]
        assert t.roles[obs - 1] == 0 and t.behaviour_logps[obs - 1] == 0.0


def test_prefill_pad_dims_buckets():
    assert prefill_pad_dims([5, 64], 3, 3) == (64, 4, 4)
    assert prefill_pad_dims([65], 1, 1) == (128, 1, 1)
