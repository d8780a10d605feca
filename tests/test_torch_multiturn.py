"""The port's multi-turn environments on the CPU, against the JAX package.

* environments: the port's ``MultiStepMathEnv``, ``CalculatorToolEnv``,
  the single-turn adapter and ``TaskMixture`` against JAX's on seeded
  specs: ``reset()``, and ``step()`` on the same responses; the edge cases
  of ``CalculatorToolEnv._eval_call``; the mixture's dispatch sequence for
  one seed;
* engine parity: the port's ``RolloutEngine(env_factory=...)`` against
  JAX's, same weights, prompts and stage key, dense (and the port's paged
  engine against the same JAX run): on common (group_id, sample_idx) keys
  equal response tokens, roles, ``turn_starts`` and ``env_return``, logps
  atol 1e-5 (torch's and XLA's f32 transcendentals differ in the last
  bits); ``env_steps`` / ``env_turns`` equal. Both engines get an
  env worker that runs each step at submit, so which chunk boundary an
  observation lands on does not depend on thread timing;
* the engine's properties, re-proved in the port with the threaded
  ``AsyncEnvWorker``: dense and paged preempt between turns and resume
  bit-exactly; an env that raises ends its episode; the single-turn adapter
  gives the plain task's tokens; the overlapped trainer runs multi-turn
  end to end with env tokens out of the loss.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.common.config import RolloutConfig as JRolloutConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.rollout import RolloutEngine as JRolloutEngine  # noqa: E402
from repro.data import tasks as jtasks  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.common.config import RolloutConfig, TrainConfig  # noqa: E402
from repro_torch.common.tree import tree_map  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.copris import CoPRISTrainer  # noqa: E402
from repro_torch.core.rollout import RolloutEngine  # noqa: E402
from repro_torch.data import tasks  # noqa: E402
from repro_torch.data.tasks import (CALL, EOS, EQ, PLUS, AdditionTask,  # noqa: E402
                                    CalculatorToolEnv, MultiTurnMathTask,
                                    SingleTurnEnvTask)
from repro_torch.sampling import prng  # noqa: E402

torch.set_num_threads(1)
CFG = get_config("tiny")


@pytest.fixture(scope="module")
def jax_params():
    return JM.init_params(jax.random.PRNGKey(0), jget_config("tiny"))


@pytest.fixture(scope="module")
def params(jax_params):
    return params_from_jax(jax.device_get(jax_params), CFG, device="cpu")


def _tmap(groups):
    return {(g.group_id, t.sample_idx): t
            for g in groups for t in g.trajectories}


# -- environments against JAX's -------------------------------------------------


def _responses(rng, n=6):
    """Model turns: digit runs, tool calls (well and badly formed), EOS."""
    out = []
    for _ in range(n):
        kind = int(rng.integers(0, 3))
        body = [int(d) for d in rng.integers(0, 10, int(rng.integers(0, 3)))]
        if kind == 1:
            body = [CALL] + body + [PLUS, int(rng.integers(0, 10))]
        elif kind == 2:
            body = [CALL, PLUS] + body
        out.append(body + [EOS])
    return out


def _episode(env, resps):
    trace = [env.reset().tolist()]
    for r in resps:
        obs, rew, done = env.step(r)
        trace.append((np.asarray(obs).tolist(), float(rew), bool(done)))
        if done:
            break
    return trace


@pytest.mark.parametrize("seed", range(4))
def test_envs_match_jax(seed):
    rng = np.random.default_rng(seed)
    mt = MultiTurnMathTask(max_value=9, num_turns=3, seed=seed)
    jmt = jtasks.MultiTurnMathTask(max_value=9, num_turns=3, seed=seed)
    tc = tasks.ToolCallTask(max_value=9, seed=seed)
    jtc = jtasks.ToolCallTask(max_value=9, seed=seed)
    for _ in range(3):
        (p, spec), (jp, jspec) = mt.sample_prompt(), jmt.sample_prompt()
        assert p.tolist() == jp.tolist() and spec == jspec
        resps = [[int(d) for d in rng.integers(0, 10, 2)] + [EOS]
                 for _ in range(3)]
        assert _episode(mt.make_env(spec), resps) == \
            _episode(jmt.make_env(jspec), resps)
        assert mt.reward(resps[0], spec) == jmt.reward(resps[0], jspec)
        (p, spec), (jp, jspec) = tc.sample_prompt(), jtc.sample_prompt()
        assert p.tolist() == jp.tolist() and spec == jspec
        resps = _responses(rng)
        assert _episode(tc.make_env(spec), resps) == \
            _episode(jtc.make_env(jspec), resps)
        assert tc.reward(resps[0], spec) == jtc.reward(resps[0], jspec)
    st = SingleTurnEnvTask(AdditionTask(max_value=20, seed=seed))
    jst = jtasks.SingleTurnEnvTask(jtasks.AdditionTask(max_value=20,
                                                       seed=seed))
    (p, spec), (jp, jspec) = st.sample_prompt(), jst.sample_prompt()
    assert p.tolist() == jp.tolist() and spec[1] == jspec[1]
    resps = [[1, 2, EOS]]
    assert _episode(st.make_env(spec), resps) == \
        _episode(jst.make_env(jspec), resps)


@pytest.mark.parametrize("body,want", [
    ([2, PLUS, 3], 5),
    ([1, 2, PLUS, 3], 15),                         # multi-digit group
    ([7], 7),
    ([], None),
    ([PLUS, 3], None),                             # leading '+'
    ([2, PLUS], None),                             # trailing '+'
    ([2, EQ, 3], None),                            # non-digit token
])
def test_eval_call_edges(body, want):
    assert CalculatorToolEnv._eval_call(body) == want
    assert jtasks.CalculatorToolEnv._eval_call(body) == want


def test_task_mixture_dispatch_sequence_matches_jax():
    def members(mod):
        return [mod.AdditionTask(max_value=9, seed=0),
                mod.MultiTurnMathTask(max_value=9, num_turns=2, seed=0),
                mod.ToolCallTask(max_value=9, seed=0)]

    mix = tasks.TaskMixture(members(tasks), weights=[1.0, 2.0, 1.0], seed=4)
    jmix = jtasks.TaskMixture(members(jtasks), weights=[1.0, 2.0, 1.0],
                              seed=4)
    seen = set()
    for _ in range(40):
        (p, (m, inner)), (jp, (jm, jinner)) = (mix.sample_prompt(),
                                               jmix.sample_prompt())
        assert m == jm and np.asarray(p).tolist() == np.asarray(jp).tolist()
        seen.add(m)
        resp = [1, EOS]
        assert _episode(mix.make_env((m, inner)), [resp]) == \
            _episode(jmix.make_env((jm, jinner)), [resp])
        assert mix.reward(resp, (m, inner)) == jmix.reward(resp,
                                                           (jm, jinner))
    assert seen == {0, 1, 2}


# -- engine parity ---------------------------------------------------------------


class _InlineEnvWorker:
    """An env worker that runs each step at submit: every observation is
    there at the next poll, whatever the threads' timing."""

    def __init__(self):
        self._done = []

    def submit(self, key, fn, *args):
        try:
            self._done.append((key, True, fn(*args)))
        except Exception as e:          # the engine's failure path
            self._done.append((key, False, e))
        return True

    def poll(self):
        out, self._done = self._done, []
        return out

    def wait(self, timeout):
        pass

    def stats_snapshot(self):
        return dict(env_timeouts=0)

    def shutdown(self):
        pass


def _ro(cls, backend="dense", **kw):
    base = dict(batch_size=3, group_size=2, max_prompt_len=16,
                max_response_len=64, concurrency=4, mode="copris",
                kv_backend=backend, kv_page_size=16, decode_chunk=4)
    base.update(kw)
    return cls(**base)


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_engine_multiturn_matches_jax(params, jax_params, backend):
    task = MultiTurnMathTask(max_value=9, num_turns=2, seed=3)
    eng = RolloutEngine(CFG, _ro(RolloutConfig, backend),
                        task.sample_prompt, eos_id=EOS,
                        env_factory=task.make_env,
                        env_worker=_InlineEnvWorker(), device="cpu")
    got, st = eng.collect(params, 0, prng.PRNGKey(1))
    jtask = jtasks.MultiTurnMathTask(max_value=9, num_turns=2, seed=3)
    jeng = JRolloutEngine(jget_config("tiny"), _ro(JRolloutConfig),
                          jtask.sample_prompt, eos_id=EOS,
                          env_factory=jtask.make_env,
                          env_worker=_InlineEnvWorker())
    ref, jst = jeng.collect(jax_params, 0, jax.random.PRNGKey(1))
    g, r = _tmap(got), _tmap(ref)
    common = set(g) & set(r)
    assert len(common) >= 4
    multi = 0
    for k in common:
        assert g[k].response_tokens == r[k].response_tokens, k
        assert g[k].roles == r[k].roles, k
        assert g[k].turn_starts == r[k].turn_starts, k
        assert g[k].env_return == r[k].env_return, k
        assert g[k].finish_reason == r[k].finish_reason, k
        np.testing.assert_allclose(g[k].behaviour_logps,
                                   r[k].behaviour_logps, atol=1e-5)
        multi += g[k].num_turns > 1
    assert multi > 0, "expected multi-turn episodes among the common keys"
    if backend == "dense":
        assert set(g) == set(r)
        assert (st["env_steps"], st["env_turns"]) == \
            (jst["env_steps"], jst["env_turns"])
    assert st["env_steps"] > 0 and st["env_turns"] > 0


# -- engine properties in the port ---------------------------------------------


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_engine_multiturn_preempt_resume_bitexact(params, backend):
    """Stage 0 is cut after a few chunks, so episodes evict between (and
    inside) turns; stage 1 resumes and finishes them. Same stage key both
    stages: per-trajectory PRNG streams make content independent of where
    the stage boundary fell, so this backend's run equals the dense one's
    bit for bit on common keys."""
    def run(be):
        task = MultiTurnMathTask(max_value=9, num_turns=2, seed=7)
        eng = RolloutEngine(CFG, _ro(RolloutConfig, be), task.sample_prompt,
                            eos_id=EOS, env_factory=task.make_env,
                            device="cpu")
        key = prng.PRNGKey(9)
        try:
            eng.begin_stage(params, 0, key)
            for _ in range(4):                   # 16 decode steps, then cut
                if not eng.step_stage(params, key):
                    break
            g0, s0 = eng.end_stage()
            g1, _ = eng.collect(params, 1, key)
        finally:
            eng.env_worker.shutdown()
        return g0 + g1, s0

    base, s_dense = run("dense")
    got, s_be = run(backend)
    assert s_dense["evicted"] > 0 and s_be["evicted"] > 0
    for groups in (base, got):
        spans = [t for g in groups for t in g.trajectories
                 if t.num_turns > 1 and len(set(t.stage_ids)) > 1]
        assert spans, "expected a multi-turn episode resumed across stages"
        for g in groups:
            for t in g.trajectories:
                t.check_invariants()
    b, g = _tmap(base), _tmap(got)
    common = set(b) & set(g)
    assert common
    for k in common:
        assert b[k].response_tokens == g[k].response_tokens
        assert b[k].roles == g[k].roles
        assert b[k].behaviour_logps == g[k].behaviour_logps


def test_engine_env_exception_ends_episode(params):
    class BoomEnv:
        def reset(self):
            return np.asarray([12, EQ], np.int32)

        def step(self, resp):
            raise RuntimeError("sandbox crashed")

    task = AdditionTask(max_value=20, seed=2)
    eng = RolloutEngine(CFG, _ro(RolloutConfig, batch_size=2,
                                 max_response_len=16),
                        task.sample_prompt, eos_id=EOS,
                        env_factory=lambda spec: BoomEnv(), device="cpu")
    try:
        groups, stats = eng.collect(params, 0, prng.PRNGKey(3))
    finally:
        eng.env_worker.shutdown()
    assert len(groups) == 2
    assert stats["env_failures"] > 0
    for g in groups:
        for t in g.trajectories:
            assert t.done and t.reward == 0.0


def test_engine_single_turn_through_env_adapter_matches_plain(params):
    def run(env_path):
        task = AdditionTask(max_value=20, seed=11)
        ro = _ro(RolloutConfig, max_response_len=20)
        if env_path:
            adapted = SingleTurnEnvTask(AdditionTask(max_value=20, seed=11))
            eng = RolloutEngine(CFG, ro, adapted.sample_prompt, eos_id=EOS,
                                env_factory=adapted.make_env, device="cpu")
        else:
            eng = RolloutEngine(CFG, ro, task.sample_prompt, eos_id=EOS,
                                device="cpu")
        try:
            return eng.collect(params, 0, prng.PRNGKey(13))
        finally:
            if env_path:
                eng.env_worker.shutdown()

    g_plain, _ = run(False)
    g_env, st = run(True)
    assert st["env_steps"] > 0 and st["env_turns"] == 0
    base, got = _tmap(g_plain), _tmap(g_env)
    common = set(base) & set(got)
    assert common
    for k in common:
        assert base[k].response_tokens == got[k].response_tokens
        assert base[k].behaviour_logps == got[k].behaviour_logps
    task = AdditionTask(max_value=20)
    for g in g_env:
        for t in g.trajectories:
            assert t.num_turns == 1 and all(r == 1 for r in t.roles)
            assert t.reward == pytest.approx(
                task.reward(t.response_tokens, g.answer[1]))


def test_trainer_multiturn_overlap_e2e(params):
    task = MultiTurnMathTask(max_value=9, num_turns=2, seed=0)
    ro = RolloutConfig(batch_size=4, group_size=2, max_prompt_len=16,
                       max_response_len=64, concurrency=6, mode="copris",
                       env_step_timeout=10.0)
    tc = TrainConfig(lr=1e-4, warmup_steps=1, overlap=True, seed=0)
    tr = CoPRISTrainer(CFG, ro, tc, task, eos_id=EOS,
                       params=tree_map(lambda t: t.clone(), params),
                       device="cpu")
    tr.batch_timeout = 120.0
    try:
        hist = [tr.step() for _ in range(3)]
    finally:
        tr.close()
    assert sum(h["env_steps"] for h in hist) > 0
    assert sum(h["env_turns"] for h in hist) > 0
    assert all(h["env_timeouts"] == 0 for h in hist)
    assert all(0 <= h["param_staleness"] <= 1 for h in hist)
    b = tr.last_batch
    resp, lm = b["response_mask"], b["loss_mask"]
    env_pos = (resp > 0) & (lm == 0)
    assert env_pos.sum() > 0, "batch should contain env observations"
    assert (b["behaviour_logp"][env_pos] == 0.0).all()
    assert (b["stage_ids"][env_pos] == -1).all()
    assert (lm <= resp).all()
    assert (b["rewards"] >= 0.0).all() and (b["rewards"] <= 1.0).all()
