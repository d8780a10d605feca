"""The port's sharded serving and rollout, and the CoPRIS trainer on one mesh,
against the JAX package on the CPU.

Two spawns of 4 gloo ranks (``tests/torch_ranks.py``) carry every
multi-rank case; the JAX references run once, here, unsharded, on the
same converted weights (sharding changes no value, only the order of
sums):

* (a) ``prefill`` and 4 ``decode_step`` s on the serve layout against
  ``M.prefill`` / ``M.decode_step``: tiny on (2, 2) (the kv heads over
  "model"), tiny on (1, 4) (2 kv heads on 4 ranks: the cache's length
  split over "model", the slices merged by their log-sum-exp) and the
  reduced llama3.2-1b at vocab 8192 on (2, 2) (the logits
  vocab-parallel). Logits and the gathered caches atol 1e-4 (float32, the
  model tests' tolerance); every rank gathers the same.
* (b) ``RolloutEngine.collect`` of tiny on (2, 2) and (1, 4) against the
  JAX engine with the same prompts and stage key: every rank returns the
  same groups, tokens equal and logps within 1e-5. Where a token differs,
  the JAX draw at that step must be a near-tie (its top-2 margin of
  tempered logits plus Gumbel noise under 1e-5), and the test reports it.
* (d) ``init_sharded_params`` equals ``shard_params(init_params)`` bit for
  bit on every rank's shards, tiny and the smoke deepseek-moe-16b (its 3-D
  expert leaves); the same placements and gradient flags.
* (c) one ``CoPRISTrainer(train_mesh=)`` step of tiny (entropy 0.01, so
  the update is not weight decay alone) on (2, 2) against one step of the
  JAX trainer: tokens and rewards equal, behaviour logps and the metrics
  atol 1e-5 (``tests/test_torch_train.py``'s tolerances), the updated
  params atol 1e-5. The reference's trainer refuses ``disaggregated=True``
  without ``overlap=True``, and its overlapped one fails on this JAX
  (``tests/test_weight_sync.py``, a known failure); its reshard onto
  ``make_cpu_mesh()`` changes no value, so the sequential JAX trainer is
  the reference.

In this process, on a (1, 1) gloo mesh: sharded serving of tiny equals the
unsharded engine bit for bit, tokens and logps; ``partitioning.on_rows``
(the one helper of the functions of a batch's rows) equals the function
on plain tensors, outputs and gradients; and what the mesh does not run
raises.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_ranks  # noqa: E402
from repro.common.config import RolloutConfig as JRolloutConfig  # noqa: E402
from repro.common.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.core import copris as jcopris  # noqa: E402
from repro.core.rollout import RolloutEngine as JRolloutEngine  # noqa: E402
from repro.data.tasks import EOS  # noqa: E402
from repro.data.tasks import AdditionTask as JAdditionTask  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.common.config import RolloutConfig, TrainConfig  # noqa: E402
from repro_torch.common.partitioning import on_rows  # noqa: E402
from repro_torch.common.tree import leaves  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import copris  # noqa: E402
from repro_torch.core.rollout import RolloutEngine  # noqa: E402
from repro_torch.data.tasks import AdditionTask  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import make_single_mesh  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.sampling import prng  # noqa: E402

torch.set_num_threads(1)
ATOL = 1e-4
RO = dict(batch_size=3, group_size=2, max_prompt_len=16, max_response_len=24,
          concurrency=4, mode="copris", decode_chunk=4)
MODEL_CASES = [("tiny", (2, 2)), ("tiny", (1, 4)), ("llama", (2, 2))]
ENGINE_MESHES = [(2, 2), (1, 4)]
INIT_CASES = ["tiny", "deepseek-moe-16b"]


def _cfgs(case):
    if case == "tiny":
        return jget_config("tiny"), get_config("tiny")
    kw = dict(vocab_size=8192, dtype="float32")
    return (dataclasses.replace(jget_smoke("llama3.2-1b"), **kw),
            torch_ranks._serve_cfg(case))


def _jax_tree(case):
    """Numpy weights in the JAX layout: tiny from the JAX init, the reduced
    llama from the port's seeded init (the JAX init runs op by op)."""
    cfg_j, cfg_t = _cfgs(case)
    if case == "tiny":
        return jax.device_get(JM.init_params(jax.random.PRNGKey(0), cfg_j))
    return convert.params_to_jax(TM.init_params(cfg_t, seed=0, device="cpu"),
                                 cfg_t)


def _model_reference(case, tree, B=4, S=16, L=32, steps=4):
    """JAX prefill and ``steps`` greedy decode steps: the logits, the
    tokens fed and the cache (layers, B, L, KV, hd)."""
    cfg_j, _ = _cfgs(case)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg_j.vocab_size, (B, S)).astype(np.int32)
    lens = np.array([S, 9, 3, 12][:B], np.int32)
    pj = jax.tree.map(jnp.asarray, tree)
    cache = JM.init_cache(cfg_j, B, L)
    lg, cache = JM.prefill(pj, cfg_j, jnp.asarray(toks), jnp.asarray(lens),
                           cache)
    logits, feed, clen = [np.asarray(lg)], [], lens.copy()
    for _ in range(steps):
        feed.append(np.asarray(logits[-1].argmax(-1), np.int32))
        lg, cache = JM.decode_step(pj, cfg_j, jnp.asarray(feed[-1]), cache,
                                   jnp.asarray(clen))
        logits.append(np.asarray(lg))
        clen = clen + 1
    body = cache["body"][0]
    return dict(toks=toks, lens=lens, feed=np.stack(feed), L=L,
                logits=logits, k=np.asarray(body["k"]),
                v=np.asarray(body["v"]))


@pytest.fixture(scope="module")
def trees():
    return {case: _jax_tree(case) for case in ("tiny", "llama")}


@pytest.fixture(scope="module")
def served(trees, tmp_path_factory):
    """The JAX references, then the one serving spawn: every model case,
    both engine meshes and the init cases."""
    refs = {(c, s): _model_reference(c, trees[c]) for c, s in MODEL_CASES}
    model_cases = [(c, s, trees[c], r["toks"], r["lens"], r["feed"], r["L"])
                   for (c, s), r in refs.items()]
    engine_cases = [("tiny", s, trees["tiny"], RO, 9, 42)
                    for s in ENGINE_MESHES]
    init_cases = [(name, (2, 2)) for name in INIT_CASES]
    res = torch_ranks.spawn("serve_sharded",
                            tmp_path_factory.mktemp("serve"), 4,
                            model_cases=model_cases,
                            engine_cases=engine_cases,
                            init_cases=init_cases)
    return refs, res


# -- (a) prefill and decode ---------------------------------------------------


@pytest.mark.parametrize("i", range(len(MODEL_CASES)),
                         ids=[f"{c}-{d}x{m}" for c, (d, m) in MODEL_CASES])
def test_sharded_prefill_decode_matches_jax(served, i):
    refs, res = served
    ref = refs[MODEL_CASES[i]]
    got = res[0]["model"][i]
    for r in res[1:]:                    # every rank gathers the same
        for a, b in zip(r["model"][i]["logits"], got["logits"]):
            np.testing.assert_array_equal(a, b)
    assert len(got["logits"]) == len(ref["logits"]) == 5
    for step, (a, b) in enumerate(zip(got["logits"], ref["logits"])):
        np.testing.assert_allclose(a, b, atol=ATOL, err_msg=f"step {step}")
    np.testing.assert_allclose(got["k"], ref["k"], atol=ATOL)
    np.testing.assert_allclose(got["v"], ref["v"], atol=ATOL)
    # the cache's layout: kv heads over "model", or its length where the
    # kv heads do not divide it (tiny's 2 on 4 ranks)
    split = "Shard(dim=1)" if MODEL_CASES[i][1] == (1, 4) else "Shard(dim=2)"
    assert all(split in lay for lay in got["layout"]), got["layout"]


# -- (b) the engine -----------------------------------------------------------


def _jax_engine(tree):
    task = JAdditionTask(max_value=20, seed=9)
    eng = JRolloutEngine(jget_config("tiny"), JRolloutConfig(**RO),
                         task.sample_prompt, eos_id=EOS)
    groups, st = eng.collect(jax.tree.map(jnp.asarray, tree), 0,
                             jax.random.PRNGKey(42))
    return {(g.group_id, t.sample_idx): t
            for g in groups for t in g.trajectories}, st


def _margin(tree, traj, key, j):
    """The JAX draw of response token ``j`` of ``traj``: the top-2 margin
    of its tempered logits plus the Gumbel noise of its key (the draw is
    their argmax)."""
    cfg = jget_config("tiny")
    seq = list(traj.prompt_tokens) + list(traj.response_tokens[:j])
    lg = JM.forward_train(jax.tree.map(jnp.asarray, tree), cfg,
                          jnp.asarray([seq], jnp.int32))[0, -1]
    k = key
    for x in (traj.group_id, traj.sample_idx, j):
        k = jax.random.fold_in(k, x)
    z = np.sort(np.asarray(lg / RO.get("temperature", 1.0)
                           + jax.random.gumbel(k, lg.shape)))
    return float(z[-1] - z[-2])


@pytest.mark.parametrize("i", range(len(ENGINE_MESHES)),
                         ids=[f"{d}x{m}" for d, m in ENGINE_MESHES])
def test_sharded_engine_matches_jax_engine(served, trees, i):
    _, res = served
    got = res[0]["engine"][i]
    for r in res[1:]:                    # every rank holds the same groups
        assert r["engine"][i] == got
    ref, jst = _jax_engine(trees["tiny"])
    assert set(got["trajs"]) == set(ref)
    ties = []
    for key, t in ref.items():
        toks, logps, reason = got["trajs"][key]
        n = min(len(toks), len(t.response_tokens))
        diff = next((j for j in range(n)
                     if toks[j] != t.response_tokens[j]), None)
        if diff is None:
            assert toks == list(t.response_tokens), key
            np.testing.assert_allclose(logps, t.behaviour_logps, atol=1e-5)
            assert reason == t.finish_reason, key
            continue
        margin = _margin(trees["tiny"], t, jax.random.PRNGKey(42), diff)
        ties.append((key, diff, margin))
        assert margin < 1e-5, (key, diff, margin)
        np.testing.assert_allclose(logps[:diff], t.behaviour_logps[:diff],
                                   atol=1e-5)
    if ties:
        print(f"near-ties at (trajectory, token, margin): {ties}")
    else:
        assert got["generated"] == jst["generated"]


# -- (d) the sharded init -------------------------------------------------------


@pytest.mark.parametrize("i", range(len(INIT_CASES)), ids=INIT_CASES)
def test_init_sharded_params_equals_shard_params(served, i):
    _, res = served
    for r in res:
        got = r["init"][i]
        assert got["equal"] and got["placements"] and got["grads"], got
    if INIT_CASES[i] == "deepseek-moe-16b":
        assert res[0]["init"][i]["dims3"] > 0         # the expert leaves


# -- (c) the trainer on one mesh ------------------------------------------------


TRAIN_RO = dict(batch_size=3, group_size=2, max_prompt_len=16,
                max_response_len=16, concurrency=4, mode="copris")
TRAIN_TC = dict(lr=1e-3, seed=3, entropy_coef=0.01)


def test_trainer_step_on_mesh_matches_jax_trainer(trees, tmp_path):
    tree = trees["tiny"]
    jt = jcopris.CoPRISTrainer(jget_config("tiny"), JRolloutConfig(**TRAIN_RO),
                               JTrainConfig(**TRAIN_TC),
                               JAdditionTask(max_value=20, seed=9),
                               eos_id=EOS,
                               params=jax.tree.map(jnp.asarray, tree))
    try:
        out_j = jt.step()
    finally:
        jt.close()
    res = torch_ranks.spawn("trainer_step", tmp_path, 4, mesh_shape=(2, 2),
                            case="tiny", params=tree, ro=TRAIN_RO,
                            tc=TRAIN_TC, task_seed=9)
    got = res[0]
    for r in res[1:]:
        assert r["trajs"] == got["trajs"]
        for a, b in zip(r["params"], got["params"]):
            np.testing.assert_array_equal(a, b)
    assert got["sharded"] and got["stage"] == 1
    # the published version is in the serving layout: no "data" shard
    assert all("Shard" not in lay.split(",")[0] for lay in got["serve_layout"])
    ref = {(g.group_id, t.sample_idx): t for g in jt.last_groups
           for t in g.trajectories}
    assert set(got["trajs"]) == set(ref) and len(ref) == 6
    for key, t in ref.items():
        toks, logps, reward = got["trajs"][key]
        assert toks == list(t.response_tokens), key
        assert reward == t.reward, key
        np.testing.assert_allclose(logps, t.behaviour_logps, atol=1e-5)
    for k in ("pg_loss", "ratio_mean", "approx_kl", "entropy", "grad_norm",
              "reward_mean", "off_policy_frac"):
        np.testing.assert_allclose(got["metrics"][k], out_j[k], atol=1e-5,
                                   err_msg=k)
    new_j = leaves(convert.params_from_jax(jax.device_get(jt.params),
                                           get_config("tiny"), "cpu"))
    assert len(new_j) == len(got["params"])
    for a, b in zip(got["params"], new_j):
        np.testing.assert_allclose(a, b.numpy(), atol=1e-5)


# -- a (1, 1) mesh in this process -------------------------------------------


@pytest.fixture
def mesh():
    m = make_single_mesh("cpu")
    yield m
    torch.distributed.destroy_process_group()


def test_single_rank_mesh_serving_is_bit_equal(trees, mesh):
    cfg = get_config("tiny")
    params = convert.params_from_jax(trees["tiny"], cfg, "cpu")

    def run(m):
        task = AdditionTask(max_value=20, seed=9)
        eng = RolloutEngine(cfg, RolloutConfig(**RO), task.sample_prompt,
                            eos_id=EOS, device="cpu", mesh=m)
        groups, st = eng.collect(eng.prepare_params(params), 0,
                                 prng.PRNGKey(42))
        return {(g.group_id, t.sample_idx): (t.response_tokens,
                                             t.behaviour_logps)
                for g in groups for t in g.trajectories}, st

    plain, st_p = run(None)
    sharded, st_s = run(mesh)
    assert plain == sharded and len(plain) >= 6
    assert st_p["generated"] == st_s["generated"]


def test_on_rows_equals_the_function(mesh):
    """``on_rows`` (a function of a batch's rows with whole weights) on
    plain tensors is the function; on a mesh it gives the same outputs and
    gradients, per row and ``whole``."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 3, 5, generator=g)
    p = {"w": torch.randn(5, 6, generator=g), "b": torch.randn(6, generator=g)}

    def fn(x_, p_):
        return torch.tanh(x_ @ p_["w"] + p_["b"])

    def both(x_, p_):
        y = fn(x_, p_)
        return y, y.square().mean()

    def grads(out, params):
        return torch.autograd.grad(out.sum(), leaves(params))

    pw = {k: v.clone().requires_grad_() for k, v in p.items()}
    want = fn(x, pw)
    gw = grads(want, pw)
    assert torch.equal(on_rows(fn, (x,), pw), want)
    pm = shd.shard_params(p, mesh, get_config("tiny"))
    xm = shd.shard_batch({"x": x}, mesh)["x"]
    got = on_rows(fn, (xm,), pm)
    np.testing.assert_allclose(got.full_tensor().detach().numpy(),
                               want.detach().numpy(), atol=1e-6)
    for a, b in zip(grads(got, pm), gw):
        np.testing.assert_allclose(a.full_tensor().numpy(), b.numpy(),
                                   atol=1e-6)
    y, aux = on_rows(both, (xm,), pm, n_rep=1, whole=True)
    assert tuple(y.placements) == tuple(xm.placements)
    np.testing.assert_allclose(float(aux.full_tensor().detach()),
                               float(both(x, p)[1]), atol=1e-6)


def test_mesh_refuses_what_it_does_not_run(mesh):
    """What the mesh does not run raises NotImplementedError naming ROADMAP
    (the paged cache, kv_snapshot resume, multi-turn environments,
    overlap=True); every block kind is served."""
    cfg = get_config("tiny")
    task = AdditionTask(max_value=20, seed=9)
    for kw, what in ((dict(kv_backend="paged"), "paged"),
                     (dict(resume_strategy="kv_snapshot"), "kv_snapshot"),
                     (dict(env_factory=lambda spec: None),
                      "multi-turn environments")):
        ro = {k: v for k, v in kw.items() if k != "env_factory"}
        with pytest.raises(NotImplementedError,
                           match=f"(?s){what}.*ROADMAP"):
            RolloutEngine(cfg, RolloutConfig(**dict(RO, **ro)),
                          task.sample_prompt, eos_id=EOS, mesh=mesh,
                          env_factory=kw.get("env_factory"))
    for arch in ("hymba-1.5b", "rwkv6-1.6b", "deepseek-moe-16b",
                 "llama-3.2-vision-90b"):
        RolloutEngine(get_config(arch).reduced(max_d_model=64),
                      RolloutConfig(**RO), task.sample_prompt, eos_id=EOS,
                      mesh=mesh)
    with pytest.raises(NotImplementedError, match="collectives"):
        copris.CoPRISTrainer(cfg, RolloutConfig(**TRAIN_RO),
                             TrainConfig(overlap=True), task, eos_id=EOS,
                             train_mesh=mesh)
    with pytest.raises(ValueError, match="train_mesh"):
        copris.CoPRISTrainer(cfg, RolloutConfig(**TRAIN_RO), TrainConfig(),
                             task, eos_id=EOS, rollout_mesh=mesh)
