"""Train and rollout on meshes of their own, against the JAX package on the
CPU. Two spawns of gloo ranks (``tests/torch_ranks.py``):

* (a) eight ranks: ``make_param_resharder`` between two meshes, the
  tiny config and the reduced llama3.2-1b (GQA, 2 kv heads) from the
  port's seeded init, on disjoint (2, 2) + (2, 2) meshes (the reference's
  own case, ``tests/test_weight_sync.py``), on disjoint (4, 1) + (1, 4),
  and for the llama on the same four ranks as (2, 2) -> the (1, 2, 2) GQA
  serve mesh. Every rollout rank's local box (global offset and shape)
  and its values must equal, bit for bit, what the reference's
  ``make_param_resharder`` places on the device of the same index (a
  subprocess with 8 host devices: ``devices_indices_map`` of each output
  shard, mapped to the port's leaves by ``convert.params_from_jax``). The
  port lays the serve layout out with the reference's decode placements
  (``params_shardings(serve_tp_only=True, serve_decode=True)``): where the
  kv heads do not divide "model" (2 on the (1, 4) mesh) the reference's
  resharder, which takes no ``serve_decode``, shards the attention's
  ``wq`` over "model" and the decode placements replicate it, so those
  leaves alone, and every one of them, are held to the reference's
  output moved to its decode placements. The world-too-small error of
  ``make_disaggregated_meshes`` must read as the reference's.
* (b) four ranks: the two-sided trainer on disjoint (1, 2) + (1, 2)
  meshes, the reduced llama at vocab 8192 (the fused loss),
  overlap + disaggregated, max_staleness 1, 4 steps, its weights
  ``restore`` d before the first step (so the first version the rollout
  side runs is the republished one). The run's schedule (each batch's
  params version) is replayed on the JAX sequential trainer, whose
  ``param_store.acquire`` the test patches to ``get(v)`` of the recorded
  versions (``tests/test_torch_async_trainer.py``): the same trajectory
  keys and tokens, logps atol 1e-5, ``pg_loss`` / ``ratio_mean`` atol
  1e-5, the final params atol 1e-5; at least one step at staleness 1.
  Every version the rollout side acquired equals, bit for bit, the train
  side's params at that stage (sha256 of the gathered leaves);
  ``evaluate()`` gives one value on every rank. The refusals: meshes that
  share some ranks but not all, disjoint meshes without overlap, and
  ``TrainConfig``'s own error for ``disaggregated`` without ``overlap``.
  In the same spawn, the same four ranks in two shapes, (2, 2) training
  and the (1, 2, 2) GQA serve mesh collecting, one sequential step
  against one step of the JAX trainer: tokens equal, logps and the
  metrics atol 1e-5, the updated params atol 1e-5
  (``tests/test_torch_serve_sharded.py``'s tolerances).
"""
import os
import pickle
import subprocess
import sys
import time

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
from repro.data.tasks import EOS  # noqa: E402
from repro.data.tasks import AdditionTask as JAdditionTask  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.common.config import TrainConfig  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RESHARD_CASES = [("tiny", (2, 2), (2, 2)), ("tiny", (4, 1), (1, 4)),
                 ("smoke:llama3.2-1b", (2, 2), (2, 2)),
                 ("smoke:llama3.2-1b", (4, 1), (1, 4)),
                 ("smoke:llama3.2-1b", (2, 2), "kvg")]
TOO_BIG = ((4, 4), (4, 4))

# the reference's side: its resharder on 8 host devices, each output
# shard's box and values per device, in the port's leaves
_REFERENCE = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import numpy as np
from jax.sharding import Mesh
sys.path.insert(0, os.path.join(sys.argv[1], "tests"))
import torch_ranks
from repro.configs import get_config, get_smoke_config
from repro.core.weight_sync import make_param_resharder
from repro.launch import sharding as shd
from repro.launch.mesh import make_disaggregated_meshes
from repro_torch import convert
from repro_torch.common.tree import leaves
from repro_torch.models import model as TM

cases, too_big = pickle.load(open(sys.argv[2], "rb"))
devs = np.asarray(jax.devices())
out = dict(cases=[])
for name, train_shape, rollout_shape in cases:
    cfg_t = torch_ranks.case_config(name)
    cfg = torch_ranks.case_config(name, get_config, get_smoke_config)
    tree = convert.params_to_jax(TM.init_params(cfg_t, seed=0, device="cpu"),
                                 cfg_t)
    if rollout_shape == "kvg":
        train = Mesh(devs[:4].reshape(train_shape), ("data", "model"))
        rollout = Mesh(devs[:4].reshape(1, 2, 2), ("data", "kvg", "model"))
    else:
        train, rollout = make_disaggregated_meshes(train_shape, rollout_shape)
    params = jax.device_put(tree, shd.params_shardings(tree, train, cfg=cfg))
    reshard, out_sh = make_param_resharder(cfg, params, train, rollout)
    resharded = reshard(params)
    decode = shd.params_shardings(tree, rollout, serve_tp_only=True,
                                  serve_decode=True, cfg=cfg)
    # the leaves whose decode placements differ from the resharder's are
    # moved there (their paths are reported)
    moved = []

    def place(path, leaf, sh, want):
        if sh.spec == want.spec:
            return leaf
        moved.append(jax.tree_util.keystr(path))
        return jax.device_put(leaf, want)
    resharded = jax.tree_util.tree_map_with_path(place, resharded, out_sh,
                                                 decode)
    rollout_ids = {d.id for d in rollout.devices.flat}
    per_device = {}
    for d in rollout.devices.flat:
        vals = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), tree)
        mask = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), tree)
        def fill(a, v, m):
            assert {x.id for x in a.sharding.device_set} <= rollout_ids
            for s in a.addressable_shards:
                if s.device == d:
                    v[s.index] = np.asarray(s.data)
                    m[s.index] = 1.0
        jax.tree.map(fill, resharded, vals, mask)
        got = []
        for v, m in zip(leaves(convert.params_from_jax(vals, cfg_t, "cpu")),
                        leaves(convert.params_from_jax(mask, cfg_t, "cpu"))):
            m = m.numpy()
            nz = np.nonzero(m)
            lo = tuple(int(i.min()) for i in nz)
            hi = tuple(int(i.max()) + 1 for i in nz)
            box = tuple(slice(a, b) for a, b in zip(lo, hi))
            assert m[box].all() and m.sum() == m[box].size, "not a box"
            got.append((lo, tuple(b - a for a, b in zip(lo, hi)),
                        v.numpy()[box].copy()))
        per_device[d.id] = got
    out["cases"].append(dict(devices=per_device, moved=moved))
try:
    make_disaggregated_meshes(*too_big)
    out["error"] = None
except ValueError as e:
    out["error"] = str(e)
pickle.dump(out, open(sys.argv[3], "wb"))
"""


@pytest.fixture(scope="module")
def resharded(tmp_path_factory):
    """The reference's subprocess and the port's 8-rank spawn, run at
    once."""
    tmp = tmp_path_factory.mktemp("reshard")
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump((RESHARD_CASES, TOO_BIG), f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("JAX_PLATFORMS", None)
    ref = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, ROOT, str(tmp / "cases.pkl"),
         str(tmp / "ref.pkl")], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        (tmp / "ranks").mkdir()
        res = torch_ranks.spawn("disaggregated_reshard", tmp / "ranks", 8,
                                cases=RESHARD_CASES, too_big=TOO_BIG)
        print(f"8-rank spawn: {time.perf_counter() - t0:.1f} s")
        _, err = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-3000:]
    with open(tmp / "ref.pkl", "rb") as f:
        return pickle.load(f), res


def _rollout_ranks(case):
    _, train, rollout = case
    if rollout == "kvg":
        return list(range(4))
    n = int(np.prod(train))
    return list(range(n, n + int(np.prod(rollout))))


@pytest.mark.parametrize("i", range(len(RESHARD_CASES)),
                         ids=[f"{c.split(':')[-1]}-{t}-{r}"
                              for c, t, r in RESHARD_CASES])
def test_resharder_matches_the_reference(resharded, i):
    ref, res = resharded
    case, want = RESHARD_CASES[i], ref["cases"][i]
    ranks = _rollout_ranks(case)
    for rank, r in enumerate(res):
        got = r["cases"][i]["got"]
        if rank not in ranks:
            assert got is None, rank
            continue
        expect = want["devices"][rank]
        assert len(got) == len(expect) > 0
        for j, ((off, shape, vals, pl), (r_off, r_shape, r_vals)) in \
                enumerate(zip(got, expect)):
            assert (off, shape) == (r_off, r_shape), (rank, j, pl)
            np.testing.assert_array_equal(vals, r_vals,
                                          err_msg=f"rank {rank} leaf {j}")
            assert vals.dtype == r_vals.dtype
    # the decode placements differ from the resharder's exactly at the
    # attention's wq where the kv heads do not divide "model"
    cfg = torch_ranks.case_config(case[0])
    indivisible = case[2] != "kvg" and cfg.num_kv_heads % case[2][1] != 0
    assert bool(want["moved"]) == indivisible, want["moved"]
    assert all("'wq'" in p for p in want["moved"])
    senders = [r["cases"][i]["bytes_sent"] for r in res]
    assert sum(senders) > 0


def test_world_too_small_error_reads_as_the_reference(resharded):
    ref, res = resharded
    assert ref["error"] is not None
    for r in res:
        assert r["error"] is not None
        assert r["error"].split(" —")[0] == ref["error"].split(" —")[0]


# -- (b) the two-sided trainer against the JAX sequential trainer ---------------


RO = dict(batch_size=3, group_size=2, max_prompt_len=16, max_response_len=16,
          concurrency=4, mode="copris")
TC = dict(lr=1e-3, seed=3, entropy_coef=0.01, max_staleness=1)
STEPS = 4
# adaptive N' across the sides: the slot pool sized to 6, the controller's
# owner handing out targets that differ from the initial 4 and each other
ADAPTIVE = dict(ro=dict(RO, adaptive_concurrency=True, concurrency_min=1,
                        concurrency_max=6), steps=3, scripted=[6, 2, 5])


def test_disaggregated_needs_overlap():
    with pytest.raises(ValueError, match="overlap"):
        TrainConfig(disaggregated=True, overlap=False)


def _llama():
    cfg_t = torch_ranks.case_config("llama")
    cfg_j = torch_ranks.case_config("llama", jget_config, jget_smoke)
    return cfg_t, cfg_j


@pytest.fixture(scope="module")
def two_sided(tmp_path_factory):
    cfg_t, _ = _llama()
    start = convert.params_to_jax(TM.init_params(cfg_t, seed=1, device="cpu"),
                                  cfg_t)
    params = convert.params_to_jax(TM.init_params(cfg_t, seed=0,
                                                  device="cpu"), cfg_t)
    t0 = time.perf_counter()
    res = torch_ranks.spawn("disaggregated_trainer",
                            tmp_path_factory.mktemp("two_sided"), 4,
                            params=params, start=start, ro=RO, tc=TC,
                            task_seed=9, steps=STEPS, eval_prompts=2,
                            adaptive=ADAPTIVE)
    print(f"4-rank spawn: {time.perf_counter() - t0:.1f} s, of which the "
          f"adaptive trainer {max(r['adaptive']['seconds'] for r in res):.1f}"
          " s")
    return params, res


def test_two_sided_trainer_refuses_what_it_does_not_run(two_sided):
    _, res = two_sided
    for r in res:
        shared, sequential = r["refused"]
        assert shared is not None and "share some ranks" in shared
        assert sequential is not None and "overlap=True" in sequential


def test_two_sided_trainer_replays_on_the_jax_trainer(two_sided):
    params, res = two_sided
    roles = [r["role"] for r in res]
    assert roles == ["train", "train", "rollout", "rollout"]
    train, rollout = res[0], res[2]
    same = ("step", "param_staleness", "pg_loss", "ratio_mean", "grad_norm",
            "reward_mean")
    assert [{k: o[k] for k in same} for o in res[1]["outs"]] == \
        [{k: o[k] for k in same} for o in train["outs"]]
    assert rollout["trajs"] == res[3]["trajs"]
    outs = train["outs"]
    schedule = [o["step"] - o["param_staleness"] for o in outs]
    assert [o["params_version"] for o in rollout["outs"]] == schedule
    assert any(o["param_staleness"] == 1 for o in outs), schedule
    for i, o in enumerate(outs):
        # the gate: collect i waits for the version of i - max_staleness
        assert i - TC["max_staleness"] <= schedule[i] <= i

    _, cfg_j = _llama()
    jt = jcopris.CoPRISTrainer(cfg_j, JRolloutConfig(**RO), JTrainConfig(**TC),
                               JAdditionTask(max_value=20, seed=9),
                               eos_id=EOS,
                               params=jax.tree.map(jnp.asarray, params))
    versions = iter(schedule)
    store = jt.param_store

    def replay_acquire():
        v = next(versions)
        return store.get(v), v

    store.acquire = replay_acquire
    try:
        for i, o in enumerate(outs):
            oj = jt.step()
            got = [(g.group_id, t.sample_idx, tuple(t.response_tokens),
                    tuple(t.behaviour_logps), tuple(t.stage_ids))
                   for g in jt.last_groups for t in g.trajectories]
            mine = rollout["trajs"][i]
            assert [k[:3] + k[4:] for k in got] == \
                [k[:3] + k[4:] for k in mine], f"step {i}"
            for a, b in zip(got, mine):
                np.testing.assert_allclose(a[3], b[3], atol=1e-5)
            assert oj["param_staleness"] == o["param_staleness"]
            for k in ("pg_loss", "ratio_mean"):
                np.testing.assert_allclose(o[k], oj[k], atol=1e-5,
                                           err_msg=f"{k} step {i}")
        final_j = jax.device_get(jt.params)
    finally:
        jt.close()
    cfg_t, _ = _llama()
    want = convert.params_from_jax(final_j, cfg_t, "cpu")
    from repro_torch.common.tree import leaves
    for a, b in zip(train["final"], leaves(want)):
        np.testing.assert_allclose(a, b.numpy(), atol=1e-5)


def test_two_sided_acquired_versions_are_the_train_sides_params(two_sided):
    _, res = two_sided
    train, rollout = res[0], res[2]
    assert sorted(train["stages"]) == list(range(STEPS + 1))
    assert res[1]["stages"] == train["stages"]
    assert res[3]["acquired"] == rollout["acquired"]
    # every collect's version and evaluate's
    assert len(rollout["acquired"]) == STEPS + 1
    for v, digests in rollout["acquired"]:
        assert digests == train["stages"][v], v


def test_two_sided_evaluate_and_restore(two_sided):
    _, res = two_sided
    assert len({r["eval"] for r in res}) == 1
    # the initial version, its republish by restore, one a step: sent on
    # the train side, landed on the rollout side
    for r in res:
        assert r["stats"]["published"] == STEPS + 2, r["role"]
    for r in res[2:]:
        assert r["stats"]["acquired"] == STEPS + 1


def test_same_ranks_in_another_shape_matches_the_jax_trainer(two_sided):
    params, res = two_sided
    _, cfg_j = _llama()
    tc = {k: v for k, v in TC.items() if k != "max_staleness"}
    jt = jcopris.CoPRISTrainer(cfg_j, JRolloutConfig(**RO), JTrainConfig(**tc),
                               JAdditionTask(max_value=20, seed=9),
                               eos_id=EOS,
                               params=jax.tree.map(jnp.asarray, params))
    try:
        oj = jt.step()
        want = [(g.group_id, t.sample_idx, tuple(t.response_tokens),
                 tuple(t.behaviour_logps), tuple(t.stage_ids))
                for g in jt.last_groups for t in g.trajectories]
        final_j = jax.device_get(jt.params)
    finally:
        jt.close()
    got = res[0]["reshaped"]
    assert got["role"] is None
    # the published version is on the kvg mesh (three placements a leaf)
    assert all(lay.count("(") >= 3 for lay in got["serve_layout"])
    for r in res[1:]:
        assert r["reshaped"]["trajs"] == got["trajs"]
    assert [k[:3] + k[4:] for k in got["trajs"]] == \
        [k[:3] + k[4:] for k in want]
    for a, b in zip(got["trajs"], want):
        np.testing.assert_allclose(a[3], b[3], atol=1e-5)
    for k in ("pg_loss", "ratio_mean", "approx_kl", "entropy", "grad_norm",
              "reward_mean"):
        np.testing.assert_allclose(got["metrics"][k], oj[k], atol=1e-5,
                                   err_msg=k)
    cfg_t, _ = _llama()
    from repro_torch.common.tree import leaves
    want_p = leaves(convert.params_from_jax(final_j, cfg_t, "cpu"))
    assert len(want_p) == len(got["params"])
    for a, b in zip(got["params"], want_p):
        np.testing.assert_allclose(a, b.numpy(), atol=1e-5)


def test_two_sided_adaptive_concurrency(two_sided):
    """Adaptive N' across the two sides (the third trainer of the spawn):
    the train side's first rank alone owns the controller; its trace
    equals the reference's ``AdaptiveConcurrencyController`` fed the same
    observations; both rollout ranks collect under one target; collect
    ``idx`` runs under the target set after update ``j``, ``idx -
    max_staleness - 1 <= j <= idx`` (the initial target before any such
    update), and the train ranks report it as ``concurrency_target``."""
    from repro.core.scheduler import AdaptiveConcurrencyController as JCtrl
    _, res = two_sided
    got = [r["adaptive"] for r in res]
    assert [g["owner"] for g in got] == [True, False, False, False]
    owner = got[0]
    n = ADAPTIVE["steps"]
    assert len(owner["observed"]) == n
    for obs in owner["observed"]:
        assert set(obs) == {"rollout_time", "train_time", "evicted"}
        assert obs["rollout_time"] > 0 and obs["train_time"] > 0
    ref = JCtrl(JRolloutConfig(**ADAPTIVE["ro"]))
    for obs in owner["observed"]:
        ref.observe(**obs)
    assert owner["trace"] == ref.trace
    initial = ref.trace[0]
    assert initial not in ADAPTIVE["scripted"]
    rollout = [o["concurrency_target"] for o in got[2]["outs"]]
    assert rollout == [o["concurrency_target"] for o in got[3]["outs"]]
    assert [o["collect_idx"] for o in got[2]["outs"]] == list(range(n))
    k = TC["max_staleness"]
    for idx, target in enumerate(rollout):
        allowed = {ADAPTIVE["scripted"][j]
                   for j in range(max(0, idx - k - 1), idx + 1)}
        if idx - k - 1 < 0:
            allowed.add(initial)
        assert target in allowed, (idx, target, rollout)
    assert rollout[0] == initial
    for g in got[:2]:
        assert [o["concurrency_target"] for o in g["outs"]] == rollout
