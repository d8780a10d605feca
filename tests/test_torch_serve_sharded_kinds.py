"""The port's sharded serving of every block kind (hymba, rwkv, moe, xattn),
the ``shard_seq`` cache layout and the GQA serve mesh, against the JAX
package on the CPU.

One spawn of 4 gloo ranks (``tests/torch_ranks.py``) carries every
multi-rank case; the JAX references run once, here, unsharded, on the same
converted weights (sharding changes no value, only the order of sums):

* ``prefill`` and 4 ``decode_step`` s on the serve layout against
  ``M.prefill`` / ``M.decode_step``, logits and every gathered cache leaf
  atol 1e-4 (float32): the smoke hymba-1.5b (1 kv head: its window
  attention's cache split over the length; the SSM's channels over
  "model"), rwkv6-1.6b (heads over "model"), deepseek-moe-16b (experts
  over "model", the dense dispatch) and the VLM at one 5-layer period with
  its gates at 0.5/0.7 and media (1 kv head: the media K/V split over
  head_dim), each on (2, 2) and (1, 4); the capacity-bounded dispatch
  (8 experts) on (1, 4); ``shard_seq`` at batch 1 on (2, 2) for rwkv6,
  hymba, tiny and tiny with one kv head (the length over ("data",
  "model")); tiny on the (1, 2, 2) ("data", "kvg", "model") mesh.
* ``RolloutEngine.collect`` of the smoke hymba and rwkv6 on (2, 2), and of
  hymba with a pool of one slot (its cache in the ``shard_seq`` layout),
  against the JAX engine: every rank returns the same groups, tokens equal
  and logps within 1e-5; a differing token must be a near-tie of the JAX
  draw (its top-2 margin under 1e-5), which the test reports.

The serve layout's rules (the decode placements of every parameter leaf,
the cache's in both layouts) at these shapes equal the reference's on
(2, 2), (1, 4) and (1, 2, 2) (``tests/test_torch_sharding.py`` checks them
at full size), and the new chip scripts import no JAX.

In this process, on a (1, 1) gloo mesh (and the (1, 1, 1) GQA serve mesh):
the sharded engine of each new kind equals the unsharded engine bit for
bit, tokens and logps; one ``CoPRISTrainer(train_mesh=)`` step of hymba,
rwkv6 and deepseek-moe (the versions resharded into the serve layout, the
SSM's ``in_proj`` in its serve form) equals the unsharded trainer's step
bit for bit, tokens and updated params. (Neither package's trainer feeds
a VLM's media to its engine, so the VLM is served, not trained, here.)
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

import test_torch_hygiene as hygiene  # noqa: E402
import test_torch_sharding as rules  # noqa: E402
import torch_ranks  # noqa: E402
from repro.common.config import RolloutConfig as JRolloutConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.core.rollout import RolloutEngine as JRolloutEngine  # noqa: E402
from repro.data.tasks import EOS  # noqa: E402
from repro.data.tasks import AdditionTask as JAdditionTask  # noqa: E402
from repro.launch import sharding as jshd  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.common.config import RolloutConfig, TrainConfig  # noqa: E402
from repro_torch.common.tree import leaves, tree_map  # noqa: E402
from repro_torch.core.copris import CoPRISTrainer  # noqa: E402
from repro_torch.core.rollout import RolloutEngine  # noqa: E402
from repro_torch.data.tasks import AdditionTask  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import (make_gqa_serve_mesh,  # noqa: E402
                                     make_single_mesh)
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.sampling import prng  # noqa: E402

torch.set_num_threads(1)
ATOL = 1e-4
HYMBA, RWKV = "smoke:hymba-1.5b", "smoke:rwkv6-1.6b"
MOE = "smoke:deepseek-moe-16b"
RO = dict(batch_size=3, group_size=2, max_prompt_len=16, max_response_len=24,
          concurrency=4, mode="copris", decode_chunk=4)
# (case, mesh shape, batch), and the layout one leaf must show
MODEL_CASES = [
    (HYMBA, (2, 2), 4), (HYMBA, (1, 4), 4),
    (RWKV, (2, 2), 4), (RWKV, (1, 4), 4),
    (MOE, (2, 2), 4), (MOE, (1, 4), 4),
    ("deepseek-sparse", (1, 4), 4),
    ("vlm", (2, 2), 4), ("vlm", (1, 4), 4),
    (RWKV, (2, 2), 1), (HYMBA, (2, 2), 1),
    ("tiny", (2, 2), 1), ("tiny-kv1", (2, 2), 1),
    ("tiny", (1, 2, 2), 4),
]
LAYOUT = {
    (HYMBA, (1, 4), 4): ("0.k", "Shard(dim=0), Shard(dim=1)"),
    (HYMBA, (2, 2), 4): ("0.ssm", "Shard(dim=0), Shard(dim=1)"),
    (RWKV, (1, 4), 4): ("0.wkv", "Shard(dim=0), Shard(dim=1)"),
    ("vlm", (1, 4), 4): ("4.mk", "Shard(dim=0), Shard(dim=3)"),
    (RWKV, (2, 2), 1): ("0.tm_prev", "Replicate(), Shard(dim=1)"),
    (HYMBA, (2, 2), 1): ("0.k", "Shard(dim=1), Shard(dim=1)"),
    ("tiny", (2, 2), 1): ("0.k", "Shard(dim=1), Shard(dim=2)"),
    ("tiny-kv1", (2, 2), 1): ("0.k", "Shard(dim=1), Shard(dim=1)"),
    ("tiny", (1, 2, 2), 4): ("0.k", "Shard(dim=0), Shard(dim=2), "
                                    "Shard(dim=1)"),
}
ENGINE_CASES = [(HYMBA, (2, 2), 4), (RWKV, (2, 2), 4), (HYMBA, (2, 2), 1)]
SINGLE_CASES = [HYMBA, RWKV, "deepseek-sparse", "vlm", "tiny-kvg"]


def _ids(cases):
    return [f"{c.split(':')[-1]}-{'x'.join(map(str, s))}-B{b}"
            for c, s, b in cases]


def _cfgs(case):
    return (torch_ranks.case_config(case, jget_config, jget_smoke),
            torch_ranks.case_config(case))


def _tree(case):
    """Numpy weights in the JAX layout from the port's seeded init (the
    JAX init runs op by op); the VLM's tanh gates opened to 0.5 / 0.7 (zero
    at init, they would hide the cross-attention)."""
    _, cfg = _cfgs(case)
    params = TM.init_params(cfg, seed=0, device="cpu")
    for layer in params["layers"]:
        if "xattn" in layer:
            layer["xattn"]["gate"].fill_(0.5)
            layer["mlp_gate"].fill_(0.7)
    return convert.params_to_jax(params, cfg)


def _media(cfg, B, seed=2):
    if not cfg.uses_media:
        return None
    xa = cfg.cross_attn
    return (np.random.default_rng(seed).normal(
        size=(B, xa.num_media_tokens, xa.d_media)) * 0.1).astype(np.float32)


def _port_cache(cache, cfg):
    """The JAX stack cache as the port's flat list of layers: the prefix
    layers, then every repeat of the pattern (``convert.params_from_jax``'s
    order)."""
    out = [{k: np.asarray(v) for k, v in c.items()} for c in cache["prefix"]]
    for r in range(cfg.num_repeats):
        for c in cache["body"]:
            out.append({k: np.asarray(v)[r] for k, v in c.items()})
    return out


def _model_reference(case, B, tree, S=16, L=32, steps=4):
    """JAX prefill and ``steps`` greedy decode steps: the logits, the
    tokens fed and every cache leaf."""
    cfg_j, _ = _cfgs(case)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg_j.vocab_size, (B, S)).astype(np.int32)
    lens = np.array([11] if B == 1 else [S, 9, 3, 12][:B], np.int32)
    media = _media(cfg_j, B)
    pj = jax.tree.map(jnp.asarray, tree)
    cache = JM.init_cache(cfg_j, B, L)
    lg, cache = JM.prefill(pj, cfg_j, jnp.asarray(toks), jnp.asarray(lens),
                           cache, media=None if media is None
                           else jnp.asarray(media))
    logits, feed, clen = [np.asarray(lg)], [], lens.copy()
    for _ in range(steps):
        feed.append(np.asarray(logits[-1].argmax(-1), np.int32))
        lg, cache = JM.decode_step(pj, cfg_j, jnp.asarray(feed[-1]), cache,
                                   jnp.asarray(clen))
        logits.append(np.asarray(lg))
        clen = clen + 1
    return dict(toks=toks, lens=lens, media=media, feed=np.stack(feed), L=L,
                logits=logits, cache=_port_cache(cache, cfg_j))


def _port_reference(case, ref, tree):
    """The unsharded port on the JAX reference's inputs and fed tokens:
    every cache leaf after the last step."""
    _, cfg = _cfgs(case)
    params = convert.params_from_jax(tree, cfg, "cpu")
    cache = TM.init_cache(cfg, ref["toks"].shape[0], ref["L"], device="cpu")
    _, cache = TM.prefill(params, cfg, torch.from_numpy(ref["toks"]),
                          torch.from_numpy(ref["lens"]), cache,
                          media=None if ref["media"] is None
                          else torch.from_numpy(ref["media"]))
    clen = torch.from_numpy(ref["lens"])
    for tok in ref["feed"]:
        _, cache = TM.decode_step(params, cfg, torch.from_numpy(tok), cache,
                                  clen)
        clen = clen + 1
    return [{n: t.numpy() for n, t in layer.items()} for layer in cache]


def _ro(B):
    """The engine cases' rollout config: a pool of ``B`` slots."""
    return dict(RO, concurrency=B) if B != RO["concurrency"] else RO


@pytest.fixture(scope="module")
def trees():
    return {c: _tree(c) for c in {c for c, _, _ in MODEL_CASES + ENGINE_CASES}}


@pytest.fixture(scope="module")
def served(trees, tmp_path_factory):
    """The JAX references, then the one spawn: every model case and every
    engine case."""
    once = {}
    for c, _, b in MODEL_CASES:
        if (c, b) not in once:
            once[c, b] = _model_reference(c, b, trees[c])
            once[c, b]["port"] = _port_reference(c, once[c, b], trees[c])
    refs = [once[c, b] for c, _, b in MODEL_CASES]
    model_cases = [(c, s, trees[c], r["toks"], r["lens"], r["media"],
                    r["feed"], r["L"])
                   for (c, s, _), r in zip(MODEL_CASES, refs)]
    engine_cases = [(c, s, trees[c], _ro(b), 9, 42)
                    for c, s, b in ENGINE_CASES]
    res = torch_ranks.spawn("serve_sharded_kinds",
                            tmp_path_factory.mktemp("kinds"), 4,
                            model_cases=model_cases,
                            engine_cases=engine_cases)
    return refs, res


@pytest.mark.parametrize("i", range(len(MODEL_CASES)), ids=_ids(MODEL_CASES))
def test_sharded_kinds_prefill_decode_match_jax(served, i):
    refs, res = served
    ref, got = refs[i], res[0]["model"][i]
    for r in res[1:]:                    # every rank gathers the same
        for a, b in zip(r["model"][i]["logits"], got["logits"]):
            np.testing.assert_array_equal(a, b)
    assert len(got["logits"]) == len(ref["logits"]) == 5
    for step, (a, b) in enumerate(zip(got["logits"], ref["logits"])):
        np.testing.assert_allclose(a, b, atol=ATOL, err_msg=f"step {step}")
    assert len(got["cache"]) == len(ref["cache"]) == len(ref["port"])
    for layer, (a, b, c) in enumerate(zip(got["cache"], ref["cache"],
                                          ref["port"])):
        assert set(a) == set(b) == set(c), layer
        for name in b:
            msg = f"layer {layer} {name}"
            # against the unsharded port: the sharding's own error
            np.testing.assert_allclose(a[name], c[name], atol=ATOL,
                                       err_msg=msg)
            # against JAX: atol relative to the leaf's largest element (the
            # recurrent states reach ~10, where the unsharded port's f32
            # already differs from JAX's by 1.7e-4)
            np.testing.assert_allclose(
                a[name], b[name], err_msg=msg,
                atol=ATOL * max(1.0, float(np.abs(b[name]).max())))
    if MODEL_CASES[i] in LAYOUT:
        leaf, want = LAYOUT[MODEL_CASES[i]]
        assert want in got["layout"][leaf], got["layout"][leaf]


def _jax_engine(case, tree, ro):
    cfg_j, _ = _cfgs(case)
    eng = JRolloutEngine(cfg_j, JRolloutConfig(**ro),
                         JAdditionTask(max_value=20, seed=9).sample_prompt,
                         eos_id=EOS)
    groups, st = eng.collect(jax.tree.map(jnp.asarray, tree), 0,
                             jax.random.PRNGKey(42))
    return {(g.group_id, t.sample_idx): t
            for g in groups for t in g.trajectories}, st


def _margin(case, tree, traj, key, j, ro):
    """The JAX draw of response token ``j`` of ``traj``: the top-2 margin
    of its tempered logits plus the Gumbel noise of its key (the draw is
    their argmax)."""
    cfg_j, _ = _cfgs(case)
    seq = list(traj.prompt_tokens) + list(traj.response_tokens[:j])
    lg = JM.forward_train(jax.tree.map(jnp.asarray, tree), cfg_j,
                          jnp.asarray([seq], jnp.int32))[0, -1]
    k = key
    for x in (traj.group_id, traj.sample_idx, j):
        k = jax.random.fold_in(k, x)
    z = np.sort(np.asarray(lg / ro.get("temperature", 1.0)
                           + jax.random.gumbel(k, lg.shape)))
    return float(z[-1] - z[-2])


@pytest.mark.parametrize("i", range(len(ENGINE_CASES)),
                         ids=_ids(ENGINE_CASES))
def test_sharded_kinds_engine_matches_jax_engine(served, trees, i):
    _, res = served
    case, _, b = ENGINE_CASES[i]
    got = res[0]["engine"][i]
    for r in res[1:]:                    # every rank holds the same groups
        assert r["engine"][i] == got
    ro = _ro(b)
    ref, jst = _jax_engine(case, trees[case], ro)
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
        margin = _margin(case, trees[case], t, jax.random.PRNGKey(42), diff,
                         ro)
        ties.append((key, diff, margin))
        assert margin < 1e-5, (key, diff, margin)
        np.testing.assert_allclose(logps[:diff], t.behaviour_logps[:diff],
                                   atol=1e-5)
    if ties:
        print(f"near-ties at (trajectory, token, margin): {ties}")
    else:
        assert got["generated"] == jst["generated"]


# -- the rules at these shapes, the chip scripts -------------------------------


RULE_MESHES = (((2, 2), ("data", "model")), ((1, 4), ("data", "model")),
               ((1, 2, 2), ("data", "kvg", "model")))


@pytest.mark.parametrize("case", [HYMBA, RWKV, MOE, "vlm"],
                         ids=["hymba", "rwkv6", "deepseek", "vlm"])
def test_serve_rules_match_reference_at_these_shapes(case):
    cfg_j, cfg = _cfgs(case)
    tree = jax.eval_shape(lambda k: JM.init_params(k, cfg_j),
                          jax.random.PRNGKey(0))
    ctree = jax.eval_shape(lambda: JM.init_cache(cfg_j, 4, 32))
    port = rules._port_layout(tree, cfg, rules._shape_leaf)
    cport = rules._port_layout(ctree, cfg, rules._shape_leaf, cache=True)
    n = 0
    for sizes, names in RULE_MESHES:
        jmesh, axes = AbstractMesh(sizes, names), dict(zip(names, sizes))

        def ref(path, leaf, body):
            return rules._placements(jshd.param_pspec(
                path, leaf, jmesh, cfg_j, serve_decode=True), leaf.ndim,
                list(names), int(body))
        want = rules._port_layout(tree, cfg, ref)
        got = shd.params_placements(port, axes, cfg=cfg, serve_decode=True)
        for path, _ in rules._walk(port):
            assert rules._at(got, path) == rules._at(want, path), (
                sizes, path)
            n += 1
        for shard_seq in (False, True):
            def cref(path, leaf, body, shard_seq=shard_seq):
                return rules._placements(jshd.cache_pspec(
                    path, leaf, cfg_j, jmesh, shard_seq=shard_seq),
                    leaf.ndim, list(names), int(body))
            want = rules._port_layout(ctree, cfg, cref, cache=True)
            got = shd.cache_placements_tree(cport, cfg, axes,
                                            shard_seq=shard_seq)
            for path, _ in rules._walk(cport):
                assert rules._at(got, path) == rules._at(want, path), (
                    sizes, shard_seq, path)
                n += 1
    assert n > 0


def test_chip_scripts_import_no_jax():
    """chip_phases.py and chip_mesh.py, as chip_smoke.py
    (``tests/test_torch_hygiene.py``), import neither jax nor the JAX
    package."""
    for script in ("chip_phases.py", "chip_mesh.py"):
        mods = list(hygiene._imports(hygiene.ROOT / script))
        assert mods and not [m for m in mods if m.split(".")[0]
                             in hygiene.FORBIDDEN], script


# -- (1, 1) meshes in this process --------------------------------------------


@pytest.fixture
def single():
    yield
    torch.distributed.destroy_process_group()


@pytest.mark.parametrize("case", SINGLE_CASES)
def test_single_rank_mesh_serving_of_each_kind_is_bit_equal(case, single):
    """The engine on a (1, 1) mesh (tiny-kvg: the (1, 1, 1) GQA serve mesh)
    equals the unsharded engine bit for bit; a pool of one slot (the
    ``shard_seq`` layout) too, for the recurrent kinds."""
    name = "tiny" if case == "tiny-kvg" else case
    _, cfg = _cfgs(name)
    params = convert.params_from_jax(_tree(name), cfg, "cpu")
    media = _media(cfg, 1)
    mesh = (make_gqa_serve_mesh(1, 1, 1, device_type="cpu")
            if case == "tiny-kvg" else make_single_mesh("cpu"))

    def run(m, pool):
        task = AdditionTask(max_value=20, seed=9)
        eng = RolloutEngine(cfg, RolloutConfig(**_ro(pool)),
                            task.sample_prompt, eos_id=EOS, device="cpu",
                            mesh=m, media=None if media is None else media[0])
        groups, st = eng.collect(eng.prepare_params(params), 0,
                                 prng.PRNGKey(42))
        return {(g.group_id, t.sample_idx): (t.response_tokens,
                                             t.behaviour_logps)
                for g in groups for t in g.trajectories}, st["generated"]

    pools = (4, 1) if case in (HYMBA, RWKV) else (4,)
    for pool in pools:
        plain, sharded = run(None, pool), run(mesh, pool)
        assert plain == sharded and len(plain[0]) >= 6, pool


@pytest.mark.parametrize("case", [HYMBA, RWKV, MOE])
def test_single_rank_mesh_trainer_step_of_each_kind_is_bit_equal(case,
                                                                 single):
    _, cfg = _cfgs(case)
    base = convert.params_from_jax(_tree(case), cfg, "cpu")
    ro = dict(RO, max_response_len=16)

    def step(mesh):
        tr = CoPRISTrainer(cfg, RolloutConfig(**ro),
                           TrainConfig(lr=1e-3, seed=3, entropy_coef=0.01),
                           AdditionTask(max_value=20, seed=9), eos_id=EOS,
                           params=tree_map(lambda t: t.clone(), base),
                           train_mesh=mesh,
                           device="cpu" if mesh is None else None)
        try:
            out = tr.step()
            toks = {(g.group_id, t.sample_idx): list(t.response_tokens)
                    for g in tr.last_groups for t in g.trajectories}
            params = [getattr(t, "full_tensor", lambda t=t: t)().detach()
                      for t in leaves(tr.params)]
        finally:
            tr.close()
        return toks, out["pg_loss"], params

    plain = step(None)
    sharded = step(make_single_mesh("cpu"))
    assert sharded[0] == plain[0] and len(plain[0]) >= 6
    assert sharded[1] == plain[1]
    assert all(torch.equal(a, b) for a, b in zip(sharded[2], plain[2]))
