"""The port's sharded update on ``torch.distributed`` against the JAX
package, on 4 gloo ranks over a (2, 2) ("data", "model") mesh
(``tests/torch_ranks.py`` runs the ranks; each gets the inputs as numpy
arrays and sends back its gathered results the same way). The JAX
reference runs once, here, on one device and with no mesh: sharding
changes no value, only the order of sums.

* (a) one sharded ``make_train_step`` against the JAX ``make_train_step``
  and against the port's unsharded step, on the same weights and batch:
  ``tiny`` (microbatches=2) and the reduced llama3.2-1b at vocab 8192 (the
  big-vocab loss; its logits materialised vocab-sharded), plus the same
  llama on a (4, 1) mesh, where the fused loss runs on each rank's rows;
* (b) the expert-parallel dispatch against the JAX dense oracle
  ``apply_moe`` on the JAX test's own case (smoke deepseek-moe-16b, 8
  experts top-2, capacity factor 16, (B, S) = (4, 8) and (2, 13)): y, the
  input and weight gradients, and aux against the mean of the per-rank
  Switch losses over the same token split;
* (c) one sharded update of that deepseek with ``dispatch="shardmap"``
  against the JAX update with ``"sparse"`` (capacity factor 16: both
  dropless; ``router_aux_coef`` 0, as the two define aux differently), the
  exchanges counted, and ``router_aux`` against the per-rank definition;
* (d) the launcher: ``main`` exits 2 on a (4, 2) mesh over 4 ranks; ``run``
  takes 2 steps on (2, 2) with finite losses and identical params on every
  data replica;
* a (1, 1) mesh in this process (gloo, world size 1): the sharded step
  equals the unsharded one.

Tolerances are those of ``tests/test_torch_train.py`` for the unsharded
step: loss and metrics atol 1e-5, grad_norm rtol 1e-5, the AdamW moments
2e-6 (the gradients' 2e-5 times 1 - b1) and the parameters 1e-6 where the
gradient is above 1e-5, for the MoE each of these times the leaf's
largest element where that is above 1 and parameters where the gradient is
above 1e-3.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_ranks  # noqa: E402
from repro.common.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.core import copris as jcopris  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.common.config import TrainConfig  # noqa: E402
from repro_torch.common.partitioning import set_activation_mesh  # noqa: E402
from repro_torch.common.tree import leaves, tree_map  # noqa: E402
from repro_torch.core import copris  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import make_single_mesh  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.optim import adam  # noqa: E402

torch.set_num_threads(1)

TC = dict(lr=1e-3, weight_decay=0.01, grad_clip=1.0, entropy_coef=0.01,
          remat=True)


def _tc(legacy):
    return dict(TC, fused_loss=False, entropy_coef=0.0) if legacy else TC


def _jax_config(case):
    if case.startswith("deepseek"):      # the JAX update: sparse
        cfg = jget_smoke("deepseek-moe-16b")
        moe = dataclasses.replace(cfg.moe, num_experts=8, top_k=2,
                                  capacity_factor=16.0, router_aux_coef=0.0,
                                  dispatch="sparse")
        return dataclasses.replace(cfg, moe=moe, vocab_size=8192,
                                   dtype="float32")
    return torch_ranks.case_config(case, jget_config, jget_smoke)


def _open_gates(tree, cfg):
    """The JAX tree with every xattn layer's tanh gates at 0.5 / 0.7 (zero
    at init, where the cross-attention would not reach the loss)."""
    for j, kind in enumerate(cfg.block_pattern):
        if kind == "xattn":
            layer = tree["stack"]["body"][j]
            layer["xattn"]["gate"] = np.full_like(layer["xattn"]["gate"], 0.5)
            layer["mlp_gate"] = np.full_like(layer["mlp_gate"], 0.7)
    return tree


def _batch(cfg, N=4, T=24, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (N, T)).astype(np.int32)
    mask = np.zeros((N, T), np.float32)
    for n in range(N):
        mask[n, rng.integers(4, 10):rng.integers(14, T)] = 1.0
    behaviour = ((rng.standard_normal((N, T)) * 0.3 - 1.0 - np.log(
        cfg.vocab_size)) * mask).astype(np.float32)
    adv = rng.standard_normal(N).astype(np.float32)
    batch = dict(tokens=tokens, loss_mask=mask, behaviour_logp=behaviour,
                 advantages=adv)
    if cfg.cross_attn is not None:
        xa = cfg.cross_attn
        batch["media"] = (rng.normal(size=(N, xa.num_media_tokens,
                                           xa.d_media)) * 0.1
                          ).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _reference(case, microbatches, legacy=False):
    """(JAX-layout numpy params, batch, the JAX step's new params / AdamW
    moments / metrics in the port's layout, the port's unsharded step's).
    ``legacy``: ``fused_loss=False`` (entropy off, which it cannot
    compute)."""
    cfg_t = torch_ranks.case_config(case)
    cfg_j = _jax_config(case)
    tree = _open_gates(convert.params_to_jax(TM.init_params(
        cfg_t, seed=0, device="cpu"), cfg_t), cfg_j)
    batch = _batch(cfg_t)
    tc = dict(_tc(legacy), microbatches=microbatches)
    pj = jax.tree.map(jnp.asarray, tree)
    pj_new, oj, mj = jax.jit(jcopris.make_train_step(cfg_j, JTrainConfig(
        **tc)))(pj, jadam.init(pj),
                {k: jnp.asarray(v) for k, v in batch.items()},
                jnp.asarray(1e-3, jnp.float32))
    port_p = lambda t: [x.numpy() for x in leaves(  # noqa: E731
        convert.params_from_jax(jax.device_get(t), cfg_t, "cpu"))]
    ref = dict(params=port_p(pj_new), m=port_p(oj["m"]), v=port_p(oj["v"]),
               metrics={k: float(v) for k, v in mj.items()})
    pt = convert.params_from_jax(tree, cfg_t, "cpu")
    for p in leaves(pt):
        p.requires_grad_(True)
    pt, st, mt = copris.make_train_step(cfg_t, TrainConfig(**tc))(
        pt, adam.init(pt), {k: torch.from_numpy(v) for k, v in
                            batch.items()}, 1e-3)
    port = dict(params=[x.detach().numpy() for x in leaves(pt)],
                m=[x.numpy() for x in leaves(st["m"])],
                v=[x.numpy() for x in leaves(st["v"])],
                metrics={k: float(v) for k, v in mt.items()})
    return tree, batch, ref, port


def _assert_update(got, ref, *, scaled, skip=()):
    for k, v in ref["metrics"].items():
        if k in skip:
            continue
        if k == "grad_norm":
            np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5)
        else:
            np.testing.assert_allclose(got["metrics"][k], v, atol=1e-5,
                                       err_msg=k)
    compared = 0
    floor = 1e-3 if scaled else 1e-5
    for name in ("m", "v"):
        for a, b in zip(got[name], ref[name]):
            scale = max(1.0, float(np.abs(b).max())) if scaled else 1.0
            np.testing.assert_allclose(a, b, atol=2e-6 * scale, err_msg=name)
    for a, b, m in zip(got["params"], ref["params"], ref["m"]):
        sel = np.abs(m) / 0.1 > floor          # |clipped grad| > floor
        compared += int(sel.sum())
        np.testing.assert_allclose(a[sel], b[sel], atol=1e-6)
    assert compared > 1000


def _flat(res):
    return dict(params=leaves(res["params"]), m=leaves(res["m"]),
                v=leaves(res["v"]), metrics=res["metrics"])


@pytest.mark.parametrize("case,mesh_shape,microbatches,legacy", [
    ("tiny", (2, 2), 2, False), ("llama", (2, 2), 1, False),
    ("llama", (4, 1), 1, False), ("hymba", (2, 2), 1, False),
    ("gemma2", (2, 2), 1, False), ("qwen3", (2, 2), 1, False),
    ("vlm", (2, 2), 1, False), ("llama", (2, 2), 1, True),
    ("llama", (4, 1), 1, True)],
    ids=["tiny-2x2-mb2", "llama-2x2", "llama-4x1", "hymba-2x2",
         "gemma2-2x2", "qwen3-2x2", "vlm-2x2", "llama-2x2-legacy",
         "llama-4x1-legacy"])
def test_sharded_update_matches_jax(tmp_path, case, mesh_shape,
                                    microbatches, legacy):
    """hymba: 5 heads (laid out whole over "model"), its SSM branch run
    per rank on its own rows; its gradients take the hybrids' tolerance.
    gemma2: 8/4 heads over "model", both softcaps, the window binding;
    qwen3: qk-norm, 5/1 heads laid out whole; vlm: the xattn layer (8/1
    heads whole, its gates opened) and the media rows over the batch
    axes. legacy: ``fused_loss=False``, the log-probs materialised
    vocab-sharded on (2, 2) and by the fused op on each rank's rows on
    (4, 1)."""
    tree, batch, ref, port = _reference(case, microbatches, legacy)
    res = torch_ranks.spawn("train_step", tmp_path, 4, mesh_shape=mesh_shape,
                            case=case, params=tree, batch=batch,
                            tc=dict(_tc(legacy), microbatches=microbatches))
    for r in res[1:]:                     # every rank gathers the same
        for a, b in zip(leaves(r["params"]), leaves(res[0]["params"])):
            np.testing.assert_array_equal(a, b)
    got = _flat(res[0])
    assert res[0]["step"] == 1
    assert res[0]["opt_placed"]
    _assert_update(got, ref, scaled=case == "hymba")
    _assert_update(got, port, scaled=case == "hymba")


# -- (b) the expert-parallel dispatch ------------------------------------------


def _switch_aux(xt, router, E, k):
    """The Switch load-balance loss of the tokens xt, in numpy."""
    logits = xt.astype(np.float64) @ router.astype(np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    top = np.argsort(-probs, axis=-1, kind="stable")[:, :k]
    frac = np.eye(E)[top].sum(1).mean(0)
    return E * float((frac * probs.mean(0)).sum())


def _per_rank_aux(xt, router, E, k, ranks):
    pad = (-xt.shape[0]) % ranks
    xt = np.concatenate([xt, np.zeros((pad, xt.shape[1]), xt.dtype)])
    return float(np.mean([_switch_aux(c, router, E, k)
                          for c in np.split(xt, ranks)]))


@pytest.mark.parametrize("B,S", [(4, 8), (2, 13)])
def test_expert_parallel_dispatch_matches_dense(tmp_path, B, S):
    cfg_j = _jax_config("deepseek")
    p = jmoe.init_moe(jax.random.PRNGKey(0), cfg_j, jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(B * 100 + S),
                          (B, S, cfg_j.d_model)) * 0.5
    yd, _ = jmoe.apply_moe(p, cfg_j, x)
    gp, gx = jax.grad(lambda p_, x_: jmoe.apply_moe(p_, cfg_j, x_)[0].sum(),
                      argnums=(0, 1))(p, x)
    pn = jax.tree.map(np.asarray, jax.device_get(p))
    res = torch_ranks.spawn("moe_dispatch", tmp_path, 4, mesh_shape=(2, 2),
                            params=pn, x=np.asarray(x), cf=16.0)
    r = res[0]
    assert r["exchanges"] == 4            # out and back, forward and backward
    np.testing.assert_allclose(r["y"], np.asarray(yd), atol=2e-4)
    np.testing.assert_allclose(r["dx"], np.asarray(gx), atol=5e-4)
    ref = jax.tree.map(np.asarray, jax.device_get(gp))
    for name in ("router", "wi", "wg", "wo"):
        np.testing.assert_allclose(r["grads"][name], ref[name], atol=5e-4,
                                   err_msg=name)
    for name in ("wi", "wg", "wo"):
        np.testing.assert_allclose(r["grads"]["shared"][name],
                                   ref["shared"][name], atol=5e-4)
    want = _per_rank_aux(np.asarray(x).reshape(B * S, -1), pn["router"],
                         cfg_j.moe.num_experts, cfg_j.moe.top_k, 4)
    np.testing.assert_allclose(r["aux"], want, atol=1e-5)


# -- (c) a sharded update with the expert-parallel dispatch ----------------------


def test_sharded_moe_update_shardmap_matches_sparse(tmp_path, monkeypatch):
    tree, batch, ref, port = _reference("deepseek-sparse", 1)
    res = torch_ranks.spawn("train_step", tmp_path, 4, mesh_shape=(2, 2),
                            case="deepseek", params=tree, batch=batch,
                            tc=dict(TC))
    r = res[0]
    assert r["exchanges"] > 0             # the all-to-all path ran
    got = _flat(r)
    _assert_update(got, ref, scaled=True, skip=("router_aux",))
    _assert_update(got, port, scaled=True, skip=("router_aux",))
    # router_aux is each rank's Switch loss over its own tokens, averaged:
    # recompute it from the MoE layer's input on the unsharded port
    cfg = torch_ranks.case_config("deepseek-sparse")
    seen = []
    orig = transformer._moe_ffn

    def record(params, cfg_, h2, mode="train"):
        seen.append((h2.detach().numpy().copy(),
                     params["moe"]["router"].detach().numpy()))
        return orig(params, cfg_, h2, mode)

    monkeypatch.setattr(transformer, "_moe_ffn", record)
    pt = convert.params_from_jax(tree, cfg, "cpu")
    with torch.no_grad():
        copris.make_loss_fn(cfg, TrainConfig(**TC))(
            pt, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert len(seen) == 1
    h2, router = seen[0]
    want = _per_rank_aux(h2.reshape(-1, h2.shape[-1]), router,
                         cfg.moe.num_experts, cfg.moe.top_k, 4)
    np.testing.assert_allclose(r["metrics"]["router_aux"], want, atol=1e-5)
    # the whole batch's aux (the sparse dispatch's) is another number
    assert abs(want - port["metrics"]["router_aux"]) > 1e-4


# -- (d) the launcher -------------------------------------------------------------


def test_launcher_refuses_bad_mesh_and_keeps_replicas(tmp_path):
    res = torch_ranks.spawn("launcher", tmp_path, 4, mesh_shape=(2, 2),
                            bad_mesh=(4, 2), steps=2)
    assert [r["code"] for r in res] == [2] * 4
    for r in res:
        assert len(r["losses"]) == 2 and np.all(np.isfinite(r["losses"]))
        for a, b in zip(r["full"], res[0]["full"]):
            np.testing.assert_array_equal(a, b)
    # a leaf replicated over "data" holds the same bits on both data ranks
    by_coord = {r["coord"]: r for r in res}
    n = 0
    for i, replicated in enumerate(res[0]["data_replicated"]):
        if not replicated:
            continue
        for m in (0, 1):
            np.testing.assert_array_equal(by_coord[(0, m)]["local"][i],
                                          by_coord[(1, m)]["local"][i])
            n += 1
    assert n > 0


# -- the (1, 1) mesh, in this process ----------------------------------------------


@pytest.mark.parametrize("case", ["tiny", "llama", "rwkv",
                                  "deepseek-sparse"])
def test_single_rank_mesh_equals_unsharded(case):
    """rwkv: its blocks per rank on their own rows; deepseek with the
    sparse dispatch: the experts run whole on every rank."""
    tree, batch, ref, port = _reference(case, 1)
    cfg = torch_ranks.case_config(case)
    mesh = make_single_mesh("cpu")
    try:
        set_activation_mesh(mesh)
        p = shd.shard_params(convert.params_from_jax(tree, cfg, "cpu"), mesh,
                             cfg)
        b = shd.shard_batch({k: torch.from_numpy(v) for k, v in
                             batch.items()}, mesh)
        p, st, m = copris.make_train_step(cfg, TrainConfig(**TC))(
            p, adam.init(p), b, 1e-3)
        got = dict(params=leaves(torch_ranks._np(p)),
                   m=leaves(torch_ranks._np(st["m"])),
                   v=leaves(torch_ranks._np(st["v"])),
                   metrics={k: float(v) for k, v in m.items()})
    finally:
        set_activation_mesh(None)
        torch.distributed.destroy_process_group()
    scaled = case in ("rwkv", "deepseek-sparse")
    _assert_update(got, port, scaled=scaled)
    _assert_update(got, ref, scaled=scaled)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_single_rank_shardmap_equals_sparse(dtype):
    """The smoke deepseek-moe-16b as shipped (its shared experts, its
    capacity factor, the router loss on), in bfloat16 compute and in
    float32: the loss and every gradient of ``dispatch="shardmap"`` on a
    (1, 1) mesh equal those of ``"sparse"`` unsharded bit for bit. One
    rank's exchange is a copy and its capacity and aux are the sparse
    dispatch's, so nothing may round apart (the order in which x's
    gradient adds the routed and shared experts' terms once did, by up to
    1e-2 of a leaf in bfloat16)."""
    from repro_torch.configs import get_smoke_config
    cfg = dataclasses.replace(get_smoke_config("deepseek-moe-16b"),
                              dtype=dtype)
    base = TM.init_params(cfg, seed=4, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, N=8).items()}
    tc = TrainConfig(**TC)

    def arm(dispatch, mesh=None):
        c = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=dispatch))
        p = tree_map(lambda t: t.detach().clone().requires_grad_(), base)
        b = batch
        if mesh is not None:
            set_activation_mesh(mesh)
            p, b = shd.shard_params(p, mesh, cfg), shd.shard_batch(b, mesh)
        try:
            loss, _ = copris.make_loss_fn(c, tc)(p, b)
            grads = torch.autograd.grad(loss, leaves(p))
        finally:
            set_activation_mesh(None)
        return (torch_ranks._np(loss.detach()),
                leaves(torch_ranks._np(list(grads))))

    loss_s, grads_s = arm("sparse")
    before = transformer.apply_moe_shardmap.exchanges
    try:
        loss_e, grads_e = arm("shardmap", make_single_mesh("cpu"))
    finally:
        torch.distributed.destroy_process_group()
    assert transformer.apply_moe_shardmap.exchanges > before
    np.testing.assert_array_equal(loss_e, loss_s)
    assert len(grads_e) == len(grads_s) == len(leaves(base))
    for a, b in zip(grads_e, grads_s):
        np.testing.assert_array_equal(a, b)
