"""The port's mixture-of-experts FFN (``repro_torch.models.moe``) against
``repro.models.moe`` on the CPU, on the two MoE smoke configs
(deepseek-moe-16b: 4 experts top-2 plus a shared expert; qwen3-moe-235b-a22b:
4 experts top-2), with the expert weights converted from the JAX init:

* the dense dispatch and the capacity-bounded one: output and router loss
  within atol 1e-5 in float32;
* a dropping case (``capacity_factor=0.1``: one slot an expert), whose
  dropped (token, k) pairs equal the reference's, and a chunked one
  (``dispatch_chunk`` < T, with the T % chunk halving);
* the gradients of output and router loss in the router, the experts and
  the input, against ``jax.grad``: atol 1e-5 times the leaf's largest
  magnitude where that exceeds 1 (these gradients reach 64, and float32
  sums taken in another order differ there by a few ulps, ~5e-7 of the
  largest value);
* bit-equal results across two calls.

Also the configs and the converter of the three archs this block kind and
the VLM's bring: ``param_count()`` equal to the reference's and inside its
published ranges (``tests/test_configs.py``), and the ``params_from_jax``
-> ``params_to_jax`` round trip, exact, with the router float32 before and
after ``cast_params`` to bfloat16.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402

torch.set_num_threads(1)
ATOL = 1e-5
ARCHS = ["deepseek-moe-16b", "qwen3-moe-235b-a22b"]


def _tensors(tree):
    return {k: _tensors(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v, copy=True))
            for k, v in tree.items()}


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """(JAX config, port config, JAX params, port params, x (B, S, d))."""
    jcfg, cfg = jget_smoke(request.param), get_smoke_config(request.param)
    jp = jmoe.init_moe(jax.random.PRNGKey(1), jcfg, jnp.float32)
    x = np.random.default_rng(0).normal(size=(3, 8, cfg.d_model)).astype(
        np.float32)
    return jcfg, cfg, jp, _tensors(jax.device_get(jp)), x


def _jax(fn, jp, jcfg, x, **kw):
    y, aux = fn(jp, jcfg, jnp.asarray(x), **kw)
    return np.asarray(y), float(aux)


@pytest.mark.parametrize("kw", [{}, {"capacity_factor": 0.1},
                                {"dispatch_chunk": 16},
                                {"dispatch_chunk": 10,
                                 "capacity_factor": 0.5}],
                         ids=["default", "dropping", "chunked",
                              "chunked-halved"])
def test_sparse_matches_jax(case, kw):
    jcfg, cfg, jp, p, x = case
    want, want_aux = _jax(jmoe.apply_moe_sparse, jp, jcfg, x, **kw)
    got, aux = moe.apply_moe_sparse(p, cfg, torch.from_numpy(x), **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert abs(float(aux) - want_aux) < ATOL


def test_dense_matches_jax(case):
    jcfg, cfg, jp, p, x = case
    want, want_aux = _jax(jmoe.apply_moe, jp, jcfg, x)
    got, aux = moe.apply_moe(p, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert abs(float(aux) - want_aux) < ATOL


def _reference_keep(jp, jcfg, xt, cap):
    """The reference's kept (token, k) pairs, by its own steps
    (``apply_moe_sparse.one_chunk``): top-k of the float32 router, the
    running count per expert over the flat (token, k) order, kept below
    ``cap``."""
    m = jcfg.moe
    probs = jax.nn.softmax(jnp.asarray(xt) @ jp["router"], axis=-1)
    _, top_i = jax.lax.top_k(probs, m.top_k)
    flat_e = top_i.reshape(-1)
    pos_in_e = jnp.cumsum(jax.nn.one_hot(flat_e, m.num_experts,
                                         dtype=jnp.int32), axis=0)
    pos = jnp.take_along_axis(pos_in_e, flat_e[:, None], axis=1)[:, 0] - 1
    return np.asarray(pos < cap)


def test_dropped_pairs_equal_reference(case):
    """At capacity_factor 0.1 each expert keeps one pair of the 24 tokens'
    48: the dropped set is the reference's, and some pairs are dropped."""
    jcfg, cfg, jp, p, x = case
    xt = x.reshape(-1, cfg.d_model)
    chunk, cap = moe.capacity(cfg, xt.shape[0], capacity_factor=0.1)
    assert chunk == xt.shape[0] and cap == 1
    _, _, top_i, _ = moe.route(p["router"], cfg, torch.from_numpy(xt))
    _, keep = moe.dispatch_slots(top_i, cfg.moe.num_experts, cap)
    want = _reference_keep(jp, jcfg, xt, cap)
    np.testing.assert_array_equal(keep.numpy(), want)
    assert 0 < want.sum() < want.size


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_gradients_match_jax_vjp(case, sparse):
    """d(<out, g> + 0.3 aux) in the router, every expert weight, the shared
    block and the input, against jax.grad of the reference; the router and
    every expert stack get a nonzero gradient."""
    jcfg, cfg, jp, p, x = case
    g = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    jfn = jmoe.apply_moe_sparse if sparse else jmoe.apply_moe
    tfn = moe.apply_moe_sparse if sparse else moe.apply_moe
    kw = {"capacity_factor": 0.5} if sparse else {}

    def jloss(params, xx):
        y, aux = jfn(params, jcfg, xx, **kw)
        return jnp.sum(y * g) + 0.3 * aux

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = jax.tree_util.tree_leaves_with_path(p)
    flat = [t.requires_grad_(True) for _, t in leaves]
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = tfn(p, cfg, xt, **kw)
    loss = (y * torch.from_numpy(g)).sum() + 0.3 * aux
    grads = torch.autograd.grad(loss, flat + [xt])
    for (path, _), gt in zip(leaves, grads[:-1]):
        want = np.asarray(_at(jg_p, path))
        np.testing.assert_allclose(gt.numpy(), want, atol=_scaled(want),
                                   err_msg=jax.tree_util.keystr(path))
        assert np.abs(want).max() > 0, jax.tree_util.keystr(path)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jg_x),
                               atol=_scaled(np.asarray(jg_x)))
    for t in flat:
        t.requires_grad_(False)


def _scaled(want):
    return ATOL * max(1.0, float(np.abs(want).max()))


def _at(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_bit_equal_across_calls(case, sparse):
    _, cfg, _, p, x = case
    fn = moe.apply_moe_sparse if sparse else moe.apply_moe
    a = fn(p, cfg, torch.from_numpy(x))
    b = fn(p, cfg, torch.from_numpy(x))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_model_dispatch_choice():
    """The moe block takes the dense dispatch at decode (S == 1) and for
    ``dispatch == "dense"``, the sparse one otherwise ("shardmap" has no
    mesh on one card): a dropping capacity shows which ran."""
    from repro_torch.models import transformer
    cfg = get_smoke_config("qwen3-moe-235b-a22b")
    p = {"moe": moe.init_moe(cfg, torch.float32, "cpu",
                             torch.Generator().manual_seed(0))}
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    tight = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.1, dispatch="sparse"))
    dense, _ = moe.apply_moe(p["moe"], tight, x)
    sparse, _ = moe.apply_moe_sparse(p["moe"], tight, x)
    assert not torch.allclose(dense, sparse)
    for dispatch, want in (("dense", dense), ("sparse", sparse),
                           ("shardmap", sparse)):
        c = dataclasses.replace(tight, moe=dataclasses.replace(
            tight.moe, dispatch=dispatch))
        assert torch.equal(transformer._moe_ffn(p, c, x)[0], want)
    one = x[:, :1]
    assert torch.equal(transformer._moe_ffn(p, tight, one)[0],
                       moe.apply_moe(p["moe"], tight, one)[0])


# -- configs and converter ---------------------------------------------------

# the published sizes, billions (tests/test_configs.py), total and active
PARAMS_B = {"deepseek-moe-16b": ((15.5, 17.5), (2.0, 3.5)),
            "qwen3-moe-235b-a22b": ((225, 245), (20, 25)),
            "llama-3.2-vision-90b": ((83, 92), (83, 92))}


@pytest.mark.parametrize("arch", sorted(PARAMS_B))
def test_param_count_matches_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for active, (lo, hi) in zip((False, True), PARAMS_B[arch]):
        n = cfg.param_count(active_only=active)
        assert n == jcfg.param_count(active_only=active)
        assert lo <= n / 1e9 <= hi, (arch, active, n)


@pytest.mark.parametrize("arch,layers", [("deepseek-moe-16b", 2),
                                         ("qwen3-moe-235b-a22b", 2),
                                         ("llama-3.2-vision-90b", 5)])
def test_convert_round_trip(arch, layers):
    """JAX tree -> port -> JAX tree is exact (the router float32, the (E,
    d, f) expert stacks, the shared block, the xattn gates and
    ``media_proj``); bf16 serving casts keep the router float32."""
    jcfg = jget_config(arch).reduced(num_layers=layers)
    cfg = get_config(arch).reduced(num_layers=layers)
    tree = jax.device_get(JM.init_params(jax.random.PRNGKey(0), jcfg))
    params = convert.params_from_jax(tree, cfg, device="cpu")
    back = convert.params_to_jax(params, cfg)
    flat_a, tdef_a = jax.tree_util.tree_flatten(tree)
    flat_b, tdef_b = jax.tree_util.tree_flatten(back)
    assert tdef_a == tdef_b
    for a, b in zip(flat_a, flat_b):
        a = np.asarray(a)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    cast = M.cast_params(params, torch.bfloat16)
    for layer, raw in zip(cast["layers"], params["layers"]):
        if "moe" in layer:
            assert raw["moe"]["router"].dtype == torch.float32
            assert layer["moe"]["router"].dtype == torch.float32
            assert layer["moe"]["wi"].dtype == torch.bfloat16
            if "shared" in layer["moe"]:
                assert layer["moe"]["shared"]["wo"].dtype == torch.bfloat16
        if "xattn" in layer:
            assert layer["xattn"]["gate"].dtype == torch.bfloat16
            assert layer["mlp_gate"].dtype == torch.bfloat16
    if cfg.uses_media:
        assert cast["embed"]["media_proj"].dtype == torch.bfloat16
        assert "xattn" in params["layers"][4]
