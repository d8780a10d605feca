"""The VLM's cross-attention in the port against the JAX package on the CPU,
on llama-3.2-vision-90b reduced to one period of its block pattern (four
``attn`` layers and one ``xattn``, d_model 512, 8/1 heads of 64, 16 media
tokens of width 64), with the tanh gates set to 0.5 and 0.7 (they are zero
at init, where the cross-attention would not reach the output):

* ``cross_attention_block`` with the media projected and with cached media
  K/V, against the reference (atol 1e-5);
* the non-causal attention it runs (Sq != Sk, the flash kernel's plain
  version) with its logsumexp and backward against the reference's
  ``chunked_attention`` and ``jax.vjp`` of it (atol 1e-5);
* ``_project_media``'s refusal without media outside decode;
* ``forward_train`` with media (atol 1e-4), and the loss with
  ``mb["media"]``: loss, metrics and every gradient against the JAX loss
  (atol 2e-5), the gates included.

Prefill + decode and one engine collect with media are in
``tests/test_torch_model.py`` (``ARCHS``), the media K/V across evict and
resume in ``tests/test_torch_paged.py``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.common.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import copris as jcopris  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.common.config import TrainConfig  # noqa: E402
from repro_torch.common.tree import leaves  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import copris  # noqa: E402
from repro_torch.hopper import flash_attn  # noqa: E402
from repro_torch.models import attention, model as M  # noqa: E402

torch.set_num_threads(1)
ARCH = "llama-3.2-vision-90b"


def vlm_configs(**kw):
    """(JAX, port) llama-3.2-vision-90b reduced to one 5-layer period."""
    return (dataclasses.replace(jget_config(ARCH).reduced(num_layers=5), **kw),
            dataclasses.replace(get_config(ARCH).reduced(num_layers=5), **kw))


def open_gates(tree, cfg):
    """The JAX tree with every xattn layer's tanh gates at 0.5 / 0.7."""
    for j, kind in enumerate(cfg.block_pattern):
        if kind == "xattn":
            layer = tree["stack"]["body"][j]
            layer["xattn"]["gate"] = np.full_like(layer["xattn"]["gate"], 0.5)
            layer["mlp_gate"] = np.full_like(layer["mlp_gate"], 0.7)
    return tree


@pytest.fixture(scope="module")
def vlm():
    cfg_j, cfg_t = vlm_configs()
    assert cfg_t.block_pattern.count("xattn") == 1
    tree = open_gates(jax.device_get(
        JM.init_params(jax.random.PRNGKey(0), cfg_j)), cfg_j)
    pj = jax.tree.map(jnp.asarray, tree)
    pt = convert.params_from_jax(tree, cfg_t, device="cpu")
    return cfg_j, cfg_t, pj, pt


def _media(cfg, B, seed=0):
    xa = cfg.cross_attn
    return (np.random.default_rng(seed).normal(
        size=(B, xa.num_media_tokens, xa.d_media)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("cached", [False, True], ids=["media", "media_kv"])
def test_cross_attention_block_matches_jax(vlm, cached):
    cfg_j, cfg_t, pj, pt = vlm
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, cfg_t.d_model)).astype(np.float32)
    media = rng.normal(size=(2, 16, cfg_t.d_model)).astype(np.float32)
    jp = pj["stack"]["body"][4]["xattn"]
    tp = pt["layers"][4]["xattn"]
    want, (mk, mv) = jattn.cross_attention_block(
        jax.tree.map(lambda a: a[0], jp), cfg_j, jnp.asarray(x),
        jnp.asarray(media))
    kw = {}
    if cached:
        kw["media_kv"] = (torch.from_numpy(np.array(mk)),
                          torch.from_numpy(np.array(mv)))
    got, (tk, tv) = attention.cross_attention_block(
        tp, cfg_t, torch.from_numpy(x),
        None if cached else torch.from_numpy(media), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(mk), atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(mv), atol=1e-5)
    assert float(np.abs(np.asarray(want)).max()) > 0.0


@pytest.mark.parametrize("Sq,Sk", [(1, 37), (13, 37), (40, 9)])
def test_noncausal_attention_and_backward_match_jax(Sq, Sk):
    """The flash kernel's plain version at causal=False with Sq != Sk: the
    output, the logsumexp of rows that see every key, and dq/dk/dv."""
    rng = np.random.default_rng(2)
    B, H, KV, hd = 2, 4, 2, 16
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
    do = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)

    def f(q_, k_, v_):
        return jattn.chunked_attention(q_, k_, v_, causal=False, window=0,
                                       block_q=16, block_k=16)

    out_r, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    grads_r = vjp(jnp.asarray(do))
    out, lse = flash_attn.flash_attention(
        *map(torch.from_numpy, (q, k, v)), causal=False, return_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_r), atol=1e-5)
    s = np.einsum("bqgrd,bkgd->bgrqk", q.reshape(B, Sq, KV, H // KV, hd),
                  k) * hd ** -0.5
    want_lse = np.log(np.exp(s.astype(np.float64)).sum(-1)).reshape(
        B, H, Sq)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5)
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    flash_attn.flash_attention(*ts, causal=False).backward(
        torch.from_numpy(do))
    for name, t, g in zip("qkv", ts, grads_r):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-5,
                                   err_msg=f"d{name}")


def test_project_media_requires_media_outside_decode(vlm):
    _, cfg_t, _, pt = vlm
    for mode in ("train", "prefill"):
        with pytest.raises(ValueError, match="requires media"):
            M._project_media(pt, cfg_t, None, mode=mode)
    assert M._project_media(pt, cfg_t, None, mode="decode") is None
    toks = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="requires media"):
        M.forward_train(pt, cfg_t, toks)


def test_forward_with_media_matches_jax(vlm):
    cfg_j, cfg_t, pj, pt = vlm
    toks = np.random.default_rng(3).integers(
        0, cfg_t.vocab_size, (2, 20)).astype(np.int32)
    media = _media(cfg_t, 2)
    want, aux = JM.forward_train(pj, cfg_j, jnp.asarray(toks),
                                 media=jnp.asarray(media))
    got, taux = M.forward_train(pt, cfg_t, torch.from_numpy(toks),
                                media=torch.from_numpy(media),
                                return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert float(taux["router_aux"]) == float(aux["router_aux"]) == 0.0
    other = M.forward_train(pt, cfg_t, torch.from_numpy(toks),
                            media=torch.from_numpy(_media(cfg_t, 2, seed=1)))
    assert float((other - got).abs().max()) > 1e-3     # the media reach it


def test_loss_with_media_matches_jax(vlm):
    """make_loss_fn with ``mb["media"]`` (the full-logits branch, V 512):
    loss, metrics and every gradient against the JAX loss, the xattn
    gates' included; the gates get a nonzero gradient."""
    cfg_j, cfg_t, pj, pt = vlm
    rng = np.random.default_rng(4)
    N, T = 2, 16
    tokens = rng.integers(0, cfg_t.vocab_size, (N, T)).astype(np.int32)
    mask = np.zeros((N, T), np.float32)
    mask[:, 5:14] = 1.0
    batch = dict(tokens=tokens, loss_mask=mask,
                 behaviour_logp=(-np.log(cfg_t.vocab_size) * mask).astype(
                     np.float32),
                 advantages=np.array([1.0, -0.5], np.float32),
                 media=_media(cfg_t, N))
    tc = dict(entropy_coef=0.01, remat=True)
    (lv_j, m_j), g_j = jax.value_and_grad(
        jcopris.make_loss_fn(cfg_j, JTrainConfig(**tc)), has_aux=True)(
            pj, {k: jnp.asarray(v) for k, v in batch.items()})
    params = convert.params_from_jax(jax.device_get(pj), cfg_t, "cpu")
    for p in leaves(params):
        p.requires_grad_(True)
    lv, m = copris.make_loss_fn(cfg_t, TrainConfig(**tc))(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(lv, leaves(params))
    np.testing.assert_allclose(float(lv.detach()), float(lv_j), atol=1e-5)
    for k in m_j:
        np.testing.assert_allclose(float(m[k]), float(m_j[k]), atol=1e-5,
                                   err_msg=k)
    want = leaves(convert.params_from_jax(jax.device_get(g_j), cfg_t, "cpu"))
    for g, r in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=2e-5)
    tree = convert.params_from_jax(jax.device_get(g_j), cfg_t, "cpu")
    xl = tree["layers"][4]
    assert float(xl["xattn"]["gate"].abs()) > 0
    assert float(xl["mlp_gate"].abs()) > 0
    assert float(tree["embed"]["media_proj"].abs().max()) > 0


def test_make_serve_engine_wires_media_and_keeps_whole_repeats():
    """make_serve_engine hands the engine the reference's media (a numpy
    default_rng(seed) normal of (M, d_media) times 0.1) and serves a
    request with it; ``num_layers`` must keep whole repeats of the block
    pattern (the VLM's period is 5)."""
    from repro_torch.launch import serve
    eng, cfg = serve.make_serve_engine(ARCH, smoke=True, max_tokens=4,
                                       seed=3, device="cpu")
    xa = cfg.cross_attn
    want = np.random.default_rng(3).normal(
        size=(xa.num_media_tokens, xa.d_media)).astype(np.float32) * 0.1
    np.testing.assert_array_equal(eng.eng.media.numpy(), want)
    eng.submit(serve.GenerateRequest(prompt=np.arange(1, 6)))
    (res,) = eng.drain()
    assert 1 <= len(res.tokens) <= 4
    eng.close()
    for n in (7, 101):
        with pytest.raises(ValueError, match="whole repeats"):
            serve.make_serve_engine(ARCH, num_layers=n, device="cpu")
