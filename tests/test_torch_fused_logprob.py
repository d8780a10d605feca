"""The port's fused log-prob and the legacy ``fused_loss=False`` loss on the
CPU, against the JAX package:

* ``fused_logprob_plain`` (vocab-blocked) against the JAX oracle
  ``ref.fused_logprob`` (one shot and blocked) and the Pallas kernel
  ``fused_logprob_rows`` in interpret mode, with and without the logit
  softcap, with V not a multiple of the block: atol 1e-5;
* the differentiable op: its backward (the IS-GRPO backward with a = g,
  e = 0) against autograd through the plain version, atol 1e-5;
* ``make_loss_fn`` with ``fused_loss=False`` on the reduced llama3.2-1b with
  vocab 8192, float32: loss, metrics and every gradient against
  ``jax.value_and_grad`` of the JAX legacy branch, at the fused branch's
  tolerances in ``test_torch_train.py`` (loss and metrics atol 1e-5,
  gradients atol 2e-5).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.common.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.core import copris as jcopris  # noqa: E402
from repro.kernels.fused_logprob import fused_logprob as flp_pallas  # noqa: E402
from repro.kernels.fused_logprob import ref as flp_ref  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.common.config import TrainConfig  # noqa: E402
from repro_torch.common.tree import leaves  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import copris  # noqa: E402
from repro_torch.hopper import fused_logprob as flp  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

torch.set_num_threads(1)

CASES = [(2, 16, 64, 1000, 0.0), (1, 7, 128, 2048, 30.0),
         (3, 5, 32, 517, 0.0)]


def _inputs(B, S, d, V, seed=0):
    rng = np.random.default_rng(seed)
    h = (rng.standard_normal((B, S, d)) * 0.3).astype(np.float32)
    w = (rng.standard_normal((d, V)) * 0.3).astype(np.float32)
    t = rng.integers(0, V, (B, S)).astype(np.int32)
    return h, w, t


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_matches_jax_oracle_and_pallas(case):
    B, S, d, V, cap = case
    h, w, t = _inputs(B, S, d, V)
    ref = np.asarray(flp_ref.fused_logprob(jnp.asarray(h), jnp.asarray(w),
                                           jnp.asarray(t),
                                           logit_softcap=cap))
    blk = np.asarray(flp_ref.fused_logprob(jnp.asarray(h), jnp.asarray(w),
                                           jnp.asarray(t), logit_softcap=cap,
                                           vocab_block=128))
    pal = np.asarray(flp_pallas.fused_logprob_rows(
        jnp.asarray(h.reshape(B * S, d)), jnp.asarray(w),
        jnp.asarray(t.reshape(-1)), logit_softcap=cap, block_rows=8,
        block_v=128, interpret=True)).reshape(B, S)
    th = torch.from_numpy(h.reshape(B * S, d))
    tw = torch.from_numpy(w)
    tt = torch.from_numpy(t.reshape(-1))
    for block in (128, 2048):             # V % 128 != 0 for V = 1000, 517
        lp, lse = flp.fused_logprob_plain(th, tw, tt, logit_softcap=cap,
                                          vocab_block=block)
        got = lp.reshape(B, S).numpy()
        for want in (ref, blk, pal):
            np.testing.assert_allclose(got, want, atol=1e-5)
    # the row wrapper on CPU tensors is the plain version, no launch
    n0 = flp.fused_logprob_rows.launches
    lp_w, lse_w = flp.fused_logprob_rows(th, tw, tt, logit_softcap=cap)
    assert flp.fused_logprob_rows.launches == n0
    np.testing.assert_allclose(lp_w.numpy(), lp.numpy(), atol=1e-6)
    logits = th @ tw
    if cap:
        logits = torch.tanh(logits / cap) * cap
    np.testing.assert_allclose(lse_w.numpy(),
                               torch.logsumexp(logits, -1).numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("cap,tied", [(0.0, True), (30.0, False)])
def test_backward_matches_autograd_through_plain(cap, tied):
    """The op's gradient (dl = g (onehot - p) through the IS-GRPO backward)
    against autograd of the plain version; the tied case passes w as the
    transposed (V, d) embedding, as the model does."""
    B, S, d, V = 2, 6, 32, 517
    h, w, t = _inputs(B, S, d, V, seed=1)
    g = np.random.default_rng(2).standard_normal((B, S)).astype(np.float32)

    def leaves_of(op):
        th = torch.tensor(h, requires_grad=True)
        if tied:
            base = torch.tensor(np.ascontiguousarray(w.T), requires_grad=True)
            tw = base.T
        else:
            base = tw = torch.tensor(w, requires_grad=True)
        out = op(th, tw, torch.from_numpy(t))
        out.backward(torch.from_numpy(g))
        return out.detach(), th.grad, base.grad

    got = leaves_of(lambda a, b, c: flp.fused_logprob(a, b, c,
                                                      logit_softcap=cap))
    want = leaves_of(lambda a, b, c: flp.fused_logprob_plain(
        a.reshape(B * S, d), b, c.reshape(-1), logit_softcap=cap,
        vocab_block=128)[0].reshape(B, S))
    for x, y in zip(got, want):
        assert x.shape == y.shape
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-5)


# -- the legacy loss branch ------------------------------------------------------


def _configs():
    kw = dict(vocab_size=8192, dtype="float32")
    return (dataclasses.replace(jget_smoke("llama3.2-1b"), **kw),
            dataclasses.replace(get_smoke_config("llama3.2-1b"), **kw))


def _batch(cfg, N=4, T=24, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (N, T)).astype(np.int32)
    mask = np.zeros((N, T), np.float32)
    for n in range(N):
        mask[n, rng.integers(4, 10):rng.integers(14, T)] = 1.0
    behaviour = ((rng.standard_normal((N, T)) * 0.3 - 1.0 - np.log(
        cfg.vocab_size)) * mask).astype(np.float32)
    adv = rng.standard_normal(N).astype(np.float32)
    return dict(tokens=tokens, loss_mask=mask, behaviour_logp=behaviour,
                advantages=adv)


TC = dict(lr=1e-3, weight_decay=0.01, grad_clip=1.0, entropy_coef=0.0,
          remat=True, fused_loss=False)


def test_legacy_loss_matches_jax():
    cfg_j, cfg_t = _configs()
    pt = TM.init_params(cfg_t, seed=0, device="cpu")
    pj = jax.tree.map(jnp.asarray, convert.params_to_jax(pt, cfg_t))
    batch = _batch(cfg_t)
    (lv_j, m_j), g_j = jax.jit(jax.value_and_grad(
        jcopris.make_loss_fn(cfg_j, JTrainConfig(**TC)), has_aux=True))(
            pj, {k: jnp.asarray(v) for k, v in batch.items()})
    for p in leaves(pt):
        p.requires_grad_(True)
    n0 = flp.fused_logprob_rows.launches
    lv, m = copris.make_loss_fn(cfg_t, TrainConfig(**TC))(
        pt, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(lv, leaves(pt))
    assert flp.fused_logprob_rows.launches == n0     # CPU: the plain path
    np.testing.assert_allclose(float(lv.detach()), float(lv_j), atol=1e-5)
    assert set(m) == set(m_j) and "entropy" not in m
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(m_j[k]), atol=1e-5,
                                   err_msg=k)
    ref = leaves(convert.params_from_jax(jax.device_get(g_j), cfg_t, "cpu"))
    assert len(ref) == len(grads)
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=2e-5)
    assert all(float(g.abs().max()) > 0.0 for g in grads)
