"""The port's fused IS+GRPO loss (plain versions, CPU) against the JAX
package: ``fio_ops.fused_is_grpo(impl="pallas")`` (the Pallas kernels in
interpret mode) and the unfused oracle ``ref.is_grpo_reference``, in value
and in gradient, on the shapes and ``KW`` cases of tests/test_fused_is_grpo.

Tolerances: float32 throughout; values atol 3e-5 and gradients atol 5e-5,
the reference test's own (sums over vocab blocks in another order).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.fused_is_grpo import ops as fio_ops  # noqa: E402
from repro.kernels.fused_is_grpo.ref import is_grpo_reference  # noqa: E402
from repro_torch.hopper import fused_is_grpo as tfio  # noqa: E402

torch.set_num_threads(1)

KW = dict(logit_softcap=5.0, clip_low=0.2, clip_high=0.28, use_is=True,
          is_ratio_cap=10.0, entropy_coef=0.01)
CASES = [
    KW,
    dict(logit_softcap=0.0, clip_low=0.2, clip_high=0.28, use_is=False,
         is_ratio_cap=10.0, entropy_coef=0.0),
    dict(logit_softcap=0.0, clip_low=0.3, clip_high=0.3, use_is=True,
         is_ratio_cap=1.5, entropy_coef=0.05),   # tight cap: ratios clamp
]
PALLAS = dict(impl="pallas", vocab_block=32, block_rows=4, block_v=32)


def _inputs(seed=0, B=2, S=5, d=16, V=133):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((B, S, d)).astype(np.float32)
    w = (rng.standard_normal((d, V)) * 0.3).astype(np.float32)
    targets = rng.integers(0, V, (B, S)).astype(np.int32)
    behaviour = (rng.standard_normal((B, S)) * 0.5 - 2.0).astype(np.float32)
    adv = rng.standard_normal((B, S)).astype(np.float32)
    return hidden, w, targets, behaviour, adv


def _t(*xs, grad=False):
    return [torch.tensor(x, requires_grad=grad and x.dtype == np.float32)
            for x in xs]


@pytest.mark.parametrize("kw", CASES, ids=["softcap_ent", "no_is", "cap"])
def test_forward_matches_pallas_and_reference(kw):
    h, w, t, b, a = _inputs()
    ref = is_grpo_reference(*map(jnp.asarray, (h, w, t, b, a)), **kw)
    pal = fio_ops.fused_is_grpo(*map(jnp.asarray, (h, w, t, b, a)),
                                **PALLAS, **kw)
    got = tfio.fused_is_grpo(*_t(h, w, t, b, a), **kw)
    for name, g, p, r in zip(("loss", "ratio", "logp", "entropy"), got, pal,
                             ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(p), atol=3e-5,
                                   err_msg=f"pallas:{name}")
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=3e-5,
                                   err_msg=f"ref:{name}")


def test_rows_forward_returns_lse():
    h, w, t, b, a = _inputs(seed=4)
    R = h.shape[0] * h.shape[1]
    outs = tfio.fused_is_grpo_fwd_rows(
        *_t(h.reshape(R, -1), w, t.reshape(-1), b.reshape(-1),
            a.reshape(-1)), **KW)
    logits = np.tanh(h.reshape(R, -1) @ w / 5.0) * 5.0
    lse = np.log(np.exp(logits).sum(-1))
    np.testing.assert_allclose(outs[3].numpy(), lse, atol=3e-5)


@pytest.mark.parametrize("kw", CASES, ids=["softcap_ent", "no_is", "cap"])
def test_grad_parity(kw):
    h, w, t, b, a = _inputs(seed=1)
    ct = (np.random.default_rng(7).standard_normal(t.shape) * 0.3
          ).astype(np.float32)

    def f_jax(op):
        def f(h_, w_, b_, a_):
            lt, r, _, _ = op(h_, w_, jnp.asarray(t), b_, a_, **kw)
            return (lt * ct).sum() + 0.1 * (r * ct).sum()
        return jax.grad(f, argnums=(0, 1, 2, 3))(
            *map(jnp.asarray, (h, w, b, a)))

    g_pal = f_jax(lambda *x, **k: fio_ops.fused_is_grpo(*x, **PALLAS, **k))
    g_ref = f_jax(is_grpo_reference)
    th, tw, tb, ta = _t(h, w, b, a, grad=True)
    lt, r, _, _ = tfio.fused_is_grpo(th, tw, torch.tensor(t), tb, ta, **kw)
    ctt = torch.tensor(ct)
    ((lt * ctt).sum() + 0.1 * (r * ctt).sum()).backward()
    for name, got, p, rf in zip(("dh", "dw", "dbeh", "dadv"),
                                (th, tw, tb, ta), g_pal, g_ref):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(p),
                                   atol=5e-5, err_msg=f"pallas:{name}")
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(rf),
                                   atol=5e-5, err_msg=f"ref:{name}")


def test_grad_through_logp_and_entropy_channels():
    h, w, t, b, a = _inputs(seed=3, V=67)

    def f(h_, w_):
        out = is_grpo_reference(h_, w_, jnp.asarray(t), jnp.asarray(b),
                                jnp.asarray(a), **KW)
        return (out[2] ** 2).sum() + 0.5 * out[3].sum()

    g_ref = jax.grad(f, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th, tw = _t(h, w, grad=True)
    out = tfio.fused_is_grpo(th, tw, *_t(t, b, a), **KW)
    ((out[2] ** 2).sum() + 0.5 * out[3].sum()).backward()
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(g_ref[0]),
                               atol=5e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(g_ref[1]),
                               atol=5e-5)


@pytest.mark.parametrize("case", ["tie_at_one", "below_cap", "above_cap",
                                  "below_clip_high", "above_clip_high"])
def test_clip_boundary_subgradients(case):
    """The reference test's cases: behaviour == logp (ratio exactly 1, the
    minimum() tie) and ratios just inside/outside the cap and 1+clip_high.
    The port's gradient must equal jax.grad of the reference and of the
    Pallas op (the 0.5 tie convention, not torch.clamp's 1)."""
    h, w, t, _, a = _inputs(seed=5, V=41)
    logp = np.asarray(is_grpo_reference(
        *map(jnp.asarray, (h, w, t, np.zeros_like(a), a)), **KW)[2])
    log_cap = float(np.log(KW["is_ratio_cap"]))
    behaviour = {
        "tie_at_one": logp,
        "below_cap": logp - log_cap + 0.05,
        "above_cap": logp - log_cap - 0.05,
        "below_clip_high": logp - np.log(1.28) + 0.05,
        "above_clip_high": logp - np.log(1.28) - 0.05,
    }[case].astype(np.float32)

    def f_jax(op):
        def f(h_):
            lt, r, _, _ = op(h_, jnp.asarray(w), jnp.asarray(t),
                             jnp.asarray(behaviour), jnp.asarray(a), **KW)
            return lt.sum() + r.sum()
        return np.asarray(jax.grad(f)(jnp.asarray(h)))

    g_ref = f_jax(is_grpo_reference)
    g_pal = f_jax(lambda *x, **k: fio_ops.fused_is_grpo(
        *x, impl="pallas", vocab_block=16, block_rows=4, block_v=16, **k))
    (th,) = _t(h, grad=True)
    lt, r, _, _ = tfio.fused_is_grpo(th, *_t(w, t, behaviour, a), **KW)
    (lt.sum() + r.sum()).backward()
    np.testing.assert_allclose(th.grad.numpy(), g_ref, atol=5e-5)
    np.testing.assert_allclose(th.grad.numpy(), g_pal, atol=5e-5)


def test_tied_layout_and_zero_rows():
    """w given as the transpose of a (V, d) embedding: the gradient comes
    back in the embedding's layout; rows with zero advantage and zero
    cotangent add exactly zero to dh."""
    h, w, t, b, a = _inputs(seed=6)
    a[0] = 0.0
    emb = torch.tensor(w.T.copy(), requires_grad=True)        # (V, d)
    th = torch.tensor(h, requires_grad=True)
    lt, _, _, _ = tfio.fused_is_grpo(th, emb.T, *_t(t, b, a),
                                     logit_softcap=0.0)
    lt.sum().backward()
    assert emb.grad.shape == emb.shape and emb.grad.is_contiguous()
    assert torch.count_nonzero(th.grad[0]) == 0
    tw = torch.tensor(w, requires_grad=True)
    lt2, _, _, _ = tfio.fused_is_grpo(torch.tensor(h), tw, *_t(t, b, a),
                                      logit_softcap=0.0)
    lt2.sum().backward()
    np.testing.assert_allclose(emb.grad.numpy(), tw.grad.numpy().T,
                               atol=1e-6)


def test_entry_point_plain_versions_agree_with_blocked():
    """bwd_dh / bwd_dw plain versions (one materialised dl), the references
    of those kernels, equal the blocked port of _bwd_blocked; the entry
    points' wrappers take CUDA tensors only."""
    rng = np.random.default_rng(8)
    R, d, V = 9, 16, 133
    h = torch.tensor(rng.standard_normal((R, d)), dtype=torch.float32)
    w = torch.tensor(rng.standard_normal((d, V)) * 0.3, dtype=torch.float32)
    t = torch.tensor(rng.integers(0, V, R))
    _, _, logp, lse, ent = tfio.fwd_plain(h, w, t, torch.zeros(R),
                                          torch.zeros(R))
    a, e = (torch.tensor(rng.standard_normal(R), dtype=torch.float32)
            for _ in range(2))
    dh, dw = tfio.bwd_plain(h, w, t, lse, lse - ent, a, e, vocab_block=32)
    dl, dh2 = tfio.bwd_dh_plain(h, w, t, lse, lse - ent, a, e)
    dw2 = tfio.bwd_dw_plain(h, dl)
    with pytest.raises(ValueError, match="unsupported device"):
        tfio.fused_is_grpo_bwd_dh_rows(h, w, t, lse, lse - ent, a, e)
    with pytest.raises(ValueError, match="unsupported device"):
        tfio.fused_is_grpo_bwd_dw_rows(h, dl, torch.empty(d, V))
    np.testing.assert_allclose(dh2.numpy(), dh.numpy(), atol=1e-5)
    np.testing.assert_allclose(dw2.numpy(), dw.numpy(), atol=1e-5)
