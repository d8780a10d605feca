"""The port's GRPO objective (core/grpo.py) against repro.core.grpo, in
value and in gradient (``torch.autograd`` against ``jax.grad``), including
both sides of each clip and of the ratio cap and exact boundary ties, where
both must give the 0.5 subgradient (``torch.clamp`` would give 1).

Tolerances: float32; atol 1e-6 for values and gradients of the elementwise
math (the same operations in the same order), 1e-5 for masked means.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import grpo as jgrpo  # noqa: E402
from repro_torch.core import grpo as tgrpo  # noqa: E402
from repro_torch.optim import adam as tadam  # noqa: E402
from repro_torch.optim import schedule as tschedule  # noqa: E402

torch.set_num_threads(1)

KW = dict(clip_low=0.2, clip_high=0.28, is_ratio_cap=10.0)


def test_group_advantages_population_std():
    rng = np.random.default_rng(0)
    r = rng.random(12).astype(np.float32)
    r[4:8] = 0.5                                   # a constant group -> 0
    got = tgrpo.group_advantages(torch.tensor(r), 4).numpy()
    ref = np.asarray(jgrpo.group_advantages(jnp.asarray(r), 4))
    np.testing.assert_allclose(got, ref, atol=1e-6)
    np.testing.assert_allclose(got[4:8], 0.0, atol=1e-6)


def _boundary_logps():
    """Log-ratios on both sides of, and exactly at, every kink: the cap
    (±log 10), the clip edges (log 0.8, log 1.28) and ratio 1."""
    lc = float(np.float32(np.log(np.float32(10.0))))
    pts = [0.0, lc - 0.05, lc + 0.05, -lc + 0.05, -lc - 0.05,
           float(np.log(0.8)) + 0.03, float(np.log(0.8)) - 0.03,
           float(np.log(1.28)) + 0.03, float(np.log(1.28)) - 0.03]
    return np.asarray(pts, np.float32)


@pytest.mark.parametrize("use_is", [True, False])
@pytest.mark.parametrize("adv_sign", [1.0, -1.0])
def test_per_token_objective_value_and_grad(use_is, adv_sign):
    lr = _boundary_logps()
    behaviour = np.full_like(lr, -2.0)
    logp = (behaviour + lr).astype(np.float32)
    adv = np.full_like(lr, adv_sign * 0.7)
    ent = np.linspace(0.1, 2.0, lr.size).astype(np.float32)
    kw = dict(KW, use_is=use_is, entropy_coef=0.01)

    def f_jax(lp, b, a, e):
        lt, r = jgrpo.per_token_objective(lp, b, a, entropy=e, **kw)
        return lt.sum() + 0.3 * r.sum()

    vals = jgrpo.per_token_objective(*map(jnp.asarray, (logp, behaviour,
                                                         adv)),
                                     entropy=jnp.asarray(ent), **kw)
    g_ref = jax.grad(f_jax, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (logp, behaviour, adv, ent)))
    ts = [torch.tensor(x, requires_grad=True)
          for x in (logp, behaviour, adv, ent)]
    lt, r = tgrpo.per_token_objective(ts[0], ts[1], ts[2], entropy=ts[3],
                                      **kw)
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(vals[0]),
                               atol=1e-6)
    np.testing.assert_allclose(r.detach().numpy(), np.asarray(vals[1]),
                               atol=1e-6)
    (lt.sum() + 0.3 * r.sum()).backward()
    for t, g in zip(ts, g_ref):
        got = torch.zeros_like(t) if t.grad is None else t.grad  # unused
        np.testing.assert_allclose(got.numpy(), np.asarray(g), atol=1e-6)


def test_exact_ties_give_half_subgradient():
    """At ratio exactly 1 (logp == behaviour) minimum() ties its two
    branches; at a log-ratio exactly on the cap jnp.clip's subgradient is
    0.5. The port must agree with jax.grad at both."""
    cap = jnp.log(jnp.float32(10.0))
    behaviour = np.asarray([-1.0, -1.0], np.float32)
    logp = np.asarray([-1.0, -1.0 + float(cap)], np.float32)
    adv = np.asarray([1.0, -1.0], np.float32)

    def f_jax(lp):
        return jgrpo.per_token_objective(lp, jnp.asarray(behaviour),
                                         jnp.asarray(adv), **KW)[0].sum()

    g_ref = np.asarray(jax.grad(f_jax)(jnp.asarray(logp)))
    t = torch.tensor(logp, requires_grad=True)
    tgrpo.per_token_objective(t, torch.tensor(behaviour), torch.tensor(adv),
                              **KW)[0].sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), g_ref, atol=1e-6)
    # and torch.clamp would not: the cap tie is 0.5 of the unclipped slope
    assert 0.0 < abs(float(t.grad[1])) < abs(float(np.exp(cap) * adv[1]))


@pytest.mark.parametrize("loss_agg", ["token_mean", "seq_mean"])
def test_grpo_loss_and_metrics(loss_agg):
    rng = np.random.default_rng(3)
    N, T = 4, 7
    logp = (rng.standard_normal((N, T)) * 0.3 - 1.5).astype(np.float32)
    behaviour = (logp + rng.standard_normal((N, T)) * 0.4).astype(np.float32)
    adv = rng.standard_normal(N).astype(np.float32)
    mask = (rng.random((N, T)) > 0.3).astype(np.float32)
    ent = rng.random((N, T)).astype(np.float32)
    kw = dict(KW, loss_agg=loss_agg, entropy_coef=0.02)

    def f_jax(lp):
        return jgrpo.grpo_loss(lp, *map(jnp.asarray, (behaviour, adv, mask)),
                               entropy=jnp.asarray(ent), **kw)

    (loss_r, m_r), g_r = jax.value_and_grad(f_jax, has_aux=True)(
        jnp.asarray(logp))
    t = torch.tensor(logp, requires_grad=True)
    loss, m = tgrpo.grpo_loss(t, *map(torch.tensor, (behaviour, adv, mask)),
                              entropy=torch.tensor(ent), **kw)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_r),
                               atol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(g_r), atol=1e-6)
    assert set(m) == set(m_r)
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(m_r[k]), atol=1e-5,
                                   err_msg=k)


def test_adamw_and_schedule_match_reference():
    """Two AdamW steps with weight decay and global-norm clipping, in place,
    against repro.optim.adam; warmup_constant against the JAX schedule."""
    from repro.optim import adam as jadam
    from repro.optim import schedule as jschedule
    rng = np.random.default_rng(5)
    p = {"a": rng.standard_normal((3, 4)).astype(np.float32),
         "b": [rng.standard_normal(5).astype(np.float32)]}
    gs = [{"a": rng.standard_normal((3, 4)).astype(np.float32) * 3,
           "b": [rng.standard_normal(5).astype(np.float32)]}
          for _ in range(2)]
    kw = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01, grad_clip=1.0)
    jp, js = jax.tree.map(jnp.asarray, p), jadam.init(jax.tree.map(
        jnp.asarray, p))
    tp = {"a": torch.tensor(p["a"]), "b": [torch.tensor(p["b"][0])]}
    ts = tadam.init(tp)
    for i, g in enumerate(gs):
        lr_j = jschedule.warmup_constant(jnp.asarray(i, jnp.float32),
                                         lr=1e-2, warmup_steps=3)
        lr_t = tschedule.warmup_constant(i, lr=1e-2, warmup_steps=3)
        np.testing.assert_allclose(lr_t, float(lr_j), rtol=1e-6)
        jp, js, jm = jadam.update(jax.tree.map(jnp.asarray, g), js, jp,
                                  lr=lr_j, **kw)
        tg = {"a": torch.tensor(g["a"]), "b": [torch.tensor(g["b"][0])]}
        tp2, ts, tm = tadam.update(tg, ts, tp, lr=lr_t, **kw)
        assert tp2 is tp                               # updated in place
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(tp["a"].numpy(), np.asarray(jp["a"]),
                               atol=1e-6)
    np.testing.assert_allclose(tp["b"][0].numpy(), np.asarray(jp["b"][0]),
                               atol=1e-6)
    np.testing.assert_allclose(ts["v"]["a"].numpy(),
                               np.asarray(js["v"]["a"]), rtol=1e-5)
    assert int(ts["step"]) == int(js["step"]) == 2
