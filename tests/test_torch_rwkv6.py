"""The port's WKV6 recurrence and RWKV6 time-mix / channel-mix on the CPU,
against the JAX package:

* ``wkv6_plain`` (the plain version of ``csrc/wkv6.cu``) against
  ``repro.models.rwkv6.wkv6_scan`` and against the Pallas kernel
  ``repro.kernels.rwkv6_scan.ops.wkv6`` in interpret mode, on
  ``tests/test_kernels.py``'s ``test_wkv6`` cases, plus T = 1 (decode),
  streaming in two halves, ``seq_mask`` and bfloat16 inputs;
* ``apply_time_mix`` and ``apply_channel_mix`` on weights converted from
  the JAX init.

Tolerances: float32 atol 1e-4 (sums over hd in another order); bfloat16
outputs within two bf16 ulps of each element (both sides compute in
float32 and round once).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.kernels.rwkv6_scan import ops as wkv_ops  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.hopper import rwkv6_scan  # noqa: E402
from repro_torch.models import rwkv6  # noqa: E402

torch.set_num_threads(1)
ARCH = "rwkv6-1.6b"


def assert_within_bf16_ulps(got, want, n=2):
    """|got - want| <= n bf16 ulps of each element of ``want`` (float32
    arrays holding bf16 values)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    mag = np.maximum(np.abs(want), np.float32(2.0 ** -126))
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    bad = np.abs(got - want) > n * ulp
    assert not bad.any(), (np.abs(got - want)[bad].max(), bad.sum())


def _inputs(B, S, H, hd, seed, *, s0_scale=0.2):
    rng = np.random.default_rng(seed)
    f = np.float32
    r, k, v = ((rng.standard_normal((B, S, H, hd)) * 0.5).astype(f)
               for _ in range(3))
    w = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, H, hd)))) * 0.5
         + 0.45).astype(f)
    u = (rng.standard_normal((H, hd)) * 0.3).astype(f)
    s0 = (rng.standard_normal((B, H, hd, hd)) * s0_scale).astype(f)
    return r, k, v, w, u, s0


def _torch(arrs, dtype=torch.float32):
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in arrs)
    return r.to(dtype), k.to(dtype), v.to(dtype), w.to(dtype), u, s0


# tests/test_kernels.py's test_wkv6 cases (B, S, H, hd, chunk), then decode
CASES = [(2, 64, 4, 32, 16), (1, 100, 2, 64, 32), (2, 33, 3, 16, 128),
         (4, 1, 2, 64, 8)]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_wkv6_matches_reference_and_pallas(case):
    B, S, H, hd, chunk = case
    arrs = _inputs(B, S, H, hd, seed=S)
    y, sf = rwkv6_scan.wkv6_plain(*_torch(arrs))
    jin = [jnp.asarray(a) for a in arrs]
    y_ref, sf_ref = jrwkv.wkv6_scan(*jin)
    y_pl, sf_pl = wkv_ops.wkv6(*jin, chunk=chunk, interpret=True)
    for want, got in ((y_ref, y), (sf_ref, sf), (y_pl, y), (sf_pl, sf)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)


def test_plain_wkv6_state_streaming():
    """Two half-sequences with the state carried between them equal one
    run over the whole sequence (test_wkv6_state_streaming's shape)."""
    r, k, v, w, u, s0 = _torch(_inputs(1, 40, 2, 32, seed=4, s0_scale=0.0))
    y, sf = rwkv6_scan.wkv6_plain(r, k, v, w, u, s0)
    y1, s1 = rwkv6_scan.wkv6_plain(r[:, :20], k[:, :20], v[:, :20],
                                   w[:, :20], u, s0)
    y2, s2 = rwkv6_scan.wkv6_plain(r[:, 20:], k[:, 20:], v[:, 20:],
                                   w[:, 20:], u, s1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(s2.numpy(), sf.numpy(), atol=1e-4)


def test_plain_wkv6_seq_mask_freezes_state():
    arrs = _inputs(3, 20, 2, 32, seed=6)
    lens = np.array([20, 7, 1])
    mask = np.arange(20)[None, :] < lens[:, None]
    tin = _torch(arrs)
    y, sf = rwkv6_scan.wkv6_plain(*tin, seq_mask=torch.from_numpy(mask))
    y_ref, sf_ref = jrwkv.wkv6_scan(*[jnp.asarray(a) for a in arrs],
                                    seq_mask=jnp.asarray(mask))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-4)
    np.testing.assert_allclose(sf.numpy(), np.asarray(sf_ref), atol=1e-4)
    r, k, v, w, u, s0 = tin
    for b, n in enumerate(lens):
        _, s_b = rwkv6_scan.wkv6_plain(r[b:b + 1, :n], k[b:b + 1, :n],
                                       v[b:b + 1, :n], w[b:b + 1, :n], u,
                                       s0[b:b + 1])
        np.testing.assert_allclose(sf[b:b + 1].numpy(), s_b.numpy(),
                                   atol=1e-6)


@pytest.mark.parametrize("S", [1, 37])
def test_plain_wkv6_bf16_inputs(S):
    tin = _torch(_inputs(2, S, 4, 64, seed=12), torch.bfloat16)
    y, sf = rwkv6_scan.wkv6_plain(*tin)
    assert y.dtype == torch.bfloat16 and sf.dtype == torch.float32
    jin = [jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)
        for t in tin]
    y_ref, sf_ref = jrwkv.wkv6_scan(*jin)
    assert_within_bf16_ulps(y.float().numpy(),
                            np.asarray(y_ref.astype(jnp.float32)))
    np.testing.assert_allclose(sf.numpy(), np.asarray(sf_ref), atol=1e-4)


def test_wrapper_takes_the_plain_version_on_cpu():
    tin = _torch(_inputs(2, 5, 2, 32, seed=2))
    n0 = rwkv6_scan.wkv6.launches
    y, sf = rwkv6_scan.wkv6(*tin)
    yp, sp = rwkv6_scan.wkv6_plain(*tin)
    assert torch.equal(y, yp) and torch.equal(sf, sp)
    assert rwkv6_scan.wkv6.launches == n0
    with pytest.raises(ValueError):
        rwkv6_scan.wkv6(*tin[:4], tin[4][:1], tin[5])


@pytest.fixture(scope="module")
def block_params():
    jcfg = jget_smoke(ARCH)
    tree = jax.device_get(JM.init_params(jax.random.PRNGKey(1), jcfg))
    jp = jax.tree.map(lambda a: a[0], tree["stack"]["body"][0])
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jp, tp


@pytest.mark.parametrize("mode", ["full", "padded", "decode"])
def test_apply_time_mix_matches_reference(block_params, mode):
    cfg, jcfg = get_smoke_config(ARCH), jget_smoke(ARCH)
    jp, tp = block_params
    rng = np.random.default_rng(9)
    B, S, d = 3, 1 if mode == "decode" else 11, cfg.d_model
    H, hd = d // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    x = (rng.standard_normal((B, S, d)) * 0.5).astype(np.float32)
    prev = (rng.standard_normal((B, d)) * 0.5).astype(np.float32)
    st = (rng.standard_normal((B, H, hd, hd)) * 0.1).astype(np.float32)
    kw, jkw = {}, {}
    if mode == "padded":
        mask = np.arange(S)[None, :] < np.array([11, 5, 1])[:, None]
        kw = dict(seq_mask=torch.from_numpy(mask))
        jkw = dict(seq_mask=jnp.asarray(mask))
    y, p, s = rwkv6.apply_time_mix(tp["tm"], cfg, torch.from_numpy(x),
                                   torch.from_numpy(prev),
                                   torch.from_numpy(st), **kw)
    y_ref, p_ref, s_ref = jrwkv.apply_time_mix(
        jp["tm"], jcfg, jnp.asarray(x), jnp.asarray(prev), jnp.asarray(st),
        **jkw)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-4)
    np.testing.assert_array_equal(p.numpy(), np.asarray(p_ref))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=1e-4)


@pytest.mark.parametrize("S", [1, 9])
def test_apply_channel_mix_matches_reference(block_params, S):
    cfg, jcfg = get_smoke_config(ARCH), jget_smoke(ARCH)
    jp, tp = block_params
    rng = np.random.default_rng(10)
    x = (rng.standard_normal((2, S, cfg.d_model)) * 0.5).astype(np.float32)
    prev = (rng.standard_normal((2, cfg.d_model)) * 0.5).astype(np.float32)
    y, p = rwkv6.apply_channel_mix(tp["cm"], cfg, torch.from_numpy(x),
                                   torch.from_numpy(prev))
    y_ref, p_ref = jrwkv.apply_channel_mix(jp["cm"], jcfg, jnp.asarray(x),
                                           jnp.asarray(prev))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-4)
    np.testing.assert_array_equal(p.numpy(), np.asarray(p_ref))
