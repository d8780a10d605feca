"""The port's WKV6 recurrence and RWKV6 time-mix / channel-mix on the CPU,
against the JAX package:

* ``wkv6_plain`` (the plain version of ``csrc/wkv6.cu``) against
  ``repro.models.rwkv6.wkv6_scan`` and against the Pallas kernel
  ``repro.kernels.rwkv6_scan.ops.wkv6`` in interpret mode, on
  ``tests/test_kernels.py``'s ``test_wkv6`` cases, plus T = 1 (decode),
  streaming in two halves, ``seq_mask`` and bfloat16 inputs;
* the CUDA kernels' summation order (``csrc/wkv6.cu``: the state cut into
  row slices, y merged by xor shuffles and then in warp order, Q by one
  warp), emulated for the decode kernel's tiles and the prefill kernel's,
  against the reference and the Pallas kernel, with strong decay too;
* ``apply_time_mix`` and ``apply_channel_mix`` on weights converted from
  the JAX init;
* ``wkv6_bwd_plain`` (the plain version of the backward kernel
  ``wkv6_bwd``) against ``jax.vjp`` of the reference, on the JAX kernel
  tests' cases, T = 1, T on both sides of the kernel's 3-step chunk,
  bfloat16 inputs, decays down to 1e-8 and a nonzero final-state
  cotangent; and the wrapper under autograd (the mask applied outside the
  autograd function) against ``jax.vjp`` with ``seq_mask``.

Tolerances: float32 atol 1e-4 (sums over hd in another order); bfloat16
outputs within two bf16 ulps of each element (both sides compute in
float32 and round once). Gradients: float32 within 1e-4 of the largest
element of each, bfloat16 within two bf16 ulps of each element plus that.
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


def wkv6_split(r, k, v, w, u, state, *, rows, per_warp, seq_mask=None):
    """The CUDA kernels' order (csrc/wkv6.cu) in torch. A lane owns
    ``rows`` consecutive rows of S (and some columns); a warp holds
    ``per_warp`` consecutive row slices, the warps of a head follow down
    the rows. Per step, y's row sum: each slice sums its rows in order, the
    slices of a warp merge by xor shuffles (lowest slice bit first), the
    warps add up in order; Q = sum_i r u k is summed by one warp, lane l
    over rows l and l + 32, merged by xor shuffles 16, 8, 4, 2, 1;
    y = P + v Q. Both kernels give a lane 4 columns, so a slice spans hd / 4
    lanes and a warp holds 32 / (hd / 4) slices; the decode kernel's lane
    owns rows hd / 16, the prefill kernel's hd / 8. Returns y in r's dtype
    and the final state."""
    out_dt = r.dtype
    r, k, v, w = (a.float() for a in (r, k, v, w))
    if seq_mask is not None:                   # as the wrapper masks
        m = seq_mask[:, :, None, None].float()
        k = k * m
        w = w * m + (1.0 - m)
    B, T, H, hd = r.shape
    warps = hd // rows // per_warp
    lanes = torch.arange(32)
    s = state.float()
    ys = []
    for t in range(T):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]   # (B, H, hd)
        prod = (rt[..., :, None] * s).view(B, H, hd // rows, rows, hd)
        p = prod[:, :, :, 0]
        for m in range(1, rows):
            p = p + prod[:, :, :, m]
        p = p.view(B, H, warps, per_warp, hd)
        off = 1
        while off < per_warp:
            p = p + p[:, :, :, torch.arange(per_warp) ^ off]
            off *= 2
        acc = p[:, :, 0, 0]
        for x in range(1, warps):
            acc = acc + p[:, :, x, 0]
        ruk = rt * kt * u.float()
        q = torch.zeros(B, H, 32)
        q[..., :min(hd, 32)] = ruk[..., :32]
        if hd > 32:
            q = q + ruk[..., 32:]
        for off in (16, 8, 4, 2, 1):
            q = q + q[..., lanes ^ off]
        ys.append(acc + vt * q[..., :1])
        s = wt[..., :, None] * s + kt[..., :, None] * vt[..., None, :]
    return torch.stack(ys, dim=1).to(out_dt), s


def _tiles(kernel, hd):
    return dict(rows=hd // 16 if kernel == "decode" else hd // 8,
                per_warp=32 // (hd // 4))


# the decode kernel runs at T = 1 only; the prefill kernel at any T
SPLIT_CASES = [("decode", (4, 1, 2, 64, 8)), ("decode", (3, 1, 2, 32, 8)),
               ("decode", (2, 1, 3, 16, 8)), ("prefill", (4, 1, 2, 64, 8))] \
    + [("prefill", c) for c in CASES[:3]]


@pytest.mark.parametrize("kernel,case", SPLIT_CASES, ids=str)
def test_kernel_order_matches_reference_and_pallas(kernel, case):
    """float32 at the JAX kernel tests' cases (and T = 1 at every hd):
    within atol 1e-4 of repro.models.rwkv6.wkv6_scan and of the Pallas
    kernel in interpret mode."""
    B, S, H, hd, chunk = case
    arrs = _inputs(B, S, H, hd, seed=S + hd)
    y, sf = wkv6_split(*_torch(arrs), **_tiles(kernel, hd))
    jin = [jnp.asarray(a) for a in arrs]
    y_ref, sf_ref = jrwkv.wkv6_scan(*jin)
    y_pl, sf_pl = wkv_ops.wkv6(*jin, chunk=chunk, interpret=True)
    for want, got in ((y_ref, y), (sf_ref, sf), (y_pl, y), (sf_pl, sf)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)


@pytest.mark.parametrize("kernel,S", [("decode", 1), ("prefill", 1),
                                      ("prefill", 37)])
def test_kernel_order_bf16_inputs(kernel, S):
    """bfloat16 r, k, v, w at rwkv6-1.6b's head_dim: y within two bf16
    ulps of the reference's, the float32 state within 1e-4."""
    tin = _torch(_inputs(2, S, 4, 64, seed=13), torch.bfloat16)
    y, sf = wkv6_split(*tin, **_tiles(kernel, 64))
    jin = [jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)
        for t in tin]
    y_ref, sf_ref = jrwkv.wkv6_scan(*jin)
    assert_within_bf16_ulps(y.float().numpy(),
                            np.asarray(y_ref.astype(jnp.float32)))
    np.testing.assert_allclose(sf.numpy(), np.asarray(sf_ref), atol=1e-4)


@pytest.mark.parametrize("kernel,S", [("decode", 1), ("prefill", 45)])
def test_kernel_order_strong_decay(kernel, S):
    """Decays down to 1e-8 (exp(-exp(x)) at x = 2.9), as the model's decay
    can give: float32 within atol 1e-4 of the reference and of the Pallas
    kernel, and masked rows (the state frozen across the pads)."""
    B, H, hd = 3, 2, 64
    arrs = list(_inputs(B, S, H, hd, seed=21))
    rng = np.random.default_rng(22)
    arrs[3] = np.exp(-np.exp(rng.uniform(-1.0, 2.9, arrs[3].shape))
                     ).astype(np.float32)
    assert arrs[3].min() < 1e-7
    lens = np.array([S, max(1, S // 3), 1])
    mask = np.arange(S)[None, :] < lens[:, None]
    y, sf = wkv6_split(*_torch(arrs), **_tiles(kernel, hd),
                       seq_mask=torch.from_numpy(mask))
    jin = [jnp.asarray(a) for a in arrs]
    y_ref, sf_ref = jrwkv.wkv6_scan(*jin, seq_mask=jnp.asarray(mask))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(sf.numpy(), np.asarray(sf_ref), atol=1e-4,
                               rtol=0)
    y_pl, sf_pl = wkv_ops.wkv6(*jin, chunk=16, interpret=True)
    y0, s0 = wkv6_split(*_torch(arrs), **_tiles(kernel, hd))
    np.testing.assert_allclose(y0.numpy(), np.asarray(y_pl), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(s0.numpy(), np.asarray(sf_pl), atol=1e-4,
                               rtol=0)


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


# -- the backward ----------------------------------------------------------------


def _vjp_ref(arrs, dy, dsf, **kw):
    """jax.vjp of repro.models.rwkv6.wkv6_scan at ``arrs``: every input's
    cotangent, as float32 numpy arrays."""
    (_, _), vjp = jax.vjp(lambda *a: jrwkv.wkv6_scan(*a, **kw), *arrs)
    return [np.asarray(g.astype(jnp.float32)) for g in vjp((dy, dsf))]


def _grads_agree(got, want):
    """float32 within 1e-4 of each gradient's largest element; bfloat16
    within two bf16 ulps of each element plus that."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        scale = float(np.abs(w).max())
        gf = g.float().numpy()
        if g.dtype == torch.bfloat16:
            mag = np.maximum(np.abs(w), np.float32(2.0 ** -126))
            ulp = np.exp2(np.floor(np.log2(mag)) - 7)
            assert (np.abs(gf - w) <= 2 * ulp + 1e-4 * scale).all()
        else:
            np.testing.assert_allclose(gf, w, rtol=0, atol=1e-4 * scale)


def _cotangents(B, S, H, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, H, hd, hd)).astype(np.float32))


# the JAX kernel tests' cases, decode, T on both sides of the kernel's
# 3-step chunk
BWD_CASES = CASES + [(2, 2, 2, 16, 0), (2, 3, 2, 32, 0), (2, 4, 2, 16, 0)]


@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_plain_backward_matches_jax_vjp(case):
    """Every input's gradient, the initial state's included, with a nonzero
    cotangent of the final state."""
    B, S, H, hd, _ = case
    arrs = _inputs(B, S, H, hd, seed=200 + S)
    dy, dsf = _cotangents(B, S, H, hd, seed=S)
    got = rwkv6_scan.wkv6_bwd_plain(*_torch(arrs), torch.from_numpy(dy),
                                    torch.from_numpy(dsf))
    want = _vjp_ref([jnp.asarray(a) for a in arrs], jnp.asarray(dy),
                    jnp.asarray(dsf))
    _grads_agree(got, want)


@pytest.mark.parametrize("S", [1, 37])
def test_plain_backward_bf16_inputs(S):
    """bfloat16 r, k, v, w and y's cotangent: their gradients bfloat16, u's
    and the state's float32, against jax.vjp on the same bfloat16 inputs; a
    zero final-state cotangent."""
    B, H, hd = 2, 4, 64
    tin = _torch(_inputs(B, S, H, hd, seed=12), torch.bfloat16)
    dy, _ = _cotangents(B, S, H, hd, seed=5)
    dyb = torch.from_numpy(dy).to(torch.bfloat16)
    got = rwkv6_scan.wkv6_bwd_plain(*tin, dyb)
    assert [g.dtype for g in got] == [t.dtype for t in tin]
    jin = [jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)
        for t in tin]
    want = _vjp_ref(jin, jnp.asarray(dy).astype(jnp.bfloat16),
                    jnp.zeros((B, H, hd, hd), jnp.float32))
    _grads_agree(got, want)


@pytest.mark.parametrize("S", [1, 30])
def test_plain_backward_strong_decay(S):
    """Decays down to 1e-8 (exp(-exp(x)) at x = 2.9): the states are kept
    from the forward pass, never recovered by dividing by a decay."""
    B, H, hd = 2, 2, 32
    arrs = list(_inputs(B, S, H, hd, seed=21))
    rng = np.random.default_rng(22)
    arrs[3] = np.exp(-np.exp(rng.uniform(-1.0, 2.9, arrs[3].shape))
                     ).astype(np.float32)
    assert arrs[3].min() < 1e-7
    dy, dsf = _cotangents(B, S, H, hd, seed=23)
    got = rwkv6_scan.wkv6_bwd_plain(*_torch(arrs), torch.from_numpy(dy),
                                    torch.from_numpy(dsf))
    want = _vjp_ref([jnp.asarray(a) for a in arrs], jnp.asarray(dy),
                    jnp.asarray(dsf))
    _grads_agree(got, want)


def test_wrapper_under_autograd_matches_jax_vjp():
    """``wkv6`` with grad on (the autograd function: plain forward and
    plain backward on the CPU) on right-padded rows: the mask applied to k
    and w outside, against jax.vjp with seq_mask; the initial state is left
    as it was."""
    B, S, H, hd = 3, 13, 2, 32
    arrs = _inputs(B, S, H, hd, seed=24)
    mask = np.arange(S)[None, :] < np.array([S, 5, 1])[:, None]
    dy, dsf = _cotangents(B, S, H, hd, seed=25)
    tin = [t.clone().requires_grad_() for t in _torch(arrs)]
    s_before = tin[5].detach().clone()
    n0 = rwkv6_scan.wkv6.bwd_launches
    y, sf = rwkv6_scan.wkv6(*tin, seq_mask=torch.from_numpy(mask))
    torch.autograd.backward((y, sf), (torch.from_numpy(dy),
                                      torch.from_numpy(dsf)))
    assert torch.equal(tin[5].detach(), s_before)
    assert rwkv6_scan.wkv6.bwd_launches == n0          # no kernel here
    want = _vjp_ref([jnp.asarray(a) for a in arrs], jnp.asarray(dy),
                    jnp.asarray(dsf), seq_mask=jnp.asarray(mask))
    _grads_agree([t.grad for t in tin], want)


# -- the backward kernel's schedule ------------------------------------------------


def _butterfly(x, offsets):
    """xor-shuffle sums over the last axis (lanes), in the order of
    ``offsets``: lane l adds lane l ^ o's value at each level."""
    idx = torch.arange(x.shape[-1])
    for o in offsets:
        x = x + x[..., idx ^ o]
    return x


def _seq_sum(x, dim):
    """A sum along ``dim`` in index order (a lane's own loop)."""
    x = x.movedim(dim, 0)
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc


def wkv6_bwd_split(r, k, v, w, u, state, dy, dstate=None, *, C, K):
    """The schedule of the backward kernel ``wkv6_bwd`` (csrc/wkv6.cu, C =
    1; with C > 1 the cluster design of variants/wkv6_bwd_cluster.cu) in
    torch, float32. The state at every boundary of K steps comes from the
    forward (the save kernel); each chunk's states are recomputed from its
    boundary and walked backwards. A head's hd columns split over C blocks
    of BC = hd / C columns; a lane owns RT = BC / 8 rows by 4 columns, so CG = 2 RT lanes
    span a row slice of the block and a warp holds 32 / CG slices. Row sums
    (dr, dk, dw): each lane sums its 4 columns in order, the slice's lanes
    merge by xor shuffles RT, RT / 2, .. 1 (row_scatter), rank 0 adds the u
    terms, the blocks' partials add up in rank order. dv: each lane sums
    its RT rows in order, the warp's slices merge by xor shuffles 16, 8
    lanes apart and then CG, 2 CG, .. 4 (col_scatter), the warps add up in
    warp order, + Q dy. Q and P: lane s + K p of a warp sums the p-th of
    32 / K shares of step s's elements in order, merged by xor shuffles K,
    2 K, .. 16. du: rank 0's lanes over the steps in reverse; the rows' du
    summed over the batch. Returns what wkv6_bwd_plain returns, float32."""
    rf, kf, vf, wf, dyf = (a.float() for a in (r, k, v, w, dy))
    uf = u.float()
    B, T, H, hd = r.shape
    BC = hd // C
    CG = BC // 4
    RT, RGW = CG // 2, 32 // CG
    NW = hd // (RT * RGW)
    LS = 32 // K
    nchk = -(-T // K)
    S = state.float()
    bounds = [S]
    for t in range((nchk - 1) * K):
        S = wf[:, t, :, :, None] * S + kf[:, t, :, :, None] * vf[:, t, :, None, :]
        if (t + 1) % K == 0:
            bounds.append(S)
    G = torch.zeros_like(S) if dstate is None else dstate.float().clone()
    dr, dk, dv, dw = (torch.empty(B, T, H, hd) for _ in range(4))
    du = torch.zeros(B, H, hd)

    def lanes_sum(x):                  # (B, H, hd) -> (B, H): Q or P
        part = _seq_sum(x.view(B, H, LS, hd // LS), -1)
        offsets = [1 << i for i in range(LS.bit_length() - 1)]
        return _butterfly(part, offsets)[..., 0]

    def row_sums(prod):                # sum_j prod[i, j]: per block, lanes
        lane = _seq_sum(prod.view(B, H, hd, C, CG, 4), -1)
        offsets = [RT >> i for i in range(RT.bit_length())]
        return _butterfly(lane, offsets)[..., 0]             # (B, H, hd, C)

    def rank_order(parts):
        acc = parts[..., 0]
        for q in range(1, C):
            acc = acc + parts[..., q]
        return acc

    for c in reversed(range(nchk)):
        t0 = c * K
        nt = min(K, T - t0)
        S = bounds[c]
        hist = []
        for s in range(nt):
            t = t0 + s
            hist.append(S)
            S = (wf[:, t, :, :, None] * S
                 + kf[:, t, :, :, None] * vf[:, t, :, None, :])
        for s in reversed(range(nt)):
            t = t0 + s
            rt, kt, vt, wt, dyt = (a[:, t] for a in (rf, kf, vf, wf, dyf))
            Q = lanes_sum(rt * kt * uf[None])
            P = lanes_sum(vt * dyt)
            pr = row_sums(hist[s] * dyt[..., None, :])
            pk = row_sums(G * vt[..., None, :])
            pw = row_sums(G * hist[s])
            pr[..., 0] = pr[..., 0] + uf[None] * kt * P[..., None]
            pk[..., 0] = pk[..., 0] + uf[None] * rt * P[..., None]
            dr[:, t], dk[:, t], dw[:, t] = (rank_order(p) for p in (pr, pk, pw))
            du = du + rt * kt * P[..., None]
            lane = _seq_sum((G * kt[..., None]).view(B, H, NW, RGW, RT, hd), -2)
            slice_offsets = [x // CG for x in (16, 8) if x >= CG] + \
                [1 << i for i in range(max(0, (8 // CG).bit_length() - 1))]
            col = _butterfly(lane.movedim(-1, -2), slice_offsets)[..., 0]
            dv[:, t] = _seq_sum(col, 2) + Q[..., None] * dyt
            G = wt[..., None] * G + rt[..., None] * dyt[..., None, :]
    return dr, dk, dv, dw, du.sum(0), G


# the kernel's configuration (C = 1, K = 8) at every hd, and the column
# splits and boundary intervals chip_variants.py times at hd 64
SCHEDULES = [(16, 1, 8), (32, 1, 8), (64, 1, 8), (64, 1, 4), (64, 1, 16),
             (64, 2, 4), (64, 2, 8), (64, 4, 8), (64, 4, 16), (32, 2, 16)]


@pytest.mark.parametrize("hd,C,K", SCHEDULES, ids=str)
def test_bwd_schedule_matches_jax_vjp(hd, C, K):
    """The backward kernel's schedule against jax.vjp of
    repro.models.rwkv6.wkv6_scan, float32 within 1e-4 of each gradient's
    largest element, with a nonzero final-state cotangent: T on both sides
    of the boundary interval (one chunk, a partial last chunk)."""
    for B, S, H in ((2, K - 1, 2), (2, 2 * K + 3, 3)):
        arrs = _inputs(B, S, H, hd, seed=300 + S + hd)
        dy, dsf = _cotangents(B, S, H, hd, seed=S + C)
        got = wkv6_bwd_split(*_torch(arrs), torch.from_numpy(dy),
                             torch.from_numpy(dsf), C=C, K=K)
        want = _vjp_ref([jnp.asarray(a) for a in arrs], jnp.asarray(dy),
                        jnp.asarray(dsf))
        _grads_agree(got, want)


@pytest.mark.parametrize("case", CASES[:3], ids=str)
def test_bwd_schedule_kernel_cases(case):
    """The kernel's configuration at the JAX kernel tests' cases, against
    jax.vjp and against the plain backward."""
    B, S, H, hd, _ = case
    arrs = _inputs(B, S, H, hd, seed=400 + S)
    dy, dsf = _cotangents(B, S, H, hd, seed=S + 1)
    got = wkv6_bwd_split(*_torch(arrs), torch.from_numpy(dy),
                         torch.from_numpy(dsf), C=1, K=8)
    want = _vjp_ref([jnp.asarray(a) for a in arrs], jnp.asarray(dy),
                    jnp.asarray(dsf))
    _grads_agree(got, want)
    plain = rwkv6_scan.wkv6_bwd_plain(*_torch(arrs), torch.from_numpy(dy),
                                      torch.from_numpy(dsf))
    _grads_agree(got, [p.numpy() for p in plain])


@pytest.mark.parametrize("S", [17, 45])
def test_bwd_schedule_strong_decay(S):
    """Decays down to 1e-8 at rwkv6-1.6b's head_dim, the kernel's
    configuration (one block a head, boundaries every 8 steps) and a
    cluster of 4 blocks: every gradient within 1e-4 of its largest element
    of jax.vjp's."""
    B, H, hd = 2, 2, 64
    arrs = list(_inputs(B, S, H, hd, seed=31))
    rng = np.random.default_rng(32)
    arrs[3] = np.exp(-np.exp(rng.uniform(-1.0, 2.9, arrs[3].shape))
                     ).astype(np.float32)
    assert arrs[3].min() < 1e-7
    dy, dsf = _cotangents(B, S, H, hd, seed=33)
    want = _vjp_ref([jnp.asarray(a) for a in arrs], jnp.asarray(dy),
                    jnp.asarray(dsf))
    for C, K in ((1, 8), (4, 16)):
        got = wkv6_bwd_split(*_torch(arrs), torch.from_numpy(dy),
                             torch.from_numpy(dsf), C=C, K=K)
        _grads_agree(got, want)
