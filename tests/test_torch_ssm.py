"""The port's selective scan and SSM head (hymba) on the CPU, against the
JAX package:

* ``selective_scan_plain`` (the plain version of ``csrc/ssm_scan.cu``)
  against ``repro.models.ssm.selective_scan`` and against the Pallas kernel
  ``repro.kernels.ssm_scan.ops.selective_scan`` in interpret mode, on
  ``tests/test_kernels.py``'s three cases, plus T = 1 (decode), bfloat16
  inputs, a ``seq_mask`` case and a carried state;
* the kernels' split of a channel's states over lanes of 4 states, with
  their partial sums merged in xor-shuffle order, against the reference:
  the decode kernel's T = 1 step at hymba-1.5b's width, and the prefill
  kernel's T > 1 scan at the JAX kernel tests' cases (also against the
  Pallas kernel), with bfloat16 inputs and masked rows;
* ``causal_conv1d`` with and without ``lengths``;
* ``apply_ssm`` on weights converted from the JAX init;
* ``selective_scan_bwd_plain`` (the plain version of the backward kernel
  ``ssm_scan_bwd``) against ``jax.vjp`` of the reference, on the JAX kernel
  tests' cases, T = 1, bfloat16 inputs, decays down to 1e-8, a nonzero
  final-state cotangent, and T on both sides of the reference's chunk and
  the kernel's 8-step chunk; and the wrapper under autograd (the mask
  applied outside the autograd function) against ``jax.vjp`` with
  ``seq_mask``.

Tolerances: float32 atol 1e-4 (the sum over N runs in another order);
bfloat16 outputs within two bf16 ulps of each element (both sides compute
in float32 and round once). Gradients: float32 within 1e-4 of the largest
element of each, bfloat16 within two bf16 ulps of each element plus that.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.kernels.ssm_scan import ops as ssm_ops  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.hopper import ssm_scan  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

torch.set_num_threads(1)
ARCH = "hymba-1.5b"


def assert_within_bf16_ulps(got, want, n=2):
    """|got - want| <= n bf16 ulps of each element of ``want`` (float32
    arrays holding bf16 values)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    mag = np.maximum(np.abs(want), np.float32(2.0 ** -126))
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    bad = np.abs(got - want) > n * ulp
    assert not bad.any(), (np.abs(got - want)[bad].max(), bad.sum())


def _inputs(B, T, di, N, seed, *, s0_scale=0.0):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = (rng.standard_normal((B, T, di)) * 0.5).astype(f)
    dt = (np.log1p(np.exp(rng.standard_normal((B, T, di)))) * 0.1).astype(f)
    A_log = np.log(np.abs(rng.standard_normal((di, N))) + 0.5).astype(f)
    Bc = (rng.standard_normal((B, T, N)) * 0.5).astype(f)
    Cc = (rng.standard_normal((B, T, N)) * 0.5).astype(f)
    D = (rng.standard_normal(di) * 0.2).astype(f)
    s0 = (rng.standard_normal((B, di, N)) * s0_scale).astype(f)
    return x, dt, A_log, Bc, Cc, D, s0


def _torch(arrs, dtype=torch.float32):
    x, dt, A_log, Bc, Cc, D, s0 = (torch.from_numpy(a) for a in arrs)
    return (x.to(dtype), dt.to(dtype), A_log, Bc.to(dtype), Cc.to(dtype), D,
            s0)


# tests/test_kernels.py's cases (B, T, di, N, chunk), then decode (T = 1)
CASES = [(2, 64, 128, 16, 32), (1, 50, 64, 8, 16), (2, 33, 256, 16, 128),
         (3, 1, 128, 16, 8)]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_scan_matches_reference_and_pallas(case):
    B, T, di, N, chunk = case
    arrs = _inputs(B, T, di, N, seed=T)
    y, sf = ssm_scan.selective_scan_plain(*_torch(arrs))
    jin = [jnp.asarray(a) for a in arrs]
    y_ref, sf_ref = jssm.selective_scan(*jin)
    y_pl, sf_pl = ssm_ops.selective_scan(*jin, block_d=64, chunk=chunk,
                                         interpret=True)
    for want, got in ((y_ref, y), (sf_ref, sf), (y_pl, y), (sf_pl, sf)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)


def test_plain_scan_carried_state_streams():
    """A carried (non-zero) state, and two halves with the state carried
    between them, equal one run over the whole sequence."""
    arrs = _inputs(2, 40, 64, 16, seed=3, s0_scale=0.3)
    x, dt, A_log, Bc, Cc, D, s0 = _torch(arrs)
    y, sf = ssm_scan.selective_scan_plain(x, dt, A_log, Bc, Cc, D, s0)
    y_ref, sf_ref = jssm.selective_scan(*[jnp.asarray(a) for a in arrs])
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-4)
    np.testing.assert_allclose(sf.numpy(), np.asarray(sf_ref), atol=1e-4)
    y1, s1 = ssm_scan.selective_scan_plain(x[:, :17], dt[:, :17], A_log,
                                           Bc[:, :17], Cc[:, :17], D, s0)
    y2, s2 = ssm_scan.selective_scan_plain(x[:, 17:], dt[:, 17:], A_log,
                                           Bc[:, 17:], Cc[:, 17:], D, s1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(s2.numpy(), sf.numpy(), atol=1e-5)


def test_plain_scan_seq_mask_freezes_state():
    """Right-padded rows: the state after the pads equals the state at each
    row's last real token, and the reference agrees on every output."""
    arrs = _inputs(3, 24, 64, 16, seed=5, s0_scale=0.2)
    lens = np.array([24, 9, 1])
    mask = np.arange(24)[None, :] < lens[:, None]
    tin = _torch(arrs)
    y, sf = ssm_scan.selective_scan_plain(*tin,
                                          seq_mask=torch.from_numpy(mask))
    y_ref, sf_ref = jssm.selective_scan(*[jnp.asarray(a) for a in arrs],
                                        seq_mask=jnp.asarray(mask))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-4)
    np.testing.assert_allclose(sf.numpy(), np.asarray(sf_ref), atol=1e-4)
    x, dt, A_log, Bc, Cc, D, s0 = tin
    for b, n in enumerate(lens):
        _, s_b = ssm_scan.selective_scan_plain(
            x[b:b + 1, :n], dt[b:b + 1, :n], A_log, Bc[b:b + 1, :n],
            Cc[b:b + 1, :n], D, s0[b:b + 1])
        np.testing.assert_allclose(sf[b:b + 1].numpy(), s_b.numpy(),
                                   atol=1e-6)


@pytest.mark.parametrize("T", [1, 37])
def test_plain_scan_bf16_inputs(T):
    """bfloat16 x, dt, B, C (the model's compute dtype): the output is
    bfloat16 within two ulps of the reference's, the state float32."""
    arrs = _inputs(2, T, 128, 16, seed=11, s0_scale=0.1)
    tin = _torch(arrs, torch.bfloat16)
    y, sf = ssm_scan.selective_scan_plain(*tin)
    assert y.dtype == torch.bfloat16 and sf.dtype == torch.float32
    jin = [jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)
        for t in tin]
    y_ref, sf_ref = jssm.selective_scan(*jin)
    assert_within_bf16_ulps(y.float().numpy(),
                            np.asarray(y_ref.astype(jnp.float32)))
    np.testing.assert_allclose(sf.numpy(), np.asarray(sf_ref), atol=1e-4)


def scan_lanes(x, dt, A_log, Bc, Cc, D, s0, lanes, seq_mask=None):
    """The CUDA kernels' order (csrc/ssm_scan.cu: ssm_step_kernel at T = 1,
    ssm_scan_kernel above) in torch: lane q of a channel owns states
    4q .. 4q + 3 and sums h * C over them in order; the lanes' partial sums
    merge by xor shuffles 1, then 2 (the second with 4 lanes only), plus
    D x. (The prefill kernel's exponential is one MUFU ex2 of a
    log2(e)-scaled argument, relative error ~2^-22; here torch.exp.)
    Returns y (B, T, di) in x's dtype and the final state."""
    B, T, di = x.shape
    xf, dtf = x.float(), dt.float()
    if seq_mask is not None:                   # as the wrapper masks
        dtf = dtf * seq_mask[..., None].float()
    negA = -torch.exp(A_log)
    h = s0.float()
    ys = []
    for t in range(T):
        xt, dtt = xf[:, t], dtf[:, t]                             # (B, di)
        h = torch.exp(negA[None] * dtt[..., None]) * h \
            + (dtt * xt)[..., None] * Bc[:, t].float()[:, None, :]
        p = (h * Cc[:, t].float()[:, None, :]).view(B, di, lanes, 4)
        part = ((p[..., 0] + p[..., 1]) + p[..., 2]) + p[..., 3]
        y = part[..., 0] + part[..., 1]                           # xor 1
        if lanes == 4:
            y = y + (part[..., 2] + part[..., 3])                 # xor 2
        ys.append(y + xt * D)
    return torch.stack(ys, dim=1).to(x.dtype), h


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [16, 8])
def test_decode_lane_split_matches_reference(N, dtype):
    """The 4-state lane split of the T = 1 step at hymba-1.5b's width (16
    rows, d_inner 3200), against repro.models.ssm.selective_scan: float32
    atol 1e-4; bfloat16 inputs within two bf16 ulps plus 1e-4, the state
    within 1e-4 of its largest element."""
    arrs = _inputs(16, 1, 3200, N, seed=N, s0_scale=0.2)
    dt_t = getattr(torch, dtype)
    tin = _torch(arrs, dt_t)
    y, sf = scan_lanes(*tin, lanes=N // 4)
    jin = [jnp.asarray(t.float().numpy()) for t in tin]
    y_ref, sf_ref = jssm.selective_scan(*jin)
    y_ref = np.asarray(y_ref)
    if dtype == "float32":
        np.testing.assert_allclose(y.numpy(), y_ref, atol=1e-4, rtol=0)
        np.testing.assert_allclose(sf.numpy(), np.asarray(sf_ref), atol=1e-4,
                                   rtol=0)
    else:
        want = y_ref.astype(jnp.bfloat16).astype(np.float32)
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want),
                                                  2.0 ** -126))) - 7)
        assert (np.abs(y.float().numpy() - want) <= 2 * ulp + 1e-4).all()
        np.testing.assert_allclose(
            sf.numpy(), np.asarray(sf_ref), rtol=0,
            atol=1e-4 * float(np.abs(np.asarray(sf_ref)).max()))


@pytest.mark.parametrize("case", CASES[:3], ids=str)
def test_prefill_lane_split_matches_reference_and_pallas(case):
    """The prefill kernel's lane split over T > 1 steps, float32 at the JAX
    kernel tests' cases: within atol 1e-4 of
    repro.models.ssm.selective_scan and of the Pallas kernel in interpret
    mode."""
    B, T, di, N, chunk = case
    arrs = _inputs(B, T, di, N, seed=T + 1, s0_scale=0.2)
    y, sf = scan_lanes(*_torch(arrs), lanes=N // 4)
    jin = [jnp.asarray(a) for a in arrs]
    y_ref, sf_ref = jssm.selective_scan(*jin)
    y_pl, sf_pl = ssm_ops.selective_scan(*jin, block_d=64, chunk=chunk,
                                         interpret=True)
    for want, got in ((y_ref, y), (sf_ref, sf), (y_pl, y), (sf_pl, sf)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)


@pytest.mark.parametrize("N,masked", [(16, False), (8, False), (16, True)])
def test_prefill_lane_split_bf16_and_masked(N, masked):
    """bfloat16 x, dt, B, C over 37 steps: y within two bf16 ulps of the
    reference's, the float32 state within 1e-4; masked rows (dt = 0 over
    the pads) against the reference's seq_mask."""
    T = 37
    arrs = _inputs(3, T, 128, N, seed=40 + N, s0_scale=0.2)
    tin = _torch(arrs, torch.bfloat16)
    jin = [jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)
        for t in tin]
    kw, jkw = {}, {}
    if masked:
        mask = np.arange(T)[None, :] < np.array([T, 12, 1])[:, None]
        kw = dict(seq_mask=torch.from_numpy(mask))
        jkw = dict(seq_mask=jnp.asarray(mask))
    y, sf = scan_lanes(*tin, lanes=N // 4, **kw)
    y_ref, sf_ref = jssm.selective_scan(*jin, **jkw)
    assert y.dtype == torch.bfloat16
    assert_within_bf16_ulps(y.float().numpy(),
                            np.asarray(y_ref.astype(jnp.float32)))
    np.testing.assert_allclose(sf.numpy(), np.asarray(sf_ref), atol=1e-4,
                               rtol=0)


def test_wrapper_takes_the_plain_version_on_cpu():
    tin = _torch(_inputs(2, 5, 64, 8, seed=2, s0_scale=0.2))
    n0 = ssm_scan.selective_scan.launches
    y, sf = ssm_scan.selective_scan(*tin)
    yp, sp = ssm_scan.selective_scan_plain(*tin)
    assert torch.equal(y, yp) and torch.equal(sf, sp)
    assert ssm_scan.selective_scan.launches == n0
    with pytest.raises(ValueError):
        ssm_scan.selective_scan(*tin[:6], tin[6][:, :, :4])


@pytest.mark.parametrize("with_lengths", [False, True])
def test_causal_conv1d_matches_reference(with_lengths):
    rng = np.random.default_rng(7)
    B, S, di, K = 3, 10, 32, 4
    x = rng.standard_normal((B, S, di)).astype(np.float32)
    w = rng.standard_normal((K, di)).astype(np.float32)
    b = rng.standard_normal(di).astype(np.float32)
    st = rng.standard_normal((B, K - 1, di)).astype(np.float32)
    lens = np.array([10, 4, 1], np.int32) if with_lengths else None
    y, ns = ssm.causal_conv1d(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        torch.from_numpy(st),
        lengths=None if lens is None else torch.from_numpy(lens))
    y_ref, ns_ref = jssm.causal_conv1d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), jnp.asarray(st),
        lengths=None if lens is None else jnp.asarray(lens))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-5)
    np.testing.assert_array_equal(ns.numpy(), np.asarray(ns_ref))
    if with_lengths:           # the tail ends at row 1's 4th input
        np.testing.assert_array_equal(ns[1].numpy(), x[1, 1:4])


@pytest.fixture(scope="module")
def ssm_params():
    jcfg = jget_smoke(ARCH)
    tree = jax.device_get(JM.init_params(jax.random.PRNGKey(1), jcfg))
    layer = jax.tree.map(lambda a: a[0], tree["stack"]["body"][0])
    jp = layer["ssm"]
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jp, tp


@pytest.mark.parametrize("mode", ["full", "padded", "decode"])
def test_apply_ssm_matches_reference(ssm_params, mode):
    """The SSM head on converted weights: a plain sequence, right-padded
    rows (seq_mask and lengths, as prefill passes them), and one decode
    step from a carried state and conv tail."""
    cfg, jcfg = get_smoke_config(ARCH), jget_smoke(ARCH)
    jp, tp = ssm_params
    rng = np.random.default_rng(8)
    B, S = 3, 1 if mode == "decode" else 14
    di, N, K = ssm.d_inner_of(cfg), cfg.ssm.state_dim, cfg.ssm.conv_dim
    x = (rng.standard_normal((B, S, cfg.d_model)) * 0.5).astype(np.float32)
    kw, jkw = {}, {}
    st = cs = jst = jcs = None
    if mode == "padded":
        lens = np.array([14, 6, 1], np.int32)
        mask = np.arange(S)[None, :] < lens[:, None]
        kw = dict(lengths=torch.from_numpy(lens),
                  seq_mask=torch.from_numpy(mask))
        jkw = dict(lengths=jnp.asarray(lens), seq_mask=jnp.asarray(mask))
    if mode == "decode":
        s0 = (rng.standard_normal((B, di, N)) * 0.2).astype(np.float32)
        c0 = (rng.standard_normal((B, K - 1, di)) * 0.5).astype(np.float32)
        st, cs = torch.from_numpy(s0), torch.from_numpy(c0)
        jst, jcs = jnp.asarray(s0), jnp.asarray(c0)
    y, s, c = ssm.apply_ssm(tp, cfg, torch.from_numpy(x), st, cs, **kw)
    y_ref, s_ref, c_ref = jssm.apply_ssm(jp, jcfg, jnp.asarray(x), jst, jcs,
                                         **jkw)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=1e-4)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), atol=1e-5)


# -- the backward ----------------------------------------------------------------


def _vjp_ref(arrs, dy, dsf, **kw):
    """jax.vjp of repro.models.ssm.selective_scan at ``arrs``: every
    input's cotangent, as float32 numpy arrays."""
    (_, _), vjp = jax.vjp(lambda *a: jssm.selective_scan(*a, **kw), *arrs)
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


# (B, T, di, N, the reference's chunk): the JAX kernel tests' cases, decode,
# T on both sides of the kernel's 8-step chunk, and T a multiple of the
# reference's chunk (its chunked, checkpointed branch)
BWD_CASES = CASES + [(2, 7, 64, 16, 256), (2, 9, 32, 8, 256),
                     (2, 64, 64, 16, 16)]


@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_plain_backward_matches_jax_vjp(case):
    """Every input's gradient, the initial state's included, with a nonzero
    cotangent of the final state."""
    B, T, di, N, chunk = case
    arrs = _inputs(B, T, di, N, seed=100 + T, s0_scale=0.2)
    rng = np.random.default_rng(T)
    dy = rng.standard_normal((B, T, di)).astype(np.float32)
    dsf = rng.standard_normal((B, di, N)).astype(np.float32)
    got = ssm_scan.selective_scan_bwd_plain(*_torch(arrs),
                                            torch.from_numpy(dy),
                                            torch.from_numpy(dsf))
    want = _vjp_ref([jnp.asarray(a) for a in arrs], jnp.asarray(dy),
                    jnp.asarray(dsf), chunk=chunk)
    _grads_agree(got, want)


@pytest.mark.parametrize("T", [1, 37])
def test_plain_backward_bf16_inputs(T):
    """bfloat16 x, dt, B, C and y's cotangent: their gradients bfloat16,
    A_log's, D's and the state's float32, against jax.vjp on the same
    bfloat16 inputs; a zero final-state cotangent."""
    arrs = _inputs(2, T, 128, 16, seed=11, s0_scale=0.1)
    tin = _torch(arrs, torch.bfloat16)
    rng = np.random.default_rng(3)
    dy = torch.from_numpy(rng.standard_normal((2, T, 128)).astype(
        np.float32)).to(torch.bfloat16)
    got = ssm_scan.selective_scan_bwd_plain(*tin, dy)
    assert [g.dtype for g in got] == [t.dtype for t in tin]
    jin = [jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)
        for t in tin]
    want = _vjp_ref(jin, jnp.asarray(dy.float().numpy()).astype(jnp.bfloat16),
                    jnp.zeros((2, 128, 16), jnp.float32))
    _grads_agree(got, want)


@pytest.mark.parametrize("T", [1, 23])
def test_plain_backward_strong_decay(T):
    """The model's A_log = log(1..N) and steps up to 1.2: decays down to
    exp(-16 * 1.2) ~ 5e-9; the states are kept from the forward pass, never
    recovered by dividing by a decay."""
    B, di, N = 2, 64, 16
    x, _, _, Bc, Cc, D, s0 = _inputs(B, T, di, N, seed=7, s0_scale=0.3)
    rng = np.random.default_rng(8)
    dt = rng.uniform(0.0, 1.2, (B, T, di)).astype(np.float32)
    A_log = np.log(np.arange(1, N + 1, dtype=np.float32))[None].repeat(di, 0)
    arrs = (x, dt, A_log, Bc, Cc, D, s0)
    decay = np.exp(-np.exp(A_log)[None, None] * dt[..., None])
    assert decay.min() < 1e-8
    dy = rng.standard_normal((B, T, di)).astype(np.float32)
    dsf = rng.standard_normal((B, di, N)).astype(np.float32)
    got = ssm_scan.selective_scan_bwd_plain(*_torch(arrs),
                                            torch.from_numpy(dy),
                                            torch.from_numpy(dsf))
    want = _vjp_ref([jnp.asarray(a) for a in arrs], jnp.asarray(dy),
                    jnp.asarray(dsf))
    _grads_agree(got, want)


def test_wrapper_under_autograd_matches_jax_vjp():
    """``selective_scan`` with grad on (the autograd function: plain forward
    and plain backward on the CPU) on right-padded rows: the mask applied
    to dt outside, against jax.vjp with seq_mask; the initial state is left
    as it was."""
    B, T, di, N = 3, 21, 64, 16
    arrs = _inputs(B, T, di, N, seed=13, s0_scale=0.2)
    mask = np.arange(T)[None, :] < np.array([T, 9, 1])[:, None]
    rng = np.random.default_rng(14)
    dy = rng.standard_normal((B, T, di)).astype(np.float32)
    dsf = rng.standard_normal((B, di, N)).astype(np.float32)
    tin = [t.clone().requires_grad_() for t in _torch(arrs)]
    s_before = tin[6].detach().clone()
    n0 = ssm_scan.selective_scan.bwd_launches
    y, sf = ssm_scan.selective_scan(*tin, seq_mask=torch.from_numpy(mask))
    torch.autograd.backward((y, sf), (torch.from_numpy(dy),
                                      torch.from_numpy(dsf)))
    assert torch.equal(tin[6].detach(), s_before)
    assert ssm_scan.selective_scan.bwd_launches == n0      # no kernel here
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


def _in_order(x, dim):
    """A sum along ``dim`` in index order."""
    x = x.movedim(dim, 0)
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc


def selective_scan_bwd_split(x, dt, A_log, Bc, Cc, D, state, dy,
                             dstate=None, *, K=8, threads=160):
    """The schedule of the backward kernel ``ssm_scan_bwd``
    (csrc/ssm_scan.cu) in torch, float32. The state at every boundary of K
    steps comes from a forward pass; each chunk's states h_t and decays a_t
    are recomputed from its boundary and kept, and the reverse walk reads
    a_t (no exponential of its own). Lane q of a channel owns states
    4q .. 4q + 3 (L = N / 4 lanes a channel); G.B and the sum of gA over
    them in order, merged over the channel's lanes by xor shuffles 1, then
    2. dB_t, dC_t: over the block's channels (``threads`` / L) in channel
    order, then the blocks in order. dA_log and dD: each row over the
    steps in reverse, then the rows in order. Returns what
    selective_scan_bwd_plain returns, float32."""
    xf, dtf, Bf, Cf, dyf = (a.float() for a in (x, dt, Bc, Cc, dy))
    Bn, T, di = x.shape
    N = A_log.shape[-1]
    L = N // 4
    CB = threads // L                             # channels a block
    nblk = -(-di // CB)
    pad = nblk * CB - di
    negA = -torch.exp(A_log.float())
    nchk = -(-T // K)

    def step(h, t):
        a = torch.exp(negA[None] * dtf[:, t, :, None])
        return a * h + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :], a

    h = state.float()
    bounds = [h]
    for t in range((nchk - 1) * K):
        h, _ = step(h, t)
        if (t + 1) % K == 0:
            bounds.append(h)

    def lanes(v):                      # (B, di, N) -> (B, di): lanes in order
        part = _in_order(v.view(Bn, di, L, 4), -1)
        return _butterfly(part, [1, 2][:L.bit_length() - 1])[..., 0]

    def over_channels(v):              # (B, di, N) -> (B, N)
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        return _in_order(_in_order(v.view(Bn, nblk, CB, N), 2), 1)

    g = torch.zeros_like(h) if dstate is None else dstate.float().clone()
    dx, ddt = torch.empty(Bn, T, di), torch.empty(Bn, T, di)
    dB, dC = torch.empty(Bn, T, N), torch.empty(Bn, T, N)
    dA = torch.zeros(Bn, di, N)
    dD = torch.zeros(Bn, di)
    for c in reversed(range(nchk)):
        t0 = c * K
        nt = min(K, T - t0)
        hs, as_ = [bounds[c]], []
        for s in range(nt):
            hn, a = step(hs[-1], t0 + s)
            hs.append(hn)
            as_.append(a)
        for s in reversed(range(nt)):
            t = t0 + s
            G = g + dyf[:, t, :, None] * Cf[:, t, None, :]
            dC[:, t] = over_channels(hs[s + 1] * dyf[:, t, :, None])
            dB[:, t] = over_channels(G * (dtf[:, t] * xf[:, t])[..., None])
            gb = lanes(G * Bf[:, t, None, :])
            gA = G * hs[s] * as_[s] * negA[None]
            dx[:, t] = dtf[:, t] * gb + D.float() * dyf[:, t]
            ddt[:, t] = xf[:, t] * gb + lanes(gA)
            dA = dA + gA * dtf[:, t, :, None]
            dD = dD + dyf[:, t] * xf[:, t]
            g = as_[s] * G
    return (dx, ddt, _in_order(dA, 0), dB, dC, _in_order(dD, 0), g)


@pytest.mark.parametrize("N,threads,K", [(16, 160, 8), (8, 160, 8),
                                         (16, 320, 8), (16, 96, 8),
                                         (16, 160, 4)],
                         ids=str)
def test_bwd_schedule_matches_jax_vjp(N, threads, K):
    """The backward kernel's schedule (the kernel's: 160 threads a block,
    boundaries every 8 steps; and the variants chip_variants.py times)
    against jax.vjp of repro.models.ssm.selective_scan, float32 within 1e-4
    of each gradient's largest element, with a nonzero final-state
    cotangent: T = 1, inside one chunk and over a partial last chunk,
    channels over several blocks with a tail."""
    for B, T, di in ((2, 1, 96), (2, K - 1, 64), (2, 2 * K + 3, 200)):
        arrs = _inputs(B, T, di, N, seed=500 + T + N, s0_scale=0.2)
        rng = np.random.default_rng(T + threads)
        dy = rng.standard_normal((B, T, di)).astype(np.float32)
        dsf = rng.standard_normal((B, di, N)).astype(np.float32)
        got = selective_scan_bwd_split(*_torch(arrs), torch.from_numpy(dy),
                                       torch.from_numpy(dsf), K=K,
                                       threads=threads)
        want = _vjp_ref([jnp.asarray(a) for a in arrs], jnp.asarray(dy),
                        jnp.asarray(dsf))
        _grads_agree(got, want)


@pytest.mark.parametrize("case", CASES[:3], ids=str)
def test_bwd_schedule_kernel_cases(case):
    """The kernel's schedule at the JAX kernel tests' cases, against
    jax.vjp (with the reference's chunk) and the plain backward."""
    B, T, di, N, chunk = case
    arrs = _inputs(B, T, di, N, seed=600 + T, s0_scale=0.2)
    rng = np.random.default_rng(T + 1)
    dy = rng.standard_normal((B, T, di)).astype(np.float32)
    dsf = rng.standard_normal((B, di, N)).astype(np.float32)
    tin = _torch(arrs)
    got = selective_scan_bwd_split(*tin, torch.from_numpy(dy),
                                   torch.from_numpy(dsf))
    want = _vjp_ref([jnp.asarray(a) for a in arrs], jnp.asarray(dy),
                    jnp.asarray(dsf), chunk=chunk)
    _grads_agree(got, want)
    plain = ssm_scan.selective_scan_bwd_plain(*tin, torch.from_numpy(dy),
                                              torch.from_numpy(dsf))
    _grads_agree(got, [p.numpy() for p in plain])


@pytest.mark.parametrize("T", [9, 23])
def test_bwd_schedule_strong_decay(T):
    """The model's A_log = log(1..N) and steps up to 1.2 (decays down to
    ~5e-9): the kernel's schedule within 1e-4 of each gradient's largest
    element of jax.vjp's; the states come from the boundaries, never from
    dividing by a decay."""
    B, di, N = 2, 64, 16
    x, _, _, Bc, Cc, D, s0 = _inputs(B, T, di, N, seed=17, s0_scale=0.3)
    rng = np.random.default_rng(18)
    dt = rng.uniform(0.0, 1.2, (B, T, di)).astype(np.float32)
    A_log = np.log(np.arange(1, N + 1, dtype=np.float32))[None].repeat(di, 0)
    arrs = (x, dt, A_log, Bc, Cc, D, s0)
    assert np.exp(-np.exp(A_log)[None, None] * dt[..., None]).min() < 1e-8
    dy = rng.standard_normal((B, T, di)).astype(np.float32)
    dsf = rng.standard_normal((B, di, N)).astype(np.float32)
    got = selective_scan_bwd_split(*_torch(arrs), torch.from_numpy(dy),
                                   torch.from_numpy(dsf))
    want = _vjp_ref([jnp.asarray(a) for a in arrs], jnp.asarray(dy),
                    jnp.asarray(dsf))
    _grads_agree(got, want)
