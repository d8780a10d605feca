"""The rounding points of the tensor-core flash kernels (csrc/flash_attn.cu,
csrc/flash_attn_bwd.cu), emulated in plain PyTorch on the CPU and held
against the JAX ``chunked_attention`` and ``jax.vjp`` of it.

The kernels take bf16 inputs, multiply and sum in float32, and round:

* forward: P = exp(s - m) to bf16 once before P V, per 64-key tile of the
  online softmax (its row sum in float32), O / l to bf16 at the end;
* backward: P and dS = P (dP - D) passed to their products as two bf16
  terms, hi = bf16(x) and lo = bf16(x - hi); dq, dk, dv to bf16 at the end.

The emulation repeats those steps; the reference runs in float32 on the
same bf16 values and rounds its result to bf16, as the plain versions do.
Tolerances are the card's, unchanged: forward atol 2e-2, logsumexp 1e-4,
backward 5e-2. At the train shape a single bf16 rounding of P and dS, as
SDPA does, misses the backward's atol (one bf16 ulp, 0.0625, of a dv in
[8, 16)); the two terms meet it. The cases at head_dim 128 and 256 run
there too; their backward also admits one bf16 ulp of the element where
that exceeds 5e-2 (the card's check at those head sizes does the same).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import attention as jattn  # noqa: E402

torch.set_num_threads(1)
BF16 = torch.bfloat16
TILE = 64
FWD_ATOL, LSE_ATOL, BWD_ATOL = 2e-2, 1e-4, 5e-2


def _bf16(x):
    return x.to(BF16).float()


def _two_terms(x):
    hi = _bf16(x)
    return hi + _bf16(x - hi)


def _mask(S, causal, window):
    pos = torch.arange(S)
    ok = torch.ones(S, S, dtype=torch.bool)
    if causal:
        ok &= pos[None, :] <= pos[:, None]
    if window > 0:
        ok &= (pos[:, None] - pos[None, :]) < window
    return ok                                               # (q, k)


def _scores(q, k, scale, cap):
    """Raw scores (B, KV, R, q, k) and the softcapped ones, float32."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    raw = torch.einsum("bqgrd,bkgd->bgrqk", qg, k) * scale
    return raw, (torch.tanh(raw / cap) * cap if cap > 0 else raw)


def emulate_fwd(q, k, v, *, causal, window, cap):
    """q, k, v float32 holding bf16 values. Returns (out bf16-valued, lse)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    _, s = _scores(q, k, hd ** -0.5, cap)
    s = torch.where(_mask(S, causal, window), s, -torch.inf)
    m = torch.full(s.shape[:-1], -1e30)
    l = torch.zeros(s.shape[:-1])
    acc = torch.zeros(*s.shape[:-1], hd)
    for k0 in range(0, S, TILE):
        st = s[..., k0:k0 + TILE]
        m_new = torch.maximum(m, st.amax(-1))
        p = torch.exp(st - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bgrqk,bkgd->bgrqd", _bf16(p), v[:, k0:k0 + TILE])
        m = m_new
    denom = l.clamp_min(1e-30)
    out = (acc / denom[..., None]).permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)
    return _bf16(out), (m + torch.log(denom)).reshape(B, H, S)


def emulate_bwd(q, k, v, out, lse, dout, *, causal, window, cap,
                terms=_two_terms):
    """Gradients (dq, dk, dv), bf16-valued; ``terms`` is how P and dS reach
    their products."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    R = H // KV
    scale = hd ** -0.5
    raw, s = _scores(q, k, scale, cap)
    L = lse.reshape(B, KV, R, S)[..., None]
    p = torch.where(_mask(S, causal, window), torch.exp(s - L), 0.0)
    dog = dout.reshape(B, S, KV, R, hd)
    D = (dout * out).sum(-1).reshape(B, S, KV, R).permute(0, 2, 3, 1)
    D = D[..., None]
    ds = p * (torch.einsum("bqgrd,bkgd->bgrqk", dog, v) - D)
    if cap > 0:
        ds = ds * (1 - torch.tanh(raw / cap) ** 2)
    p2, ds2 = terms(p), terms(ds)
    qg = q.reshape(B, S, KV, R, hd)
    dq = torch.einsum("bgrqk,bkgd->bqgrd", ds2, k).reshape(B, S, H, hd)
    dk = torch.einsum("bgrqk,bqgrd->bkgd", ds2, qg)
    dv = torch.einsum("bgrqk,bqgrd->bkgd", p2, dog)
    return _bf16(dq * scale), _bf16(dk * scale), _bf16(dv)


def _inputs(B, S, H, KV, hd, seed, grad=False):
    rng = np.random.default_rng(seed)
    shapes = [(B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)]
    if grad:
        shapes.append((B, S, H, hd))
    return [_bf16(torch.from_numpy(rng.standard_normal(sh).astype(np.float32)))
            for sh in shapes]


def _jax_fwd(q, k, v, causal, window, cap):
    def f(q_, k_, v_):
        return jattn.chunked_attention(q_, k_, v_, causal=causal,
                                       window=window, attn_softcap=cap)
    return f, [jnp.asarray(t.numpy()) for t in (q, k, v)]


# the cuda tests' bf16 shapes: B, S, H, KV, hd, window, softcap
FWD_CASES = [
    (2, 128, 8, 2, 64, 0, 0.0),
    (1, 100, 4, 4, 64, 0, 0.0),
    (2, 192, 8, 2, 64, 48, 0.0),
    (1, 64, 4, 2, 32, 0, 30.0),
    (2, 150, 8, 2, 64, 0, 0.0),
    # head_dim 128 at REP 7 and 48, 256 with a window and a softcap
    (2, 150, 14, 2, 128, 0, 0.0),
    (1, 130, 4, 2, 256, 40, 50.0),
    (1, 70, 48, 1, 128, 0, 0.0),
]
BWD_CASES = [
    (2, 127, 8, 2, 64, 0, 0.0),
    (1, 100, 4, 4, 64, 40, 0.0),
    (2, 70, 4, 1, 32, 0, 20.0),
    (2, 127, 14, 2, 128, 0, 0.0),
    (1, 130, 4, 2, 256, 40, 50.0),
    (1, 100, 48, 1, 128, 0, 0.0),
]


@pytest.mark.parametrize("B,S,H,KV,hd,window,cap", FWD_CASES)
def test_forward_rounding_vs_jax(B, S, H, KV, hd, window, cap):
    q, k, v = _inputs(B, S, H, KV, hd, seed=S)
    out, lse = emulate_fwd(q, k, v, causal=True, window=window, cap=cap)
    f, args = _jax_fwd(q, k, v, True, window, cap)
    ref = _bf16(torch.from_numpy(np.array(f(*args))))
    assert float((out - ref).abs().max()) <= FWD_ATOL
    # the logsumexp from float32 scores, against the float32 definition
    _, s = _scores(q, k, hd ** -0.5, cap)
    s = torch.where(_mask(S, True, window), s, -torch.inf)
    ref_lse = torch.logsumexp(s, -1).reshape(B, H, S)
    assert float((lse - ref_lse).abs().max()) <= LSE_ATOL


def _bwd_pair(B, S, H, KV, hd, window, cap, terms, seed):
    """(emulated gradients, JAX's rounded to bf16)."""
    q, k, v, do = _inputs(B, S, H, KV, hd, seed=seed, grad=True)
    f, args = _jax_fwd(q, k, v, True, window, cap)
    out_r, vjp = jax.vjp(f, *args)
    ref = [_bf16(torch.from_numpy(np.array(g)))
           for g in vjp(jnp.asarray(do.numpy()))]
    # the kernels read the forward's bf16 output and its logsumexp
    out, lse = emulate_fwd(q, k, v, causal=True, window=window, cap=cap)
    got = emulate_bwd(q, k, v, out, lse, do, causal=True, window=window,
                      cap=cap, terms=terms)
    return got, ref


def _bwd_vs_jax(B, S, H, KV, hd, window, cap, terms, seed):
    got, ref = _bwd_pair(B, S, H, KV, hd, window, cap, terms, seed)
    return [float((a - b).abs().max()) for a, b in zip(got, ref)]


def _ulp(x):
    """One bf16 ulp of each element of x."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
                      - 7)


@pytest.mark.parametrize("B,S,H,KV,hd,window,cap", BWD_CASES)
def test_backward_rounding_vs_jax(B, S, H, KV, hd, window, cap):
    """atol 5e-2; at head_dim 128 and 256 also one bf16 ulp of the reference
    element where that is larger: dk and dv sum REP x S terms and reach
    [8, 16), where one ulp is 0.0625, and float32 sums that agree to ~1e-5
    may round to neighbouring bf16 values (REP 48: dk one ulp apart)."""
    got, ref = _bwd_pair(B, S, H, KV, hd, window, cap, _two_terms, seed=S)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        tol = _ulp(b).clamp_min(BWD_ATOL) if hd >= 128 \
            else torch.full_like(b, BWD_ATOL)
        excess = float(((a - b).abs() - tol).max())
        assert excess <= 0.0, (name, excess, float((a - b).abs().max()))


@pytest.mark.parametrize("terms,meets", [(_two_terms, True), (_bf16, False)],
                         ids=["two_bf16_terms", "one_bf16_term"])
def test_backward_rounding_at_the_train_shape(terms, meets):
    """The train phase's packed batch, (32, 127, 32/8, 64): the kernels' two
    terms meet atol 5e-2; one bf16 rounding of P and dS does not."""
    errs = _bwd_vs_jax(32, 127, 32, 8, 64, 0, 0.0, terms, seed=14)
    assert (max(errs) <= BWD_ATOL) == meets, errs
