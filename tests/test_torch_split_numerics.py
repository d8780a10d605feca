"""The numerics of the kernels redesigned for the H100, emulated in plain
PyTorch on the CPU and held against the JAX package.

* Decode attention split over the cache length (csrc/decode_common.cuh,
  shared by the dense and the paged kernel): each row's positions are cut
  into chunks of C = 128 at fixed positions; a chunk reduces to a float32
  partial (max, sum of exponentials, unnormalised output) per query head,
  and the partials are merged in chunk order. Held against
  ``repro.models.attention.decode_attention`` at the card's tolerances,
  float32 atol 1e-4 and bfloat16 atol 2e-2 (the reference rounds its
  probabilities to bf16 before P V; the kernel keeps them in float32). The
  chunk boundaries depend on the position only, so the emulation gives the
  same bits from the dense cache and from page pools of any page size
  holding the same K/V.
* The loss backward's dh on the tensor cores (csrc/split_gemm.cuh): w (the
  float32 master unembedding) and dl enter bf16 products as two terms, hi =
  bf16(x) and mid = bf16(x - hi); the logits are h w_hi + h w_mid (h is
  bf16, exact) and dh = dl_hi w_hi + dl_hi w_mid + dl_mid w_hi, every
  product exact in float32 and summed in float32. Held against ``jax.grad``
  of ``repro.kernels.fused_is_grpo.ref.is_grpo_reference`` at the train
  shape's d = 2048 and V = 128256 on four rows, at the card's tolerance:
  the largest error within 1e-4 of the largest element of dh. The two
  terms give 8e-6 (softcap 0) and 1.1e-5 (softcap 30); a single bf16 pass
  (w and dl rounded to bf16 once) gives 2.4e-3 and 4.0e-3 and misses it.
  The card's f32 sums are not IEEE inside the tensor cores: they truncate,
  and carried over V / 16 = 8016 steps they drift past that tolerance; the
  kernel therefore adds each 64-deep k tile's products to its sums with an
  f32 add, which this emulation's float32 sums stand for.
* The forwards' kernel 1 on the tensor cores (IS-GRPO and the fused
  log-prob): the logits are h w_hi + h w_mid, the same two terms as the
  backward's (one device function computes both, so the backward's
  p = exp(logit - lse) sees the logits of the lse the forward saved). On the
  same four rows, logp, lse and entropy against ``is_grpo_reference`` (lse
  from the logsumexp of its float32 logits): 3.8e-6 at softcap 0 and 30,
  inside the card's atol of 1e-4; one bf16 rounding of w gives 3.2e-3 and
  misses it.
* dw = h^T dl on the tensor cores: dl (the float32 scratch) as two bf16
  terms, h exact, over K = R = 4064 rows, against float64 on a 1024-column
  slice of the vocabulary (dw's columns are independent): 5.8e-6 (softcap
  0) and 4.6e-6 (30) of the largest element, inside 1e-4; one rounding of
  dl gives 2.0e-3 and 1.7e-3. The kernel promotes each 64-deep k tile into
  float32 sums, as bwd_dh does.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.fused_is_grpo.ref import is_grpo_reference  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.hopper import decode_attn as tda  # noqa: E402
from repro_torch.hopper import fused_is_grpo as tfio  # noqa: E402

torch.set_num_threads(1)
C = tda.DECODE_CHUNK
ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
RTOL_OF_MAX = 1e-4
FWD_ATOL = 1e-4


# -- decode attention split over the cache length ------------------------------


def emulate_split_decode(q, fetch, lens, L, *, window=0, cap=0.0):
    """q (B, 1, H, hd); ``fetch(b, pos)`` returns the K and V rows (n, KV,
    hd) of row b at positions pos. Each chunk of C positions inside [lo,
    len) gives a float32 partial per query head; the partials merge in
    chunk order. Returns (B, 1, H, hd) in q's dtype."""
    B, _, H, hd = q.shape
    scale = hd ** -0.5
    out = torch.zeros(B, 1, H, hd)
    for b in range(B):
        n = min(int(lens[b]), L)
        lo = max(0, n - window) if window > 0 else 0
        qb = q[b, 0].float()                                    # (H, hd)
        parts = []
        for c in range(lo // C, (n - 1) // C + 1):
            pos = torch.arange(max(lo, c * C), min(n, (c + 1) * C))
            k, v = (x.float() for x in fetch(b, pos))           # (n, KV, hd)
            KV = k.shape[1]
            kh = k.repeat_interleave(H // KV, dim=1)            # (n, H, hd)
            vh = v.repeat_interleave(H // KV, dim=1)
            s = torch.einsum("hd,nhd->hn", qb, kh) * scale
            if cap > 0:
                s = torch.tanh(s / cap) * cap
            m = s.amax(-1)
            p = torch.exp(s - m[:, None])
            parts.append((m, p.sum(-1), torch.einsum("hn,nhd->hd", p, vh)))
        mm = torch.stack([m for m, _, _ in parts]).amax(0)
        den = torch.zeros(H)
        acc = torch.zeros(H, hd)
        for m, l, a in parts:
            w = torch.exp(m - mm)
            den = den + l * w
            acc = acc + a * w[:, None]
        out[b, 0] = acc / den.clamp_min(1e-30)[:, None]
    return out.to(q.dtype)


def _decode_inputs(B, L, H, KV, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(dtype) for s in ((B, 1, H, hd), (B, L, KV, hd),
                                    (B, L, KV, hd)))
    return q, k, v


def _jax_decode(q, k, v, lens, window, cap):
    args = [jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)
        for t in (q, k, v)]
    out = jattn.decode_attention(*args, jnp.asarray(lens.numpy()),
                                 window=window, attn_softcap=cap)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


def _pages(k, v, lens, ps, seed):
    """The dense caches as page pools at random physical pages, with the
    sentinel NP past each row's length; returns (k_pool, v_pool, table)."""
    B, L, KV, hd = k.shape
    mp = L // ps
    NP = B * mp
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(NP))
    kp = torch.zeros(NP, ps, KV, hd, dtype=k.dtype)
    vp = torch.zeros_like(kp)
    kp[perm] = k.reshape(NP, ps, KV, hd)
    vp[perm] = v.reshape(NP, ps, KV, hd)
    bt = perm.reshape(B, mp)
    unmapped = torch.arange(mp)[None, :] * ps >= lens[:, None]
    return kp, vp, torch.where(unmapped, NP, bt)


# lengths on both sides of chunk boundaries, and the whole cache
L_CACHE = 4 * C + 32                      # a whole number of 8, 16, 32 pages
LENS = [1, C - 1, C, C + 1, 2 * C + 1, L_CACHE]
# B, H, KV, hd, window, softcap: REP 4 and 5, a window crossing a boundary
DECODE_CASES = [(len(LENS), 8, 2, 64, 0, 0.0),
                (len(LENS), 10, 2, 64, 0, 30.0),
                (len(LENS), 5, 1, 64, C + 10, 0.0),
                (len(LENS), 8, 2, 32, 50, 30.0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,KV,hd,window,cap", DECODE_CASES)
def test_split_decode_vs_jax(dtype, B, H, KV, hd, window, cap):
    q, k, v = _decode_inputs(B, L_CACHE, H, KV, hd, dtype, seed=H + hd)
    lens = torch.tensor(LENS, dtype=torch.int32)
    got = emulate_split_decode(q, lambda b, p: (k[b, p], v[b, p]), lens,
                               L_CACHE, window=window, cap=cap)
    ref = _jax_decode(q, k, v, lens, window, cap)
    assert float((got.float() - ref).abs().max()) <= ATOL[dtype]
    # the port's plain version (the kernel's CPU path) agrees too
    plain = tda.decode_attention(q, k, v, lens, window=window,
                                 attn_softcap=cap)
    assert float((got.float() - plain.float()).abs().max()) <= ATOL[dtype]


@pytest.mark.parametrize("ps", [8, 16, 32])
def test_split_decode_paged_equals_dense_bits(ps):
    """Pages of 8, 16 or 32 at random physical pages give the dense
    layout's bits: the chunk partials depend on positions, not on where a
    position's row lives."""
    B, H, KV, hd, window, cap = len(LENS), 10, 2, 64, C + 10, 0.0
    q, k, v = _decode_inputs(B, L_CACHE, H, KV, hd, torch.bfloat16, seed=5)
    lens = torch.tensor(LENS, dtype=torch.int32)
    kp, vp, bt = _pages(k, v, lens, ps, seed=ps)

    def paged(b, pos):
        rows = bt[b, pos // ps] * ps + pos % ps
        return (kp.reshape(-1, KV, hd)[rows], vp.reshape(-1, KV, hd)[rows])

    dense = emulate_split_decode(q, lambda b, p: (k[b, p], v[b, p]), lens,
                                 L_CACHE, window=window, cap=cap)
    got = emulate_split_decode(q, paged, lens, L_CACHE, window=window,
                               cap=cap)
    assert torch.equal(got, dense)


# -- the loss backward's dh from split bf16 terms -----------------------------


def _bf16(x):
    return x.to(torch.bfloat16).float()


def emulate_split_dh(h, w, targets, lse, ebar, a, e, *, cap, terms,
                     vocab_block=8192):
    """dh of the bwd_dh kernels: w (d, V) float32 and dl in ``terms`` bf16
    terms (2: hi + mid, as the kernels; 1: one rounding), float32 sums."""
    R, d = h.shape
    dh = torch.zeros(R, d)
    for v0 in range(0, w.shape[1], vocab_block):
        blk = w[:, v0:v0 + vocab_block]
        hi = _bf16(blk)
        mid = _bf16(blk - hi)
        x = h @ hi + (h @ mid if terms == 2 else 0.0)
        x = tfio._softcap(x, cap)
        ids = v0 + torch.arange(blk.shape[1])
        dl = tfio._dlogits(x, ids, targets, lse, ebar, a, e, cap)
        dl_hi = _bf16(dl)
        dh += dl_hi @ hi.T
        if terms == 2:
            dh += dl_hi @ mid.T + _bf16(dl - dl_hi) @ hi.T
    return dh


@pytest.fixture(scope="module")
def train_shape_loss():
    """Four rows at the train shape: hidden (4, 2048) bf16 values, the tied
    float32 embedding (128256, 2048) * 0.02 as w = embed.T, per-row
    coefficients a (of logp) and e (of entropy), row 0 all zero."""
    R, d, V = 4, 2048, 128256
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((V, d), dtype=np.float32)
    emb *= 0.02
    h = _bf16(torch.from_numpy(rng.standard_normal((R, d), dtype=np.float32)))
    t = torch.from_numpy(rng.integers(0, V, R))
    a = torch.from_numpy(rng.standard_normal(R).astype(np.float32))
    e = torch.from_numpy(rng.standard_normal(R).astype(np.float32) * 0.1)
    a[0] = e[0] = 0.0
    return dict(emb=emb, h=h, t=t, a=a, e=e, refs={})


def _jax_w(case):
    """The embedding as JAX's (d, V) w, made once for the module."""
    if "wj" not in case:
        case["wj"] = jnp.asarray(case["emb"].T)
    return case["wj"]


def _jax_dh(case, cap):
    """jax.grad of sum(a logp + e entropy) through the unfused reference:
    the dh that dl = a (onehot - p) - e p (logit - E[logit]) gives."""
    if cap not in case["refs"]:
        h, t, a, e = case["h"], case["t"], case["a"], case["e"]
        R = h.shape[0]
        wj = _jax_w(case)
        zeros = jnp.zeros((1, R))

        def f(hh):
            _, _, lp, en = is_grpo_reference(
                hh[None], wj, jnp.asarray(t.numpy())[None], zeros, zeros,
                logit_softcap=cap)
            return (jnp.asarray(a.numpy()) * lp[0]).sum() \
                + (jnp.asarray(e.numpy()) * en[0]).sum()

        case["refs"][cap] = torch.from_numpy(
            np.array(jax.grad(f)(jnp.asarray(h.numpy()))))
    return case["refs"][cap]


@pytest.mark.parametrize("cap", [0.0, 30.0])
@pytest.mark.parametrize("terms,meets", [(2, True), (1, False)],
                         ids=["two_bf16_terms", "one_bf16_pass"])
def test_split_dh_at_the_train_shape(train_shape_loss, cap, terms, meets):
    """The kernels' two terms meet 1e-4 of the largest dh element against
    JAX at d = 2048, V = 128256; one bf16 pass misses it by 20x or more.
    A row with a = e = 0 gives exactly zero."""
    case = train_shape_loss
    h, t, a, e = case["h"], case["t"], case["a"], case["e"]
    w = torch.from_numpy(case["emb"]).T
    _, lse, ent = tfio.stats_plain(h, w, t, logit_softcap=cap)
    got = emulate_split_dh(h, w, t, lse, lse - ent, a, e, cap=cap,
                           terms=terms)
    ref = _jax_dh(case, cap)
    err = float((got - ref).abs().max() / ref.abs().max())
    assert (err <= RTOL_OF_MAX) == meets, err
    if not meets:
        assert err >= 20 * RTOL_OF_MAX, err
    assert torch.count_nonzero(got[0]) == 0


# -- the forwards' logits from split bf16 terms -------------------------------


def split_logits(h, w, *, terms, vocab_block=8192):
    """The raw logits (before the softcap) of the forward's kernel 1 and of
    bwd_dl_tc: h (bf16 values) times w as ``terms`` bf16 terms (2: hi +
    mid, as the kernels; 1: one rounding), float32 sums."""
    out = []
    for v0 in range(0, w.shape[1], vocab_block):
        blk = w[:, v0:v0 + vocab_block]
        hi = _bf16(blk)
        x = h @ hi
        if terms == 2:
            x = x + h @ _bf16(blk - hi)
        out.append(x)
    return torch.cat(out, 1)


def _stats(x, targets):
    """(logp, lse, entropy) of rows of logits x: what the forward's running
    statistics and their merge compute."""
    lse = torch.logsumexp(x, -1)
    p = torch.exp(x - lse[:, None])
    logp = x.gather(1, targets[:, None].long())[:, 0] - lse
    return logp, lse, lse - (p * x).sum(-1)


def _jax_stats(case, cap):
    """(logp, lse, entropy) of the unfused reference: logp and entropy from
    ``is_grpo_reference``, lse from the logsumexp of the same float32
    logits."""
    key = ("stats", cap)
    if key not in case["refs"]:
        h, t = case["h"], case["t"]
        R = h.shape[0]
        wj = _jax_w(case)
        hj = jnp.asarray(h.numpy())[None]
        zeros = jnp.zeros((1, R))
        _, _, lp, en = is_grpo_reference(hj, wj, jnp.asarray(t.numpy())[None],
                                         zeros, zeros, logit_softcap=cap)
        x = jnp.einsum("bsd,dv->bsv", hj, wj,
                       preferred_element_type=jnp.float32)
        if cap > 0:
            x = jnp.tanh(x / cap) * cap
        lse = jax.nn.logsumexp(x, axis=-1)
        case["refs"][key] = [torch.from_numpy(np.array(v[0]))
                             for v in (lp, lse, en)]
    return case["refs"][key]


@pytest.mark.parametrize("cap", [0.0, 30.0])
@pytest.mark.parametrize("terms,meets", [(2, True), (1, False)],
                         ids=["two_bf16_terms", "one_bf16_pass"])
def test_split_forward_at_the_train_shape(train_shape_loss, cap, terms,
                                          meets):
    """The forwards' two-term logits give logp, lse and entropy within atol
    1e-4 of JAX at d = 2048, V = 128256; one rounding of w misses it."""
    case = train_shape_loss
    key = ("logits", terms)
    if key not in case:
        case[key] = split_logits(case["h"], torch.from_numpy(case["emb"]).T,
                                 terms=terms)
    got = _stats(tfio._softcap(case[key], cap), case["t"])
    ref = _jax_stats(case, cap)
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    assert (err <= FWD_ATOL) == meets, err
    if not meets:
        assert err >= 5 * FWD_ATOL, err


# -- dw from split bf16 terms ---------------------------------------------------


@pytest.fixture(scope="module")
def train_shape_dl(train_shape_loss):
    """dw's inputs at the train shape's K = R = 4064 rows: hidden (4064,
    2048) bf16 values and dl from ``_dlogits`` on a 1024-column slice of the
    vocabulary (dw's columns are independent of one another). lse and
    E[logit] of each row are the slice's, shifted by log(V / 1024) for lse,
    so p has its full-vocabulary size; targets are drawn over the whole
    vocabulary, so a few rows hit the slice; a quarter of the rows have a
    = e = 0."""
    R, V, n = 4064, 128256, 1024
    rng = np.random.default_rng(4)
    emb = train_shape_loss["emb"]
    h = _bf16(torch.from_numpy(rng.standard_normal((R, emb.shape[1]),
                                                   dtype=np.float32)))
    w = torch.from_numpy(emb[:n]).T
    t = torch.from_numpy(rng.integers(0, V, R))
    a = torch.from_numpy(rng.standard_normal(R).astype(np.float32))
    e = torch.from_numpy(rng.standard_normal(R).astype(np.float32) * 0.1)
    a[:R // 4] = e[:R // 4] = 0.0
    raw = h @ w
    dls = {}
    for cap in (0.0, 30.0):
        x = tfio._softcap(raw, cap)
        lse = torch.logsumexp(x, -1)
        ebar = (torch.softmax(x, -1) * x).sum(-1)
        dls[cap] = tfio._dlogits(x, torch.arange(n), t,
                                 lse + float(np.log(V / n)), ebar, a, e, cap)
    return dict(h=h, dl=dls, zero_rows=R // 4)


@pytest.mark.parametrize("cap", [0.0, 30.0])
@pytest.mark.parametrize("terms,meets", [(2, True), (1, False)],
                         ids=["two_bf16_terms", "one_bf16_pass"])
def test_split_dw_at_the_train_shape(train_shape_dl, cap, terms, meets):
    """bwd_dw_tc's dw = dl_hi^T h + dl_mid^T h (h exact in bf16), float32
    sums, within 1e-4 of the largest element of the float64 h^T dl over K =
    4064 rows; one rounding of dl misses it."""
    h, dl = train_shape_dl["h"], train_shape_dl["dl"][cap]
    hi = _bf16(dl)
    got = h.T @ hi
    if terms == 2:
        got = got + h.T @ _bf16(dl - hi)
    ref = h.double().T @ dl.double()
    err = float((got.double() - ref).abs().max() / ref.abs().max())
    assert (err <= RTOL_OF_MAX) == meets, err
    if not meets:
        assert err >= 5 * RTOL_OF_MAX, err
    # rows with a = e = 0 have dl = 0 exactly
    assert torch.count_nonzero(dl[:train_shape_dl["zero_rows"]]) == 0
