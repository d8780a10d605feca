"""The cluster design of the sampling kernel (``csrc/fused_sample.cu``)
emulated in torch on the CPU, against the JAX package's sampler.

The emulation follows the kernel's arithmetic, with a row cut into C slices
of ceil(V / C) elements, one per block of a cluster:

* the tempered logits ``l = logits / T`` (an IEEE division, as the kernel's
  ``__fdiv_rn``) and their order-preserving uint32 keys;
* top-k: per-slice 256-bin count histograms of 8-bit radix digits, merged
  in rank order at each level; the pick is the highest bin whose count at
  or above it reaches the rank left;
* after level 1, when at most 64 elements of the row lie at or above the
  chosen 16-bit bin, those candidates are gathered and sorted: the top_k-th
  of them is the threshold, and top-p is taken over them (the smallest
  value whose strictly-higher 2^-40 mass is below top_p times the total);
  otherwise the radix levels go on, and top-p is a radix descent on
  per-slice 2^-40 fixed-point mass histograms merged in rank order;
* the draw: per slice, the (value, index) argmax of l + Gumbel over the kept
  elements (ties to the lower index) and the kept mass in 2^-40 units,
  merged in rank order; logp = (l_tok - max) - log(mass).

Its tokens must equal ``repro.sampling.sampler.sample_rows`` (the oracle)
and the port's plain version, at 1, 8 and 16 slices, a vocabulary that C
does not divide, and the six configurations the cuda tests run; logps
within atol 1e-4 (float32 log-softmax against a fixed-point sum).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.sampling import sampler as JS  # noqa: E402
from repro_torch.sampling import prng  # noqa: E402
from repro_torch.sampling import sampler as TS  # noqa: E402

torch.set_num_threads(1)

MASS_SCALE = 2.0 ** 40
GATHER = 64


def sortable(l):
    """float32 tensor -> int64 tensor of the kernel's uint32 keys."""
    s = l.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(s >> 31 == 1, s ^ 0xFFFFFFFF, s | 0x80000000)


def unsortable(key):
    s = key ^ 0x80000000 if key & 0x80000000 else ~key & 0xFFFFFFFF
    return float(np.array([s], np.uint32).view(np.float32)[0])


def masses(l, mx):
    """exp(l - mx) in 2^-40 units, rounded to nearest, as int64."""
    return torch.round(torch.exp(l - mx).double() * MASS_SCALE).to(torch.int64)


def merged(parts, bins_of, weights_of=None):
    """A level's 256-bin histogram: each slice's, added in rank order."""
    h = torch.zeros(256, dtype=torch.int64)
    for p in parts:
        b = bins_of(p)
        w = torch.ones_like(b) if weights_of is None else weights_of(p)
        h.index_add_(0, b, w)
    return h


def pick_count(h, rem):
    """The highest bin whose count at or above it reaches rem; the count
    above that bin."""
    suffix = torch.flip(torch.cumsum(torch.flip(h, [0]), 0), [0])
    b = int(torch.nonzero(suffix >= rem).max())
    return b, int(suffix[b] - h[b])


def pick_mass(h, above, target):
    """The lowest non-empty bin whose mass strictly above it, plus the mass
    above the prefix, is below the target."""
    strictly = torch.flip(torch.cumsum(torch.flip(h, [0]), 0), [0]) - h
    ok = [b for b in range(256)
          if h[b] > 0 and float(above + int(strictly[b])) < target]
    b = min(ok) if ok else 0
    return b, above + (int(strictly[b]) if ok else 0)


def gather_select(cands, top_k, top_p, mx):
    """The warp's thresholds from the gathered candidates (values)."""
    order = torch.argsort(sortable(cands), descending=True, stable=True)
    vals = cands[order]
    keys = sortable(vals)
    kkey = int(keys[top_k - 1])
    if top_p >= 1.0:
        return unsortable(kkey)
    w = torch.where(keys >= kkey, masses(vals, mx), 0)
    ex = torch.cumsum(w, 0) - w
    target = float(top_p) * float(int(w.sum()))
    first = torch.ones_like(keys, dtype=torch.bool)
    first[1:] = keys[1:] != keys[:-1]
    q = (keys >= kkey) & first & (ex.double() < target)
    return unsortable(int(keys[int(torch.nonzero(q).max())]))


def split_sample_row(key, x, C, temperature, top_k, top_p):
    V = x.shape[0]
    S = -(-V // C)
    cuts = [(r * S, min((r + 1) * S, V)) for r in range(C)]
    if temperature <= 0.0:
        best = (-np.inf, V)
        for a, b in cuts:
            if a < b:
                i = int(torch.argmax(x[a:b])) + a
                v = float(x[i])
                if v > best[0] or (v == best[0] and i < best[1]):
                    best = (v, i)
        return best[1], 0.0
    l = x / torch.tensor(temperature, dtype=torch.float32)
    u = sortable(l)
    parts = [(u[a:b], l[a:b]) for a, b in cuts]
    mx = max(float(pl.max()) for _, pl in parts if pl.numel())
    mx = torch.tensor(mx, dtype=torch.float32)
    tau = -np.inf
    gathered = False
    if 0 < top_k < V:
        rem, prefix = top_k, 0
        for lvl in range(4):
            shift = 24 - 8 * lvl

            def bins(p, shift=shift, prefix=prefix, lvl=lvl):
                pu = p[0]
                if lvl:
                    pu = pu[(pu >> (shift + 8)) == prefix]
                return (pu >> shift) & 0xFF
            h = merged(parts, bins)
            b, above = pick_count(h, rem)
            rem -= above
            prefix = (prefix << 8) | b
            if lvl == 1 and top_k - rem + int(h[b]) <= GATHER \
                    and prefix != 0x8000:
                cands = torch.cat([pl[(pu >> 16) >= prefix]
                                   for pu, pl in parts])
                tau = gather_select(cands, top_k, top_p, mx)
                gathered = True
                break
        if not gathered:
            tau = unsortable(prefix)
    if top_p < 1.0 and not gathered:
        tau_t = torch.tensor(tau, dtype=torch.float32)
        above, prefix, target = 0, 0, None
        for lvl in range(4):
            shift = 24 - 8 * lvl

            def keep(p, shift=shift, prefix=prefix, lvl=lvl):
                pu, pl = p
                m = pl >= tau_t
                if lvl:
                    m &= (pu >> (shift + 8)) == prefix
                return m
            h = merged(parts, lambda p, keep=keep, shift=shift:
                       (p[0][keep(p)] >> shift) & 0xFF,
                       lambda p, keep=keep: masses(p[1][keep(p)], mx))
            if lvl == 0:
                target = float(top_p) * float(int(h.sum()))
            b, above = pick_mass(h, above, target)
            prefix = (prefix << 8) | b
        tau = max(tau, unsortable(prefix))
    g = prng.gumbel(key, V)
    best, mass = (-np.inf, V), 0
    for a, b in cuts:                                  # rank order
        pl = l[a:b]
        kept = pl >= torch.tensor(tau, dtype=torch.float32)
        if kept.any():
            z = torch.where(kept, pl + g[a:b], -torch.inf)
            i = int(torch.argmax(z)) + a
            v = float(z[i - a])
            if v > best[0] or (v == best[0] and i < best[1]):
                best = (v, i)
            mass += int(masses(pl[kept], mx).sum())
    tok = best[1]
    logp = float(l[tok] - mx) - float(np.log(mass / MASS_SCALE))
    return tok, logp


def split_sample(keys, logits, C, *, temperature=1.0, top_p=1.0, top_k=-1):
    out = [split_sample_row(keys[r], logits[r], C, temperature, top_k, top_p)
           for r in range(logits.shape[0])]
    return (torch.tensor([t for t, _ in out], dtype=torch.int32),
            torch.tensor([p for _, p in out], dtype=torch.float32))


# the six configurations of tests/test_torch_kernels.py::test_fused_sample_kernel
CONFIGS = {"plain": dict(temperature=1.0),
           "topk": dict(temperature=0.8, top_k=50),
           "topp": dict(temperature=0.9, top_p=0.95),
           "both": dict(temperature=0.8, top_k=50, top_p=0.95),
           "k1": dict(temperature=1.0, top_k=1),
           "greedy": dict(temperature=0.0)}
_ORACLE = {}


def _case(V, name):
    """Seeded inputs and the oracle's and the plain version's results,
    computed once per (V, configuration)."""
    if (V, name) not in _ORACLE:
        rng = np.random.default_rng(V)
        logits = (rng.standard_normal((8, V)) * 3).astype(np.float32)
        keys = np.asarray(jax.random.split(jax.random.PRNGKey(V), 8))
        kw = CONFIGS[name]
        tj, lj = JS.sample_rows(jnp.asarray(keys), jnp.asarray(logits), **kw)
        kt = torch.from_numpy(keys.astype(np.uint32).copy())
        lt = torch.from_numpy(logits)
        tp, lp = TS.sample_rows(kt, lt, **kw)
        _ORACLE[V, name] = (kt, lt, np.asarray(tj), np.asarray(lj), tp, lp)
    return _ORACLE[V, name]


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("V", [1000, 32001])
@pytest.mark.parametrize("C", [1, 8, 16])
def test_split_design_matches_jax(C, V, name):
    keys, logits, tj, lj, tp, lp = _case(V, name)
    tok, logp = split_sample(keys, logits, C, **CONFIGS[name])
    np.testing.assert_array_equal(tok.numpy(), tj)
    assert torch.equal(tok, tp)
    np.testing.assert_allclose(logp.numpy(), lj, atol=1e-4, rtol=0)
    np.testing.assert_allclose(logp.numpy(), lp.numpy(), atol=1e-4, rtol=0)


@pytest.mark.parametrize("kw", [dict(top_k=200, top_p=0.9),
                                dict(temperature=0.7, top_k=100)],
                         ids=["radix-topp", "radix-topk"])
def test_split_design_radix_levels(kw):
    """Top-k over more candidates than one warp sorts: every radix level of
    both thresholds runs, and the tokens still match."""
    rng = np.random.default_rng(7)
    logits = (rng.standard_normal((8, 5000)) * 2).astype(np.float32)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(7), 8))
    tj, lj = JS.sample_rows(jnp.asarray(keys), jnp.asarray(logits), **kw)
    tok, logp = split_sample(torch.from_numpy(keys.astype(np.uint32).copy()),
                             torch.from_numpy(logits), 8, **kw)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(tj))
    np.testing.assert_allclose(logp.numpy(), np.asarray(lj), atol=1e-4)


@pytest.mark.parametrize("kw", [dict(temperature=0.0), dict(top_k=1),
                                dict(top_k=2), dict(top_p=0.5)],
                         ids=["greedy", "k1", "k2", "p0.5"])
def test_split_design_ties_across_slices(kw):
    """Tied maxima in different slices (slices of 125 at V = 1000, C = 8;
    124 | 125 straddles a boundary): the lower index wins the argmax, and
    the thresholds keep every tie."""
    V = 1000
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((4, V)).astype(np.float32)
    spots = [[124, 125], [3, 999], [250, 500, 750], [7, 8]]
    for r, idx in enumerate(spots):
        logits[r, idx] = 9.0
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(3), 4))
    tj, lj = JS.sample_rows(jnp.asarray(keys), jnp.asarray(logits), **kw)
    tok, logp = split_sample(torch.from_numpy(keys.astype(np.uint32).copy()),
                             torch.from_numpy(logits), 8, **kw)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(tj))
    np.testing.assert_allclose(logp.numpy(), np.asarray(lj), atol=1e-4)
    assert all(t in s for t, s in zip(tok.tolist(), spots))
    if kw.get("temperature") == 0.0:
        assert tok.tolist() == [s[0] for s in spots]
