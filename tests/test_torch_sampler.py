"""Port parity: the threefry PRNG and the plain sampler (the reference of the
sampling kernel) vs jax.random and repro.sampling.sampler.sample_rows.

Random bits and keys must be bit-equal. Tokens must be equal: the Gumbel
noise of the two frameworks differs by at most an ulp of float32 log, which
moves no argmax on these inputs. Log-probs agree within atol 1e-5 (float32
log-softmax in a different summation order)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.sampling import sampler as JS  # noqa: E402
from repro_torch.hopper import fused_sample  # noqa: E402
from repro_torch.sampling import prng  # noqa: E402
from repro_torch.sampling import sampler as TS  # noqa: E402

torch.set_num_threads(1)


def _u32(a):
    return torch.from_numpy(np.asarray(a, np.uint32).copy())


@pytest.mark.parametrize("seed", [0, 42, 2**31 + 5])
def test_prngkey_fold_in_split(seed):
    k = jax.random.PRNGKey(seed)
    kt = prng.PRNGKey(seed)
    assert kt.tolist() == np.asarray(k).tolist()
    for d in (0, 1, 7, 2**31 - 1):
        assert prng.fold_in(kt, torch.tensor(d)).tolist() == \
            np.asarray(jax.random.fold_in(k, d)).tolist()
    assert prng.split(kt, 5).tolist() == \
        np.asarray(jax.random.split(k, 5)).tolist()


def test_threefry2x32_vs_jax():
    from jax._src import prng as jprng
    rng = np.random.default_rng(0)
    key = rng.integers(0, 2**32, 2, dtype=np.uint64).astype(np.uint32)
    x = rng.integers(0, 2**32, (2, 64), dtype=np.uint64).astype(np.uint32)
    ref = np.asarray(jprng.threefry_2x32(jnp.asarray(key),
                                         jnp.asarray(x.reshape(-1))))
    k64 = torch.from_numpy(key.astype(np.int64))
    x64 = torch.from_numpy(x.astype(np.int64))
    y0, y1 = prng.threefry2x32(k64[0], k64[1], x64[0], x64[1])
    np.testing.assert_array_equal(np.concatenate([y0.numpy(), y1.numpy()]),
                                  ref.astype(np.int64))


@pytest.mark.parametrize("n", [7, 100, 2049])
def test_bits_and_gumbel_vs_jax(n):
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(3), 4))
    bits = np.stack([np.asarray(jax.random.bits(jnp.asarray(k), (n,)))
                     for k in keys])
    np.testing.assert_array_equal(prng.random_bits(_u32(keys), n).numpy(),
                                  bits.astype(np.int64))
    g = np.stack([np.asarray(jax.random.gumbel(jnp.asarray(k), (n,)))
                  for k in keys])
    np.testing.assert_allclose(prng.gumbel(_u32(keys), n).numpy(), g,
                               rtol=1e-6, atol=1e-6)


SAMPLE_CASES = [
    dict(temperature=1.0),
    dict(temperature=0.7),
    dict(temperature=0.8, top_k=5),
    dict(temperature=1.0, top_k=1),
    dict(temperature=0.9, top_p=0.8),
    dict(temperature=1.2, top_p=0.3),
    dict(temperature=0.8, top_k=50, top_p=0.95),
    dict(temperature=0.0),
]


@pytest.mark.parametrize("V", [64, 1000])
@pytest.mark.parametrize("kw", SAMPLE_CASES,
                         ids=[str(sorted(c.items())) for c in SAMPLE_CASES])
def test_sample_rows_vs_jax(kw, V):
    rng = np.random.default_rng(V)
    logits = (rng.normal(size=(16, V)) * 3).astype(np.float32)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(11), 16))
    tj, lj = JS.sample_rows(jnp.asarray(keys), jnp.asarray(logits), **kw)
    tt, lt = TS.sample_rows(_u32(keys), torch.from_numpy(logits), **kw)
    assert tt.dtype == torch.int32 and lt.dtype == torch.float32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5)


@pytest.mark.parametrize("kw", [dict(temperature=1.0, top_k=3),
                                dict(temperature=1.0, top_p=0.5)])
def test_sample_rows_forced_ties(kw):
    """Ties at the top-k / top-p threshold are kept by both."""
    V = 32
    logits = np.zeros((24, V), np.float32)
    logits[:, :6] = 2.0                       # six tied top values
    logits[:, 6:10] = 1.0
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(5), 24))
    tj, lj = JS.sample_rows(jnp.asarray(keys), jnp.asarray(logits), **kw)
    tt, lt = TS.sample_rows(_u32(keys), torch.from_numpy(logits), **kw)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5)
    assert (tt.numpy() < 6).all()             # only the tied top set is kept


def test_prepare_logits_vs_jax():
    rng = np.random.default_rng(9)
    logits = (rng.normal(size=(8, 200)) * 2).astype(np.float32)
    ref = JS.prepare_logits(jnp.asarray(logits), temperature=0.7, top_p=0.9,
                            top_k=20)
    got = TS.prepare_logits(torch.from_numpy(logits), temperature=0.7,
                            top_p=0.9, top_k=20)
    np.testing.assert_array_equal(got.numpy() > -1e29,
                                  np.asarray(ref) > -1e29)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


def test_kernel_wrapper_on_cpu_is_plain():
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.normal(size=(4, 50)).astype(np.float32))
    keys = prng.split(prng.PRNGKey(0), 4)
    before = fused_sample.sample_rows.launches
    a = fused_sample.sample_rows(keys, logits, temperature=0.9, top_k=10)
    b = TS.sample_rows(keys, logits, temperature=0.9, top_k=10)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert fused_sample.sample_rows.launches == before   # no kernel launch
    with pytest.raises(TypeError):
        fused_sample.sample_rows(keys.to(torch.int64), logits)
