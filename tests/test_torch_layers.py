"""Port parity: repro_torch.models.layers vs repro.models.layers.

Same numpy inputs through both frameworks on the CPU. Tolerances: float32
elementwise ops agree to a few ulps (atol 1e-5 after a 128-wide reduction);
bfloat16 outputs may differ by one bf16 ulp from a rounding tie (atol 1e-2
on values of order 1)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

torch.set_num_threads(1)


def _np(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_rms_norm(dtype, atol):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 128)).astype(np.float32)
    s = rng.normal(size=(128,)).astype(np.float32)
    ref = JL.rms_norm(jnp.asarray(x, dtype), jnp.asarray(s), eps=1e-6)
    got = TL.rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                      torch.from_numpy(s), eps=1e-6)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), _np(ref), atol=atol)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_apply_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 4, 64)).astype(np.float32)
    pos = rng.integers(0, 600, (2, 9)).astype(np.int32)
    ref = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-5)


def test_apply_mlp():
    rng = np.random.default_rng(2)
    d, f = 32, 96
    p = {k: rng.normal(size=s).astype(np.float32) / np.sqrt(s[0])
         for k, s in (("wi", (d, f)), ("wg", (d, f)), ("wo", (f, d)))}
    x = rng.normal(size=(4, 3, d)).astype(np.float32)
    ref = JL.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x))
    got = TL.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-5)


@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_softcap(cap):
    x = np.linspace(-100, 100, 101).astype(np.float32)
    ref = JL.softcap(jnp.asarray(x), cap)
    got = TL.softcap(torch.from_numpy(x), cap)
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-5)
