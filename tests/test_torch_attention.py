"""Port parity: the plain PyTorch attention (the references of the prefill
and decode kernels) vs the JAX functions and the Pallas kernels run in
interpret mode, on the same numpy inputs.

Tolerance: float32 attention, atol 1e-5 (online softmax in a different
summation order over at most a few hundred keys)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.common.config import ModelConfig as JModelConfig  # noqa: E402
from repro.kernels.decode_attn import ops as da_ops  # noqa: E402
from repro.kernels.flash_attn import ops as fa_ops  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro_torch.common.config import ModelConfig  # noqa: E402
from repro_torch.hopper import decode_attn, flash_attn  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402

torch.set_num_threads(1)
ATOL = 1e-5

PREFILL_CASES = [
    # B, S, H, KV, hd, window, softcap, block
    (2, 64, 4, 2, 32, 0, 0.0, 512),     # GQA, one block
    (1, 100, 4, 1, 64, 0, 0.0, 32),     # ragged S over several blocks
    (2, 96, 4, 2, 32, 24, 0.0, 32),     # sliding window
    (1, 80, 2, 2, 32, 0, 20.0, 32),     # softcap
    # the published head dims: paper-qwen-7b's 128 at REP 7, granite-34b's
    # 128 at REP 48 (MQA), gemma2-2b's 256 with a window and a softcap
    (1, 70, 7, 1, 128, 0, 0.0, 32),
    (1, 40, 48, 1, 128, 0, 0.0, 32),
    (2, 72, 2, 1, 256, 24, 50.0, 32),
]


def _qkv(B, S, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("case", PREFILL_CASES)
def test_chunked_attention_vs_jax(case):
    B, S, H, KV, hd, win, cap, blk = case
    q, k, v = _qkv(B, S, H, KV, hd, 0)
    ref = JA.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=True, window=win, attn_softcap=cap,
                               block_q=blk, block_k=blk)
    got = TA.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=True, window=win,
                               attn_softcap=cap, block_q=blk, block_k=blk)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("case", PREFILL_CASES[:3] + PREFILL_CASES[4:])
def test_flash_wrapper_vs_pallas_interpret(case):
    """The kernel wrapper on CPU tensors (its plain version) vs the Pallas
    flash kernel run in interpret mode."""
    B, S, H, KV, hd, win, cap, _ = case
    q, k, v = _qkv(B, S, H, KV, hd, 1)
    ref = fa_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=True, window=win,
                                 attn_softcap=cap, block_q=32, block_k=32)
    got = flash_attn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), causal=True,
                                     window=win, attn_softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


DECODE_CASES = [
    # B, L, H, KV, hd, window, softcap
    (4, 64, 8, 2, 32, 0, 0.0),
    (3, 96, 4, 4, 64, 0, 0.0),
    (4, 64, 8, 2, 32, 16, 0.0),
    (2, 64, 4, 1, 32, 0, 25.0),
    (3, 96, 7, 1, 128, 0, 0.0),         # paper-qwen-7b: 128, REP 7
    (2, 64, 48, 1, 128, 0, 0.0),        # granite-34b: 128, REP 48
    (3, 80, 4, 2, 256, 24, 50.0),       # gemma2-2b: 256, window, softcap
]


def _decode_inputs(B, L, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 1, H, hd)).astype(np.float32)
    kc = rng.normal(size=(B, L, KV, hd)).astype(np.float32)
    vc = rng.normal(size=(B, L, KV, hd)).astype(np.float32)
    lens = rng.integers(1, L + 1, B).astype(np.int32)     # ragged
    lens[0] = L                                            # a full row
    return q, kc, vc, lens


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_attention_vs_jax(case):
    B, L, H, KV, hd, win, cap = case
    q, kc, vc, lens = _decode_inputs(B, L, H, KV, hd, 2)
    ref = JA.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                              jnp.asarray(vc), jnp.asarray(lens), window=win,
                              attn_softcap=cap)
    got = TA.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                              torch.from_numpy(vc), torch.from_numpy(lens),
                              window=win, attn_softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_wrapper_vs_pallas_interpret(case):
    """The kernel wrapper on CPU tensors vs the Pallas decode kernel
    (interpret mode), which reads the same model cache layout through its
    ops wrapper."""
    B, L, H, KV, hd, win, cap = case
    q, kc, vc, lens = _decode_inputs(B, L, H, KV, hd, 3)
    ref = da_ops.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                  jnp.asarray(vc), jnp.asarray(lens),
                                  window=win, attn_softcap=cap, block_l=32)
    got = decode_attn.decode_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(lens), window=win, attn_softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def _cfg(cls, kind_window):
    return cls(name="t", family="dense", num_layers=1, d_model=64,
               num_heads=4, num_kv_heads=2, head_dim=32, d_ff=128,
               vocab_size=32, sliding_window=kind_window, dtype="float32")


@pytest.mark.parametrize("kind", ["attn", "local"])
def test_attention_block_decode_writes_in_place(kind):
    """Decode attention_block vs JAX: same output, and the K/V write at
    cache_len lands in place (start clamped to L - 1, as the reference's
    dynamic_update_slice)."""
    rng = np.random.default_rng(4)
    cfg_t, cfg_j = _cfg(ModelConfig, 8), _cfg(JModelConfig, 8)
    d, B, L = 64, 3, 16
    p = {n: (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
         for n, s in (("wq", (d, 128)), ("wk", (d, 64)), ("wv", (d, 64)),
                      ("wo", (128, d)))}
    x = rng.normal(size=(B, 1, d)).astype(np.float32)
    kc = rng.normal(size=(B, L, 2, 32)).astype(np.float32)
    vc = rng.normal(size=(B, L, 2, 32)).astype(np.float32)
    clen = np.array([3, 15, 20], np.int32)                 # 20 clamps to 15
    pos = clen[:, None]
    ref, (rk, rv) = JA.attention_block(
        {n: jnp.asarray(a) for n, a in p.items()}, cfg_j, jnp.asarray(x),
        jnp.asarray(pos), kind=kind, kv_cache=(jnp.asarray(kc),
                                               jnp.asarray(vc)),
        cache_len=jnp.asarray(clen))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got, (gk, gv) = TA.attention_block(
        {n: torch.from_numpy(a) for n, a in p.items()}, cfg_t,
        torch.from_numpy(x), torch.from_numpy(pos), kind=kind,
        kv_cache=(tk, tv), cache_len=torch.from_numpy(clen))
    assert gk is tk and gv is tv                           # in place
    np.testing.assert_allclose(gk.numpy(), np.asarray(rk), atol=ATOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(rv), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_wrappers_reject_bad_inputs():
    q = torch.zeros(1, 4, 4, 32)
    with pytest.raises(ValueError):
        flash_attn.flash_attention(q, torch.zeros(1, 4, 3, 32),
                                   torch.zeros(1, 4, 3, 32))
    with pytest.raises(ValueError):
        decode_attn.decode_attention(torch.zeros(1, 2, 4, 32),
                                     torch.zeros(1, 8, 2, 32),
                                     torch.zeros(1, 8, 2, 32),
                                     torch.ones(1, dtype=torch.int32))
