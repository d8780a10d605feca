"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Marked ``cuda``: they need an NVIDIA GPU and nvcc, and skip elsewhere (the
decision is taken inside the fixture, never at import). On the GPU machine,
which has no JAX for tests/conftest.py:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_kernels.py

Tolerances: float32 inputs, atol 1e-4 (the kernels sum in another order);
bfloat16 attention, atol 2e-2 (one bf16 ulp of outputs of order 1, and the
plain decode rounds its probabilities to bf16 where the kernel keeps f32).
Sampled tokens must be equal; logps within atol 1e-4.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.hopper import decode_attn, flash_attn, fused_sample  # noqa: E402
from repro_torch.sampling import prng  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (run on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,S,H,KV,hd,window,cap", [
    (2, 128, 8, 2, 64, 0, 0.0),
    (1, 100, 4, 4, 64, 0, 0.0),
    (2, 192, 8, 2, 64, 48, 0.0),
    (1, 64, 4, 2, 32, 0, 30.0),
])
def test_flash_attention_kernel(dev, dtype, atol, B, S, H, KV, hd, window,
                                cap):
    g = _gen(0)
    q = torch.randn(B, S, H, hd, device=dev, generator=g).to(dtype)
    k = torch.randn(B, S, KV, hd, device=dev, generator=g).to(dtype)
    v = torch.randn(B, S, KV, hd, device=dev, generator=g).to(dtype)
    n0 = flash_attn.flash_attention.launches
    out = flash_attn.flash_attention(q, k, v, causal=True, window=window,
                                     attn_softcap=cap)
    torch.cuda.synchronize()
    assert flash_attn.flash_attention.launches == n0 + 1
    ref = flash_attn.flash_attention_plain(q, k, v, causal=True,
                                           window=window, attn_softcap=cap)
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,L,H,KV,hd,window,cap", [
    (16, 640, 32, 8, 64, 0, 0.0),
    (5, 300, 12, 4, 64, 0, 0.0),
    (4, 256, 8, 2, 32, 64, 0.0),
    (3, 128, 8, 8, 64, 0, 20.0),
])
def test_decode_attention_kernel(dev, dtype, atol, B, L, H, KV, hd, window,
                                 cap):
    g = _gen(1)
    q = torch.randn(B, 1, H, hd, device=dev, generator=g).to(dtype)
    kc = torch.randn(B, L, KV, hd, device=dev, generator=g).to(dtype)
    vc = torch.randn(B, L, KV, hd, device=dev, generator=g).to(dtype)
    lens = torch.randint(1, L + 1, (B,), device=dev, generator=g,
                         dtype=torch.int32)
    lens[0] = L
    n0 = decode_attn.decode_attention.launches
    out = decode_attn.decode_attention(q, kc, vc, lens, window=window,
                                       attn_softcap=cap)
    torch.cuda.synchronize()
    assert decode_attn.decode_attention.launches == n0 + 1
    ref = decode_attn.decode_attention_plain(q, kc, vc, lens, window=window,
                                             attn_softcap=cap)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("kw", [
    dict(temperature=1.0), dict(temperature=0.8, top_k=50),
    dict(temperature=0.9, top_p=0.95),
    dict(temperature=0.8, top_k=50, top_p=0.95),
    dict(temperature=1.0, top_k=1), dict(temperature=0.0),
], ids=["plain", "topk", "topp", "both", "k1", "greedy"])
@pytest.mark.parametrize("V", [1000, 128256])
def test_fused_sample_kernel(dev, kw, V):
    g = _gen(2)
    R = 16
    logits = torch.randn(R, V, device=dev, generator=g) * 3
    keys = prng.split(prng.PRNGKey(7), R).to(dev)
    n0 = fused_sample.sample_rows.launches
    tok, logp = fused_sample.sample_rows(keys, logits, **kw)
    torch.cuda.synchronize()
    assert fused_sample.sample_rows.launches == n0 + 1
    rt, rl = fused_sample.sample_rows_plain(keys, logits, **kw)
    assert torch.equal(tok, rt)
    torch.testing.assert_close(logp, rl, atol=1e-4, rtol=0)


def test_fused_sample_kernel_ties(dev):
    logits = torch.zeros(8, 512, device=dev)
    logits[:, :6] = 8.0          # the six tied values hold ~97% of the mass
    keys = prng.split(prng.PRNGKey(1), 8).to(dev)
    for kw in (dict(top_k=3), dict(top_p=0.5)):
        tok, logp = fused_sample.sample_rows(keys, logits, **kw)
        rt, rl = fused_sample.sample_rows_plain(keys, logits, **kw)
        assert torch.equal(tok, rt) and (tok < 6).all()
        torch.testing.assert_close(logp, rl, atol=1e-5, rtol=0)
