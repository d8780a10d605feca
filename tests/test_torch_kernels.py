"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Marked ``cuda``: they need an NVIDIA GPU and nvcc, and skip elsewhere (the
decision is taken inside the fixture, never at import). On the GPU machine,
which has no JAX for tests/conftest.py:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_kernels.py

Tolerances: float32 inputs, atol 1e-4 (the kernels sum in another order);
bfloat16 attention, atol 2e-2 (one bf16 ulp of outputs of order 1, and the
plain decode rounds its probabilities to bf16 where the kernel keeps f32).
Sampled tokens must be equal; logps within atol 1e-4. The attention
backward: float32 atol 1e-4, bfloat16 atol 5e-2 (gradients of order 1 that
go through bf16 rounding of each output; at head_dim 128 and 256, where dk
and dv sum REP x S terms and reach [8, 16), also one bf16 ulp of the
reference element where that is larger); bfloat16 runs the tensor-core
kernels, float32 the SIMT ones, and the bf16 backward is bit-equal from
call to call. The fused IS+GRPO kernels keep float32 accuracy like their
plain versions (bf16 hidden on the tensor cores, from w and dl as two bf16
terms; f32 hidden on the SIMT kernels): per-row outputs of both forwards
atol 1e-4, dh/dw atol 1e-4 relative to their largest element (sums over V
or over rows in another order), 1e-2 for a bf16 dh (one bf16 ulp). The paged decode
kernel: as the dense one (float32 1e-4, bfloat16 2e-2), and bit-equal to the
dense kernel, whose loop it shares: both split each row into chunks of 128
positions at fixed positions and merge them in chunk order, so lengths and
windows on both sides of chunk boundaries give the same bits from either
cache, for pages of 8, 16 and 32, and from call to call. The tensor-core
bwd_dh (bf16 hidden; f32 hidden runs the SIMT kernels): dl and dh within
1e-4 of their largest element of the plain version's, zero rows exactly
zero, repeats bit-equal. The fused
log-prob: logp and lse atol 1e-4; its gradient (the IS-GRPO backward
kernels with e = 0) within 1e-4 of the largest element of autograd's
through the plain version. The scan kernels (selective scan, WKV6):
float32 outputs and states atol 1e-4; bfloat16 outputs within two bf16
ulps of each element plus that float32 atol (both sides compute in
float32, in another summation order, and round once), their float32
states within 1e-4 of the largest element.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.hopper import decode_attn, flash_attn, fused_sample  # noqa: E402
from repro_torch.hopper import fused_is_grpo as fio  # noqa: E402
from repro_torch.hopper import fused_logprob as flp  # noqa: E402
from repro_torch.hopper import paged_decode_attn as pda  # noqa: E402
from repro_torch.hopper import rwkv6_scan, ssm_scan  # noqa: E402
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


ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _assert_grad_close(got, want, atol, name, wide=False):
    """|got - want| <= atol; with ``wide`` (bf16 gradients at head_dim 128
    and 256) at most one bf16 ulp of the reference element where that is
    larger than atol: there dk and dv sum REP x S terms and reach |x| in
    [8, 16), where one ulp is 0.0625 > 5e-2, so kernel and plain version,
    both exact to ~1e-5 in float32, may round to neighbouring bf16 values."""
    got, want = got.float(), want.float()
    tol = torch.full_like(want, atol)
    if wide:
        ulp = torch.exp2(torch.floor(torch.log2(
            want.abs().clamp_min(2.0 ** -126))) - 7)
        tol = torch.maximum(tol, ulp)
    excess = float(((got - want).abs() - tol).max())
    assert excess <= 0.0, (name, excess, float((got - want).abs().max()))


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,S,H,KV,hd,window,cap", [
    (2, 128, 8, 2, 64, 0, 0.0),
    (1, 100, 4, 4, 64, 0, 0.0),
    (2, 192, 8, 2, 64, 48, 0.0),
    (1, 64, 4, 2, 32, 0, 30.0),
    (16, 512, 25, 5, 64, 1024, 0.0),          # hymba-1.5b prefill: H/KV = 5
    (2, 150, 14, 2, 128, 0, 0.0),             # paper-qwen-7b's 128 x REP 7
    (1, 130, 4, 2, 256, 40, 50.0),            # gemma2-2b's 256, softcap
    (1, 70, 48, 1, 128, 0, 0.0),              # granite-34b's MQA
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
    (16, 640, 25, 5, 64, 1024, 0.0),          # hymba-1.5b: H/KV = 5
    (16, 640, 28, 4, 128, 0, 0.0),            # paper-qwen-7b: REP 7
    (16, 640, 8, 4, 256, 100, 50.0),          # gemma2-2b: 256, local
    (16, 640, 48, 1, 128, 0, 0.0),            # granite-34b: REP 48
    (4, 300, 16, 2, 128, 0, 0.0),             # REP 8
    (3, 200, 16, 1, 256, 0, 0.0),             # REP 16 at 256: 4 groups
    (2, 150, 7, 1, 256, 0, 30.0),             # REP 7 at 256: 7 groups
    (5, 300, 10, 2, 32, 0, 0.0),              # REP 5 at 32
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
@pytest.mark.parametrize("V", [1000, 32001, 65536, 128256])
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


SAMPLE_KWS = [dict(temperature=1.0), dict(temperature=0.8, top_k=50),
              dict(temperature=0.9, top_p=0.95),
              dict(temperature=0.8, top_k=50, top_p=0.95),
              dict(temperature=1.0, top_k=1), dict(temperature=0.0)]


def _sample_agrees(keys, logits, kw, **launch):
    """The kernel (through the wrapper, or one ``launch`` with the given
    cluster size) against the plain version: equal tokens, logp within
    1e-4."""
    if launch:
        tok, logp = fused_sample.launch(keys, logits, **{
            "temperature": 1.0, "top_p": 1.0, "top_k": -1, **kw, **launch})
    else:
        tok, logp = fused_sample.sample_rows(keys, logits, **kw)
    torch.cuda.synchronize()
    rt, rl = fused_sample.sample_rows_plain(keys, logits, **kw)
    assert torch.equal(tok, rt), kw
    torch.testing.assert_close(logp, rl, atol=1e-4, rtol=0)
    return tok, logp


@pytest.mark.parametrize("V", [5, 1000, 32001, 65536, 128256])
@pytest.mark.parametrize("R", [1, 3, 16])
def test_fused_sample_cluster_rows_and_vocabs(dev, R, V):
    """One cluster per row at 1, 3 and 16 rows (prefill samples few rows),
    vocabularies below the cluster size, odd, and the served ones; all six
    configurations of test_fused_sample_kernel."""
    logits = torch.randn(R, V, device=dev, generator=_gen(R + V)) * 3
    keys = prng.split(prng.PRNGKey(R), R).to(dev)
    for kw in SAMPLE_KWS:
        n0 = fused_sample.sample_rows.launches
        _sample_agrees(keys, logits, kw)
        assert fused_sample.sample_rows.launches == n0 + 1


@pytest.mark.parametrize("cluster", [1, 2, 4, 6, 7, 8, 16])
def test_fused_sample_cluster_sizes(dev, cluster):
    """Every cluster size the wrapper may take gives the plain version's
    tokens."""
    logits = torch.randn(3, 32001, device=dev, generator=_gen(8)) * 3
    keys = prng.split(prng.PRNGKey(8), 3).to(dev)
    for kw in SAMPLE_KWS:
        _sample_agrees(keys, logits, kw, cluster=cluster)


def test_fused_sample_ties_across_slices(dev):
    """Tied maxima in different slices of a row (slices of 125 at V = 1000
    and 8 blocks; 7 and 8 straddle a boundary): greedy takes the lowest
    index, the thresholds keep every tie, sampling agrees with the plain
    version."""
    V = 1000
    logits = torch.randn(4, V, device=dev, generator=_gen(9))
    spots = [[124, 125], [3, 999], [250, 500, 750], [7, 8]]
    for r, idx in enumerate(spots):
        logits[r, idx] = 9.0
    keys = prng.split(prng.PRNGKey(9), 4).to(dev)
    tok, _ = _sample_agrees(keys, logits, dict(temperature=0.0))
    assert tok.tolist() == [s[0] for s in spots]
    for kw in (dict(top_k=1), dict(top_k=2), dict(top_p=0.5),
               dict(temperature=0.1)):
        tok, _ = _sample_agrees(keys, logits, kw)
        assert all(t in s for t, s in zip(tok.tolist(), spots)), kw


@pytest.mark.parametrize("kw", [dict(top_k=1), dict(top_k=32001),
                                dict(top_k=40000), dict(top_p=1e-6),
                                dict(temperature=0.7, top_k=1, top_p=1e-6),
                                dict(top_k=200, top_p=0.9),
                                dict(temperature=0.7, top_k=100),
                                dict(top_k=64, top_p=0.99)],
                         ids=["k1", "k=V", "k>V", "p1e-6", "k1p1e-6",
                              "radix-k200p", "radix-k100", "k64p"])
def test_fused_sample_extreme_truncation(dev, kw):
    """Truncation at its extremes, and top-k over more candidates than the
    gather sorts (every radix level of both thresholds runs)."""
    logits = torch.randn(16, 32001, device=dev, generator=_gen(10)) * 2
    keys = prng.split(prng.PRNGKey(10), 16).to(dev)
    _sample_agrees(keys, logits, kw)


def test_fused_sample_cluster_choice(dev):
    """The wrapper takes the largest cluster whose rows the card holds at
    once: 16 blocks per row for one row, fewer for 16 rows."""
    for R, V in ((1, 128256), (3, 32001), (16, 128256), (16, 65536)):
        C = fused_sample.cluster_size(dev, R, V)
        assert fused_sample.max_clusters(dev, V, C) >= R
        bigger = [c for c in fused_sample.CLUSTERS if c > C]
        assert all(fused_sample.max_clusters(dev, V, c) < R for c in bigger)
    assert fused_sample.cluster_size(dev, 1, 128256) == 16


def test_fused_sample_is_deterministic(dev):
    """The same keys and logits give the same tokens and logps, bit for bit
    (integer histograms, rank-order merges)."""
    logits = torch.randn(16, 128256, device=dev, generator=_gen(11)) * 2
    keys = prng.split(prng.PRNGKey(11), 16).to(dev)
    for kw in SAMPLE_KWS:
        a = fused_sample.sample_rows(keys, logits, **kw)
        b = fused_sample.sample_rows(keys, logits, **kw)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), kw


def test_fused_sample_refuses_a_vocabulary_beyond_shared_memory(dev):
    limit = fused_sample.max_vocab(dev)
    assert fused_sample.max_vocab(dev, 8) >= 256000   # gemma2's fits in 8
    logits = torch.zeros(1, limit + 1, device=dev)
    keys = prng.split(prng.PRNGKey(0), 1).to(dev)
    with pytest.raises(ValueError, match="does not fit in the shared memory"):
        fused_sample.sample_rows(keys, logits)
    tok, _ = fused_sample.sample_rows(keys, logits, temperature=0.0)
    assert tok.item() == 0                     # greedy keeps no slice


def test_fused_sample_draw_probe_bits(dev):
    """The probe kernels (one and two Gumbel draws per output, whose SASS
    chip_smoke.py counts) draw jax's Gumbel noise."""
    import ctypes
    from repro_torch.hopper import build
    key = prng.PRNGKey(3)
    want = prng.gumbel(key, 512).float().to(dev)
    lib = build.library("fused_sample")
    stream = torch.cuda.current_stream().cuda_stream
    k0, k1 = (ctypes.c_uint(int(k)) for k in key.tolist())
    for K in (1, 2):
        out = torch.empty(512 // K, device=dev)
        build.check(lib.fused_sample_draw_probe(k0, k1, out.data_ptr(),
                                                512 // K, K, stream), "probe")
        torch.cuda.synchronize()
        ref = want.view(-1, K).sum(1) if K == 2 else want
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_lse(dev, dtype):
    g = _gen(3)
    B, S, H, KV, hd = 2, 150, 8, 2, 64
    q, k, v = (torch.randn(B, S, n, hd, device=dev, generator=g).to(dtype)
               for n in (H, KV, KV))
    out, lse = flash_attn.flash_attention(q, k, v, return_lse=True)
    ref, ref_lse = flash_attn.flash_attention_plain(q, k, v, return_lse=True)
    torch.cuda.synchronize()
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
    torch.testing.assert_close(out.float(), ref.float(),
                               atol=1e-4 if dtype == torch.float32 else 2e-2,
                               rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,hd,window,cap", [(14, 2, 128, 0, 0.0),
                                                (4, 2, 256, 40, 50.0)])
def test_flash_attention_kernel_lse_wide_heads(dev, dtype, H, KV, hd, window,
                                               cap):
    """The forward with its logsumexp at head_dim 128 and 256."""
    g = _gen(3)
    B, S = 2, 150
    q, k, v = (torch.randn(B, S, n, hd, device=dev, generator=g).to(dtype)
               for n in (H, KV, KV))
    kw = dict(window=window, attn_softcap=cap)
    out, lse = flash_attn.flash_attention(q, k, v, return_lse=True, **kw)
    ref, ref_lse = flash_attn.flash_attention_plain(q, k, v, return_lse=True,
                                                    **kw)
    torch.cuda.synchronize()
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("B,S,H,KV,hd,window,cap", [
    (2, 127, 8, 2, 64, 0, 0.0),
    (1, 100, 4, 4, 64, 40, 0.0),
    (2, 70, 4, 1, 32, 0, 20.0),
    (2, 150, 8, 2, 32, 0, 30.0),              # hd 32, softcap, ragged tiles
    (2, 150, 8, 2, 32, 48, 30.0),             # and a window
    (2, 127, 14, 2, 128, 0, 0.0),             # paper-qwen-7b's 128 x REP 7
    (1, 130, 4, 2, 256, 40, 50.0),            # gemma2-2b's 256, softcap
    (1, 100, 48, 1, 128, 0, 0.0),             # granite-34b's MQA
])
def test_flash_attention_bwd_kernel(dev, dtype, atol, B, S, H, KV, hd,
                                    window, cap):
    g = _gen(4)
    q, k, v = (torch.randn(B, S, n, hd, device=dev, generator=g).to(dtype)
               for n in (H, KV, KV))
    do = torch.randn(B, S, H, hd, device=dev, generator=g).to(dtype)
    kw = dict(causal=True, window=window, attn_softcap=cap)
    out, lse = flash_attn.flash_attention(q, k, v, return_lse=True, **kw)
    n0 = flash_attn.flash_attention_bwd.launches
    dq, dk, dv = flash_attn.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert flash_attn.flash_attention_bwd.launches == n0 + 1
    ref = flash_attn.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        assert a.dtype == dtype
        _assert_grad_close(a, b, atol, name,
                           wide=hd >= 128 and dtype == torch.bfloat16)


# the main paths' bf16 shapes: train (with lse), serve prefill, hymba
# prefill; paper-qwen-7b's and gemma2-2b's train and prefill shapes
TC_SHAPES = [
    (32, 127, 32, 8, 64, 0),
    (16, 512, 32, 8, 64, 0),
    (16, 512, 25, 5, 64, 1024),
    (32, 127, 28, 4, 128, 0),
    (16, 512, 28, 4, 128, 0),
    (32, 127, 8, 4, 256, 4096),
    (16, 512, 8, 4, 256, 4096),
]
TC_IDS = ["train", "serve", "hymba", "qwen7b_train", "qwen7b_prefill",
          "gemma2_train", "gemma2_prefill"]


def _flash_inputs(B, S, H, KV, hd, seed):
    g = _gen(seed)
    return [torch.randn(B, S, n, hd, device="cuda", generator=g).bfloat16()
            for n in (H, KV, KV, H)]


@pytest.mark.parametrize("B,S,H,KV,hd,window", TC_SHAPES, ids=TC_IDS)
def test_flash_attention_tc_main_path_shapes(dev, B, S, H, KV, hd, window):
    """The tensor-core kernels at the main paths' shapes, forward with lse
    and backward; no f32 SIMT kernel runs for bf16."""
    q, k, v, do = _flash_inputs(B, S, H, KV, hd, 8)
    kw = dict(causal=True, window=window)
    fa = flash_attn.flash_attention
    fb = flash_attn.flash_attention_bwd
    n0 = (fa.launches, fa.simt_launches, fb.launches, fb.simt_launches)
    out, lse = fa(q, k, v, return_lse=True, **kw)
    grads = fb(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert (fa.launches, fa.simt_launches, fb.launches, fb.simt_launches) \
        == (n0[0] + 1, n0[1], n0[2] + 1, n0[3])
    ref, ref_lse = flash_attn.flash_attention_plain(q, k, v, return_lse=True,
                                                    **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
    rgrads = flash_attn.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), grads, rgrads):
        _assert_grad_close(a, b, 5e-2, name, wide=hd >= 128)


def test_flash_attention_bwd_tc_is_deterministic(dev):
    """No atomics: two backward calls give the same bits."""
    q, k, v, do = _flash_inputs(*TC_SHAPES[0][:5], 10)
    out, lse = flash_attn.flash_attention(q, k, v, return_lse=True)
    first = flash_attn.flash_attention_bwd(q, k, v, out, lse, do)
    second = flash_attn.flash_attention_bwd(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B,S,H,KV,hd,window", TC_SHAPES[3::2],
                         ids=TC_IDS[3::2])
def test_flash_attention_bwd_tc_wide_heads_are_deterministic(
        dev, B, S, H, KV, hd, window):
    """The same at head_dim 128 and 256 (column blocks over the grid)."""
    q, k, v, do = _flash_inputs(B, S, H, KV, hd, 10)
    out, lse = flash_attn.flash_attention(q, k, v, window=window,
                                          return_lse=True)
    first = flash_attn.flash_attention_bwd(q, k, v, out, lse, do,
                                           window=window)
    second = flash_attn.flash_attention_bwd(q, k, v, out, lse, do,
                                            window=window)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_attention_tc_refuses_unsupported_head_dim(dev):
    """head_dim 96, which no kernel takes, raises on the card (no reroute
    to the plain version)."""
    q, k, v, do = _flash_inputs(1, 64, 4, 2, 96, 11)
    n0 = flash_attn.flash_attention.launches
    with pytest.raises(TypeError, match="head_dim"):
        flash_attn.flash_attention(q, k, v)
    out = torch.zeros_like(q)
    lse = torch.zeros(1, 4, 64, device=dev)
    with pytest.raises(TypeError, match="head_dim"):
        flash_attn.flash_attention_bwd(q, k, v, out, lse, do)
    assert flash_attn.flash_attention.launches == n0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", [128, 256])
@pytest.mark.parametrize("rep", [1, 2, 4, 5, 6, 7, 8, 11, 16, 48])
def test_decode_kernels_every_ratio(dev, dtype, hd, rep):
    """Dense and paged decode at the registry's GQA ratios and at ratios no
    arch has (6, 11: the kernels take any integer ratio), at head sizes 128
    and 256: within atol of the plain version, paged bit-equal to dense, one
    launch each."""
    B, L, KV, ps = 3, 300, 2, 16
    H = KV * rep
    g = _gen(18)
    q = torch.randn(B, 1, H, hd, device=dev, generator=g).to(dtype)
    kc = torch.randn(B, 320, KV, hd, device=dev, generator=g).to(dtype)
    vc = torch.randn(B, 320, KV, hd, device=dev, generator=g).to(dtype)
    lens = torch.tensor([L, 129, 7], dtype=torch.int32, device=dev)
    bt = torch.arange(B * 20, dtype=torch.int32, device=dev).reshape(B, 20)
    n0 = (decode_attn.decode_attention.launches,
          pda.paged_decode_attention.launches)
    out = decode_attn.decode_attention(q, kc, vc, lens)
    paged = pda.paged_decode_attention(q, kc.reshape(B * 20, ps, KV, hd),
                                       vc.reshape(B * 20, ps, KV, hd), bt,
                                       ps, lens)
    torch.cuda.synchronize()
    assert (decode_attn.decode_attention.launches,
            pda.paged_decode_attention.launches) == (n0[0] + 1, n0[1] + 1)
    assert torch.equal(out, paged)
    ref = decode_attn.decode_attention_plain(q, kc, vc, lens)
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("H,KV,hd,exc,match",
                         [(12, 5, 128, ValueError, "incompatible"),
                          (8, 4, 96, TypeError, "head_dim")],
                         ids=["h_not_multiple_of_kv", "hd96"])
def test_decode_kernels_refuse_unsupported_shapes(dev, H, KV, hd, exc, match):
    """Query heads that are no multiple of the kv heads (12 over 5), or a
    head_dim outside the dispatch (96), raise in both decode wrappers, with
    no launch."""
    g = _gen(16)
    q = torch.randn(2, 1, H, hd, device=dev, generator=g).bfloat16()
    kc = torch.randn(2, 64, KV, hd, device=dev, generator=g).bfloat16()
    lens = torch.tensor([10, 64], dtype=torch.int32, device=dev)
    n0 = (decode_attn.decode_attention.launches,
          pda.paged_decode_attention.launches)
    with pytest.raises(exc, match=match):
        decode_attn.decode_attention(q, kc, kc, lens)
    bt = torch.arange(8, dtype=torch.int32, device=dev).reshape(2, 4)
    pool = kc.reshape(8, 16, KV, hd)
    with pytest.raises(exc, match=match):
        pda.paged_decode_attention(q, pool, pool, bt, 16, lens)
    assert (decode_attn.decode_attention.launches,
            pda.paged_decode_attention.launches) == n0


def test_attention_weights_get_gradients_on_card(dev):
    """The train forward on the card: every attention projection of every
    layer gets a nonzero gradient through the flash kernels."""
    from repro_torch.common.tree import leaves
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    cfg = get_smoke_config("llama3.2-1b")
    params = M.init_params(cfg, seed=0, device=dev)
    for p in leaves(params):
        p.requires_grad_(True)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), device=dev,
                         generator=_gen(5))
    n0 = flash_attn.flash_attention_bwd.launches
    loss = M.forward_train(params, cfg, toks, remat=True).logsumexp(-1).mean()
    loss.backward()
    torch.cuda.synchronize()
    assert flash_attn.flash_attention_bwd.launches == n0 + cfg.num_layers
    for layer in params["layers"]:
        for name in ("wq", "wk", "wv", "wo"):
            grad = layer["attn"][name].grad
            assert grad is not None and float(grad.abs().max()) > 0.0, name


def _loss_inputs(dev, R, d, V, h_dtype, tied, seed=6):
    g = _gen(seed)
    h = torch.randn(R, d, device=dev, generator=g).to(h_dtype)
    if tied:
        w = (torch.randn(V, d, device=dev, generator=g) * 0.05).T
    else:
        w = torch.randn(d, V, device=dev, generator=g) * 0.05
    t = torch.randint(0, V, (R,), device=dev, generator=g, dtype=torch.int32)
    b = torch.randn(R, device=dev, generator=g) * 0.3 - 9.0
    a = torch.randn(R, device=dev, generator=g)
    return h, w, t, b, a


LOSS_KW = dict(clip_low=0.2, clip_high=0.28, use_is=True, is_ratio_cap=10.0)


@pytest.mark.parametrize("h_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tied", [True, False], ids=["tied", "lm_head"])
@pytest.mark.parametrize("cap,ent", [(0.0, 0.0), (30.0, 0.01)])
def test_fused_is_grpo_fwd_kernel(dev, h_dtype, tied, cap, ent):
    h, w, t, b, a = _loss_inputs(dev, 300, 256, 5000, h_dtype, tied)
    kw = dict(LOSS_KW, logit_softcap=cap, entropy_coef=ent)
    n0 = fio.fused_is_grpo_fwd_rows.launches
    outs = fio.fused_is_grpo_fwd_rows(h, w, t, b, a, **kw)
    torch.cuda.synchronize()
    assert fio.fused_is_grpo_fwd_rows.launches == n0 + 1
    ref = fio.fwd_plain(h, w, t, b, a, **kw)
    for name, x, y in zip(("loss", "ratio", "logp", "lse", "ent"), outs, ref):
        torch.testing.assert_close(x, y, atol=1e-4, rtol=1e-5, msg=name)


@pytest.mark.parametrize("h_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tied", [True, False], ids=["tied", "lm_head"])
@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_fused_is_grpo_bwd_kernels(dev, h_dtype, tied, cap):
    R, d, V = 300, 256, 5000
    h, w, t, b, _ = _loss_inputs(dev, R, d, V, h_dtype, tied)
    _, _, logp, lse, ent = fio.fwd_plain(h, w, t, b, b, logit_softcap=cap)
    g = _gen(7)
    ca = torch.randn(R, device=dev, generator=g)
    ce = torch.randn(R, device=dev, generator=g) * 0.1
    ca[:50] = 0.0                       # zero rows contribute exactly zero
    ce[:50] = 0.0
    ebar = lse - ent
    n_dh = fio.fused_is_grpo_bwd_dh_rows.launches
    n_dw = fio.fused_is_grpo_bwd_dw_rows.launches
    dh, dw = fio.fused_is_grpo_bwd_rows(h, w, t, lse, ebar, ca, ce,
                                        logit_softcap=cap)
    torch.cuda.synchronize()
    assert fio.fused_is_grpo_bwd_dh_rows.launches == n_dh + 1
    assert fio.fused_is_grpo_bwd_dw_rows.launches == n_dw + 1
    rdh, rdw = fio.bwd_plain(h, w, t, lse, ebar, ca, ce, logit_softcap=cap)
    assert dh.dtype == h_dtype and dw.shape == w.shape
    assert dw.stride() == w.stride()           # the weight's own layout
    assert torch.count_nonzero(dh[:50]) == 0
    for name, x, y in (("dh", dh, rdh), ("dw", dw, rdw)):
        # dh comes back in hidden's dtype: one bf16 ulp (2^-8 relative)
        rel = 1e-2 if name == "dh" and h_dtype == torch.bfloat16 else 1e-4
        torch.testing.assert_close(x.float(), y.float(), rtol=0,
                                   atol=rel * float(y.abs().max()), msg=name)


@pytest.mark.parametrize("h_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("tied", [True, False], ids=["tied", "lm_head"])
def test_fused_is_grpo_bwd_row_chunks(dev, monkeypatch, tied, h_dtype):
    """Rows in several chunks of the dl scratch: dw accumulates over them,
    on the tensor cores for bf16 hidden (chunks of 128 rows start 16-byte
    aligned) and on the SIMT kernel for f32 (``simt_launches``)."""
    R, d, V = 300, 128, 3000
    h, w, t, b, _ = _loss_inputs(dev, R, d, V, h_dtype, tied, seed=8)
    _, _, _, lse, ent = fio.fwd_plain(h, w, t, b, b)
    ca = torch.randn(R, device=dev, generator=_gen(9))
    ce = torch.zeros(R, device=dev)
    monkeypatch.setattr(fio, "DL_SCRATCH_ELEMS", 128 * V)   # 3 chunks
    fn = fio.fused_is_grpo_bwd_dw_rows
    n0, s0 = fn.launches, fn.simt_launches
    dh, dw = fio.fused_is_grpo_bwd_rows(h, w, t, lse, lse - ent, ca, ce)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 3
    assert fn.simt_launches == s0 + (3 if h_dtype == torch.float32 else 0)
    rdh, rdw = fio.bwd_plain(h, w, t, lse, lse - ent, ca, ce)
    assert dw.stride() == w.stride()
    torch.testing.assert_close(dw, rdw, atol=1e-4 * float(rdw.abs().max()),
                               rtol=0)
    # dh comes back in hidden's dtype: one bf16 ulp (2^-8 relative)
    rel = 1e-2 if h_dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(dh.float(), rdh.float(), rtol=0,
                               atol=rel * float(rdh.abs().max()))



BWD_DH_R = [1, 100, 4064]
BWD_DH_V = [5000, 32001, 65536, 128256]


@pytest.mark.parametrize("h_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("cap", [0.0, 30.0])
@pytest.mark.parametrize("tied", [True, False], ids=["tied", "lm_head"])
@pytest.mark.parametrize("V", BWD_DH_V)
@pytest.mark.parametrize("R", BWD_DH_R)
def test_fused_is_grpo_bwd_dh_entry(dev, R, V, tied, cap, h_dtype):
    """The bwd_dh entry point against its plain version at ragged row and
    vocabulary tails (R = 4064 = 31.75 x 128; V = 32001): dl and dh within
    1e-4 of their largest element; rows with a = e = 0 give exactly zero
    dh; a second call gives the same bits. bf16 hidden runs the tensor-core
    kernels, f32 hidden the SIMT ones (``simt_launches``)."""
    d = 256
    h, w, t, b, _ = _loss_inputs(dev, R, d, V, h_dtype, tied, seed=R + V)
    _, _, _, lse, ent = fio.fwd_plain(h, w, t, b, b, logit_softcap=cap)
    g = _gen(10)
    ca = torch.randn(R, device=dev, generator=g)
    ce = torch.randn(R, device=dev, generator=g) * 0.1
    zero = R // 4
    ca[:zero] = 0.0
    ce[:zero] = 0.0
    ebar = lse - ent
    fn = fio.fused_is_grpo_bwd_dh_rows
    n0, s0 = fn.launches, fn.simt_launches
    dl, dh = fn(h, w, t, lse, ebar, ca, ce, logit_softcap=cap)
    dl2, dh2 = fn(h, w, t, lse, ebar, ca, ce, logit_softcap=cap)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 2
    assert fn.simt_launches == s0 + (2 if h_dtype == torch.float32 else 0)
    assert torch.equal(dl, dl2) and torch.equal(dh, dh2)
    assert torch.count_nonzero(dh[:zero]) == 0
    rdl, rdh = fio.bwd_dh_plain(h, w, t, lse, ebar, ca, ce,
                                logit_softcap=cap)
    for name, x, y in (("dl", dl, rdl), ("dh", dh, rdh)):
        torch.testing.assert_close(x, y, rtol=0,
                                   atol=1e-4 * float(y.abs().max()), msg=name)


def test_fused_is_grpo_bwd_dh_tc_refuses_ragged_width(dev):
    """The tensor-core kernels take d a multiple of 8: anything else raises,
    with no fallback to the SIMT kernels."""
    h, w, t, b, _ = _loss_inputs(dev, 10, 100, 500, torch.bfloat16, True)
    _, _, _, lse, ent = fio.fwd_plain(h, w, t, b, b)
    with pytest.raises(ValueError, match="multiple of 8"):
        fio.fused_is_grpo_bwd_dh_rows(h, w, t, lse, lse - ent, b, b)


# R ragged (1, 100 rows; 4064 = 31.75 x 128), d a multiple of 8 but not of
# 64 (200: a ragged k tile in the forwards, a ragged d tile in dw), and the
# hybrid families' vocabularies (32001 ragged)
TC_RD = [(1, 256), (100, 200), (4064, 256)]
TC_V = [8192, 32001, 65536]


@pytest.mark.parametrize("h_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("cap", [0.0, 30.0])
@pytest.mark.parametrize("tied", [True, False], ids=["tied", "lm_head"])
@pytest.mark.parametrize("V", TC_V)
@pytest.mark.parametrize("R,d", TC_RD)
def test_fused_forwards_tc_entry(dev, R, d, V, tied, cap, h_dtype):
    """Kernel 1 of both forwards (IS-GRPO and the fused log-prob) against
    the plain versions: per-row outputs atol 1e-4; bf16 hidden on the
    tensor cores, f32 hidden on the SIMT kernel (``simt_launches``)."""
    h, w, t, b, adv = _loss_inputs(dev, R, d, V, h_dtype, tied, seed=R + V)
    kw = dict(LOSS_KW, logit_softcap=cap, entropy_coef=0.01)
    simt = 1 if h_dtype == torch.float32 else 0
    for fn, call, plain in (
            (fio.fused_is_grpo_fwd_rows,
             lambda: fio.fused_is_grpo_fwd_rows(h, w, t, b, adv, **kw),
             lambda: fio.fwd_plain(h, w, t, b, adv, **kw)),
            (flp.fused_logprob_rows,
             lambda: flp.fused_logprob_rows(h, w, t, logit_softcap=cap),
             lambda: flp.fused_logprob_plain(h, w, t, logit_softcap=cap))):
        n0, s0 = fn.launches, fn.simt_launches
        outs = call()
        torch.cuda.synchronize()
        assert (fn.launches, fn.simt_launches) == (n0 + 1, s0 + simt)
        for x, y in zip(outs, plain()):
            torch.testing.assert_close(x, y, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("h_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("tied", [True, False], ids=["tied", "lm_head"])
@pytest.mark.parametrize("V", TC_V)
@pytest.mark.parametrize("R,d", TC_RD)
def test_fused_is_grpo_bwd_dw_entry(dev, R, d, V, tied, h_dtype):
    """The bwd_dw entry point against its plain version on the dl of
    bwd_dh's plain version, written and then accumulated into w's own
    layout: within 1e-4 of the largest element; a second call gives the
    same bits. bf16 hidden on the tensor cores, f32 on the SIMT kernel."""
    h, w, t, b, _ = _loss_inputs(dev, R, d, V, h_dtype, tied, seed=R + d)
    _, _, _, lse, ent = fio.fwd_plain(h, w, t, b, b)
    g = _gen(16)
    ca = torch.randn(R, device=dev, generator=g)
    ce = torch.randn(R, device=dev, generator=g) * 0.1
    dl, _ = fio.bwd_dh_plain(h, w, t, lse, lse - ent, ca, ce)
    fn = fio.fused_is_grpo_bwd_dw_rows
    n0, s0 = fn.launches, fn.simt_launches
    dw = fn(h, dl, torch.empty_like(w))
    dw2 = fn(h, dl, torch.empty_like(w))
    base = torch.empty_like(w)                  # w's layout
    base.copy_(torch.randn(w.shape, device=dev, generator=g)
               * float(dw.abs().max()))
    acc = fn(h, dl, base.clone(), accumulate=True)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 3
    assert fn.simt_launches == s0 + (3 if h_dtype == torch.float32 else 0)
    assert dw.stride() == acc.stride() == w.stride()
    assert torch.equal(dw, dw2)
    ref = fio.bwd_dw_plain(h, dl)
    scale = float(ref.abs().max())
    torch.testing.assert_close(dw, ref, rtol=0, atol=1e-4 * scale)
    torch.testing.assert_close(acc, base + ref, rtol=0,
                               atol=1e-4 * float((base + ref).abs().max()))


def test_fused_loss_tc_kernels_refuse_what_they_cannot_read(dev):
    """The forwards and dw on the tensor cores read bf16 hidden rows with
    16-byte loads: d not a multiple of 8, or a hidden that does not start
    16-byte aligned, raises in words, with no fallback to the SIMT kernels."""
    h, w, t, b, a = _loss_inputs(dev, 10, 100, 500, torch.bfloat16, True)
    dl = torch.zeros(10, 500, device=dev)
    calls = (lambda h, w: fio.fused_is_grpo_fwd_rows(h, w, t, b, a),
             lambda h, w: flp.fused_logprob_rows(h, w, t),
             lambda h, w: fio.fused_is_grpo_bwd_dw_rows(
                 h, dl, torch.empty_like(w)))
    buf = torch.zeros(10 * 128 + 1, device=dev, dtype=torch.bfloat16)
    shifted = buf[1:].view(10, 128)             # 2 bytes past the start
    w128 = torch.randn(128, 500, device=dev)
    for call in calls:
        with pytest.raises(ValueError, match="multiple of 8"):
            call(h, w)
        with pytest.raises(ValueError, match="16-byte aligned"):
            call(shifted, w128)


# -- paged decode attention ------------------------------------------------------

PDA_CASES = [
    # B, NP, max_pages, ps, H, KV, hd, win, cap, dtype: the CPU tests' cases,
    # then the serve shapes (pool 16, max_len 640, ps 16)
    (2, 12, 4, 16, 4, 2, 64, 0, 0.0, torch.float32),
    (3, 20, 6, 8, 8, 8, 32, 0, 30.0, torch.float32),
    (2, 16, 8, 16, 4, 1, 64, 48, 0.0, torch.float32),
    (1, 9, 3, 32, 5, 5, 64, 0, 0.0, torch.bfloat16),
    (16, 640, 40, 16, 32, 8, 64, 0, 0.0, torch.bfloat16),
    # hymba-1.5b's paged serve layout: 256 pages of 16, H/KV = 5, window
    (16, 256, 40, 16, 25, 5, 64, 1024, 0.0, torch.bfloat16),
    # the wide heads' paged serve layouts: paper-qwen-7b, gemma2-2b (local
    # window), granite-34b; and float32 at 256 over REP 7
    (16, 256, 40, 16, 28, 4, 128, 0, 0.0, torch.bfloat16),
    (16, 256, 40, 16, 8, 4, 256, 100, 50.0, torch.bfloat16),
    (16, 256, 40, 16, 48, 1, 128, 0, 0.0, torch.bfloat16),
    (2, 16, 8, 16, 7, 1, 256, 0, 0.0, torch.float32),
]


def _paged_inputs(dev, case, seed=11):
    B, NP, mp, ps, H, KV, hd, win, cap, dt = case
    g = _gen(seed)
    q = torch.randn(B, 1, H, hd, device=dev, generator=g).to(dt)
    kp = torch.randn(NP, ps, KV, hd, device=dev, generator=g).to(dt)
    vp = torch.randn(NP, ps, KV, hd, device=dev, generator=g).to(dt)
    # a pool smaller than B full rows caps each row at its share of pages
    lens = torch.randint(2, min(mp, NP // B) * ps + 1, (B,), generator=g,
                         device=dev, dtype=torch.int32)
    bt = torch.full((B, mp), NP, dtype=torch.int32)
    perm = torch.randperm(NP, generator=torch.Generator().manual_seed(seed))
    used = 0
    for b in range(B):
        npg = -(-int(lens[b]) // ps)
        bt[b, :npg] = perm[used:used + npg]
        used += npg
    return q, kp, vp, bt.to(dev), lens


@pytest.mark.parametrize("case", PDA_CASES, ids=lambda c: str(c[:9]))
def test_paged_decode_attention_kernel(dev, case):
    B, NP, mp, ps, H, KV, hd, win, cap, dt = case
    q, kp, vp, bt, lens = _paged_inputs(dev, case)
    kw = dict(window=win, attn_softcap=cap)
    n0 = pda.paged_decode_attention.launches
    out = pda.paged_decode_attention(q, kp, vp, bt, ps, lens, **kw)
    torch.cuda.synchronize()
    assert pda.paged_decode_attention.launches == n0 + 1
    ref = pda.paged_decode_attention_plain(q, kp, vp, bt, ps, lens, **kw)
    atol = 1e-4 if dt == torch.float32 else 2e-2
    assert out.dtype == dt
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_matches_dense_kernel_on_identity_table(dev, dtype):
    """Pages laid out in order (slot b owns pages b*mp .. b*mp + mp - 1):
    the pool is the dense cache's bytes, and the two kernels agree bit for
    bit — they run the same loop over the same values."""
    B, mp, ps, H, KV, hd = 4, 8, 16, 8, 2, 64
    L = mp * ps
    g = _gen(12)
    q = torch.randn(B, 1, H, hd, device=dev, generator=g).to(dtype)
    kc = torch.randn(B, L, KV, hd, device=dev, generator=g).to(dtype)
    vc = torch.randn(B, L, KV, hd, device=dev, generator=g).to(dtype)
    lens = torch.tensor([L, 7, 65, 1], dtype=torch.int32, device=dev)
    bt = torch.arange(B * mp, dtype=torch.int32, device=dev).reshape(B, mp)
    out = pda.paged_decode_attention(q, kc.reshape(B * mp, ps, KV, hd),
                                     vc.reshape(B * mp, ps, KV, hd), bt, ps,
                                     lens)
    dense = decode_attn.decode_attention(q, kc, vc, lens)
    torch.cuda.synchronize()
    assert torch.equal(out, dense)


# lengths on both sides of the chunk boundaries (128 positions; 64 too), and
# the whole cache
SPLIT_LENS = [1, 63, 64, 65, 127, 128, 129, 255, 256, 257, 640]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("H,KV,window,cap", [
    (32, 8, 0, 0.0), (25, 5, 0, 30.0), (25, 5, 100, 0.0), (8, 2, 138, 0.0),
    (8, 2, 128, 30.0)])
def test_decode_split_chunk_boundaries(dev, dtype, H, KV, window, cap):
    """Rows whose live range ends or starts on either side of a chunk
    boundary (windows of 100, 128 and 138 cross them): within atol of the
    plain version, one launch per call, the same bits from call to call."""
    B, L, hd = len(SPLIT_LENS), 640, 64
    g = _gen(14)
    q = torch.randn(B, 1, H, hd, device=dev, generator=g).to(dtype)
    kc = torch.randn(B, L, KV, hd, device=dev, generator=g).to(dtype)
    vc = torch.randn(B, L, KV, hd, device=dev, generator=g).to(dtype)
    lens = torch.tensor(SPLIT_LENS, dtype=torch.int32, device=dev)
    kw = dict(window=window, attn_softcap=cap)
    n0 = decode_attn.decode_attention.launches
    out = decode_attn.decode_attention(q, kc, vc, lens, **kw)
    again = decode_attn.decode_attention(q, kc, vc, lens, **kw)
    torch.cuda.synchronize()
    assert decode_attn.decode_attention.launches == n0 + 2
    assert torch.equal(out, again)
    ref = decode_attn.decode_attention_plain(q, kc, vc, lens, **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("ps", [8, 16, 32])
@pytest.mark.parametrize("window", [0, 100])
def test_paged_equals_dense_at_chunk_boundaries(dev, ps, window):
    """The paged kernel on pages at random physical places gives the dense
    kernel's bits at lengths on both sides of chunk boundaries; one launch
    per call; repeats bit-equal."""
    B, L, H, KV, hd = len(SPLIT_LENS), 640, 25, 5, 64
    g = _gen(15)
    q = torch.randn(B, 1, H, hd, device=dev, generator=g).bfloat16()
    kc = torch.randn(B, L, KV, hd, device=dev, generator=g).bfloat16()
    vc = torch.randn(B, L, KV, hd, device=dev, generator=g).bfloat16()
    lens = torch.tensor(SPLIT_LENS, dtype=torch.int32, device=dev)
    mp = L // ps
    NP = B * mp
    perm = torch.randperm(NP, device=dev, generator=g)
    kp = torch.empty(NP, ps, KV, hd, dtype=kc.dtype, device=dev)
    vp = torch.empty_like(kp)
    kp[perm] = kc.reshape(NP, ps, KV, hd)
    vp[perm] = vc.reshape(NP, ps, KV, hd)
    bt = perm.reshape(B, mp).to(torch.int32)
    unmapped = torch.arange(mp, device=dev)[None, :] * ps >= lens[:, None]
    bt = torch.where(unmapped, NP, bt).contiguous()
    n0 = pda.paged_decode_attention.launches
    out = pda.paged_decode_attention(q, kp, vp, bt, ps, lens, window=window)
    again = pda.paged_decode_attention(q, kp, vp, bt, ps, lens,
                                       window=window)
    dense = decode_attn.decode_attention(q, kc, vc, lens, window=window)
    torch.cuda.synchronize()
    assert pda.paged_decode_attention.launches == n0 + 2
    assert torch.equal(out, again)
    assert torch.equal(out, dense)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("H,KV,hd", [(28, 4, 128), (8, 4, 256), (48, 1, 128),
                                     (16, 1, 256)])
def test_paged_equals_dense_wide_heads(dev, dtype, H, KV, hd):
    """Dense and paged at head_dim 128 and 256, REP 7, 2, 48 and 16 (the
    head groups of 8 or 4): within atol of the plain version, and the same
    bits from either cache, at lengths on both sides of chunk boundaries."""
    B, L, ps = len(SPLIT_LENS), 640, 16
    g = _gen(17)
    q = torch.randn(B, 1, H, hd, device=dev, generator=g).to(dtype)
    kc = torch.randn(B, L, KV, hd, device=dev, generator=g).to(dtype)
    vc = torch.randn(B, L, KV, hd, device=dev, generator=g).to(dtype)
    lens = torch.tensor(SPLIT_LENS, dtype=torch.int32, device=dev)
    mp = L // ps
    NP = B * mp
    perm = torch.randperm(NP, device=dev, generator=g)
    kp = torch.empty(NP, ps, KV, hd, dtype=dtype, device=dev)
    vp = torch.empty_like(kp)
    kp[perm] = kc.reshape(NP, ps, KV, hd)
    vp[perm] = vc.reshape(NP, ps, KV, hd)
    bt = perm.reshape(B, mp).to(torch.int32).contiguous()
    dense = decode_attn.decode_attention(q, kc, vc, lens, window=100)
    out = pda.paged_decode_attention(q, kp, vp, bt, ps, lens, window=100)
    torch.cuda.synchronize()
    assert torch.equal(out, dense)
    ref = decode_attn.decode_attention_plain(q, kc, vc, lens, window=100)
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL[dtype],
                               rtol=0)


def test_paged_decode_kernel_reads_sentinel_as_zeros(dev):
    """A sentinel entry inside the live range (which the allocator never
    makes) is not dereferenced: it reads as the zeros the plain gather
    fills in."""
    NP, ps, H, KV, hd = 6, 8, 4, 2, 32
    g = _gen(13)
    q = torch.randn(2, 1, H, hd, device=dev, generator=g)
    kp = torch.randn(NP, ps, KV, hd, device=dev, generator=g)
    vp = torch.randn(NP, ps, KV, hd, device=dev, generator=g)
    bt = torch.tensor([[3, NP, 1], [NP + 7, 0, -1]], dtype=torch.int32,
                      device=dev)
    lens = torch.tensor([20, 24], dtype=torch.int32, device=dev)
    out = pda.paged_decode_attention(q, kp, vp, bt, ps, lens)
    ref = pda.paged_decode_attention_plain(q, kp, vp, bt, ps, lens)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)


# -- fused log-prob ----------------------------------------------------------------


@pytest.mark.parametrize("h_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tied", [True, False], ids=["tied", "lm_head"])
@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_fused_logprob_kernel(dev, h_dtype, tied, cap):
    h, w, t, _, _ = _loss_inputs(dev, 300, 256, 5000, h_dtype, tied)
    n0 = flp.fused_logprob_rows.launches
    logp, lse = flp.fused_logprob_rows(h, w, t, logit_softcap=cap)
    torch.cuda.synchronize()
    assert flp.fused_logprob_rows.launches == n0 + 1
    rlogp, rlse = flp.fused_logprob_plain(h, w, t, logit_softcap=cap)
    torch.testing.assert_close(logp, rlogp, atol=1e-4, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0)


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "lm_head"])
@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_fused_logprob_grad_matches_autograd_through_plain(dev, tied, cap):
    B, S, d, V = 3, 100, 256, 5000
    h, w, t, _, _ = _loss_inputs(dev, B * S, d, V, torch.float32, tied,
                                 seed=14)
    gout = torch.randn(B, S, device=dev, generator=_gen(15))

    def grads(op):
        hh = h.reshape(B, S, d).clone().requires_grad_()
        base = (w.T if tied else w).detach().clone().requires_grad_()
        out = op(hh, base.T if tied else base, t.reshape(B, S))
        hg, wg = torch.autograd.grad(out, (hh, base), gout)
        return out.detach(), hg, wg

    counts = (flp.fused_logprob_rows.launches,
              fio.fused_is_grpo_bwd_dh_rows.launches,
              fio.fused_is_grpo_bwd_dw_rows.launches)
    got = grads(lambda a, b, c: flp.fused_logprob(a, b, c, logit_softcap=cap))
    torch.cuda.synchronize()
    assert (flp.fused_logprob_rows.launches,
            fio.fused_is_grpo_bwd_dh_rows.launches,
            fio.fused_is_grpo_bwd_dw_rows.launches) == tuple(
                n + 1 for n in counts)
    want = grads(lambda a, b, c: flp.fused_logprob_plain(
        a.reshape(B * S, d), b, c.reshape(-1),
        logit_softcap=cap)[0].reshape(B, S))
    torch.testing.assert_close(got[0], want[0], atol=1e-4, rtol=0)
    for x, y in zip(got[1:], want[1:]):
        assert x.shape == y.shape
        torch.testing.assert_close(x, y, rtol=0,
                                   atol=1e-4 * float(y.abs().max()))


def _within_bf16_ulps(got, want, n=2, atol=1e-4):
    """|got - want| <= n bf16 ulps of each element of ``want``, plus the
    float32 atol: the float32 sums before the rounding differ by up to that
    (another summation order), which is more than an ulp of an output that
    is nearly zero."""
    want = want.float()
    mag = want.abs().clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    assert bool(((got.float() - want).abs() <= n * ulp + atol).all())


def _ssm_inputs(B, T, di, N, dtype, g, dev, s0_scale=0.2):
    x = torch.randn(B, T, di, device=dev, generator=g) * 0.5
    dt = torch.nn.functional.softplus(
        torch.randn(B, T, di, device=dev, generator=g)) * 0.1
    A_log = torch.log(torch.randn(di, N, device=dev, generator=g).abs()
                      + 0.5)
    # B and C as the model hands them: views into one projection
    proj = torch.randn(B, T, 3 + 2 * N, device=dev, generator=g) * 0.5
    Bc, Cc = proj[..., 3:3 + N].to(dtype), proj[..., 3 + N:].to(dtype)
    D = torch.randn(di, device=dev, generator=g) * 0.2
    s0 = torch.randn(B, di, N, device=dev, generator=g) * s0_scale
    return x.to(dtype), dt.to(dtype), A_log, Bc, Cc, D, s0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,di,N,masked", [
    (2, 64, 128, 16, False), (1, 50, 64, 8, False), (2, 33, 256, 16, False),
    (16, 1, 3200, 16, False),                 # hymba-1.5b decode
    (3, 70, 3200, 16, True),                  # padded prefill, channel tail
    (2, 2, 3200, 16, False), (2, 2, 200, 8, False),           # T = 2
    (3, 21, 200, 8, True),                    # T not a multiple of 8 steps
    (2, 17, 77, 16, False),                   # x, dt rows not 16-byte aligned
    (3, 1, 200, 8, True),                     # masked decode
])
def test_ssm_scan_kernel(dev, dtype, B, T, di, N, masked):
    g = _gen(5)
    x, dt, A_log, Bc, Cc, D, s0 = _ssm_inputs(B, T, di, N, dtype, g, dev)
    mask = None
    if masked:
        lens = torch.tensor([T, T // 2, 1], device=dev)
        mask = torch.arange(T, device=dev)[None, :] < lens[:, None]
    want_y, want_s = ssm_scan.selective_scan_plain(x, dt, A_log, Bc, Cc, D,
                                                   s0, seq_mask=mask)
    state = s0.clone()
    n0 = ssm_scan.selective_scan.launches
    y, sf = ssm_scan.selective_scan(x, dt, A_log, Bc, Cc, D, state,
                                    seq_mask=mask)
    torch.cuda.synchronize()
    assert ssm_scan.selective_scan.launches == n0 + 1
    assert sf is state and y.dtype == dtype          # state updated in place
    if dtype == torch.float32:
        torch.testing.assert_close(y, want_y, atol=1e-4, rtol=0)
        torch.testing.assert_close(sf, want_s, atol=1e-4, rtol=0)
    else:
        _within_bf16_ulps(y, want_y)
        torch.testing.assert_close(sf, want_s, rtol=0,
                                   atol=1e-4 * float(want_s.abs().max()))


def _scan_agrees(y, sf, want_y, want_s, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(y, want_y, atol=1e-4, rtol=0)
        torch.testing.assert_close(sf, want_s, atol=1e-4, rtol=0)
    else:
        _within_bf16_ulps(y, want_y)
        torch.testing.assert_close(sf, want_s, rtol=0,
                                   atol=1e-4 * float(want_s.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,di,N", [(3, 200, 16), (3, 200, 8),
                                    (16, 3200, 16), (5, 77, 8)])
def test_ssm_scan_decode_kernel(dev, dtype, B, di, N):
    """T = 1 takes the decode kernel (B and C strided views, channel tails
    of a warp and of a block), against the plain version."""
    x, dt, A_log, _, _, D, s0 = _ssm_inputs(B, 1, di, N, dtype, _gen(12),
                                            dev)
    proj = torch.randn(B, 1, 3 + 2 * N, device=dev,
                       generator=_gen(16)).to(dtype)
    Bc, Cc = proj[..., 3:3 + N], proj[..., 3 + N:]   # views, offset 3
    want_y, want_s = ssm_scan.selective_scan_plain(x, dt, A_log, Bc, Cc, D,
                                                   s0)
    state = s0.clone()
    n0 = (ssm_scan.selective_scan.decode_launches,
          ssm_scan.selective_scan.prefill_launches)
    y, sf = ssm_scan.selective_scan(x, dt, A_log, Bc, Cc, D, state)
    torch.cuda.synchronize()
    assert (ssm_scan.selective_scan.decode_launches,
            ssm_scan.selective_scan.prefill_launches) == (n0[0] + 1, n0[1])
    assert sf is state and y.dtype == dtype
    _scan_agrees(y, sf, want_y, want_s, dtype)


def test_ssm_scan_dispatch_by_length(dev):
    """T = 1 counts a decode launch, T > 1 a prefill launch; launches counts
    both."""
    fn = ssm_scan.selective_scan
    for T, N, want in ((1, 16, (1, 1, 0)), (2, 16, (1, 0, 1)),
                       (33, 16, (1, 0, 1)), (1, 8, (1, 1, 0)),
                       (9, 8, (1, 0, 1))):
        args = _ssm_inputs(2, T, 64, N, torch.float32, _gen(13), dev)
        n0 = (fn.launches, fn.decode_launches, fn.prefill_launches)
        fn(*args)
        got = (fn.launches, fn.decode_launches, fn.prefill_launches)
        assert tuple(g - n for g, n in zip(got, n0)) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [8, 16])
def test_ssm_scan_decode_matches_prefill_kernel(dev, dtype, N):
    """At T = 1 the decode kernel agrees with the prefill kernel: the same
    state update, y summed in another order."""
    x, dt, A_log, Bc, Cc, D, s0 = _ssm_inputs(16, 1, 3200, N, dtype,
                                              _gen(14), dev)
    s_dec, s_pre = s0.clone(), s0.clone()
    y_dec = ssm_scan.launch(x, dt, A_log, Bc, Cc, D, s_dec)
    y_pre = ssm_scan.launch(x, dt, A_log, Bc, Cc, D, s_pre,
                            prefill_only=True)
    torch.cuda.synchronize()
    _scan_agrees(y_dec, s_dec, y_pre, s_pre, dtype)


def _wkv6_inputs(B, T, H, hd, dtype, g, dev, *, strong=False):
    r, k, v = (torch.randn(B, T, H, hd, device=dev, generator=g) * 0.5
               for _ in range(3))
    x = torch.randn(B, T, H, hd, device=dev, generator=g)
    # strong: decays down to ~1e-8, as exp(-exp(.)) gives
    w = (torch.exp(-torch.exp(x * 1.2 + 0.9)) if strong
         else torch.sigmoid(x) * 0.5 + 0.45)
    u = torch.randn(H, hd, device=dev, generator=g) * 0.3
    s0 = torch.randn(B, H, hd, hd, device=dev, generator=g) * 0.2
    return [t.to(dtype) for t in (r, k, v, w)] + [u, s0]


def test_wkv6_counts_decode_and_prefill(dev):
    """T = 1 counts a decode launch, T > 1 a prefill launch, at every hd."""
    fn = rwkv6_scan.wkv6
    for T, hd, want in ((1, 32, (1, 1, 0)), (4, 32, (1, 0, 1)),
                        (1, 64, (1, 1, 0)), (2, 64, (1, 0, 1)),
                        (1, 16, (1, 1, 0)), (9, 16, (1, 0, 1))):
        u = torch.zeros(2, hd, device=dev)
        r = torch.randn(2, T, 2, hd, device=dev, generator=_gen(15))
        s = torch.zeros(2, 2, hd, hd, device=dev)
        n0 = (fn.launches, fn.decode_launches, fn.prefill_launches)
        fn(r, r, r, torch.sigmoid(r), u, s)
        got = (fn.launches, fn.decode_launches, fn.prefill_launches)
        assert tuple(g - n for g, n in zip(got, n0)) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,hd,masked", [
    (2, 64, 4, 32, False), (1, 100, 2, 64, False), (2, 33, 3, 16, False),
    (16, 1, 32, 64, False),                   # rwkv6-1.6b decode
    (3, 45, 4, 64, True),                     # padded prefill
    (3, 1, 2, 32, False), (3, 1, 5, 16, False),               # decode, hd
    (2, 2, 3, 64, False), (2, 2, 2, 16, False),               # T = 2
    (3, 19, 2, 32, True),                     # T not a multiple of 8 steps
    (3, 1, 4, 64, True),                      # masked decode
])
def test_wkv6_kernel(dev, dtype, B, T, H, hd, masked):
    r, k, v, w, u, s0 = _wkv6_inputs(B, T, H, hd, dtype, _gen(6), dev)
    mask = None
    if masked:
        lens = torch.tensor([T, T // 3, 1], device=dev)
        mask = torch.arange(T, device=dev)[None, :] < lens[:, None]
    want_y, want_s = rwkv6_scan.wkv6_plain(r, k, v, w, u, s0, seq_mask=mask)
    state = s0.clone()
    n0 = rwkv6_scan.wkv6.launches
    y, sf = rwkv6_scan.wkv6(r, k, v, w, u, state, seq_mask=mask)
    torch.cuda.synchronize()
    assert rwkv6_scan.wkv6.launches == n0 + 1
    assert sf is state and y.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(y, want_y, atol=1e-4, rtol=0)
        torch.testing.assert_close(sf, want_s, atol=1e-4, rtol=0)
    else:
        _within_bf16_ulps(y, want_y)
        torch.testing.assert_close(sf, want_s, rtol=0,
                                   atol=1e-4 * float(want_s.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,hd", [(16, 32, 64), (3, 5, 32), (5, 3, 16)])
def test_wkv6_decode_matches_prefill_kernel(dev, dtype, B, H, hd):
    """At T = 1 the decode kernel agrees with the prefill kernel: the same
    state update, y summed over other row slices."""
    r, k, v, w, u, s0 = _wkv6_inputs(B, 1, H, hd, dtype, _gen(17), dev)
    s_dec, s_pre = s0.clone(), s0.clone()
    y_dec = rwkv6_scan.launch(r, k, v, w, u, s_dec)
    y_pre = rwkv6_scan.launch(r, k, v, w, u, s_pre, prefill_only=True)
    torch.cuda.synchronize()
    _scan_agrees(y_dec, s_dec, y_pre, s_pre, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_kernel_unaligned_inputs(dev, dtype):
    """r, k, v, w that are contiguous but not 16-byte aligned (views one
    element into a buffer): the prefill kernel stages them with plain
    loads instead of cp.async."""
    B, T, H, hd = 2, 19, 3, 32
    args = _wkv6_inputs(B, T, H, hd, dtype, _gen(19), dev)
    n = B * T * H * hd
    views = []
    for t in args[:4]:
        buf = torch.empty(n + 1, device=dev, dtype=dtype)
        buf[1:] = t.reshape(-1)
        views.append(buf[1:].view(B, T, H, hd))
    assert all(t.data_ptr() % 16 for t in views)
    want_y, want_s = rwkv6_scan.wkv6_plain(*args)
    y, sf = rwkv6_scan.wkv6(*views, args[4], args[5].clone())
    torch.cuda.synchronize()
    _scan_agrees(y, sf, want_y, want_s, dtype)


@pytest.mark.parametrize("T", [1, 40])
def test_wkv6_kernel_strong_decay(dev, T):
    """Decays down to ~1e-8: float32 outputs and states within atol 1e-4 of
    the plain version."""
    args = _wkv6_inputs(3, T, 4, 64, torch.float32, _gen(18), dev,
                        strong=True)
    assert float(args[3].min()) < 1e-6
    want_y, want_s = rwkv6_scan.wkv6_plain(*args)
    y, sf = rwkv6_scan.wkv6(*args[:5], args[5].clone())
    torch.cuda.synchronize()
    _scan_agrees(y, sf, want_y, want_s, torch.float32)


# -- the scans' backward kernels ---------------------------------------------


def _bwd_agrees(got, want):
    """Each gradient against the plain backward's: float32 within 1e-4 of
    its largest element (sums over channels, rows or steps in another
    order); bfloat16 within two bf16 ulps of each element plus that (both
    sides compute in float32 and round once)."""
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert x.shape == y.shape and x.dtype == y.dtype
        scale = float(y.float().abs().max())
        if x.dtype == torch.bfloat16:
            _within_bf16_ulps(x, y, atol=1e-4 * scale)
        else:
            torch.testing.assert_close(x, y, rtol=0, atol=1e-4 * scale)


def _ssm_bwd_case(B, T, di, N, dtype, dev, *, strong=False, dstate=False,
                  seed=20):
    g = _gen(seed)
    x, dt, A_log, Bc, Cc, D, s0 = _ssm_inputs(B, T, di, N, dtype, g, dev)
    if strong:
        # the model's A_log = log(1..N) and steps up to 1.5: decays down to
        # exp(-16 * 1.5) ~ 4e-11
        A_log = torch.log(torch.arange(1, N + 1, device=dev,
                                       dtype=torch.float32)).repeat(di, 1)
        dt = (torch.rand(B, T, di, device=dev, generator=g) * 1.5).to(dtype)
    dy = torch.randn(B, T, di, device=dev, generator=g).to(dtype)
    ds = (torch.randn(B, di, N, device=dev, generator=g) if dstate
          else None)
    return (x, dt, A_log, Bc, Cc, D, s0), dy, ds


# the JAX kernel tests' cases, T = 1 and 2, both sides of the 8-step chunk,
# hymba-1.5b's width (40 blocks of 80 channels), channel tails
SSM_BWD_CASES = [
    (2, 64, 128, 16), (1, 50, 64, 8), (2, 33, 256, 16),
    (2, 1, 200, 16), (3, 2, 200, 8), (2, 7, 128, 16), (2, 8, 77, 8),
    (2, 9, 200, 16), (1, 17, 160, 8), (3, 21, 3200, 16),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,di,N", SSM_BWD_CASES)
def test_ssm_scan_bwd_kernel(dev, dtype, B, T, di, N):
    """``ssm_scan_bwd`` against ``selective_scan_bwd_plain``, with a nonzero
    final-state gradient on every other case; the state left as it was."""
    args, dy, ds = _ssm_bwd_case(B, T, di, N, dtype, dev, dstate=T % 2 == 1)
    s0 = args[6].clone()
    got = ssm_scan.launch_bwd(*args, dy, ds)
    torch.cuda.synchronize()
    assert torch.equal(args[6], s0)
    _bwd_agrees(got, ssm_scan.selective_scan_bwd_plain(*args, dy, ds))


@pytest.mark.parametrize("T", [1, 9, 40])
def test_ssm_scan_bwd_kernel_strong_decay(dev, T):
    """Decays down to ~1e-11 in float32: every gradient within 1e-4 of its
    largest element, the states never recovered by dividing by a decay."""
    args, dy, ds = _ssm_bwd_case(3, T, 200, 16, torch.float32, dev,
                                 strong=True, dstate=True)
    got = ssm_scan.launch_bwd(*args, dy, ds)
    torch.cuda.synchronize()
    _bwd_agrees(got, ssm_scan.selective_scan_bwd_plain(*args, dy, ds))


def test_ssm_scan_bwd_kernel_bit_equal(dev):
    """Two launches give the same bits: the cross-block partials are summed
    in a fixed order, never by float atomics."""
    args, dy, ds = _ssm_bwd_case(4, 27, 3200, 16, torch.bfloat16, dev,
                                 dstate=True)
    one = ssm_scan.launch_bwd(*args, dy, ds)
    two = ssm_scan.launch_bwd(*args, dy, ds)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(one, two))


@pytest.mark.parametrize("masked", [False, True])
def test_ssm_scan_autograd_runs_the_kernels(dev, masked):
    """With grad on, ``selective_scan`` runs the forward kernel on a copy of
    the state and the backward kernel (one launch each, counted), and its
    gradients equal autograd's through the plain version: the mask applied
    to dt outside, B and C read as views of one projection."""
    B, T, di, N = 3, 19, 200, 16
    g = _gen(21)
    args = list(_ssm_inputs(B, T, di, N, torch.float32, g, dev))
    mask = None
    if masked:
        mask = torch.arange(T, device=dev)[None, :] < torch.tensor(
            [T, 7, 1], device=dev)[:, None]
    proj = torch.randn(B, T, 5 + 2 * N, device=dev, generator=g)
    dy = torch.randn(B, T, di, device=dev, generator=g)

    def run(fn):
        leaves = ([a.clone().requires_grad_() for a in args[:3]]
                  + [proj.clone().requires_grad_(),
                     args[5].clone().requires_grad_()])
        x, dt, A_log, p, D = leaves
        y, sf = fn(x, dt, A_log, p[..., 5:5 + N], p[..., 5 + N:], D,
                   args[6].clone(), seq_mask=mask)
        (y * dy).sum().backward()
        return [y.detach(), sf.detach()] + [t.grad for t in leaves]

    fn = ssm_scan.selective_scan
    n0 = (fn.launches, fn.bwd_launches)
    got = run(fn)
    torch.cuda.synchronize()
    assert (fn.launches, fn.bwd_launches) == (n0[0] + 1, n0[1] + 1)
    want = run(ssm_scan.selective_scan_plain)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=0,
                                   atol=1e-4 * float(y.abs().max()))


def _wkv6_bwd_case(B, T, H, hd, dtype, dev, *, strong=False, dstate=False,
                   seed=30):
    g = _gen(seed)
    args = _wkv6_inputs(B, T, H, hd, dtype, g, dev, strong=strong)
    dy = torch.randn(B, T, H, hd, device=dev, generator=g).to(dtype)
    ds = (torch.randn(B, H, hd, hd, device=dev, generator=g) if dstate
          else None)
    return args, dy, ds


# the JAX kernel tests' cases, T = 1 and 2, both sides of the 3-step chunk,
# every hd
WKV6_BWD_CASES = [
    (2, 64, 4, 32), (1, 100, 2, 64), (2, 33, 3, 16),
    (3, 1, 2, 64), (2, 2, 3, 32), (2, 3, 2, 16), (2, 4, 2, 64),
    (2, 5, 3, 64), (1, 9, 5, 32), (4, 27, 32, 64),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,hd", WKV6_BWD_CASES)
def test_wkv6_bwd_kernel(dev, dtype, B, T, H, hd):
    """``wkv6_bwd`` against ``wkv6_bwd_plain``, with a nonzero final-state
    gradient on every other case; the state left as it was."""
    args, dy, ds = _wkv6_bwd_case(B, T, H, hd, dtype, dev, dstate=T % 2 == 1)
    s0 = args[5].clone()
    got = rwkv6_scan.launch_bwd(*args, dy, ds)
    torch.cuda.synchronize()
    assert torch.equal(args[5], s0)
    _bwd_agrees(got, rwkv6_scan.wkv6_bwd_plain(*args, dy, ds))


@pytest.mark.parametrize("T", [1, 6, 40])
def test_wkv6_bwd_kernel_strong_decay(dev, T):
    """Decays down to ~1e-8 in float32: every gradient within 1e-4 of its
    largest element, the states never recovered by dividing by a decay."""
    args, dy, ds = _wkv6_bwd_case(3, T, 4, 64, torch.float32, dev,
                                  strong=True, dstate=True)
    assert float(args[3].min()) < 1e-6
    got = rwkv6_scan.launch_bwd(*args, dy, ds)
    torch.cuda.synchronize()
    _bwd_agrees(got, rwkv6_scan.wkv6_bwd_plain(*args, dy, ds))


def test_wkv6_bwd_kernel_bit_equal(dev):
    """Two launches give the same bits (du's partials summed in a fixed
    order)."""
    args, dy, ds = _wkv6_bwd_case(4, 27, 32, 64, torch.bfloat16, dev,
                                  dstate=True)
    one = rwkv6_scan.launch_bwd(*args, dy, ds)
    two = rwkv6_scan.launch_bwd(*args, dy, ds)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(one, two))


@pytest.mark.parametrize("masked", [False, True])
def test_wkv6_autograd_runs_the_kernels(dev, masked):
    """With grad on, ``wkv6`` runs the forward kernel on a copy of the state
    and the backward kernel (one launch each, counted), and its gradients
    equal autograd's through the plain version, the mask applied to k and w
    outside."""
    B, T, H, hd = 3, 19, 2, 32
    args = _wkv6_inputs(B, T, H, hd, torch.float32, _gen(31), dev)
    mask = None
    if masked:
        mask = torch.arange(T, device=dev)[None, :] < torch.tensor(
            [T, 7, 1], device=dev)[:, None]
    dy = torch.randn(B, T, H, hd, device=dev, generator=_gen(32))

    def run(fn):
        leaves = [a.clone().requires_grad_() for a in args[:5]]
        y, sf = fn(*leaves, args[5].clone(), seq_mask=mask)
        (y * dy).sum().backward()
        return [y.detach(), sf.detach()] + [t.grad for t in leaves]

    fn = rwkv6_scan.wkv6
    n0 = (fn.launches, fn.bwd_launches)
    got = run(fn)
    torch.cuda.synchronize()
    assert (fn.launches, fn.bwd_launches) == (n0[0] + 1, n0[1] + 1)
    want = run(rwkv6_scan.wkv6_plain)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=0,
                                   atol=1e-4 * float(y.abs().max()))


@pytest.mark.parametrize("R", [100, 4064])
def test_fused_loss_at_hymba_width(dev, R):
    """The fused IS-GRPO loss at hymba-1.5b's update shape: bf16 hidden of
    d 1600 (25 k tiles of 64) against the tied embedding read as w (V 32001,
    ragged): the forward's per-row outputs atol 1e-4, dh within one bf16 ulp
    of its largest element, dw within 1e-4 of its largest element."""
    d, V = 1600, 32001
    h, w, t, b, a = _loss_inputs(dev, R, d, V, torch.bfloat16, True, seed=R)
    kw = dict(LOSS_KW, entropy_coef=0.01)
    outs = fio.fused_is_grpo_fwd_rows(h, w, t, b, a, **kw)
    ref = fio.fwd_plain(h, w, t, b, a, **kw)
    for name, x, y in zip(("loss", "ratio", "logp", "lse", "ent"), outs, ref):
        torch.testing.assert_close(x, y, atol=1e-4, rtol=1e-5, msg=name)
    g = _gen(33)
    ca = torch.randn(R, device=dev, generator=g)
    ce = torch.randn(R, device=dev, generator=g) * 0.1
    lse, ent = ref[3], ref[4]
    dh, dw = fio.fused_is_grpo_bwd_rows(h, w, t, lse, lse - ent, ca, ce)
    torch.cuda.synchronize()
    rdh, rdw = fio.bwd_plain(h, w, t, lse, lse - ent, ca, ce)
    assert dw.stride() == w.stride()
    torch.testing.assert_close(dh.float(), rdh.float(), rtol=0,
                               atol=1e-2 * float(rdh.abs().max()))
    torch.testing.assert_close(dw, rdw, rtol=0,
                               atol=1e-4 * float(rdw.abs().max()))
