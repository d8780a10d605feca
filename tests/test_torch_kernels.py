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
go through bf16 rounding of each output); bfloat16 runs the tensor-core
kernels, float32 the SIMT ones, and the bf16 backward is bit-equal from
call to call. The fused IS+GRPO kernels compute
in float32 like their plain versions: per-row outputs atol 1e-4, dh/dw
atol 1e-4 relative to their largest element (sums over V or over rows in
another order), 1e-2 for a bf16 dh (one bf16 ulp). The paged decode
kernel: as the dense one (float32 1e-4, bfloat16 2e-2), and on an identity
block table bit-equal to the dense kernel, whose loop it shares. The fused
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


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,S,H,KV,hd,window,cap", [
    (2, 128, 8, 2, 64, 0, 0.0),
    (1, 100, 4, 4, 64, 0, 0.0),
    (2, 192, 8, 2, 64, 48, 0.0),
    (1, 64, 4, 2, 32, 0, 30.0),
    (16, 512, 25, 5, 64, 1024, 0.0),          # hymba-1.5b prefill: H/KV = 5
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


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("B,S,H,KV,hd,window,cap", [
    (2, 127, 8, 2, 64, 0, 0.0),
    (1, 100, 4, 4, 64, 40, 0.0),
    (2, 70, 4, 1, 32, 0, 20.0),
    (2, 150, 8, 2, 32, 0, 30.0),              # hd 32, softcap, ragged tiles
    (2, 150, 8, 2, 32, 48, 30.0),             # and a window
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
        torch.testing.assert_close(a.float(), b.float(), atol=atol, rtol=0,
                                   msg=name)


# the main paths' bf16 shapes: train (with lse), serve prefill, hymba prefill
TC_SHAPES = [
    (32, 127, 32, 8, 64, 0),
    (16, 512, 32, 8, 64, 0),
    (16, 512, 25, 5, 64, 1024),
]


def _flash_inputs(B, S, H, KV, hd, seed):
    g = _gen(seed)
    return [torch.randn(B, S, n, hd, device="cuda", generator=g).bfloat16()
            for n in (H, KV, KV, H)]


@pytest.mark.parametrize("B,S,H,KV,hd,window", TC_SHAPES,
                         ids=["train", "serve", "hymba"])
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
        torch.testing.assert_close(a.float(), b.float(), atol=5e-2, rtol=0,
                                   msg=name)


def test_flash_attention_bwd_tc_is_deterministic(dev):
    """No atomics: two backward calls give the same bits."""
    q, k, v, do = _flash_inputs(*TC_SHAPES[0][:5], 10)
    out, lse = flash_attn.flash_attention(q, k, v, return_lse=True)
    first = flash_attn.flash_attention_bwd(q, k, v, out, lse, do)
    second = flash_attn.flash_attention_bwd(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_attention_tc_refuses_head_dim_128(dev):
    q, k, v, do = _flash_inputs(1, 64, 4, 2, 128, 11)
    with pytest.raises(TypeError, match="head_dim"):
        flash_attn.flash_attention(q, k, v)
    out = torch.zeros_like(q)
    lse = torch.zeros(1, 4, 64, device=dev)
    with pytest.raises(TypeError, match="head_dim"):
        flash_attn.flash_attention_bwd(q, k, v, out, lse, do)


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


def test_fused_is_grpo_bwd_row_chunks(dev, monkeypatch):
    """Rows in several chunks of the dl scratch: dw accumulates over them."""
    R, d, V = 300, 128, 3000
    h, w, t, b, _ = _loss_inputs(dev, R, d, V, torch.float32, True, seed=8)
    _, _, _, lse, ent = fio.fwd_plain(h, w, t, b, b)
    ca = torch.randn(R, device=dev, generator=_gen(9))
    ce = torch.zeros(R, device=dev)
    monkeypatch.setattr(fio, "DL_SCRATCH_ELEMS", 128 * V)   # 3 chunks
    n0 = fio.fused_is_grpo_bwd_dw_rows.launches
    dh, dw = fio.fused_is_grpo_bwd_rows(h, w, t, lse, lse - ent, ca, ce)
    torch.cuda.synchronize()
    assert fio.fused_is_grpo_bwd_dw_rows.launches == n0 + 3
    rdh, rdw = fio.bwd_plain(h, w, t, lse, lse - ent, ca, ce)
    torch.testing.assert_close(dw, rdw, atol=1e-4 * float(rdw.abs().max()),
                               rtol=0)
    torch.testing.assert_close(dh, rdh, atol=1e-4 * float(rdh.abs().max()),
                               rtol=0)



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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,hd,masked", [
    (2, 64, 4, 32, False), (1, 100, 2, 64, False), (2, 33, 3, 16, False),
    (16, 1, 32, 64, False),                   # rwkv6-1.6b decode
    (3, 45, 4, 64, True),                     # padded prefill
])
def test_wkv6_kernel(dev, dtype, B, T, H, hd, masked):
    g = _gen(6)
    r, k, v = (torch.randn(B, T, H, hd, device=dev, generator=g) * 0.5
               for _ in range(3))
    w = torch.sigmoid(torch.randn(B, T, H, hd, device=dev, generator=g)) \
        * 0.5 + 0.45
    r, k, v, w = (t.to(dtype) for t in (r, k, v, w))
    u = torch.randn(H, hd, device=dev, generator=g) * 0.3
    s0 = torch.randn(B, H, hd, hd, device=dev, generator=g) * 0.2
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


def test_scan_kernels_refuse_grad(dev):
    g = _gen(7)
    x, dt, A_log, Bc, Cc, D, s0 = _ssm_inputs(2, 4, 64, 16, torch.float32, g,
                                              dev)
    with pytest.raises(NotImplementedError, match="backward scan kernels"):
        ssm_scan.selective_scan(x.requires_grad_(), dt, A_log, Bc, Cc, D, s0)
    r = torch.randn(2, 4, 2, 32, device=dev, generator=g)
    u = torch.zeros(2, 32, device=dev, requires_grad=True)
    s = torch.zeros(2, 2, 32, 32, device=dev)
    with pytest.raises(NotImplementedError, match="backward scan kernels"):
        rwkv6_scan.wkv6(r, r, r, torch.sigmoid(r), u, s)
    with torch.no_grad():
        rwkv6_scan.wkv6(r, r, r, torch.sigmoid(r), u, s)
