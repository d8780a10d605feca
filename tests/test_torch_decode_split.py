"""The dense decode attention over a slice of the cache (``start``) with its
log-sum-exp (``return_lse``): the pieces of the length-split cache that
sharded serving merges over the "model" ranks (``models/attention.py``).

* On the CPU, the plain version: a cache cut into 2, 3 or 4 slices, each
  slice decoded with its ``start``, the slices merged by the log-sum-exp
  rule (m = max lse, w = exp(lse - m), out = sum w o / sum w), equals the
  whole cache, float32 atol 1e-5, with and without a window and a softcap;
  rows whose slice holds no live position (past cache_len, or before the
  window) return zeros and an lse of -inf; the whole cache's lse is the
  log-sum-exp of its scores.
* ``merge_slices`` on a one-rank gloo group is the identity.
* With ``return_lse`` the output is float32 (unrounded: the slices merge
  before their one rounding).
* On the card (marked ``cuda``; no JAX here, so the GPU machine runs it
  with ``--noconftest -m cuda``): the kernel's output and lse against the
  plain version's at every ``start`` of a 4-way split, float32 atol 1e-4
  (bfloat16 inputs 2e-2 for the output, 1e-4 for the lse, which both keep
  in float32), and the merged slices, rounded once, against the
  whole-cache kernel (bf16: within one ulp of each element, plus 1e-5).
"""
import math

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.hopper import decode_attn  # noqa: E402
from repro_torch.models.attention import merge_slices  # noqa: E402

torch.set_num_threads(1)


def _inputs(B=4, L=48, H=8, KV=2, hd=32, dtype=torch.float32, seed=0,
            device="cpu"):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, 1, H, hd, generator=g).to(device, dtype)
    k = torch.randn(B, L, KV, hd, generator=g).to(device, dtype)
    v = torch.randn(B, L, KV, hd, generator=g).to(device, dtype)
    # row 0 full, row 1 inside the first slice only, row 2 mid-cache, row 3
    # a single live position
    lens = torch.tensor([L, 5, L // 2 + 3, 1][:B], dtype=torch.int32,
                        device=device)
    return q, k, v, lens


def _merge(parts):
    """The log-sum-exp merge of (out, lse) slices, in one process."""
    lse = torch.stack([p[1] for p in parts])                 # (n, B, H)
    m = lse.amax(0)
    w = torch.exp(lse - torch.where(torch.isfinite(m), m, 0.0))
    num = sum(p[0].float() * wi[:, None, :, None]
              for p, wi in zip(parts, w))
    return num / w.sum(0).clamp_min(1e-30)[:, None, :, None]


def _slices(fn, q, k, v, lens, n, **kw):
    size = k.shape[1] // n
    return [fn(q, k[:, i * size:(i + 1) * size].contiguous(),
               v[:, i * size:(i + 1) * size].contiguous(), lens,
               start=i * size, return_lse=True, **kw) for i in range(n)]


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (7, 0.0), (20, 30.0)])
def test_plain_slices_merge_to_whole(n, window, cap):
    q, k, v, lens = _inputs()
    whole = decode_attn.decode_attention_plain(q, k, v, lens, window=window,
                                               attn_softcap=cap)
    parts = _slices(decode_attn.decode_attention_plain, q, k, v, lens, n,
                    window=window, attn_softcap=cap)
    np.testing.assert_allclose(_merge(parts).numpy(), whole.numpy(),
                               atol=1e-5)
    size = k.shape[1] // n
    for i, (out, lse) in enumerate(parts):
        lo = i * size
        for b, c in enumerate(lens.tolist()):
            live = min(c, lo + size) > max(lo, c - window if window else 0)
            if not live:            # an empty slice: zeros and -inf
                assert torch.all(out[b] == 0)
                assert torch.all(lse[b] == -math.inf)
            else:
                assert torch.all(torch.isfinite(lse[b]))


def test_plain_whole_lse_is_logsumexp_of_scores():
    q, k, v, lens = _inputs()
    out, lse = decode_attn.decode_attention_plain(q, k, v, lens,
                                                  return_lse=True)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(
        out.numpy(), decode_attn.decode_attention_plain(q, k, v, lens).numpy())
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    ob, _ = decode_attn.decode_attention_plain(qb, kb, vb, lens,
                                               return_lse=True)
    assert ob.dtype == torch.float32
    B, _, H, hd = q.shape
    rep = H // k.shape[2]
    kf = k.repeat_interleave(rep, dim=2)                       # (B, L, H, hd)
    s = torch.einsum("bhd,blhd->bhl", q[:, 0], kf) * hd ** -0.5
    pos = torch.arange(k.shape[1])
    s = torch.where(pos[None, None] < lens[:, None, None], s, -math.inf)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(),
                               atol=1e-5)


def test_merge_slices_one_rank_group_is_identity():
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_single_process_group
    init_single_process_group("cpu")
    try:
        q, k, v, lens = _inputs()
        out, lse = decode_attn.decode_attention_plain(q, k, v, lens,
                                                      return_lse=True)
        np.testing.assert_allclose(
            merge_slices(out, lse, dist.group.WORLD).numpy(), out.numpy(),
            atol=1e-6)
    finally:
        dist.destroy_process_group()


# -- on the card ------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,hd,window,cap", [
    (32, 8, 64, 0, 0.0), (48, 1, 128, 0, 0.0), (8, 4, 256, 100, 50.0),
    (4, 2, 32, 0, 0.0)])
def test_kernel_start_and_lse_match_plain(dev, dtype, H, KV, hd, window,
                                          cap):
    B, L = 5, 640
    q, k, v, _ = _inputs(B, L, H, KV, hd, dtype, seed=3, device=dev)
    lens = torch.tensor([640, 129, 300, 1, 511], dtype=torch.int32,
                        device=dev)
    atol = 1e-4 if dtype == torch.float32 else 2e-2
    kw = dict(window=window, attn_softcap=cap)
    got = _slices(decode_attn.decode_attention, q, k, v, lens, 4, **kw)
    want = _slices(decode_attn.decode_attention_plain, q, k, v, lens, 4, **kw)
    for (o, lse), (o_ref, lse_ref) in zip(got, want):
        assert lse.dtype == o.dtype == torch.float32 and lse.shape == (B, H)
        np.testing.assert_allclose(o.float().cpu().numpy(),
                                   o_ref.float().cpu().numpy(), atol=atol)
        np.testing.assert_allclose(lse.cpu().numpy(), lse_ref.cpu().numpy(),
                                   atol=1e-4)
    whole = decode_attn.decode_attention(q, k, v, lens, **kw).float()
    merged = _merge(got).to(dtype).float()
    ulp = torch.exp2(torch.floor(torch.log2(
        whole.abs().clamp_min(2.0 ** -126))) - 7)
    tol = 1e-5 if dtype == torch.float32 else ulp + 1e-5
    assert bool(((merged - whole).abs() <= tol).all()), \
        float((merged - whole).abs().max())
