"""The port's paged KV backend on the CPU, against the JAX package:

* the plain paged decode attention (``paged_gather_kv`` + ``decode_attention``)
  against the JAX oracle ``ref.paged_decode_attention`` and the Pallas
  kernel in interpret mode, on the JAX kernel tests' four cases and four at
  head_dim 128 and 256 (REP 7 and 48, a window, a softcap): atol 3e-5
  for float32, 3e-2 for bfloat16 (the Pallas kernel rounds its
  probabilities to bf16 inside an online softmax);
* the model: paged ``decode_step`` equals dense bit for bit; the paged
  write drops a full slot's and a sentinel page's write;
* ``PagedCache``: allocator exhaustion, dry-run ``grow``, copy-on-write
  refcounts, random-operation invariants, page-list snapshots, and the
  flush of pending copies before a preemption snapshot;
* the engine: paged equals dense (sync, copris, randomized admission
  orders), one prefill per group, admission pressure with blocking and
  preemption, kv_snapshot resume under preemption, and the port's paged
  engine against the JAX paged engine (tokens equal, logps atol 1e-5);
* serving: paged returns the dense token streams;
* the MoE and VLM configs: paged equals dense on the two MoE smoke configs
  with the capacity-bounded dispatch at ``capacity_factor=16.0`` (no
  (token, k) pair dropped, so a request's tokens do not depend on the rows
  it is prefilled beside, and the two backends may batch differently); the
  VLM's media K/V (``mk``/``mv``, per slot) travel in both backends'
  snapshots and come back in another slot, and a paged kv_snapshot run
  under preemption equals the dense run.

Paged equals dense: tokens equal; behaviour logps equal to atol 1e-6 with
prefix sharing on — a shared prefill runs fewer rows, and the CPU GEMM's
rounding may depend on the row count — and bit for bit with it off and in
the kv_snapshot preemption scenario.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.common.config import RolloutConfig as JRolloutConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.rollout import RolloutEngine as JRolloutEngine  # noqa: E402
from repro.data.tasks import AdditionTask as JAdditionTask  # noqa: E402
from repro.kernels.paged_decode_attn import ops as pda_ops  # noqa: E402
from repro.kernels.paged_decode_attn import ref as pda_ref  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.common.config import RolloutConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.rollout import RolloutEngine  # noqa: E402
from repro_torch.core.trajectory import Trajectory  # noqa: E402
from repro_torch.data.tasks import EOS, AdditionTask  # noqa: E402
from repro_torch.hopper import paged_decode_attn as pda  # noqa: E402
from repro_torch.launch.serve import (GenerateRequest,  # noqa: E402
                                      make_serve_engine)
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.sampling import kv_cache as kvc  # noqa: E402
from repro_torch.sampling import prng  # noqa: E402

torch.set_num_threads(1)
CFG = get_config("tiny")


@pytest.fixture(scope="module")
def params():
    return M.init_params(CFG, seed=0, device="cpu")


# -- paged decode attention: plain version vs the JAX oracle and kernel -------

PDA_CASES = [
    # B, NP, max_pages, ps, H, KV, hd, win, cap, dtype
    (2, 12, 4, 16, 4, 2, 64, 0, 0.0, "float32"),
    (3, 20, 6, 8, 8, 8, 32, 0, 30.0, "float32"),
    (2, 16, 8, 16, 4, 1, 64, 48, 0.0, "float32"),
    (1, 9, 3, 32, 5, 5, 64, 0, 0.0, "bfloat16"),
    # the published head dims: REP 7 and 48 at 128, 256 with a window and a
    # softcap, and REP 7 at 128 in bfloat16
    (2, 12, 4, 16, 7, 1, 128, 0, 0.0, "float32"),
    (2, 12, 4, 16, 48, 1, 128, 0, 0.0, "float32"),
    (2, 16, 8, 16, 4, 2, 256, 40, 50.0, "float32"),
    (1, 9, 3, 32, 7, 1, 128, 0, 0.0, "bfloat16"),
]


def _block_tables(B, NP, max_pages, ps, cache_len, rng):
    """Scattered physical pages with sentinel (NP) tails."""
    bt = np.full((B, max_pages), NP, np.int32)
    for b in range(B):
        npg = -(-int(cache_len[b]) // ps)
        bt[b, :npg] = rng.choice(NP, npg, replace=False)
    return bt


def pda_inputs(case, seed=0):
    """Numpy inputs of one case (float32 values; bf16 cases round them)."""
    B, NP, mp, ps, H, KV, hd, win, cap, dt = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    kp = rng.standard_normal((NP, ps, KV, hd)).astype(np.float32)
    vp = rng.standard_normal((NP, ps, KV, hd)).astype(np.float32)
    cl = ((np.arange(B) * 29) % (mp * ps - 2) + 2).astype(np.int32)
    bt = _block_tables(B, NP, mp, ps, cl, rng)
    return q, kp, vp, bt, cl


@pytest.mark.parametrize("case", PDA_CASES, ids=lambda c: f"{c[:8]}-{c[9]}")
def test_paged_attention_plain_matches_jax(case):
    B, NP, mp, ps, H, KV, hd, win, cap, dt = case
    q, kp, vp, bt, cl = pda_inputs(case)
    jdt, tdt = getattr(jnp, dt), getattr(torch, dt)
    jx = [jnp.asarray(a).astype(jdt) for a in (q, kp, vp)]
    kw = dict(window=win, attn_softcap=cap)
    ref = pda_ref.paged_decode_attention(*jx, jnp.asarray(bt), ps,
                                         jnp.asarray(cl), **kw)
    pal = pda_ops.paged_decode_attention(*jx, jnp.asarray(bt), ps,
                                         jnp.asarray(cl), **kw)
    tx = [torch.from_numpy(a).to(tdt) for a in (q, kp, vp)]
    n0 = pda.paged_decode_attention.launches
    out = pda.paged_decode_attention(*tx, torch.from_numpy(bt), ps,
                                     torch.from_numpy(cl), **kw)
    assert pda.paged_decode_attention.launches == n0   # CPU: the plain path
    assert out.dtype == tdt and out.shape == (B, 1, H, hd)
    atol = 3e-5 if dt == "float32" else 3e-2
    got = out.float().numpy()
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), atol=atol)
    np.testing.assert_allclose(got, np.asarray(pal, np.float32), atol=atol)


def test_paged_gather_never_reads_a_sentinel_page():
    """Sentinel entries gather as zeros by masking: the pool's last page is
    not what they read."""
    pool = torch.ones(3, 4, 1, 2)
    bt = torch.tensor([[2, 3], [3, 0]], dtype=torch.int32)   # 3 = sentinel
    out = attn.paged_gather_kv(pool, bt, 4)
    assert out.shape == (2, 8, 1, 2)
    assert (out[0, :4] == 1).all() and (out[0, 4:] == 0).all()
    assert (out[1, :4] == 0).all() and (out[1, 4:] == 1).all()


# -- the model ------------------------------------------------------------------


def _backend(pool=4, max_len=32, ps=8, npg=0):
    return kvc.PagedCache(CFG, pool=pool, max_len=max_len, page_size=ps,
                          num_pages=npg, device="cpu")


def _prefill_paged(params, b, toks, lengths):
    """Prefill ``toks`` into a scratch cache and insert it into backend
    ``b``'s slots 0..B-1; returns the prefill logits."""
    B, P = toks.shape
    scratch = M.init_cache(CFG, B, P, device="cpu")
    logits, scratch = M.prefill(params, CFG, toks, lengths, scratch)
    flat_pos = np.full((B, P), b.num_pages * b.page_size, np.int32)
    for i in range(B):
        fp = b.alloc_slot_prefix(i, int(lengths[i]))
        flat_pos[i, :len(fp)] = fp
    kvc.paged_insert_rows(b.cache, scratch, np.arange(B), np.arange(B),
                          flat_pos)
    return logits


def test_paged_matches_dense_model_decode(params):
    """Prefill + 6 decode steps: the paged cache path must give the dense
    cache path's logits bit for bit."""
    B, P, MAXLEN, PS = 3, 8, 32, 8
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, CFG.vocab_size, (B, P)))
    lengths = torch.tensor([P, P - 2, P - 1], dtype=torch.int32)
    dense = M.init_cache(CFG, B, MAXLEN, device="cpu")
    logits_d, dense = M.prefill(params, CFG, toks, lengths, dense)
    b = _backend(pool=B, max_len=MAXLEN, ps=PS)
    logits_p = _prefill_paged(params, b, toks, lengths)
    assert torch.equal(logits_d, logits_p)
    cl = lengths
    for _ in range(6):
        copies = []
        for i in range(B):
            assert b.grow(i, int(cl[i]) + 1, int(cl[i]), copies)
        b.apply_copies(copies)
        tok = torch.from_numpy(rng.integers(0, CFG.vocab_size, B))
        ld, dense = M.decode_step(params, CFG, tok, dense, cl)
        lp, _ = M.decode_step(params, CFG, tok, b.cache, cl,
                              paged=(b.block_table_device(), PS))
        assert torch.equal(ld, lp)
        cl = cl + 1


def test_paged_write_full_slot_drops():
    """A write at cache_len == max_pages * page_size (slot fully written) or
    through a sentinel page must DROP — into the sink page — instead of
    clamping into a live page."""
    NP, ps, mp, KV, hd = 5, 8, 2, 2, 4
    pool = attn.paged_pool(NP, ps, KV, hd, torch.float32, "cpu")
    bt = torch.tensor([[0, 1]], dtype=torch.int32)           # fully mapped
    new = torch.ones(1, 1, KV, hd)
    attn.paged_write_kv(pool, new, bt, ps, torch.tensor([mp * ps]))
    assert (pool == 0).all()
    # a dead slot (all-sentinel row) beside a live one: only the live lands
    bt2 = torch.tensor([[NP, NP], [0, 1]], dtype=torch.int32)
    attn.paged_write_kv(pool, torch.ones(2, 1, KV, hd) * 3, bt2, ps,
                        torch.tensor([3, ps]))
    assert (pool[1, 0] == 3).all()
    pool[1, 0] = 0
    assert (pool == 0).all()
    # an in-range write still lands (page 1, offset 0)
    attn.paged_write_kv(pool, new, bt, ps, torch.tensor([ps]))
    assert (pool[1, 0] == 1).all()
    with pytest.raises(ValueError, match="sink"):
        attn.paged_write_kv(torch.zeros(NP, ps, KV, hd), new, bt, ps,
                            torch.tensor([0]))


def test_paged_snapshot_roundtrip(params):
    """extract_snapshot returns a page-list blob (never a dense slice) that
    insert_snapshot restores bit-identically into another pool."""
    B, P, PS = 2, 8, 8
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, CFG.vocab_size, (B, P)))
    lengths = torch.tensor([P, P - 3], dtype=torch.int32)
    b = _backend(pool=B, max_len=32, ps=PS)
    _prefill_paged(params, b, toks, lengths)
    snap = b.extract_snapshot(1)
    assert isinstance(snap, dict) and snap["page_count"] == 1
    b2 = _backend(pool=3, max_len=32, ps=PS)
    b2.insert_snapshot(snap, 2)
    cl1 = int(lengths[1])
    want, _ = M.decode_step(params, CFG, torch.full((B,), 5), b.cache,
                            lengths, paged=(b.block_table_device(), PS))
    got, _ = M.decode_step(params, CFG, torch.full((3,), 5), b2.cache,
                           torch.tensor([1, 1, cl1], dtype=torch.int32),
                           paged=(b2.block_table_device(), PS))
    assert torch.equal(want[1], got[2])


# -- the page allocator ----------------------------------------------------------


def test_allocator_exhaustion_and_free():
    b = _backend(pool=2, max_len=32, ps=8, npg=4)
    assert b.free_page_count() == 4
    b.alloc_slot_prefix(0, 24)                 # 3 pages
    assert b.free_page_count() == 1
    with pytest.raises(kvc.PageExhausted):
        b.alloc_slot_prefix(1, 17)             # needs 3, only 1 free
    assert b.free_page_count() == 1, "failed alloc must not leak pages"
    b.free_slot(0)
    assert b.free_page_count() == 4
    assert (b.refcount == 0).all()
    assert (b.block_table == b.num_pages).all()


def test_grow_dry_run_on_exhaustion():
    b = _backend(pool=2, max_len=32, ps=8, npg=4)
    b.alloc_slot_prefix(0, 24)                 # 3 pages
    b.alloc_slot_prefix(1, 8)                  # 1 page
    copies = []
    # slot 1 wants pages for [8, 24) -> 2 more pages, 0 free: must refuse
    # WITHOUT mutating, so the caller can preempt and retry
    assert not b.grow(1, 24, 8, copies)
    assert not copies and b.free_page_count() == 0
    b.free_slot(0)
    assert b.grow(1, 24, 8, copies)
    b.apply_copies(copies)


def test_cow_refcount():
    ps = 8
    b = _backend(pool=4, max_len=32, ps=ps)
    L = 6                                      # partial trailing page
    b.alloc_slot_prefix(0, L)
    for layer in b.cache:                      # mark the shared page
        layer["k"][b.block_table[0, 0]] = 7.0
    b.share_slots(0, 1, L)
    assert b.refcount[b.block_table[0, 0]] == 2
    copies = []
    assert b.grow(1, L + 1, L, copies)
    assert copies, "write into a shared partial page must COW"
    b.apply_copies(copies)
    assert b.block_table[1, 0] != b.block_table[0, 0]
    assert b.refcount[b.block_table[0, 0]] == 1
    assert b.refcount[b.block_table[1, 0]] == 1
    assert (b.cache[0]["k"][b.block_table[1, 0]] == 7.0).all()
    assert b.cow_copies == 1
    b.free_slot(0)
    b.free_slot(1)
    assert b.free_page_count() == b.num_pages
    # page-aligned share: the writer's first page is FRESH, never COWed
    b.alloc_slot_prefix(0, ps)
    b.share_slots(0, 1, ps)
    copies = []
    assert b.grow(1, ps + 1, ps, copies) and not copies


@pytest.mark.parametrize("seed", range(8))
def test_allocator_refcount_invariants(seed):
    """Random admission orders: interleave alloc / share / grow / free on a
    4-slot pool and check the global page-accounting invariants after every
    operation, then full reclamation."""
    rng = np.random.default_rng(seed)
    ops = [(int(rng.integers(0, 4)), int(rng.integers(1, 31)))
           for _ in range(20)]
    b = _backend(pool=4, max_len=32, ps=8, npg=10)
    lens = [0] * 4

    def check():
        mapped = b.block_table[b.block_table < b.num_pages]
        # every mapped reference is counted, exactly
        ref = np.zeros(b.num_pages, np.int64)
        np.add.at(ref, mapped, 1)
        assert (ref == b.refcount).all()
        assert b.free_page_count() + len(np.unique(mapped)) == b.num_pages

    for slot, length in ops:
        length = min(length, 31)
        kind = rng.integers(0, 3)
        try:
            if kind == 0 or lens[slot] == 0:       # (re)alloc
                if lens[slot]:
                    b.free_slot(slot)
                    lens[slot] = 0
                b.alloc_slot_prefix(slot, length)
                lens[slot] = length
            elif kind == 1:                        # share onto another slot
                dst = int(rng.integers(0, 4))
                if dst != slot:
                    if lens[dst]:
                        b.free_slot(dst)
                    b.share_slots(slot, dst, lens[slot])
                    lens[dst] = lens[slot]
            else:                                  # grow one token
                upto = min(lens[slot] + 1, 31)
                copies = []
                if b.grow(slot, upto, lens[slot], copies):
                    b.apply_copies(copies)
                    lens[slot] = upto
        except kvc.PageExhausted:
            pass
        check()
    for s in range(4):
        if lens[s]:
            b.free_slot(s)
    assert b.free_page_count() == b.num_pages
    assert (b.refcount == 0).all()


def test_preempt_flushes_pending_cow_before_snapshot(params):
    """A slot COWs a shared partial page (its block table now points at the
    copy DESTINATION, whose copy has not run yet) and is then preempted in
    the same _prepare_decode_pages round: _preempt_slot must flush the
    pending copies before extract_snapshot, or the snapshot captures the
    uninitialised destination page."""
    L, PS = 6, 8                                   # partial trailing page
    task = AdditionTask(max_value=20, seed=3)
    ro = RolloutConfig(batch_size=1, group_size=2, max_prompt_len=16,
                       max_response_len=24, concurrency=4, mode="copris",
                       resume_strategy="kv_snapshot", kv_backend="paged",
                       kv_page_size=PS)
    eng = RolloutEngine(CFG, ro, task.sample_prompt, eos_id=EOS,
                        device="cpu")
    b = eng.backend
    rng = np.random.default_rng(6)
    toks = torch.from_numpy(rng.integers(0, CFG.vocab_size, (1, L)))
    _prefill_paged(params, b, toks, torch.tensor([L], dtype=torch.int32))
    b.share_slots(0, 1, L)                         # prefix-shared member
    copies = []
    assert b.grow(1, L + 1, L, copies) and copies  # COW queued, NOT applied

    traj = Trajectory(group_id=0, sample_idx=1,
                      prompt_tokens=toks[0].numpy().astype(np.int32))
    eng.slots[1] = traj
    eng.cache_len[1] = L
    eng.last_token[1] = 5
    eng._stats = dict(page_preemptions=0)

    class _Sched:
        def requeue(self, t):
            pass

    eng._preempt_slot(1, _Sched(), copies)
    assert not copies, "pending COW batch must be flushed, not carried"
    assert traj.kv_snapshot is not None and traj.snap_cache_len == L

    # restoring the snapshot must reproduce the shared source KV exactly
    b2 = _backend(pool=2, max_len=eng.max_len, ps=PS)
    b2.insert_snapshot(traj.kv_snapshot, 0)
    want, _ = M.decode_step(params, CFG, torch.full((eng.pool,), 4), b.cache,
                            torch.full((eng.pool,), L, dtype=torch.int32),
                            paged=(b.block_table_device(), PS))
    got, _ = M.decode_step(params, CFG, torch.full((2,), 4), b2.cache,
                           torch.full((2,), L, dtype=torch.int32),
                           paged=(b2.block_table_device(), PS))
    assert torch.equal(want[0], got[0])


# -- the engine --------------------------------------------------------------------


def _ro(cls, mode, **kw):
    base = dict(batch_size=3, group_size=2, max_prompt_len=16,
                max_response_len=24, concurrency=4, mode=mode,
                decode_chunk=4)
    base.update(kw)
    return cls(**base)


def _run(params, mode, backend, *, seed=9, key=42, **kw):
    task = AdditionTask(max_value=20, seed=seed)
    eng = RolloutEngine(CFG, _ro(RolloutConfig, mode, kv_backend=backend,
                                 **kw),
                        task.sample_prompt, eos_id=EOS, device="cpu")
    return eng.collect(params, 0, prng.PRNGKey(key))


def _tmap(groups):
    return {(g.group_id, t.sample_idx): t
            for g in groups for t in g.trajectories}


def _assert_same_content(base, got, *, logp_atol):
    common = set(base) & set(got)
    assert common
    for k in common:
        assert base[k].response_tokens == got[k].response_tokens, k
        np.testing.assert_allclose(got[k].behaviour_logps,
                                   base[k].behaviour_logps, atol=logp_atol,
                                   rtol=0, err_msg=str(k))
    return common


@pytest.mark.parametrize("mode", ["sync", "copris"])
def test_engine_paged_equals_dense(params, mode):
    """kv_backend='paged' gives the dense trajectory content (per-trajectory
    PRNG streams make it independent of the admission path); sync mode also
    pins the trajectory set. Without prefix sharing, bit for bit."""
    gd, _ = _run(params, mode, "dense")
    gp, sp = _run(params, mode, "paged", kv_page_size=16)
    base, got = _tmap(gd), _tmap(gp)
    if mode == "sync":
        assert set(base) == set(got)
    _assert_same_content(base, got, logp_atol=1e-6)
    # prefix sharing fired and the accounting is closed
    assert sp["shared_prefill_rows"] > 0
    assert sp["prefill_rows"] + sp["shared_prefill_rows"] == sp["prefill_count"]
    gn, _ = _run(params, mode, "paged", kv_page_size=16,
                 kv_prefix_sharing=False)
    _assert_same_content(base, _tmap(gn), logp_atol=0.0)


@pytest.mark.parametrize("seed,key,ps,chunk", [(9, 42, 8, 2), (5, 7, 16, 6)])
def test_engine_paged_equals_dense_randomized(params, seed, key, ps, chunk):
    """Different prompt mixes, page sizes and chunk lengths permute the
    admission order; content must not move."""
    gd, _ = _run(params, "copris", "dense", seed=seed, key=key,
                 decode_chunk=chunk)
    gp, _ = _run(params, "copris", "paged", seed=seed, key=key,
                 decode_chunk=chunk, kv_page_size=ps)
    _assert_same_content(_tmap(gd), _tmap(gp), logp_atol=1e-6)


def test_one_prefill_per_group(params):
    """Prefix sharing: one prefill ROW feeds all G samples of a group. In
    sync mode all B*G spawns land in one initial fill, so rows == B and
    shared == B*(G-1)."""
    _, st = _run(params, "sync", "paged", kv_page_size=16)
    assert st["prefill_rows"] == 3
    assert st["shared_prefill_rows"] == 3
    assert st["prefill_count"] == 6


def test_admission_pressure_still_completes(params):
    """A page pool as large as one trajectory forces admission blocking and
    mid-stage preemption — every group must still complete."""
    gp, st = _run(params, "copris", "paged", kv_page_size=8, kv_num_pages=8)
    assert len(gp) == 3 and all(len(g.trajectories) == 2 for g in gp)
    for g in gp:
        for t in g.trajectories:
            t.check_invariants()
    assert st["admission_blocked"] > 0
    assert st["page_preemptions"] > 0


def test_preemption_kv_snapshot_bitexact(params):
    """Paged + resume_strategy='kv_snapshot' + mid-stage preemption under
    page pressure, with prefix sharing live: resumed trajectories keep the
    dense run's content bit for bit."""
    gd, _ = _run(params, "copris", "dense", resume_strategy="kv_snapshot")
    gp, st = _run(params, "copris", "paged", kv_page_size=8, kv_num_pages=8,
                  resume_strategy="kv_snapshot")
    assert st["page_preemptions"] > 0
    assert st["shared_prefill_rows"] > 0
    assert st["snapshot_resumes"] > 0
    _assert_same_content(_tmap(gd), _tmap(gp), logp_atol=0.0)


def test_paged_kv_snapshot_resume(params):
    """resume_strategy='kv_snapshot' on the paged backend across stages:
    evictions carry page-list blobs (never a dense slice) and the next
    stage restores them. The prompts are chosen so that the first stage
    does evict."""
    rng = np.random.default_rng(4)

    def source():
        n = int(rng.integers(3, 40))
        return rng.integers(0, CFG.vocab_size - 1, n).astype(np.int32), None

    ro = RolloutConfig(batch_size=2, group_size=2, max_prompt_len=40,
                       max_response_len=40, concurrency=8, mode="copris",
                       decode_chunk=4, temperature=1.0,
                       resume_strategy="kv_snapshot", kv_backend="paged",
                       kv_page_size=16)
    eng = RolloutEngine(CFG, ro, source, eos_id=CFG.vocab_size - 1,
                        max_len=64, device="cpu")
    _, s1 = eng.collect(params, 0, prng.PRNGKey(1))
    assert s1["evicted"] > 0
    snaps = [t for g in eng.buffer.groups() for t in g.trajectories
             if t.kv_snapshot is not None]
    assert snaps
    assert all(isinstance(t.kv_snapshot, dict)
               and "page_count" in t.kv_snapshot for t in snaps)
    assert eng.backend.free_page_count() == eng.backend.num_pages
    _, s2 = eng.collect(params, 1, prng.PRNGKey(2))
    assert s2["snapshot_resumes"] > 0


@pytest.mark.parametrize("kw", [dict(kv_page_size=16),
                                dict(kv_page_size=8, kv_num_pages=8)],
                         ids=["paged", "paged_under_pressure"])
def test_paged_engine_matches_jax_paged_engine(params, kw):
    """The port's paged engine against the JAX package's on converted
    weights, same prompts and stage key: the same trajectories, tokens
    equal, logps within atol 1e-5, and the same page accounting."""
    got, st = _run(params, "copris", "paged", seed=9, key=42, **kw)
    jp = jax.tree.map(jnp.asarray, convert.params_to_jax(params, CFG))
    jeng = JRolloutEngine(jget_config("tiny"),
                          _ro(JRolloutConfig, "copris", kv_backend="paged",
                              **kw),
                          JAdditionTask(max_value=20, seed=9).sample_prompt,
                          eos_id=EOS)
    ref, jst = jeng.collect(jp, 0, jax.random.PRNGKey(42))
    g, r = _tmap(got), _tmap(ref)
    assert set(g) == set(r)
    for key in r:
        assert g[key].response_tokens == r[key].response_tokens, key
        np.testing.assert_allclose(g[key].behaviour_logps,
                                   r[key].behaviour_logps, atol=1e-5)
    for k in ("generated", "prefill_rows", "shared_prefill_rows",
              "admission_blocked", "page_preemptions"):
        assert st[k] == jst[k], k


def test_serve_paged_matches_dense():
    """Serving over the paged backend returns the dense token streams — the
    backend is invisible at the API boundary."""
    streams = []
    for backend in ("dense", "paged"):
        serve, cfg = make_serve_engine("tiny", max_prompt_len=8,
                                       max_tokens=10, concurrency=2, seed=4,
                                       kv_backend=backend, kv_page_size=8,
                                       device="cpu")
        rng = np.random.default_rng(11)
        for _ in range(4):
            serve.submit(GenerateRequest(
                prompt=rng.integers(0, cfg.vocab_size, 8)))
        out = serve.drain()
        streams.append({r.request_id: r.tokens for r in out})
        serve.close()
    assert streams[0] == streams[1]


# -- MoE and VLM ---------------------------------------------------------------


def _moe_cfg(arch):
    import dataclasses
    cfg = get_config(arch).reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch="sparse", capacity_factor=16.0))


def _vlm_cfg():
    return get_config("llama-3.2-vision-90b").reduced(num_layers=5)


def _vlm_media(cfg):
    xa = cfg.cross_attn
    return (np.random.default_rng(3).normal(
        size=(xa.num_media_tokens, xa.d_media)) * 0.1).astype(np.float32)


def _open(params):
    for layer in params["layers"]:
        if "xattn" in layer:
            layer["xattn"]["gate"].fill_(0.5)
            layer["mlp_gate"].fill_(0.7)
    return params


def _run_cfg(cfg, params, backend, *, media=None, **kw):
    task = AdditionTask(max_value=20, seed=9)
    base = dict(batch_size=3, group_size=2, max_prompt_len=16,
                max_response_len=16, concurrency=4, mode="copris",
                decode_chunk=4, kv_backend=backend)
    base.update(kw)
    eng = RolloutEngine(cfg, RolloutConfig(**base), task.sample_prompt,
                        eos_id=EOS, media=media, device="cpu")
    return eng.collect(params, 0, prng.PRNGKey(42))


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen3-moe-235b-a22b"])
def test_moe_engine_paged_equals_dense_with_headroom(arch):
    """Sparse dispatch at capacity_factor 16: paged (with prefix sharing,
    and under page pressure with preemption) gives the dense content."""
    cfg = _moe_cfg(arch)
    params = M.init_params(cfg, seed=0, device="cpu")
    gd, _ = _run_cfg(cfg, params, "dense")
    gp, sp = _run_cfg(cfg, params, "paged", kv_page_size=8)
    assert sp["shared_prefill_rows"] > 0
    base = _tmap(gd)
    assert set(base) == set(_tmap(gp))
    _assert_same_content(base, _tmap(gp), logp_atol=1e-5)
    gq, sq = _run_cfg(cfg, params, "paged", kv_page_size=8, kv_num_pages=8)
    assert sq["page_preemptions"] > 0
    _assert_same_content(base, _tmap(gq), logp_atol=1e-5)


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_media_kv_travels_in_snapshots(backend):
    """A prefilled slot's media K/V are the projected media's, its snapshot
    carries them, and inserting it into another slot of a fresh cache
    restores them there (the other slots stay zero)."""
    cfg = _vlm_cfg()
    params = _open(M.init_params(cfg, seed=0, device="cpu"))
    media = torch.from_numpy(_vlm_media(cfg))
    kw = dict(page_size=8, num_pages=12) if backend == "paged" else {}
    b = kvc.make_backend(backend, cfg, 2, 32, device="cpu", **kw)
    toks = torch.arange(1, 9)[None].repeat(2, 1)
    lengths = torch.tensor([8, 5], dtype=torch.int32)
    scratch = M.init_cache(cfg, 2, 8, device="cpu")
    M.prefill(params, cfg, toks, lengths, scratch,
              media=media[None].expand(2, *media.shape))
    flat = np.full((2, 8), -1)
    if backend == "paged":
        for i in range(2):
            fp = b.alloc_slot_prefix(i, int(lengths[i]))
            flat[i, :len(fp)] = fp
        kvc.paged_insert_rows(b.cache, scratch, np.arange(2), np.arange(2),
                              flat)
    else:
        kvc.dense_insert_rows(b.cache, scratch, np.arange(2), np.arange(2))
    x = params["layers"][4]
    proj = media @ params["embed"]["media_proj"]
    want_k = (proj @ x["xattn"]["wk"]).unflatten(-1, (cfg.num_kv_heads,
                                                       cfg.head_dim))
    torch.testing.assert_close(b.cache[4]["mk"][1], want_k)
    snap = b.extract_snapshot(1)
    b2 = kvc.make_backend(backend, cfg, 3, 32, device="cpu", **kw)
    b2.insert_snapshot(snap, 2)
    for name in ("mk", "mv"):
        assert torch.equal(b2.cache[4][name][2], b.cache[4][name][1])
        assert (b2.cache[4][name][:2] == 0).all()


def test_vlm_paged_preemption_snapshot_equals_dense():
    """The VLM engine with media, paged under page pressure with
    kv_snapshot resumes (evicted slots come back with their media K/V from
    the snapshot, not from a prefill), against the dense engine."""
    cfg = _vlm_cfg()
    params = _open(M.init_params(cfg, seed=0, device="cpu"))
    media = _vlm_media(cfg)
    gd, _ = _run_cfg(cfg, params, "dense", media=media,
                     resume_strategy="kv_snapshot")
    gp, st = _run_cfg(cfg, params, "paged", media=media, kv_page_size=8,
                      kv_num_pages=8, resume_strategy="kv_snapshot")
    assert st["page_preemptions"] > 0 and st["snapshot_resumes"] > 0
    _assert_same_content(_tmap(gd), _tmap(gp), logp_atol=1e-5)


# -- the deprecated free functions against the reference's -------------------


def test_deprecated_shims_match_the_reference():
    """``insert_slots`` / ``insert_slots_prefix`` / ``extract_slots`` /
    ``zero_slots`` on the same dense cache (tiny: 4 attention layers, a
    pool of 4 slots of 16 positions, random values) give the reference's
    shims' values leaf for leaf, each warning with the reference's text
    naming ``repro_torch``; out-of-range slot ids (the padding rows) are
    dropped by the inserts and by the reset."""
    import warnings

    from repro.sampling import kv_cache as jkvc

    rng = np.random.default_rng(5)
    pool, L, KV, hd = 4, 16, CFG.num_kv_heads, CFG.head_dim

    def rand(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def body(layers):              # the port's per-layer dicts -> JAX's
        return {"body": ({n: jnp.stack([jnp.asarray(lay[n].numpy())
                                        for lay in layers])
                          for n in ("k", "v")},), "prefix": []}

    def port(j):
        return [{n: torch.from_numpy(np.array(j["body"][0][n][i]))
                 for n in ("k", "v")} for i in range(CFG.num_layers)]

    def same(mine, theirs):
        for i, lay in enumerate(mine):
            for n in ("k", "v"):
                np.testing.assert_array_equal(
                    lay[n].numpy(), np.asarray(theirs["body"][0][n][i]))

    base = [{n: torch.from_numpy(rand(pool, L, KV, hd)) for n in ("k", "v")}
            for _ in range(CFG.num_layers)]
    new = [{n: torch.from_numpy(rand(2, L, KV, hd)) for n in ("k", "v")}
           for _ in range(CFG.num_layers)]
    prefix = [{n: torch.from_numpy(rand(2, 6, KV, hd)) for n in ("k", "v")}
              for _ in range(CFG.num_layers)]
    ids = np.array([2, pool], np.int32)       # the second: a padding row
    cases = [
        ("insert_slots", (new, ids), (body(new), jnp.asarray(ids))),
        ("insert_slots_prefix", (prefix, ids),
         (body(prefix), jnp.asarray(ids))),
        ("zero_slots", (np.array([0, 3, pool]),),
         (jnp.asarray([0, 3, pool]),)),
        ("extract_slots", (np.array([3, 1]),), (jnp.asarray([3, 1]),)),
    ]
    for name, mine, theirs in cases:
        cache = [{n: t.clone() for n, t in lay.items()} for lay in base]
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            got = getattr(kvc, name)(cache, *mine)
            want = getattr(jkvc, name)(body(base), *theirs)
        msgs = [str(x.message) for x in w
                if issubclass(x.category, DeprecationWarning)]
        assert len(msgs) == 2, msgs
        assert msgs[0].startswith(f"repro_torch.sampling.kv_cache.{name} ")
        assert msgs[0].split(" is deprecated")[1] == \
            msgs[1].split(" is deprecated")[1]
        same(got, want)
        if name != "extract_slots":          # in place
            assert got is cache
    # what extract took, insert puts back: a snapshot moved to another slot
    cache = [{n: t.clone() for n, t in lay.items()} for lay in base]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        snap = kvc.extract_slots(cache, [1])
        kvc.insert_slots(cache, snap, [2])
        jc = jkvc.insert_slots(body(base), jkvc.extract_slots(
            body(base), jnp.asarray([1])), jnp.asarray([2]))
    same(cache, jc)
    assert torch.equal(port(jc)[0]["k"][2], base[0]["k"][1])
