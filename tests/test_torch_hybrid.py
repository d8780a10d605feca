"""The hymba (hybrid attention + SSM) and rwkv6 (attention-free) families in
the port, on the CPU, against the JAX package, for both smoke configs:

* ``forward_train`` logits on weights converted from the JAX init (atol
  1e-4), and the ``params_to_jax`` round trip (exact);
* right-padded prefill + decode reproduces the full forward (the state
  threading: ``seq_mask``, ``lengths``, in-place cache updates; atol 1e-4);
* the rollout engine: the port's, over the dense and the paged cache,
  against one JAX dense-engine run (group size 2, so prefix sharing copies
  the recurrent state): the same trajectories, tokens equal, logps within
  1e-5; decode-chunk invariance (exact) and paged == dense inside the port
  (logps within 1e-5: a shared prefill runs fewer rows, the CPU GEMM may
  round by row count, and the recurrent state carries that rounding
  forward); a kv_snapshot resume across stages that evicts in its first
  stage, dense and paged alike;
* ``cast_params`` keeps the reference's float32 leaves.

Training both families (loss, gradients, AdamW, one trainer step against
the JAX trainer) is held against JAX in ``tests/test_torch_train.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.common.config import RolloutConfig as JRolloutConfig  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.core.rollout import RolloutEngine as JRolloutEngine  # noqa: E402
from repro.data.tasks import AdditionTask as JAdditionTask  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.common.config import RolloutConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.rollout import RolloutEngine  # noqa: E402
from repro_torch.data.tasks import EOS, AdditionTask  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.sampling import prng  # noqa: E402

torch.set_num_threads(1)
ARCHS = ["hymba-1.5b", "rwkv6-1.6b"]


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(name, port config, JAX config, JAX params, port params)."""
    name = request.param
    jcfg = jget_smoke(name)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = get_smoke_config(name)
    params = convert.params_from_jax(jax.device_get(jp), cfg, device="cpu")
    return name, cfg, jcfg, jp, params


def test_forward_train_matches_jax(arch):
    _, cfg, jcfg, jp, params = arch
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 20))
    want, _ = JM.forward_train(jp, jcfg, jnp.asarray(toks, jnp.int32),
                               remat=False)
    got = M.forward_train(params, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_params_to_jax_roundtrip(arch):
    _, cfg, _, jp, params = arch
    tree = jax.device_get(jp)
    back = convert.params_to_jax(params, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_prefill_decode_matches_full_forward(arch):
    """Right-padded prefill (lengths 5 and 3 in a bucket of 8) and 4
    decode steps reproduce the full-sequence logits."""
    _, cfg, _, _, params = arch
    B, S = 2, 12
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S)))
    full = M.forward_train(params, cfg, toks)
    lengths = torch.tensor([5, 3], dtype=torch.int32)
    padded = toks[:, :8].clone()
    padded[1, 3:] = 0                     # right-pads of row 1
    cache = M.init_cache(cfg, B, 32, device="cpu")
    lg, cache = M.prefill(params, cfg, padded, lengths, cache)
    for b, n in enumerate((5, 3)):
        torch.testing.assert_close(lg[b], full[b, n - 1], atol=1e-4, rtol=0)
    clen = lengths.clone()
    for _ in range(4):
        tok = toks[torch.arange(B), clen.long()]
        lg, cache = M.decode_step(params, cfg, tok, cache, clen)
        for b in range(B):
            torch.testing.assert_close(lg[b], full[b, int(clen[b])],
                                       atol=1e-4, rtol=0)
        clen = clen + 1


def test_cast_params_keeps_the_reference_float32_leaves(arch):
    name, cfg, _, _, params = arch
    cast = M.cast_params(params, torch.bfloat16)
    layer = cast["layers"][0]
    if name.startswith("hymba"):
        kept = {k: layer["ssm"][k] for k in ("dt_proj", "dt_bias", "A_log",
                                             "D")}
        cast_ = [layer["ssm"][k] for k in ("in_proj", "conv", "conv_b",
                                           "x_proj", "out_proj")]
        cast_ += [layer["beta"], layer["attn"]["wq"], layer["mlp"]["wi"]]
        norms = [layer[k] for k in ("ln1", "ln2", "fuse_norm_a",
                                    "fuse_norm_s")]
    else:
        kept = {k: layer["tm"][k] for k in ("w_base", "dec_b", "u")}
        cast_ = [layer["tm"][k] for k in ("mu", "mix_a", "mix_b", "wr", "wk",
                                          "wv", "wg", "wo", "dec_a", "ln_x")]
        cast_ += list(layer["cm"].values())
        norms = [layer["ln1"], layer["ln2"]]
    assert all(t.dtype == torch.float32 for t in kept.values()), kept.keys()
    assert all(t.dtype == torch.bfloat16 for t in cast_)
    assert all(t.dtype == torch.float32 for t in norms)


# -- the engine -----------------------------------------------------------------


def _ro(cls, **kw):
    base = dict(batch_size=3, group_size=2, max_prompt_len=16,
                max_response_len=24, concurrency=4, mode="copris",
                decode_chunk=4)
    base.update(kw)
    return cls(**base)


def _run(cfg, params, **kw):
    task = AdditionTask(max_value=20, seed=9)
    eng = RolloutEngine(cfg, _ro(RolloutConfig, **kw), task.sample_prompt,
                        eos_id=EOS, device="cpu")
    return eng.collect(params, 0, prng.PRNGKey(42))


def _tmap(groups):
    return {(g.group_id, t.sample_idx): t
            for g in groups for t in g.trajectories}


def _assert_same(base, got, *, atol, same_set=True):
    if same_set:
        assert set(base) == set(got)
    common = set(base) & set(got)
    assert common
    for k in common:
        assert got[k].response_tokens == base[k].response_tokens, k
        np.testing.assert_allclose(got[k].behaviour_logps,
                                   base[k].behaviour_logps, atol=atol,
                                   rtol=0, err_msg=str(k))


@pytest.fixture(scope="module")
def jax_run(arch):
    """One JAX dense-engine stage per architecture."""
    _, _, jcfg, jp, _ = arch
    jeng = JRolloutEngine(jcfg, _ro(JRolloutConfig),
                          JAdditionTask(max_value=20, seed=9).sample_prompt,
                          eos_id=EOS)
    groups, st = jeng.collect(jp, 0, jax.random.PRNGKey(42))
    return _tmap(groups), st


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_engine_matches_jax_engine(arch, jax_run, backend):
    """The port's engine against the JAX engine on converted weights and the
    same stage key; the paged run shares each group's prompt prefill, so
    the second sample's recurrent state is a copy of the first's."""
    _, cfg, _, _, params = arch
    ref, jst = jax_run
    groups, st = _run(cfg, params, kv_backend=backend, kv_page_size=8)
    _assert_same(ref, _tmap(groups), atol=1e-5)
    assert st["generated"] == jst["generated"]
    if backend == "paged":
        assert st["shared_prefill_rows"] > 0


def test_engine_decode_chunk_invariance(arch):
    _, cfg, _, _, params = arch
    base, _ = _run(cfg, params, decode_chunk=1)
    got, _ = _run(cfg, params, decode_chunk=6)
    _assert_same(_tmap(base), _tmap(got), atol=0.0, same_set=False)


def test_engine_paged_equals_dense_under_pressure(arch):
    """Inside the port: paged with a pool of 8 pages (blocked admissions,
    preemption and re-prefill) gives the dense content. (Paged with
    prefix sharing and no pressure is held against the JAX engine above.)"""
    _, cfg, _, _, params = arch
    dense, _ = _run(cfg, params)
    tight, st = _run(cfg, params, kv_backend="paged", kv_page_size=8,
                     kv_num_pages=8)
    assert st["admission_blocked"] + st["page_preemptions"] > 0
    _assert_same(_tmap(dense), _tmap(tight), atol=1e-5, same_set=False)


def test_kv_snapshot_resume_across_stages(arch):
    """resume_strategy='kv_snapshot', dense and paged: the first stage
    evicts in-flight trajectories with their recurrent state (and K/V)
    snapshotted, the next stage restores them in place of a re-prefill. The
    prompts (3-40 random tokens, max_len 64) make groups finish at
    different times, so the first stage does evict. Both backends carry
    the same state: equal tokens, logps within 1e-5."""
    _, cfg, _, _, params = arch
    runs = {}
    for backend in ("dense", "paged"):
        rng = np.random.default_rng(4)

        def source():
            n = int(rng.integers(3, 40))
            return rng.integers(0, cfg.vocab_size - 1, n).astype(np.int32), \
                None

        ro = RolloutConfig(batch_size=2, group_size=2, max_prompt_len=40,
                           max_response_len=40, concurrency=8, mode="copris",
                           decode_chunk=4, temperature=1.0,
                           resume_strategy="kv_snapshot", kv_backend=backend,
                           kv_page_size=16)
        eng = RolloutEngine(cfg, ro, source, eos_id=cfg.vocab_size - 1,
                            max_len=64, device="cpu")
        g1, s1 = eng.collect(params, 0, prng.PRNGKey(1))
        assert s1["evicted"] > 0
        assert all(t.kv_snapshot is not None for g in eng.buffer.groups()
                   for t in g.trajectories if not t.done)
        g2, s2 = eng.collect(params, 1, prng.PRNGKey(2))
        assert s2["snapshot_resumes"] > 0
        runs[backend] = _tmap(g1 + g2)
    _assert_same(runs["dense"], runs["paged"], atol=1e-5)

