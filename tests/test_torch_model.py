"""Port parity: the model (weights converted from the JAX init) vs
repro.models.model, and the port's own prefill+decode vs its full forward,
for every dense arch of the registry (reduced): forward, prefill and decode
(also across gemma2-2b's sliding window), and one engine collect.

Tolerance: float32 model logits, atol 1e-4 (a few layers of float32
matmuls summed in another order); engine logps atol 1e-5, tokens equal.
``paper-qwen-7b`` runs at ``reduced(max_d_model=448)`` (7 heads of 64) on
both sides: its default reduction gives head_dim 73, on which the
reference's rope raises."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.common.config import RolloutConfig as JRolloutConfig  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.core.rollout import RolloutEngine as JRolloutEngine  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.common.config import RolloutConfig  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.rollout import RolloutEngine  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.sampling import prng  # noqa: E402

torch.set_num_threads(1)
ATOL = 1e-4
# (arch, smoke): False the full config, True the reduced one, an int the
# reduced one at that max_d_model
ARCHS = [("tiny", False), ("llama3.2-1b", True), ("gemma2-2b", True),
         ("qwen3-14b", True), ("granite-34b", True),
         ("musicgen-medium", True), ("paper-qwen-7b", 448)]


def _cfgs(arch, smoke):
    if smoke is True:
        return jget_smoke(arch), get_smoke_config(arch)
    if smoke:
        return (jget_config(arch).reduced(max_d_model=smoke),
                get_config(arch).reduced(max_d_model=smoke))
    return jget_config(arch), get_config(arch)


@pytest.fixture(scope="module", params=ARCHS, ids=[a for a, _ in ARCHS])
def pair(request):
    arch, smoke = request.param
    cfg_j, cfg_t = _cfgs(arch, smoke)
    pj = JM.init_params(jax.random.PRNGKey(0), cfg_j)
    pt = params_from_jax(jax.device_get(pj), cfg_t, device="cpu")
    return cfg_j, cfg_t, pj, pt


def _prompts(cfg, B=3, S=24, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lens = np.array([S, S - 7, 5][:B], np.int32)
    return toks, lens


def test_convert_layout(pair):
    cfg_j, cfg_t, pj, pt = pair
    assert len(pt["layers"]) == cfg_t.num_layers
    # the last layer is the last repeat of the pattern's last block kind
    body = jax.device_get(pj)["stack"]["body"][-1]
    np.testing.assert_array_equal(pt["layers"][-1]["attn"]["wq"].numpy(),
                                  np.asarray(body["attn"]["wq"][-1]))


def test_forward_train_vs_jax(pair):
    cfg_j, cfg_t, pj, pt = pair
    toks, _ = _prompts(cfg_t)
    ref, _ = JM.forward_train(pj, cfg_j, jnp.asarray(toks))
    got = TM.forward_train(pt, cfg_t, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_prefill_and_decode_vs_jax(pair):
    cfg_j, cfg_t, pj, pt = pair
    toks, lens = _prompts(cfg_t)
    B, L = toks.shape[0], 48
    cj = JM.init_cache(cfg_j, B, L)
    lj, cj = JM.prefill(pj, cfg_j, jnp.asarray(toks), jnp.asarray(lens), cj)
    ct = TM.init_cache(cfg_t, B, L, device="cpu")
    lt, ct = TM.prefill(pt, cfg_t, torch.from_numpy(toks),
                        torch.from_numpy(lens), ct)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
    nxt = np.asarray(jnp.argmax(lj, -1), np.int32)
    dj, _ = JM.decode_step(pj, cfg_j, jnp.asarray(nxt), cj, jnp.asarray(lens))
    dt, _ = TM.decode_step(pt, cfg_t, torch.from_numpy(nxt), ct,
                           torch.from_numpy(lens))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=ATOL)


def test_decode_scan_vs_jax(pair):
    """A greedy decode_scan chunk: same tokens, same written cache."""
    cfg_j, cfg_t, pj, pt = pair
    toks, lens = _prompts(cfg_t, seed=1)
    B, L, steps = toks.shape[0], 48, 5
    act = np.array([True, True, False])

    def jstep(logits, clen, a, aux):
        return (jnp.argmax(logits, -1).astype(jnp.int32),
                jnp.zeros(B, jnp.float32), clen + 1 >= 20, aux)

    def tstep(logits, clen, a, aux):
        return (torch.argmax(logits, -1).to(torch.int32), torch.zeros(B),
                clen + 1 >= 20, aux)

    cj = JM.init_cache(cfg_j, B, L)
    lj, cj = JM.prefill(pj, cfg_j, jnp.asarray(toks), jnp.asarray(lens), cj)
    ct = TM.init_cache(cfg_t, B, L, device="cpu")
    lt, ct = TM.prefill(pt, cfg_t, torch.from_numpy(toks),
                        torch.from_numpy(lens), ct)
    first = np.asarray(jnp.argmax(lj, -1), np.int32)
    (cj, lastj, clj, actj, _), (tj, _, aj) = JM.decode_scan(
        pj, cfg_j, cj, jnp.asarray(first), jnp.asarray(lens),
        jnp.asarray(act), 0, steps=steps, step_fn=jstep)
    (ct, lastt, clt, actt, _), (tt, _, at) = TM.decode_scan(
        pt, cfg_t, ct, torch.from_numpy(first), torch.from_numpy(lens),
        torch.from_numpy(act), 0, steps=steps, step_fn=tstep)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_array_equal(clt.numpy(), np.asarray(clj))
    np.testing.assert_array_equal(lastt.numpy(), np.asarray(lastj))
    kj = np.asarray(cj["body"][-1]["k"][-1])      # the last layer's cache
    np.testing.assert_allclose(ct[-1]["k"].numpy(), kj, atol=ATOL)


def test_decode_across_window_vs_jax(pair):
    """Prefill of 40 tokens, then 40 decode steps against the JAX full
    forward's logits: past position 64, gemma2-2b's local layers (window 64
    reduced) drop the oldest keys, on both sides."""
    cfg_j, cfg_t, pj, pt = pair
    rng = np.random.default_rng(5)
    S, P = 80, 40
    toks = rng.integers(0, cfg_t.vocab_size, (2, S)).astype(np.int32)
    ref, _ = JM.forward_train(pj, cfg_j, jnp.asarray(toks))
    ref = np.asarray(ref)
    cache = TM.init_cache(cfg_t, 2, 128, device="cpu")
    lens = torch.full((2,), P, dtype=torch.int32)
    logits, cache = TM.prefill(pt, cfg_t, torch.from_numpy(toks[:, :P]),
                               lens, cache)
    np.testing.assert_allclose(logits.numpy(), ref[:, P - 1], atol=ATOL)
    for t in range(P, S):
        logits, cache = TM.decode_step(
            pt, cfg_t, torch.from_numpy(toks[:, t]), cache,
            torch.full((2,), t, dtype=torch.int32))
        np.testing.assert_allclose(logits.numpy(), ref[:, t], atol=ATOL,
                                   err_msg=f"position {t}")


def test_engine_collect_vs_jax(pair):
    """One CoPRIS collect of each engine from the same weights, prompts and
    stage key: equal tokens and finish reasons, logps within 1e-5."""
    cfg_j, cfg_t, pj, pt = pair
    V = cfg_t.vocab_size
    ro = dict(batch_size=2, group_size=2, max_prompt_len=16,
              max_response_len=8, concurrency=4, mode="copris",
              decode_chunk=4)

    def source(seed):
        rng = np.random.default_rng(seed)
        return lambda: (rng.integers(0, V - 1, int(rng.integers(3, 12))),
                        None)

    got, st = RolloutEngine(cfg_t, RolloutConfig(**ro), source(7),
                            eos_id=V - 1, device="cpu").collect(
        pt, 0, prng.PRNGKey(3))
    ref, jst = JRolloutEngine(cfg_j, JRolloutConfig(**ro), source(7),
                              eos_id=V - 1).collect(
        pj, 0, jax.random.PRNGKey(3))

    def tmap(groups):
        return {(g.group_id, t.sample_idx): t for g in groups
                for t in g.trajectories}

    g, r = tmap(got), tmap(ref)
    assert set(g) == set(r) and len(r) == 4
    for key in r:
        assert g[key].response_tokens == r[key].response_tokens, key
        assert g[key].finish_reason == r[key].finish_reason, key
        np.testing.assert_allclose(g[key].behaviour_logps,
                                   r[key].behaviour_logps, atol=1e-5)
    assert st["generated"] == jst["generated"]


@pytest.mark.parametrize("arch,smoke", ARCHS)
def test_prefill_then_decode_matches_full_forward(arch, smoke):
    """The port against itself: prefill of a prefix, then token-by-token
    decode, gives the full forward's next-token logits at every position."""
    cfg = _cfgs(arch, smoke)[1]
    params = TM.init_params(cfg, seed=3, device="cpu")
    rng = np.random.default_rng(2)
    S, P = 20, 12
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32))
    full = TM.forward_train(params, cfg, toks)
    cache = TM.init_cache(cfg, 2, 64, device="cpu")
    lens = torch.full((2,), P, dtype=torch.int32)
    logits, cache = TM.prefill(params, cfg, toks[:, :P], lens, cache)
    np.testing.assert_allclose(logits.numpy(), full[:, P - 1].numpy(),
                               atol=ATOL)
    for t in range(P, S):
        logits, cache = TM.decode_step(params, cfg, toks[:, t], cache,
                                       torch.full((2,), t, dtype=torch.int32))
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                   atol=ATOL)


def test_cast_params_bf16_keeps_norms_f32():
    cfg = get_config("tiny")
    p = TM.init_params(cfg, seed=0, device="cpu")
    c = TM.cast_params(p, torch.bfloat16)
    assert c["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert c["embed"]["tok"].dtype == torch.bfloat16
    assert c["layers"][0]["ln1"].dtype == torch.float32
    again = TM.cast_params(c, torch.bfloat16)
    assert again["layers"][0]["mlp"]["wi"] is c["layers"][0]["mlp"]["wi"]
