"""Port parity: the model (weights converted from the JAX init) vs
repro.models.model, and the port's own prefill+decode vs its full forward,
for every dense, MoE and VLM arch of the registry (reduced): forward,
prefill and decode (also across gemma2-2b's sliding window), and one engine
collect. The MoE smoke configs take the dropless dense dispatch, as the
reference's do; the capacity-bounded one is held against the JAX engine
at its default capacity factor in ``test_moe_sparse_engine_collect_vs_jax``.
llama-3.2-vision-90b runs one 5-layer period of its pattern (4 ``attn``, 1
``xattn``) with its tanh gates set to 0.5 / 0.7 (zero at init, where the
cross-attention would not reach the output) and 16 media tokens a row.

Tolerance: float32 model logits, atol 1e-4 (a few layers of float32
matmuls summed in another order); engine logps atol 1e-5, tokens equal.
``paper-qwen-7b`` runs at ``reduced(max_d_model=448)`` (7 heads of 64) on
both sides: its default reduction gives head_dim 73, on which the
reference's rope raises. The archs whose published head_dim is 128 or 256
also run at it, with their published GQA ratio, on the reduced config (2
layers, d_model 512): paper-qwen-7b 7/1 x 128, qwen3-14b 5/1 x 128 (qk_norm),
gemma2-2b 2/1 x 256 (local/global, window 64, both softcaps), granite-34b
48/1 x 128 (MQA, d_ff 256)."""
import dataclasses

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
# reduced one at that max_d_model, a dict the reduced one with those fields
# replaced (the published head_dim and GQA ratio)
ARCHS = [("tiny", False), ("llama3.2-1b", True), ("gemma2-2b", True),
         ("qwen3-14b", True), ("granite-34b", True),
         ("musicgen-medium", True), ("paper-qwen-7b", 448),
         ("paper-qwen-7b", dict(num_heads=7, num_kv_heads=1, head_dim=128)),
         ("qwen3-14b", dict(num_heads=5, num_kv_heads=1, head_dim=128)),
         ("gemma2-2b", dict(num_heads=2, num_kv_heads=1, head_dim=256)),
         ("granite-34b", dict(num_heads=48, num_kv_heads=1, head_dim=128,
                              d_ff=256)),
         ("deepseek-moe-16b", True), ("qwen3-moe-235b-a22b", True),
         ("llama-3.2-vision-90b",
          dict(num_layers=5, block_pattern=("attn",) * 4 + ("xattn",)))]
IDS = [a if not isinstance(s, dict) else
       f"{a}-hd{s['head_dim']}" if "head_dim" in s else f"{a}-xattn"
       for a, s in ARCHS]


def _replace(cfg, fields):
    """``cfg`` with ``fields`` replaced; a dict value replaces fields of
    that sub-config (``moe=dict(dispatch="sparse")``)."""
    return dataclasses.replace(cfg, **{
        k: dataclasses.replace(getattr(cfg, k), **v) if isinstance(v, dict)
        else v for k, v in fields.items()})


def _cfgs(arch, smoke):
    if isinstance(smoke, dict):
        return (_replace(jget_smoke(arch), smoke),
                _replace(get_smoke_config(arch), smoke))
    if smoke is True:
        return jget_smoke(arch), get_smoke_config(arch)
    if smoke:
        return (jget_config(arch).reduced(max_d_model=smoke),
                get_config(arch).reduced(max_d_model=smoke))
    return jget_config(arch), get_config(arch)


def _open_gates(layers):
    """Set every xattn layer's tanh gates (zero at init) to 0.5 / 0.7."""
    for layer in layers:
        if "xattn" in layer:
            layer["xattn"]["gate"] = np.full_like(layer["xattn"]["gate"], 0.5)
            layer["mlp_gate"] = np.full_like(layer["mlp_gate"], 0.7)


def _pair(cfg_j, cfg_t):
    tree = jax.device_get(JM.init_params(jax.random.PRNGKey(0), cfg_j))
    _open_gates(tree["stack"]["body"])
    return (cfg_j, cfg_t, jax.tree.map(jnp.asarray, tree),
            params_from_jax(tree, cfg_t, device="cpu"))


@pytest.fixture(scope="module", params=ARCHS, ids=IDS)
def pair(request):
    return _pair(*_cfgs(*request.param))


def _media(cfg, B, seed=0):
    """Numpy media (B, M, d_media) for a VLM config, else None."""
    if not cfg.uses_media:
        return None
    xa = cfg.cross_attn
    return (np.random.default_rng(seed).normal(
        size=(B, xa.num_media_tokens, xa.d_media)) * 0.1).astype(np.float32)


def _jm(media):
    return None if media is None else jnp.asarray(media)


def _tm(media):
    return None if media is None else torch.from_numpy(media)


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
    a = "xattn" if "xattn" in body else "attn"
    np.testing.assert_array_equal(pt["layers"][-1][a]["wq"].numpy(),
                                  np.asarray(body[a]["wq"][-1]))


def test_forward_train_vs_jax(pair):
    cfg_j, cfg_t, pj, pt = pair
    toks, _ = _prompts(cfg_t)
    media = _media(cfg_t, toks.shape[0])
    ref, aux = JM.forward_train(pj, cfg_j, jnp.asarray(toks), media=_jm(media))
    got, taux = TM.forward_train(pt, cfg_t, torch.from_numpy(toks),
                                 media=_tm(media), return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(float(taux["router_aux"]),
                               float(aux["router_aux"]), atol=1e-5)


def test_prefill_and_decode_vs_jax(pair):
    cfg_j, cfg_t, pj, pt = pair
    toks, lens = _prompts(cfg_t)
    B, L = toks.shape[0], 48
    media = _media(cfg_t, B)
    cj = JM.init_cache(cfg_j, B, L)
    lj, cj = JM.prefill(pj, cfg_j, jnp.asarray(toks), jnp.asarray(lens), cj,
                        media=_jm(media))
    ct = TM.init_cache(cfg_t, B, L, device="cpu")
    lt, ct = TM.prefill(pt, cfg_t, torch.from_numpy(toks),
                        torch.from_numpy(lens), ct, media=_tm(media))
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

    media = _media(cfg_t, B)
    cj = JM.init_cache(cfg_j, B, L)
    lj, cj = JM.prefill(pj, cfg_j, jnp.asarray(toks), jnp.asarray(lens), cj,
                        media=_jm(media))
    ct = TM.init_cache(cfg_t, B, L, device="cpu")
    lt, ct = TM.prefill(pt, cfg_t, torch.from_numpy(toks),
                        torch.from_numpy(lens), ct, media=_tm(media))
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
    # the last layer's cache: its K, or the media K an xattn layer holds
    name = "mk" if "mk" in ct[-1] else "k"
    kj = np.asarray(cj["body"][-1][name][-1])
    np.testing.assert_allclose(ct[-1][name].numpy(), kj, atol=ATOL)


def test_decode_across_window_vs_jax(pair):
    """Prefill of 40 tokens, then 40 decode steps against the JAX full
    forward's logits: past position 64, gemma2-2b's local layers (window 64
    reduced) drop the oldest keys, on both sides."""
    cfg_j, cfg_t, pj, pt = pair
    rng = np.random.default_rng(5)
    S, P = 80, 40
    toks = rng.integers(0, cfg_t.vocab_size, (2, S)).astype(np.int32)
    media = _media(cfg_t, 2)
    ref, _ = JM.forward_train(pj, cfg_j, jnp.asarray(toks), media=_jm(media))
    ref = np.asarray(ref)
    cache = TM.init_cache(cfg_t, 2, 128, device="cpu")
    lens = torch.full((2,), P, dtype=torch.int32)
    logits, cache = TM.prefill(pt, cfg_t, torch.from_numpy(toks[:, :P]),
                               lens, cache, media=_tm(media))
    np.testing.assert_allclose(logits.numpy(), ref[:, P - 1], atol=ATOL)
    for t in range(P, S):
        logits, cache = TM.decode_step(
            pt, cfg_t, torch.from_numpy(toks[:, t]), cache,
            torch.full((2,), t, dtype=torch.int32))
        np.testing.assert_allclose(logits.numpy(), ref[:, t], atol=ATOL,
                                   err_msg=f"position {t}")


def test_engine_collect_vs_jax(pair):
    """One CoPRIS collect of each engine from the same weights, prompts and
    stage key (and a VLM's media): equal tokens and finish reasons, logps
    within 1e-5."""
    _collect_vs_jax(*pair)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen3-moe-235b-a22b"])
def test_moe_sparse_engine_collect_vs_jax(arch):
    """The MoE smoke configs with the capacity-bounded dispatch at the
    default capacity factor (1.25): prefill drops the reference's (token,
    k) pairs, since both engines prefill the same padded (rows, bucket)
    batches; the forward and the collect match the JAX engine's."""
    cfg_j, cfg_t, pj, pt = _pair(*_cfgs(arch, dict(moe=dict(
        dispatch="sparse"))))
    assert cfg_t.moe.capacity_factor == 1.25
    toks, _ = _prompts(cfg_t)
    ref, aux = JM.forward_train(pj, cfg_j, jnp.asarray(toks))
    got, taux = TM.forward_train(pt, cfg_t, torch.from_numpy(toks),
                                 return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(float(taux["router_aux"]),
                               float(aux["router_aux"]), atol=1e-5)
    _collect_vs_jax(cfg_j, cfg_t, pj, pt)


def _collect_vs_jax(cfg_j, cfg_t, pj, pt):
    V = cfg_t.vocab_size
    media = _media(cfg_t, 1)
    media = None if media is None else media[0]
    ro = dict(batch_size=2, group_size=2, max_prompt_len=16,
              max_response_len=8, concurrency=4, mode="copris",
              decode_chunk=4)

    def source(seed):
        rng = np.random.default_rng(seed)
        return lambda: (rng.integers(0, V - 1, int(rng.integers(3, 12))),
                        None)

    got, st = RolloutEngine(cfg_t, RolloutConfig(**ro), source(7),
                            eos_id=V - 1, media=media, device="cpu").collect(
        pt, 0, prng.PRNGKey(3))
    ref, jst = JRolloutEngine(cfg_j, JRolloutConfig(**ro), source(7),
                              eos_id=V - 1, media=media).collect(
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
    for layer in params["layers"]:
        if "xattn" in layer:
            layer["xattn"]["gate"].fill_(0.5)
            layer["mlp_gate"].fill_(0.7)
    rng = np.random.default_rng(2)
    S, P = 20, 12
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32))
    media = _tm(_media(cfg, 2))
    full = TM.forward_train(params, cfg, toks, media=media)
    cache = TM.init_cache(cfg, 2, 64, device="cpu")
    lens = torch.full((2,), P, dtype=torch.int32)
    logits, cache = TM.prefill(params, cfg, toks[:, :P], lens, cache,
                               media=media)
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


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma2-2b", "hymba-1.5b",
                                  "rwkv6-1.6b", "deepseek-moe-16b",
                                  "qwen3-moe-235b-a22b",
                                  "llama-3.2-vision-90b"])
def test_init_params_cast_as_made_equals_cast_params(arch):
    """init_params(compute_dtype=bf16), which casts each layer as it is
    made, gives cast_params of the float32 init bit for bit: the
    projections in bf16, norms and the recurrences' and the MoE router's
    float32 leaves kept (the VLM at one 5-layer period, with its xattn
    layer and media projection)."""
    from repro_torch.common.tree import leaves
    cfg = get_config(arch).reduced(
        num_layers=5 if arch == "llama-3.2-vision-90b" else 2)
    want = TM.cast_params(TM.init_params(cfg, seed=4, device="cpu"),
                          torch.bfloat16, "cpu")
    got = TM.init_params(cfg, seed=4, device="cpu",
                         compute_dtype=torch.bfloat16)
    assert len(leaves(got)) == len(leaves(want))
    for a, b in zip(leaves(got), leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_make_serve_engine_depth_cut():
    """``num_layers`` keeps the config's widths at fewer layers, and the
    engine serves a request at that depth."""
    from repro_torch.launch import serve
    eng, cfg = serve.make_serve_engine("llama3.2-1b", smoke=True,
                                       num_layers=1, max_tokens=4,
                                       device="cpu")
    full = get_smoke_config("llama3.2-1b")
    assert cfg.num_layers == 1 and len(eng.params["layers"]) == 1
    assert (cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.vocab_size) == (
        full.d_model, full.num_heads, full.head_dim, full.vocab_size)
    eng.submit(serve.GenerateRequest(prompt=np.arange(5)))
    (res,) = eng.drain()
    assert 1 <= len(res.tokens) <= 4
    eng.close()
