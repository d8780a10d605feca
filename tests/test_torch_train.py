"""The port's training path on the CPU against the JAX package:

* flash-attention backward (plain version, through the port's autograd
  function) against ``jax.vjp`` of ``chunked_attention`` (``_flash_bwd``):
  causal, sliding window, softcap, GQA;
* ``make_loss_fn`` / ``make_train_step`` on ``tiny`` (full-logits branch)
  and on the reduced llama3.2-1b with vocab 8192 (fused branch), float32:
  loss, metrics and every gradient against ``jax.value_and_grad`` on
  converted weights, then the parameters after one AdamW step;
* the same on the reduced hymba-1.5b and rwkv6-1.6b (vocab 8192, float32):
  their scans' gradients through the autograd functions' plain backward;
* one sequential ``CoPRISTrainer.step()`` on ``tiny`` and on the reduced
  hymba-1.5b and rwkv6-1.6b against the JAX trainer with the same seed:
  equal tokens and rewards;
* checkpoints and Adam state between the two layouts.

Tolerances (float32): attention gradients atol 1e-5; loss and metrics atol
1e-5; gradients atol 2e-5 (sums of a few layers' products in another
order), for the hybrids 2e-5 of each leaf's largest element where that is
above 1: the rwkv6 forward differs between the two frameworks by ~2e-6
relative (the loss by 4e-7 of 0.18), and autograd through the plain
forward misses JAX's embedding gradient (largest element 2.7) by the same
4e-5 as the plain backward does. Adam's first step is sign-like — delta = g/|g| up to eps — so a
gradient near 0 may flip the step's sign from rounding alone: parameters
are compared only where |grad| > 1e-5 (the hybrids: 1e-3, above their
gradients' tolerance and their clipped gradients above Adam's eps), atol
1e-6.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.common.config import RolloutConfig as JRolloutConfig  # noqa: E402
from repro.common.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.core import copris as jcopris  # noqa: E402
from repro.data.tasks import AdditionTask as JAdditionTask  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.common.config import RolloutConfig, TrainConfig  # noqa: E402
from repro_torch.common.tree import leaves, unflatten  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core import copris  # noqa: E402
from repro_torch.data.tasks import EOS, AdditionTask  # noqa: E402
from repro_torch.hopper import flash_attn  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import adam  # noqa: E402

torch.set_num_threads(1)


# -- flash backward ----------------------------------------------------------


@pytest.mark.parametrize("H,KV,window,cap", [
    (4, 2, 0, 0.0), (4, 4, 11, 0.0), (4, 1, 0, 3.0)],
    ids=["causal_gqa", "window", "softcap_mqa"])
def test_flash_backward_matches_reference(H, KV, window, cap):
    rng = np.random.default_rng(0)
    B, S, hd = 2, 37, 16
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    do = rng.standard_normal((B, S, H, hd)).astype(np.float32)

    def f(q_, k_, v_):
        return jattn.chunked_attention(q_, k_, v_, causal=True, window=window,
                                       attn_softcap=cap, block_q=16,
                                       block_k=16)

    out_r, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    grads_r = vjp(jnp.asarray(do))
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = flash_attn.flash_attention(*ts, causal=True, window=window,
                                     attn_softcap=cap)
    out.backward(torch.tensor(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_r),
                               atol=1e-5)
    for name, t, g in zip("qkv", ts, grads_r):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-5,
                                   err_msg=f"d{name}")


# -- train step ----------------------------------------------------------------


def _configs(arch):
    if arch == "tiny":
        return jget_config("tiny"), get_config("tiny")
    # reduced llama3.2-1b with vocab 8192: the fused-loss branch, in f32;
    # the MoE with its published capacity-bounded dispatch (the smoke
    # config's is the dense one), at the default capacity factor
    kw = dict(vocab_size=8192, dtype="float32")
    cfgs = (jget_smoke(arch), get_smoke_config(arch))
    if arch == "deepseek-moe-16b":
        cfgs = tuple(dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, dispatch="sparse")) for c in cfgs)
    return tuple(dataclasses.replace(c, **kw) for c in cfgs)


def _batch(cfg, N=4, T=24, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (N, T)).astype(np.int32)
    mask = np.zeros((N, T), np.float32)
    for n in range(N):
        mask[n, rng.integers(4, 10):rng.integers(14, T)] = 1.0
    behaviour = ((rng.standard_normal((N, T)) * 0.3 - 1.0 - np.log(
        cfg.vocab_size)) * mask).astype(np.float32)
    adv = rng.standard_normal(N).astype(np.float32)
    return dict(tokens=tokens, loss_mask=mask, behaviour_logp=behaviour,
                advantages=adv)


TC = dict(lr=1e-3, weight_decay=0.01, grad_clip=1.0, entropy_coef=0.01,
          remat=True)


def _jax_params(cfg_t, seed=0):
    """Random weights from the port's seeded init, in the JAX layout (the
    JAX init runs op by op on the CPU and takes seconds)."""
    tree = convert.params_to_jax(TM.init_params(cfg_t, seed=seed,
                                                device="cpu"), cfg_t)
    return jax.tree.map(jnp.asarray, tree)


@pytest.fixture(scope="module", params=["tiny", "llama3.2-1b", "hymba-1.5b",
                                        "rwkv6-1.6b", "deepseek-moe-16b"])
def results(request):
    """One JAX and one port evaluation per config: loss, metrics and grads
    (``make_loss_fn``), then the parameters after ``make_train_step``."""
    cfg_j, cfg_t = _configs(request.param)
    pj = _jax_params(cfg_t)
    batch = _batch(cfg_t)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (lv_j, m_j), g_j = jax.jit(jax.value_and_grad(
        jcopris.make_loss_fn(cfg_j, JTrainConfig(**TC)), has_aux=True))(pj, jb)
    # the JAX train step with one microbatch: value_and_grad, then AdamW
    jtc = JTrainConfig(**TC)
    pj_new, _, sm_j = jax.jit(functools.partial(
        jadam.update, betas=jtc.betas, eps=jtc.eps,
        weight_decay=jtc.weight_decay, grad_clip=jtc.grad_clip))(
            g_j, jadam.init(pj), pj, lr=jnp.asarray(1e-3, jnp.float32))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    pt = convert.params_from_jax(jax.device_get(pj), cfg_t, device="cpu")
    for p in leaves(pt):
        p.requires_grad_(True)
    lv, m = copris.make_loss_fn(cfg_t, TrainConfig(**TC))(pt, tb)
    grads = torch.autograd.grad(lv, leaves(pt))
    pt, st, sm = copris.make_train_step(cfg_t, TrainConfig(**TC))(
        pt, adam.init(pt), tb, 1e-3)
    to_port = lambda tree: leaves(convert.params_from_jax(  # noqa: E731
        jax.device_get(tree), cfg_t, "cpu"))
    return dict(scaled=request.param in ("hymba-1.5b", "rwkv6-1.6b",
                                         "deepseek-moe-16b"),
                jax=dict(loss=lv_j, metrics=m_j, grads=to_port(g_j),
                         new=to_port(pj_new), step_metrics=sm_j),
                port=dict(loss=lv, metrics=m, grads=grads, new=leaves(pt),
                          step_metrics=sm, state=st, params=pt))


def test_loss_metrics_and_grads_match_jax(results):
    j, p = results["jax"], results["port"]
    np.testing.assert_allclose(float(p["loss"].detach()), float(j["loss"]),
                               atol=1e-5)
    assert set(p["metrics"]) == set(j["metrics"])
    for k in p["metrics"]:
        np.testing.assert_allclose(float(p["metrics"][k]),
                                   float(j["metrics"][k]), atol=1e-5,
                                   err_msg=k)
    assert len(j["grads"]) == len(p["grads"])
    for g, r in zip(p["grads"], j["grads"]):
        # the hybrids and the MoE: 2e-5 of each leaf's largest element
        # where that is above 1 (rwkv6's embedding gradient reaches 2.7,
        # the MoE router's sums of products are larger still)
        scale = max(1.0, float(r.abs().max())) if results["scaled"] else 1.0
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=2e-5 * scale)
    # every attention projection and every scan parameter of every layer
    # gets a gradient
    grads = iter(p["grads"])
    for leaf, g in zip(leaves(p["params"]), grads):
        assert g.shape == leaf.shape
    port_tree = unflatten(p["params"], list(p["grads"]))
    watched = {"attn": ("wq", "wk", "wv", "wo"), "ssm": ("A_log", "D"),
               "tm": ("u", "w_base"), "moe": ("router", "wi", "wg", "wo")}
    for layer in port_tree["layers"]:
        assert set(watched) & set(layer)
        for block, names in watched.items():
            for name in names if block in layer else ():
                assert float(layer[block][name].abs().max()) > 0.0, name


def test_train_step_adamw_matches_jax(results):
    j, p = results["jax"], results["port"]
    np.testing.assert_allclose(float(p["step_metrics"]["grad_norm"]),
                               float(j["step_metrics"]["grad_norm"]),
                               rtol=1e-5)
    assert int(p["state"]["step"]) == 1
    compared = 0
    # Adam's first step is sign-like; the hybrids' and the MoE's gradients
    # agree to 2e-5 of a leaf's largest element and are clipped by a norm
    # near 48, so a gradient below 1e-3 lands within 10x of Adam's eps
    floor = 1e-3 if results["scaled"] else 1e-5
    for new, ref, g in zip(p["new"], j["new"], j["grads"]):
        sel = g.abs() > floor
        compared += int(sel.sum())
        np.testing.assert_allclose(new.detach()[sel].numpy(),
                                   ref[sel].numpy(), atol=1e-6)
    assert compared > 1000


def test_microbatches_match_jax():
    """microbatches=2: the mean of the two halves' gradients, as the JAX
    step's scan; compared through Adam's first moment (1 - b1) * g."""
    cfg_j, cfg_t = _configs("tiny")
    pj = _jax_params(cfg_t, seed=1)
    batch = _batch(cfg_t, N=4)
    tc = dict(TC, microbatches=2)
    step_j = jax.jit(jcopris.make_train_step(cfg_j, JTrainConfig(**tc)))
    _, oj, m_j = step_j(pj, jadam.init(pj),
                        {k: jnp.asarray(v) for k, v in batch.items()},
                        jnp.asarray(1e-3, jnp.float32))
    pt = convert.params_from_jax(jax.device_get(pj), cfg_t, "cpu")
    for p in leaves(pt):
        p.requires_grad_(True)
    step_t = copris.make_train_step(cfg_t, TrainConfig(**tc))
    _, ot, m = step_t(pt, adam.init(pt), {k: torch.from_numpy(v)
                                          for k, v in batch.items()}, 1e-3)
    np.testing.assert_allclose(float(m["pg_loss"]), float(m_j["pg_loss"]),
                               atol=1e-5)
    ref = convert.opt_state_from_jax(jax.device_get(oj), cfg_t, "cpu")
    for a, b in zip(leaves(ot["m"]), leaves(ref["m"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-6)


def test_legacy_branch_and_entropy_raise():
    # the legacy branch is ported (tests/test_torch_fused_logprob.py): it
    # builds; an entropy bonus, which it cannot compute, still raises
    _, cfg = _configs("llama3.2-1b")
    assert callable(copris.make_loss_fn(cfg, TrainConfig(fused_loss=False)))
    with pytest.raises(ValueError, match="entropy_coef"):
        copris.make_loss_fn(cfg, TrainConfig(fused_loss=False,
                                             entropy_coef=0.1))


# -- the trainer ---------------------------------------------------------------


def test_trainer_step_matches_jax_trainer():
    _trainer_step_matches("tiny")


@pytest.mark.parametrize("arch", ["hymba-1.5b", "rwkv6-1.6b"])
def test_hybrid_trainer_step_matches_jax_trainer(arch):
    """The hybrid families (reduced, vocab 8192, float32) train through the
    scans' autograd functions, plain forward and backward on the CPU."""
    _trainer_step_matches(arch)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b"])
def test_moe_trainer_step_matches_jax_trainer(arch):
    """deepseek-moe-16b (reduced: a dense layer, then a MoE layer of 4
    experts top-2 and a shared one; vocab 8192, float32, the sparse
    dispatch): the rollout, the loss with its router term and the updated
    parameters against the JAX trainer."""
    tt, jt = _trainer_step_matches(arch)
    new_t = leaves(tt.params)
    new_j = leaves(convert.params_from_jax(jax.device_get(jt.params),
                                           tt.cfg, "cpu"))
    assert len(new_t) == len(new_j)
    for a, b in zip(new_t, new_j):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), atol=1e-5)


def _trainer_step_matches(arch):
    """One sequential step of each trainer from the same weights and seed:
    equal tokens and rewards, behaviour logps and metrics atol 1e-5.
    Returns the two trainers, stepped and closed."""
    cfg_j, cfg_t = _configs(arch)
    pj = _jax_params(cfg_t)
    ro = dict(batch_size=3, group_size=2, max_prompt_len=16,
              max_response_len=16, concurrency=4, mode="copris")
    tc = dict(lr=1e-3, seed=3)
    jt = jcopris.CoPRISTrainer(cfg_j, JRolloutConfig(**ro),
                               JTrainConfig(**tc),
                               JAdditionTask(max_value=20, seed=9),
                               eos_id=EOS, params=pj)
    tt = copris.CoPRISTrainer(
        cfg_t, RolloutConfig(**ro), TrainConfig(**tc),
        AdditionTask(max_value=20, seed=9), eos_id=EOS,
        params=convert.params_from_jax(jax.device_get(pj), cfg_t, "cpu"),
        device="cpu")
    try:
        out_j = jt.step()
        out_t = tt.step()
    finally:
        jt.close()
        tt.close()

    def trajs(groups):
        return {(g.group_id, t.sample_idx): t for g in groups
                for t in g.trajectories}

    a, b = trajs(tt.last_groups), trajs(jt.last_groups)
    assert set(a) == set(b) and len(a) == 6
    for key in b:
        assert a[key].response_tokens == b[key].response_tokens, key
        assert a[key].reward == b[key].reward, key
        np.testing.assert_allclose(a[key].behaviour_logps,
                                   b[key].behaviour_logps, atol=1e-5)
    for k in ("pg_loss", "ratio_mean", "approx_kl", "entropy", "grad_norm",
              "reward_mean", "off_policy_frac", "router_aux"):
        np.testing.assert_allclose(out_t[k], out_j[k], atol=1e-5, err_msg=k)
    assert out_t["step"] == out_j["step"] == 0 and tt.stage == 1
    return tt, jt


def test_trainer_refuses_unported_pipelines():
    # overlap=True, multi-turn tasks and the disaggregated trainer are
    # ported (tests/test_torch_async_trainer.py, test_torch_multiturn.py,
    # test_torch_weight_sync.py); what is still refused: a rollout device
    # apart from the train device without disaggregated=True, and a
    # rollout device that is not there
    cfg = get_config("tiny")
    tr = copris.CoPRISTrainer(cfg, RolloutConfig(concurrency=2),
                              TrainConfig(overlap=True, disaggregated=True),
                              AdditionTask(), eos_id=EOS, device="cpu")
    tr.close()
    assert tr.rollout_device == tr.device == torch.device("cpu")
    with pytest.raises(ValueError, match="disaggregated"):
        copris.CoPRISTrainer(cfg, RolloutConfig(concurrency=2),
                             TrainConfig(), AdditionTask(), eos_id=EOS,
                             device="cpu", rollout_device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            copris.CoPRISTrainer(
                cfg, RolloutConfig(concurrency=2),
                TrainConfig(overlap=True, disaggregated=True),
                AdditionTask(), eos_id=EOS, device="cpu",
                rollout_device="cuda")


# -- checkpoints ---------------------------------------------------------------


def test_checkpoint_roundtrip_between_layouts(tmp_path):
    cfg_j, cfg_t = _configs("tiny")
    pj = jax.device_get(JM.init_params(jax.random.PRNGKey(2), cfg_j))
    oj = jax.device_get(jadam.init(pj))
    oj = {"m": jax.tree.map(lambda x: x + 0.5, oj["m"]),
          "v": jax.tree.map(lambda x: x + 0.25, oj["v"]),
          "step": np.asarray(7, np.int32)}
    jckpt.save(str(tmp_path / "jax.zpkl"),
               {"params": pj, "opt_state": oj, "stage": 3})
    # JAX checkpoint -> the port
    state = ckpt.load(str(tmp_path / "jax.zpkl"))
    pt = convert.params_from_jax(state["params"], cfg_t, "cpu")
    ot = convert.opt_state_from_jax(state["opt_state"], cfg_t, "cpu")
    assert int(ot["step"]) == 7 and state["stage"] == 3
    # the port's checkpoint -> the JAX layout, leaf for leaf
    ckpt.save(str(tmp_path / "port.zpkl"),
              {"params": convert.params_to_jax(pt, cfg_t),
               "opt_state": convert.opt_state_to_jax(ot, cfg_t), "stage": 3})
    back = jckpt.load(str(tmp_path / "port.zpkl"), to_device=False)
    for ref, got in ((pj, back["params"]), (oj, back["opt_state"])):
        assert jax.tree.structure(ref) == jax.tree.structure(got)
        for x, y in zip(jax.tree.leaves(ref), jax.tree.leaves(got)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
