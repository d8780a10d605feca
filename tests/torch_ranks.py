"""Rank-side helpers of the multi-rank tests of the port
(``tests/test_torch_distributed.py``): no JAX here, so a spawned rank
imports only torch and the port.

:func:`spawn` starts ``world`` ranks with ``torch.multiprocessing.spawn``,
each in a gloo process group on a file store under the test's temporary
directory (never a fixed TCP port: several test workers run at once),
with one thread each; every rank runs one of the functions below on the
inputs the test wrote (numpy arrays, pickled) and its result comes back
the same way. A rank's exception fails the spawn with its traceback.
"""
from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np


# the cases at vocab 8192 (the big-vocab loss), float32
ARCH = {"llama": "llama3.2-1b", "hymba": "hymba-1.5b", "rwkv": "rwkv6-1.6b",
        "qwen3": "qwen3-14b", "gemma2": "gemma2-2b"}
VLM = "llama-3.2-vision-90b"


def case_config(name: str, get_config=None, get_smoke_config=None):
    """The port's config of a test case; given the JAX package's
    ``get_config`` / ``get_smoke_config``, the JAX one from the same
    fields. gemma2: its sliding window cut to 8, so it binds in a 24-token
    row; vlm: one 5-layer period of the VLM (one xattn layer);
    ``smoke:<arch>``: the smoke config in float32; tiny-kv1: tiny with one
    kv head."""
    if get_config is None:
        from repro_torch.configs import get_config, get_smoke_config
    if name == "tiny":
        return get_config("tiny")
    if name == "tiny-kv1":
        return dataclasses.replace(get_config("tiny"), num_kv_heads=1)
    if name.startswith("smoke:"):
        return dataclasses.replace(get_smoke_config(name[6:]),
                                   dtype="float32")
    if name == "vlm":
        return dataclasses.replace(get_config(VLM).reduced(num_layers=5),
                                   vocab_size=8192, dtype="float32")
    if name in ARCH:
        cfg = dataclasses.replace(get_smoke_config(ARCH[name]),
                                  vocab_size=8192, dtype="float32")
        if name == "gemma2":
            cfg = dataclasses.replace(cfg, sliding_window=8)
        return cfg
    if name in ("deepseek", "deepseek-sparse"):
        cfg = get_smoke_config("deepseek-moe-16b")
        moe = dataclasses.replace(
            cfg.moe, num_experts=8, top_k=2, capacity_factor=16.0,
            router_aux_coef=0.0,
            dispatch="shardmap" if name == "deepseek" else "sparse")
        return dataclasses.replace(cfg, moe=moe, vocab_size=8192,
                                   dtype="float32")
    raise KeyError(name)


def spawn(fn: str, tmp_path, world: int, **inputs):
    """Run ``fn(rank, mesh_shape=..., **inputs)`` on ``world`` gloo ranks;
    returns the ranks' results in rank order. The pickles of the inputs
    and of the results are deleted once read (a run of the tests would
    otherwise leave gigabytes of them under the temporary directory)."""
    import torch.multiprocessing as mp
    inputs_path = os.path.join(tmp_path, "inputs.pkl")
    with open(inputs_path, "wb") as f:
        pickle.dump(inputs, f)
    try:
        mp.spawn(_entry, args=(world, str(tmp_path), fn), nprocs=world,
                 join=True)
    finally:
        os.remove(inputs_path)
    out = []
    for r in range(world):
        path = os.path.join(tmp_path, f"rank{r}.pkl")
        with open(path, "rb") as f:
            out.append(pickle.load(f))
        os.remove(path)
    return out


def _entry(rank, world, tmp, fn):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)
        res = globals()[fn](rank, **inputs)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def _np(tree):
    """A tree of tensors (DTensors gathered whole) as numpy arrays."""
    from repro_torch.common.tree import tree_map
    return tree_map(lambda t: (t.full_tensor() if hasattr(t, "full_tensor")
                               else t).detach().cpu().numpy().copy(), tree)


def _mesh(mesh_shape):
    from repro_torch.common.partitioning import set_activation_mesh
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(*mesh_shape, device_type="cpu")
    set_activation_mesh(mesh)
    return mesh


def _placement_leaves(pl_tree, like):
    """The placements of ``pl_tree`` in the leaf order of ``like``."""
    if isinstance(like, dict):
        return [x for k in sorted(like)
                for x in _placement_leaves(pl_tree[k], like[k])]
    if isinstance(like, (list, tuple)):
        return [x for i, v in enumerate(like)
                for x in _placement_leaves(pl_tree[i], v)]
    return [pl_tree]


# -- rank functions -----------------------------------------------------------


def train_step(rank, *, mesh_shape, case, params, batch, tc):
    """One sharded ``make_train_step`` from the JAX-layout ``params``:
    the full updated params, AdamW state and metrics, and the all-to-all
    exchanges the step made."""
    import torch

    from repro_torch import convert
    from repro_torch.common.config import TrainConfig
    from repro_torch.common.tree import leaves
    from repro_torch.core import copris
    from repro_torch.launch import sharding as shd
    from repro_torch.models.moe_shardmap import apply_moe_shardmap
    from repro_torch.optim import adam
    cfg = case_config(case)
    mesh = _mesh(mesh_shape)
    p = shd.shard_params(convert.params_from_jax(params, cfg, "cpu"), mesh,
                         cfg)
    st = adam.init(p)
    b = shd.shard_batch({k: torch.from_numpy(v) for k, v in batch.items()},
                        mesh)
    # AdamW's moments take their parameter's placements, which are the
    # reference's opt-state rules
    want = shd.opt_state_placements(p, mesh, cfg)
    opt_placed = all(tuple(t.placements) == tuple(pl) for name in ("m", "v")
                     for t, pl in zip(leaves(st[name]),
                                      _placement_leaves(want[name], p)))
    before = apply_moe_shardmap.exchanges
    p, st, m = copris.make_train_step(cfg, TrainConfig(**tc))(p, st, b,
                                                              1e-3)
    return dict(params=_np(p), m=_np(st["m"]), v=_np(st["v"]),
                step=int(st["step"]), opt_placed=opt_placed,
                metrics={k: float(v) for k, v in m.items()},
                exchanges=apply_moe_shardmap.exchanges - before)


def moe_dispatch(rank, *, mesh_shape, params, x, cf):
    """``apply_moe_shardmap`` on the deepseek case's layer: y, aux and the
    gradients of ``y.sum()``, gathered."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.common.tree import leaves
    from repro_torch.launch import sharding as shd
    from repro_torch.models.moe_shardmap import apply_moe_shardmap
    cfg = case_config("deepseek")
    mesh = _mesh(mesh_shape)
    p = shd.shard_params({"moe": {k: (torch.from_numpy(v) if not
                                      isinstance(v, dict) else
                                      {kk: torch.from_numpy(vv)
                                       for kk, vv in v.items()})
                                  for k, v in params.items()}},
                         mesh, cfg)["moe"]
    xd = distribute_tensor(torch.from_numpy(x), mesh,
                           [Shard(0), Replicate()]).requires_grad_()
    before = apply_moe_shardmap.exchanges
    y, aux = apply_moe_shardmap(p, cfg, xd, mesh, capacity_factor=cf)
    y.sum().backward()
    return dict(y=y.full_tensor().detach().numpy(),
                aux=float(aux.full_tensor()),
                grads=_np({k: ({kk: vv.grad for kk, vv in v.items()}
                               if isinstance(v, dict) else v.grad)
                           for k, v in p.items()}),
                dx=xd.grad.full_tensor().numpy(),
                n_grads=len(leaves(p)),
                exchanges=apply_moe_shardmap.exchanges - before)


def launcher(rank, *, mesh_shape, bad_mesh, steps):
    """``multihost.main`` on a mesh that does not fit the world (its exit
    code), then ``multihost.run`` on ``mesh_shape``: the losses, each
    rank's local shards with their placements, and the full params."""
    from repro_torch.common.tree import leaves
    from repro_torch.configs import get_config
    from repro_torch.launch import multihost
    code = multihost.main(["--arch", "tiny", "--device", "cpu", "--mesh",
                           ",".join(map(str, bad_mesh)), "--steps", "1"])
    mesh = _mesh(mesh_shape)
    params, _, losses = multihost.run(get_config("tiny"), mesh,
                                      global_batch=8, seq_len=16,
                                      steps=steps, microbatches=2)
    return dict(code=code, losses=losses,
                coord=tuple(int(c) for c in mesh.get_coordinate()),
                local=[t.to_local().detach().numpy().copy()
                       for t in leaves(params)],
                data_replicated=[t.placements[0].is_replicate()
                                 for t in leaves(params)],
                full=[np.asarray(t) for t in leaves(_np(params))])


def _serve_cfg(case):
    """tiny, or the reduced llama3.2-1b at vocab 8192 in float32."""
    import dataclasses

    from repro_torch.configs import get_config, get_smoke_config
    if case == "tiny":
        return get_config("tiny")
    return dataclasses.replace(get_smoke_config(ARCH[case]),
                               vocab_size=8192, dtype="float32")


def serve_sharded(rank, *, model_cases, engine_cases, init_cases):
    """The sharded serving path on each case's mesh: ``model_cases``
    (case, mesh shape, JAX-layout params, tokens, lengths, the tokens to
    feed (steps, B), max length) run ``prefill`` and a ``decode_step`` a
    fed token on the serve-layout params and a sharded cache, returning
    every step's logits and the gathered cache; ``engine_cases`` (case,
    mesh shape, params, rollout config, task seed, key seed) run
    ``RolloutEngine.collect``, returning each trajectory's tokens and
    logps; ``init_cases`` (config name, mesh shape: ``tiny`` or a smoke
    config) hold ``init_sharded_params`` against
    ``shard_params(init_params)`` on this rank's shards, bit for bit."""
    import torch

    from repro_torch import convert
    from repro_torch.common.config import RolloutConfig
    from repro_torch.common.partitioning import on_mesh, to_host
    from repro_torch.common.tree import leaves
    from repro_torch.core.rollout import RolloutEngine
    from repro_torch.data.tasks import EOS, AdditionTask
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.sampling import prng
    out = dict(model=[], engine=[], init=[])
    for case, shape, params, toks, lens, feed, L in model_cases:
        cfg = _serve_cfg(case)
        mesh = make_mesh(*shape, device_type="cpu")
        p = shd.shard_params(convert.params_from_jax(params, cfg, "cpu"),
                             mesh, cfg, serve_tp_only=True, serve_decode=True)
        cache = M.init_cache(cfg, toks.shape[0], L, mesh=mesh, device="cpu")
        layout = [str(t.placements) for t in leaves(cache)[:2]]
        logits, cache = M.prefill(p, cfg,
                                  on_mesh(torch.from_numpy(toks), mesh),
                                  on_mesh(torch.from_numpy(lens), mesh),
                                  cache)
        got = [to_host(logits).numpy()]
        clen = torch.from_numpy(lens)
        for tok in feed:
            logits, cache = M.decode_step(p, cfg,
                                          on_mesh(torch.from_numpy(tok), mesh),
                                          cache, on_mesh(clen, mesh))
            got.append(to_host(logits).numpy())
            clen = clen + 1
        out["model"].append(dict(
            logits=got, layout=layout,
            k=np.stack([to_host(c["k"]).numpy() for c in cache]),
            v=np.stack([to_host(c["v"]).numpy() for c in cache])))
    for case, shape, params, ro, task_seed, key_seed in engine_cases:
        cfg = _serve_cfg(case)
        mesh = make_mesh(*shape, device_type="cpu")
        task = AdditionTask(max_value=20, seed=task_seed)
        eng = RolloutEngine(cfg, RolloutConfig(**ro), task.sample_prompt,
                            eos_id=EOS, mesh=mesh)
        groups, st = eng.collect(
            eng.prepare_params(convert.params_from_jax(params, cfg, "cpu")),
            0, prng.PRNGKey(key_seed))
        out["engine"].append(dict(
            trajs={(g.group_id, t.sample_idx): (list(t.response_tokens),
                                                list(t.behaviour_logps),
                                                t.finish_reason)
                   for g in groups for t in g.trajectories},
            generated=st["generated"]))
    for name, shape in init_cases:
        from repro_torch.configs import get_config, get_smoke_config
        cfg = get_config(name) if name == "tiny" else get_smoke_config(name)
        mesh = make_mesh(*shape, device_type="cpu")
        a = shd.init_sharded_params(cfg, mesh, seed=5)
        b = shd.shard_params(M.init_params(cfg, seed=5, device="cpu"), mesh,
                             cfg)
        la, lb = leaves(a), leaves(b)
        out["init"].append(dict(
            leaves=len(la), dims3=sum(t.dim() == 3 for t in la),
            placements=all(x.placements == y.placements
                           for x, y in zip(la, lb)),
            grads=all(x.requires_grad == y.requires_grad
                      for x, y in zip(la, lb)),
            equal=all(torch.equal(x.to_local(), y.to_local())
                      for x, y in zip(la, lb))))
    return out


def trainer_step(rank, *, mesh_shape, case, params, ro, tc, task_seed):
    """One sequential ``CoPRISTrainer.step()`` on ``mesh_shape`` from the
    JAX-layout ``params``: the trajectories, the metrics and the updated
    params, gathered."""
    import torch

    from repro_torch import convert
    from repro_torch.common.config import RolloutConfig, TrainConfig
    from repro_torch.common.tree import leaves
    from repro_torch.core import copris
    from repro_torch.data.tasks import EOS, AdditionTask
    from repro_torch.launch.mesh import make_mesh
    cfg = _serve_cfg(case)
    mesh = make_mesh(*mesh_shape, device_type="cpu")
    tr = copris.CoPRISTrainer(
        cfg, RolloutConfig(**ro), TrainConfig(**tc),
        AdditionTask(max_value=20, seed=task_seed), eos_id=EOS,
        params=convert.params_from_jax(params, cfg, "cpu"), train_mesh=mesh)
    try:
        metrics = tr.step()
    finally:
        tr.close()
    return dict(
        trajs={(g.group_id, t.sample_idx): (list(t.response_tokens),
                                            list(t.behaviour_logps),
                                            t.reward)
               for g in tr.last_groups for t in g.trajectories},
        metrics={k: v for k, v in metrics.items()
                 if isinstance(v, (int, float))},
        params=[np.asarray(t) for t in leaves(_np(tr.params))],
        stage=tr.stage, sharded=all(hasattr(t, "placements")
                                    for t in leaves(tr.params)),
        serve_layout=[str(t.placements) for t in
                      leaves(tr.param_store.acquire()[0])[:3]])


def _serve_mesh(shape):
    """A (data, model) mesh, or the (data, kvg, model) GQA serve mesh."""
    from repro_torch.launch.mesh import make_gqa_serve_mesh, make_mesh
    if len(shape) == 3:
        return make_gqa_serve_mesh(*shape, device_type="cpu")
    return make_mesh(*shape, device_type="cpu")


def serve_sharded_kinds(rank, *, model_cases, engine_cases):
    """Serving every block kind on a mesh: ``model_cases`` (case, mesh
    shape, JAX-layout params, tokens, lengths, media or None, the tokens to
    feed (steps, B), max length) run ``prefill`` and a ``decode_step`` a
    fed token on the serve-layout params and a sharded cache (the
    ``shard_seq`` layout at one row), returning every step's logits, every
    cache leaf gathered and the K/V leaves' layouts; ``engine_cases``
    (case, mesh shape, params, rollout config, task seed, key seed) run
    ``RolloutEngine.collect``."""
    import torch

    from repro_torch import convert
    from repro_torch.common.config import RolloutConfig
    from repro_torch.common.partitioning import on_mesh, to_host
    from repro_torch.core.rollout import RolloutEngine
    from repro_torch.data.tasks import EOS, AdditionTask
    from repro_torch.launch import sharding as shd
    from repro_torch.models import model as M
    from repro_torch.sampling import prng
    out = dict(model=[], engine=[])
    for case, shape, params, toks, lens, media, feed, L in model_cases:
        cfg = case_config(case)
        mesh = _serve_mesh(shape)
        p = shd.shard_params(convert.params_from_jax(params, cfg, "cpu"),
                             mesh, cfg, serve_tp_only=True, serve_decode=True)
        cache = M.init_cache(cfg, toks.shape[0], L, mesh=mesh, device="cpu")
        layout = {f"{i}.{n}": str(t.placements)
                  for i, layer in enumerate(cache) for n, t in layer.items()}
        logits, cache = M.prefill(
            p, cfg, on_mesh(torch.from_numpy(toks), mesh),
            on_mesh(torch.from_numpy(lens), mesh), cache,
            media=None if media is None else torch.from_numpy(media))
        got = [to_host(logits).numpy()]
        clen = torch.from_numpy(lens)
        for tok in feed:
            logits, cache = M.decode_step(p, cfg,
                                          on_mesh(torch.from_numpy(tok), mesh),
                                          cache, on_mesh(clen, mesh))
            got.append(to_host(logits).numpy())
            clen = clen + 1
        out["model"].append(dict(
            logits=got, layout=layout,
            cache=[{n: to_host(t).numpy() for n, t in layer.items()}
                   for layer in cache]))
    for case, shape, params, ro, task_seed, key_seed in engine_cases:
        cfg = case_config(case)
        mesh = _serve_mesh(shape)
        task = AdditionTask(max_value=20, seed=task_seed)
        eng = RolloutEngine(cfg, RolloutConfig(**ro), task.sample_prompt,
                            eos_id=EOS, mesh=mesh)
        groups, st = eng.collect(
            eng.prepare_params(convert.params_from_jax(params, cfg, "cpu")),
            0, prng.PRNGKey(key_seed))
        out["engine"].append(dict(
            trajs={(g.group_id, t.sample_idx): (list(t.response_tokens),
                                                list(t.behaviour_logps),
                                                t.finish_reason)
                   for g in groups for t in g.trajectories},
            generated=st["generated"]))
    return out


# -- train and rollout on meshes of their own ----------------------------------


def _digests(tree):
    """One sha256 a leaf of a tree of tensors (DTensors gathered whole, in
    their ``serve_form`` where the tree is in the serve layout): equal
    digests are equal bits."""
    import hashlib

    from repro_torch.common.tree import leaves
    return [hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
            for a in leaves(_np(tree))]


def disaggregated_reshard(rank, *, cases, too_big):
    """``make_param_resharder`` between two meshes of the 8 ranks, one
    transfer a case (config name, train shape, rollout shape or "kvg": the
    (1, 2, 2) GQA serve mesh over the train mesh's 4 ranks): on each
    rollout rank every leaf's local box (global offset and shape, from
    DTensor's own rule) and values, the placements, and that the copy is
    None elsewhere; then the error of ``make_disaggregated_meshes`` on a
    world too small for ``too_big``."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    from repro_torch.common.tree import leaves
    from repro_torch.core.weight_sync import make_param_resharder
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import (GQA_AXES, make_disaggregated_meshes,
                                         mesh_ranks)
    from repro_torch.models import model as M
    out = dict(cases=[])
    for name, train_shape, rollout_shape in cases:
        cfg = case_config(name)
        if rollout_shape == "kvg":
            train, _ = make_disaggregated_meshes(train_shape, train_shape,
                                                 device_type="cpu")
            rollout = DeviceMesh("cpu", torch.tensor(
                mesh_ranks(train)).reshape(1, 2, 2), mesh_dim_names=GQA_AXES)
        else:
            train, rollout = make_disaggregated_meshes(
                train_shape, rollout_shape, device_type="cpu")
        full = M.init_params(cfg, seed=0, device="cpu")
        params = (shd.shard_params(full, train, cfg)
                  if rank in mesh_ranks(train)
                  else M.init_params(cfg, device="meta"))
        reshard, layout = make_param_resharder(cfg, params, train, rollout)
        copy, elapsed = reshard(params)
        got = None
        if copy is not None:
            got = []
            for t in leaves(copy):
                shape, offset = compute_local_shape_and_global_offset(
                    t.shape, t.device_mesh, t.placements)
                local = t.to_local()
                assert tuple(local.shape) == tuple(shape)
                got.append((tuple(offset), tuple(shape),
                            local.numpy().copy(), str(t.placements)))
        out["cases"].append(dict(got=got, seconds=elapsed(),
                                 bytes_sent=reshard.bytes_sent))
    try:
        make_disaggregated_meshes(*too_big, device_type="cpu")
        out["error"] = None
    except ValueError as e:
        out["error"] = str(e)
    return out


def disaggregated_trainer(rank, *, params, start, ro, tc, task_seed, steps,
                          eval_prompts, adaptive=None):
    """The two-sided CoPRIS trainer on disjoint (1, 2) + (1, 2) meshes of
    the 4 ranks, the reduced llama at vocab 8192: first the refusals
    (meshes sharing some ranks, disjoint meshes without overlap), then a
    trainer made from ``start`` (JAX layout) and ``restore`` d to
    ``params`` before its first step, ``steps`` steps, ``evaluate``. A
    train rank returns each step's metrics, the digests of its params at
    every stage and (the first) the final params; a rollout rank each
    collect's stats and trajectories and the digests of every version it
    acquired. ``adaptive`` (``ro``, ``steps``, ``scripted``): then a
    trainer with adaptive N' on the same meshes from ``params``, whose
    controller hands out the ``scripted`` targets (``out["adaptive"]``:
    the observations and real trace of the controller's owner, each
    step's target)."""
    import dataclasses

    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch import convert
    from repro_torch.common.config import RolloutConfig, TrainConfig
    from repro_torch.common.tree import leaves
    from repro_torch.core.copris import CoPRISTrainer
    from repro_torch.data.tasks import EOS, AdditionTask
    from repro_torch.launch.mesh import AXES, make_disaggregated_meshes
    cfg = case_config("llama")
    tcfg = TrainConfig(**tc, overlap=True, disaggregated=True)

    def trainer(train, rollout, t=tcfg):
        return CoPRISTrainer(cfg, RolloutConfig(**ro), t,
                             AdditionTask(max_value=20, seed=task_seed),
                             eos_id=EOS, params=convert.params_from_jax(
                                 start, cfg, "cpu"),
                             train_mesh=train, rollout_mesh=rollout)

    train, rollout = make_disaggregated_meshes((1, 2), (1, 2),
                                               device_type="cpu")
    refused = []
    shared = DeviceMesh("cpu", torch.tensor([[1, 2]]), mesh_dim_names=AXES)
    for pair, t in (((train, shared), tcfg),
                    ((train, rollout), dataclasses.replace(
                        tcfg, overlap=False, disaggregated=False))):
        try:
            trainer(*pair, t)
            refused.append(None)
        except ValueError as e:
            refused.append(str(e))
    tr = trainer(train, rollout)
    out = dict(role=tr.role, refused=refused, outs=[], trajs=[],
               acquired=[], stages={})
    store = tr.param_store
    if tr.role == "rollout":
        acquire = store.acquire

        def recorded():
            p, v = acquire()
            out["acquired"].append((v, _digests(p)))
            return p, v
        store.acquire = recorded
    try:
        tr.restore(params=convert.params_from_jax(params, cfg, "cpu"))
        if tr.role == "train":
            out["stages"][tr.stage] = _digests(tr.params)
        for _ in range(steps):
            o = tr.step()
            out["outs"].append({k: v for k, v in o.items()
                                if isinstance(v, (int, float))})
            if tr.role == "train":
                out["stages"][tr.stage] = _digests(tr.params)
            else:
                out["trajs"].append([
                    (g.group_id, t.sample_idx, tuple(t.response_tokens),
                     tuple(t.behaviour_logps), tuple(t.stage_ids))
                    for g in tr.last_groups for t in g.trajectories])
        out["eval"] = tr.evaluate(n_prompts=eval_prompts)
    finally:
        tr.close()
    out["stats"] = store.stats_snapshot()
    if tr.role == "train":              # a gather: every train rank
        final = [np.asarray(t) for t in leaves(_np(tr.params))]
        if rank == 0:
            out["final"] = final
    # adaptive N' across the two sides: the train side's first rank owns
    # the controller; its observe is wrapped to record the real
    # observations and trace and to hand out the scripted targets
    if adaptive is not None:
        import time
        t0 = time.perf_counter()
        tr = CoPRISTrainer(cfg, RolloutConfig(**adaptive["ro"]), tcfg,
                           AdditionTask(max_value=20, seed=task_seed),
                           eos_id=EOS, params=convert.params_from_jax(
                               params, cfg, "cpu"),
                           train_mesh=train, rollout_mesh=rollout)
        ctrl = tr._concurrency_ctrl
        got = dict(owner=ctrl is not None, observed=[], trace=None, outs=[])
        if ctrl is not None:
            real, scripted = ctrl.observe, iter(adaptive["scripted"])

            def observe(**kw):
                got["observed"].append(kw)
                real(**kw)
                return next(scripted)
            ctrl.observe = observe
        try:
            for _ in range(adaptive["steps"]):
                o = tr.step()
                got["outs"].append({k: o[k] for k in (
                    "concurrency_target", "collect_idx", "params_version",
                    "step", "param_staleness") if k in o})
        finally:
            tr.close()
        if ctrl is not None:
            got["trace"] = list(ctrl.trace)
        got["seconds"] = time.perf_counter() - t0
        out["adaptive"] = got
    # the same four ranks in two shapes: (2, 2) trains, the (1, 2, 2) GQA
    # serve mesh collects, one sequential step
    from repro_torch.launch.mesh import make_gqa_serve_mesh, make_mesh
    tr = CoPRISTrainer(cfg, RolloutConfig(**ro), TrainConfig(**tc),
                       AdditionTask(max_value=20, seed=task_seed),
                       eos_id=EOS,
                       params=convert.params_from_jax(params, cfg, "cpu"),
                       train_mesh=make_mesh(2, 2, device_type="cpu"),
                       rollout_mesh=make_gqa_serve_mesh(1, 2, 2,
                                                        device_type="cpu"))
    try:
        o = tr.step()
    finally:
        tr.close()
    out["reshaped"] = dict(
        role=tr.role, metrics={k: v for k, v in o.items()
                               if isinstance(v, (int, float))},
        trajs=[(g.group_id, t.sample_idx, tuple(t.response_tokens),
                tuple(t.behaviour_logps), tuple(t.stage_ids))
               for g in tr.last_groups for t in g.trajectories],
        params=[np.asarray(t) for t in leaves(_np(tr.params))],
        serve_layout=[str(t.placements) for t in
                      leaves(tr.param_store.acquire()[0])[:4]])
    return out
