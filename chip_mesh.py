#!/usr/bin/env python3
"""Sharded serving across the cards of one host: the collectives, splits
and merges that a (1, 1) mesh on one card never runs (``chip_smoke.py``'s
``serve_sharded`` and ``serve_sharded_kinds`` run there). One process a
card under torchrun, every rank in lockstep:

    python3 -m torch.distributed.run --standalone --nproc-per-node 4 \\
        chip_mesh.py                     # four H100s of one host (NCCL)
    PYTHONPATH=src python3 -m torch.distributed.run --standalone \\
        --nproc-per-node 4 chip_mesh.py --device cpu --smoke   # gloo

For each case, an arch at its published widths and a few layers (with
``--smoke``, its smoke config) on a mesh of the 4 ranks:

* parity, float32: ``prefill`` of 4 right-padded prompts (1 for the
  ``shard_seq`` case) and 4 greedy ``decode_step`` s on the serve layout
  and a sharded cache, against the same calls unsharded on the rank's own
  card from the same seeded weights: the largest logit difference and the
  largest difference of each cache leaf gathered, relative to that
  leaf's largest element; the run fails above 1e-3 (1e-4 is the CPU
  tests' bound for the same comparison in float32 against the reference);
* time, bfloat16: 16 rows of 128 prompt tokens, then 16 decode steps,
  each timed by a host clock to a device synchronisation, sharded against
  unsharded on the rank's card (milliseconds a step, the median of the
  steps).

Cases: hymba-1.5b on (2, 2) (its 5 kv heads split the cache's length over
"model", the SSM's channels over "model") and (1, 4); rwkv6-1.6b on
(2, 2) (heads over "model"); deepseek-moe-16b on (1, 4) (16 experts a
rank); llama-3.2-vision-90b on (1, 4) (8 kv heads: the media K/V over its
kv heads); llama3.2-1b on (1, 4) (kv heads over "model") and on the
(1, 2, 2) GQA serve mesh (heads over "kvg", the length over "model");
hymba at batch 1 on (2, 2) (``shard_seq``: its length over ("data",
"model")). Rank 0 prints one JSON line a case, the card's name and power
limit, and last ``{"ok": true, ...}``; any failed check exits non-zero.

``--weight-sync`` runs instead the cases of train and rollout on meshes of
their own, over NCCL, llama3.2-1b at full width and depth (146 leaves,
float32 masters from the seeded sharded init):

* the cross-mesh transfer (``make_param_resharder`` between two meshes)
  from disjoint (2, 1) (ranks 0-1) to (1, 2) (ranks 2-3), and from the
  same four ranks as (2, 2) to the (1, 2, 2) GQA serve mesh: each rollout
  leaf gathered must have the fingerprints (``chip_smoke.fingerprints``:
  two 64-bit sums of its bits) of the train leaf gathered; the time of a
  version (host clock from a barrier to every rank's synchronisation, the
  median of 3 after one warm transfer; and each rank's own span, CUDA
  events) against one ``dist.send`` of a buffer of all the bytes the
  transfer moves, from the first train rank to the first rollout rank
  other than itself, on the same NCCL group;
* three steps of the two-sided trainer (``CoPRISTrainer(train_mesh=A,
  rollout_mesh=B)``, overlap and disaggregated, max_staleness 1,
  adaptive N' with targets in [8, 24]) on disjoint (2, 1) + (1, 2)
  ("model" of size 1 on the train side, where the fused loss kernels run
  on each rank's rows): finite losses, each collect's version within the
  gate, each version the rollout side acquired with the fingerprints of
  the train side's params at that stage, every kernel of its side
  launched; the train side's first rank alone owns the controller, its
  trace equals one fed the observations it recorded, both rollout ranks
  collect under one target (broadcast over the rollout mesh: NCCL across
  two cards), set after an update the gate allows, and the train side
  reports it as ``concurrency_target``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# (name, arch, layers, mesh shape, rows)
CASES = (
    ("hymba_2x2", "hymba-1.5b", 4, (2, 2), 4),
    ("hymba_1x4", "hymba-1.5b", 4, (1, 4), 4),
    ("rwkv6_2x2", "rwkv6-1.6b", 4, (2, 2), 4),
    ("deepseek_1x4", "deepseek-moe-16b", 4, (1, 4), 4),
    ("vision_1x4", "llama-3.2-vision-90b", 5, (1, 4), 4),
    ("llama_1x4", "llama3.2-1b", 4, (1, 4), 4),
    ("llama_kvg_1x2x2", "llama3.2-1b", 4, (1, 2, 2), 4),
    ("hymba_shard_seq_2x2", "hymba-1.5b", 4, (2, 2), 1),
)
TOL = 1e-3
# the two-sided trainer's steps: collect 2 waits for the first target the
# train side's adaptive N' controller sends (max_staleness 1)
TRAINER_STEPS = 3


def config(arch, layers, smoke, dtype):
    from repro_torch.configs import get_config, get_smoke_config
    cfg = get_smoke_config(arch) if smoke else dataclasses.replace(
        get_config(arch), num_layers=layers)
    return dataclasses.replace(cfg, dtype=dtype)


def media_of(np, cfg, rows):
    if not cfg.uses_media:
        return None
    xa = cfg.cross_attn
    return (np.random.default_rng(2).normal(
        size=(rows, xa.num_media_tokens, xa.d_media)) * 0.1).astype(
            np.float32)


def run_model(torch, M, params, cfg, toks, lens, media, *, mesh=None,
              steps=4, L=64):
    """Prefill and ``steps`` greedy decode steps: the logits of each step
    and the cache, gathered whole, as float32 host tensors."""
    from repro_torch.common.partitioning import on_mesh, to_host
    dev = params_device(params)

    def put(a):
        return on_mesh(torch.from_numpy(a).to(dev), mesh)

    cache = M.init_cache(cfg, toks.shape[0], L, mesh=mesh, device=dev)
    logits, cache = M.prefill(
        params, cfg, put(toks), put(lens), cache,
        media=None if media is None else put(media))
    out = [to_host(logits).float().cpu()]
    clen = lens.copy()
    for _ in range(steps):
        tok = out[-1].argmax(-1).numpy().astype(toks.dtype)
        logits, cache = M.decode_step(params, cfg, put(tok), cache,
                                      put(clen))
        out.append(to_host(logits).float().cpu())
        clen = clen + 1
    return out, [{n: to_host(t).float().cpu() for n, t in layer.items()}
                 for layer in cache]


def params_device(params):
    from repro_torch.common.tree import leaves
    t = leaves(params)[0]
    return str(t.device.type if not hasattr(t, "to_local")
               else t.to_local().device.type)


def timed_decode(torch, M, params, cfg, rows, *, mesh=None, steps=16,
                 P=128, L=256):
    """Milliseconds of each of ``steps`` decode steps of ``rows`` rows after
    a prefill of ``P`` tokens, host clock to a device synchronisation."""
    import numpy as np

    from repro_torch.common.partitioning import on_mesh
    dev = params_device(params)

    def put(a):
        return on_mesh(torch.from_numpy(a).to(dev), mesh)

    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (rows, P)).astype(np.int32)
    lens = np.full(rows, P, np.int32)
    media = media_of(np, cfg, rows)
    cache = M.init_cache(cfg, rows, L, mesh=mesh, device=dev)
    _, cache = M.prefill(params, cfg, put(toks), put(lens), cache,
                         media=None if media is None else put(media))
    tok, clen, ms = put(toks[:, -1]), lens.copy(), []
    for i in range(steps + 2):
        sync(torch, dev)
        t0 = time.perf_counter()
        _, cache = M.decode_step(params, cfg, tok, cache, put(clen))
        sync(torch, dev)
        if i >= 2:                                  # two warm steps
            ms.append((time.perf_counter() - t0) * 1e3)
        clen = clen + 1
    return statistics.median(ms)


def sync(torch, dev):
    if dev == "cuda":
        torch.cuda.synchronize()


def rel(a, b):
    """The largest |a - b| relative to b's largest element (at least 1)."""
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def weight_sync_cases(torch, dist, dev, smoke):
    """The ``--weight-sync`` cases (module docstring); rank 0 prints one
    JSON line a case. Returns False where a check failed."""
    import numpy as np

    from chip_smoke import TWO_SIDED_KERNELS, fingerprints, side_kernels
    from repro_torch.common.config import RolloutConfig, TrainConfig
    from repro_torch.core.copris import CoPRISTrainer
    from repro_torch.core.weight_sync import make_param_resharder
    from repro_torch.data.tasks import EOS, AdditionTask
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import (make_disaggregated_meshes,
                                         make_gqa_serve_mesh, make_mesh,
                                         mesh_device, mesh_ranks)
    from repro_torch.models import model as M
    cfg = config("llama3.2-1b", 16, smoke, "float32")
    rank = dist.get_rank()
    ok = True

    def everyone(x):
        out = [None] * dist.get_world_size()
        dist.all_gather_object(out, x)
        return out

    def gathered(tree):       # every leaf whole, over its own mesh
        from repro_torch.common.tree import tree_map
        return tree_map(lambda t: t.full_tensor(), tree)

    for name, pair in (("transfer_2x1_to_1x2", "disjoint"),
                       ("transfer_2x2_to_kvg_1x2x2", "kvg")):
        if pair == "disjoint":
            train, rollout = make_disaggregated_meshes((2, 1), (1, 2),
                                                       device_type=dev)
        else:
            train = make_mesh(2, 2, device_type=dev)
            rollout = make_gqa_serve_mesh(1, 2, 2, device_type=dev)
        in_train = rank in mesh_ranks(train)
        params = (shd.init_sharded_params(cfg, train, seed=0) if in_train
                  else M.init_params(cfg, device="meta"))
        reshard, _ = make_param_resharder(cfg, params, train, rollout)
        walls, spans = [], []
        for i in range(4):
            dist.barrier()
            t0 = time.perf_counter()
            copy, elapsed = reshard(params)
            sync(torch, dev)
            dist.barrier()
            if i:
                walls.append((time.perf_counter() - t0) * 1e3)
                spans.append(elapsed() * 1e3)
        want = fingerprints(torch, gathered(params)) if in_train else None
        got = (fingerprints(torch, gathered(copy)) if copy is not None
               else None)
        wants, gots = everyone(want), everyone(got)
        ref = next(w for w in wants if w is not None)
        equal = [g == ref for g in gots if g is not None]
        moved = sum(everyone(reshard.bytes_sent))
        # one buffer of the same bytes, first train rank to the first
        # rollout rank other than itself, on the transfer's group
        src = mesh_ranks(train)[0]
        dst = next(r for r in mesh_ranks(rollout) if r != src)
        buf = torch.empty(moved, dtype=torch.uint8,
                          device=mesh_device(train if in_train
                                             else rollout))
        plain = []
        for i in range(4):
            dist.barrier()
            t0 = time.perf_counter()
            if rank == src:
                dist.send(buf, dst, group=reshard.group)
            elif rank == dst:
                dist.recv(buf, src, group=reshard.group)
            sync(torch, dev)
            dist.barrier()
            if i:
                plain.append((time.perf_counter() - t0) * 1e3)
        del buf, copy, params
        if dev == "cuda":
            torch.cuda.empty_cache()
        all_spans = everyone(statistics.median(spans))
        if rank == 0:
            print(json.dumps({
                "case": name, "arch": cfg.name, "layers": cfg.num_layers,
                "leaves": len(ref), "train_mesh": dict(zip(
                    train.mesh_dim_names, train.shape)),
                "rollout_mesh": dict(zip(rollout.mesh_dim_names,
                                         rollout.shape)),
                "backend": reshard.backend, "bytes_moved": moved,
                "leaves_equal": equal,
                "version_ms": statistics.median(walls),
                "version_ms_runs": walls,
                "span_ms_by_rank": all_spans,
                "plain_send_ms": statistics.median(plain),
                "plain_send": f"one buffer of {moved} bytes, rank {src} to "
                              f"rank {dst}"}), flush=True)
        if not equal or not all(equal):
            print(f"chip_mesh: {name}: a rollout leaf differs from the "
                  "train leaf", file=sys.stderr)
            ok = False

    # two steps of the two-sided trainer; "model" of size 1 on the train
    # side, where the fused loss kernels run on each rank's rows
    train, rollout = make_disaggregated_meshes((2, 1), (1, 2),
                                               device_type=dev)
    ro = RolloutConfig(batch_size=8, group_size=4, max_prompt_len=4,
                       max_response_len=32, concurrency=16, mode="copris",
                       temperature=1.0, adaptive_concurrency=True,
                       concurrency_min=8, concurrency_max=24)
    tc = TrainConfig(lr=1e-5, warmup_steps=1, seed=3, entropy_coef=0.01,
                     overlap=True, disaggregated=True, max_staleness=1)
    tr = CoPRISTrainer(config("llama3.2-1b", 16, smoke, "bfloat16"), ro, tc,
                       AdditionTask(max_value=20, seed=3), eos_id=EOS,
                       train_mesh=train, rollout_mesh=rollout)
    kernels = {n: fn for n, fn in side_kernels().items()
               if n in TWO_SIDED_KERNELS[tr.role]}
    for fn in kernels.values():
        fn.launches = 0
    store, acquired, stages, outs = tr.param_store, [], {}, []
    # adaptive N': the train side's first rank owns the controller
    ctrl, observed = tr._concurrency_ctrl, []
    if ctrl is not None:
        observe = ctrl.observe

        def recorded_observe(**kw):
            observed.append(kw)
            return observe(**kw)
        ctrl.observe = recorded_observe
    if tr.role == "rollout":
        acquire = store.acquire

        def recorded():
            p, v = acquire()
            acquired.append((v, fingerprints(torch, gathered(p))))
            return p, v
        store.acquire = recorded
    else:
        stages[tr.stage] = fingerprints(torch, gathered(tr.params))
    try:
        for _ in range(TRAINER_STEPS):
            o = tr.step()
            outs.append({k: v for k, v in o.items()
                         if isinstance(v, (int, float))})
            if tr.role == "train":
                stages[tr.stage] = fingerprints(torch, gathered(tr.params))
    finally:
        tr.close()
    sync(torch, dev)
    recs = everyone(dict(role=tr.role, outs=outs, stages=stages,
                         acquired=acquired, observed=observed,
                         trace=list(ctrl.trace) if ctrl else None,
                         launches={n: fn.launches
                                   for n, fn in kernels.items()}))
    t_rec = next(r for r in recs if r["role"] == "train")
    r_rec = next(r for r in recs if r["role"] == "rollout")
    schedule = [o["step"] - o["param_staleness"] for o in t_rec["outs"]]
    collected = [o["params_version"] for o in r_rec["outs"]]
    equal = [f == t_rec["stages"].get(v) for v, f in r_rec["acquired"]]
    launched = (dev == "cpu" or all(
        r["launches"][n] > 0 for r in recs
        for n in TWO_SIDED_KERNELS[r["role"]]))
    gate = collected == schedule and all(
        i - 1 <= v <= i for i, v in enumerate(schedule))
    finite = all(np.isfinite(o["pg_loss"]) for o in t_rec["outs"])
    # adaptive N': one owner, its trace replayed from its observations,
    # every rollout rank under one target a collect (broadcast over the
    # rollout mesh: NCCL across two cards), each set after an update the
    # gate allows, the train side reporting it
    from repro_torch.core.scheduler import AdaptiveConcurrencyController
    owners = [r for r in recs if r["trace"] is not None]
    replay = AdaptiveConcurrencyController(ro)
    for kw in owners[0]["observed"] if owners else ():
        replay.observe(**kw)
    trace = owners[0]["trace"] if owners else []
    targets = [[o["concurrency_target"] for o in r["outs"]]
               for r in recs if r["role"] == "rollout"]
    allowed = [{trace[j + 1] for j in range(max(0, i - 2),
                                            min(i + 1, len(trace) - 1))}
               | ({trace[0]} if i < 2 and trace else set())
               for i in range(TRAINER_STEPS)]
    adaptive = (len(owners) == 1 and trace == replay.trace
                and all(t == targets[0] for t in targets)
                and all(t in a for t, a in zip(targets[0], allowed))
                and all([o["concurrency_target"] for o in r["outs"]]
                        == targets[0] for r in recs if r["role"] == "train"))
    if rank == 0:
        keys = ("step_time", "rollout_time", "update_time", "reshard_time",
                "rollout_reshard_time", "batch_wait_time",
                "param_staleness", "pg_loss")
        print(json.dumps({
            "case": "trainer_2x1_and_1x2", "arch": cfg.name,
            "layers": cfg.num_layers, "steps": [
                {k: o.get(k) for k in keys} for o in t_rec["outs"]],
            "schedule": schedule, "collected_under": collected,
            "acquired_equal": equal, "adaptive_trace": trace,
            "adaptive_replayed": replay.trace,
            "collect_targets_by_rollout_rank": targets,
            "launches": {r["role"] + str(i): r["launches"]
                         for i, r in enumerate(recs)}}), flush=True)
    if not (gate and finite and equal and all(equal) and launched
            and adaptive):
        print(f"chip_mesh: trainer: gate {gate}, finite {finite}, acquired "
              f"equal {equal}, launched {launched}, adaptive {adaptive} "
              f"(trace {trace}, replayed {replay.trace}, targets "
              f"{targets})", file=sys.stderr)
        ok = False
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke configs (a rehearsal on the CPU)")
    ap.add_argument("--weight-sync", action="store_true",
                    help="only the cases of train and rollout on meshes "
                         "of their own")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.launch import sharding as shd
    from repro_torch.launch.multihost import mesh_from_args
    from repro_torch.models import model as M
    if args.device == "cuda" and not torch.cuda.is_available():
        print("chip_mesh: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = args.device
    meshes = {}
    rank0 = None
    if args.weight_sync:
        if mesh_from_args("2,2", dev) is None:
            return 2
        rank0 = dist.get_rank() == 0
        if not weight_sync_cases(torch, dist, dev, args.smoke):
            return 1
    for name, arch, layers, shape, rows in (() if args.weight_sync
                                            else CASES):
        spec = ",".join(map(str, shape))
        if spec not in meshes:
            meshes[spec] = mesh_from_args(spec, dev)
            if meshes[spec] is None:
                return 2
        mesh = meshes[spec]
        rank0 = dist.get_rank() == 0
        where = "cpu" if dev == "cpu" else torch.device(
            "cuda", torch.cuda.current_device())
        # parity, float32
        cfg = config(arch, layers, args.smoke, "float32")
        rng = np.random.default_rng(1)
        toks = rng.integers(0, cfg.vocab_size, (rows, 16)).astype(np.int32)
        lens = np.array([11] if rows == 1 else [16, 9, 3, 12][:rows],
                        np.int32)
        media = media_of(np, cfg, rows)
        params = M.init_params(cfg, seed=0, device=where)
        want, want_cache = run_model(torch, M, params, cfg, toks, lens,
                                     media)
        sharded = shd.shard_params(params, mesh, cfg, serve_tp_only=True,
                                   serve_decode=True)
        got, got_cache = run_model(torch, M, sharded, cfg, toks, lens, media,
                                   mesh=mesh)
        logit_err = max(rel(a, b) for a, b in zip(got, want))
        leaf_err = {}
        for layer_g, layer_w in zip(got_cache, want_cache):
            for n in layer_w:
                leaf_err[n] = max(leaf_err.get(n, 0.0),
                                  rel(layer_g[n], layer_w[n]))
        layout = sorted({f"{n}: {t.placements}" for layer in M.init_cache(
            cfg, rows, 64, mesh=mesh, device=where) for n, t in
            layer.items()})
        del params, sharded
        # time, bfloat16
        cfg16 = config(arch, layers, args.smoke, "bfloat16")
        params = M.init_params(cfg16, seed=0, device=where,
                               compute_dtype=torch.bfloat16)
        rows_t = 1 if rows == 1 else 16
        plain_ms = timed_decode(torch, M, params, cfg16, rows_t)
        sharded = shd.shard_params(params, mesh, cfg16, serve_tp_only=True,
                                   serve_decode=True)
        del params
        mesh_ms = timed_decode(torch, M, sharded, cfg16, rows_t, mesh=mesh)
        del sharded
        if dev == "cuda":
            torch.cuda.empty_cache()
        errs = [None] * dist.get_world_size()
        dist.all_gather_object(errs, max([logit_err, *leaf_err.values()]))
        if rank0:
            print(json.dumps({
                "case": name, "arch": cfg.name, "layers": cfg.num_layers,
                "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
                "rows": rows, "backend": dist.get_backend(),
                "logit_rel_err": logit_err, "cache_rel_err": leaf_err,
                "worst_rel_err_by_rank": errs, "tol": TOL,
                "cache_layout": layout,
                "decode_step_ms": mesh_ms, "decode_step_ms_unsharded":
                plain_ms, "timed_rows": rows_t}), flush=True)
        if max(errs) > TOL:
            print(f"chip_mesh: {name}: sharded differs from unsharded by "
                  f"{max(errs)} (> {TOL})", file=sys.stderr)
            return 1
    dist.barrier()
    if rank0:
        if dev == "cuda":
            print(subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True,
                text=True).stdout.strip(), flush=True)
            kind, count = (torch.cuda.get_device_name(0),
                           torch.cuda.device_count())
        else:
            kind, count = "cpu", dist.get_world_size()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu" if dev == "cuda" else "cpu", "kind": kind,
            "count": count}}), flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
