"""Multi-pod dry run: the counterpart of ``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out runs/dryrun.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod

Each (architecture x input shape) step runs once on the production mesh,
("data", "model") 16 x 16, or with ``--multi-pod`` ("pod", "data",
"model") 2 x 16 x 16, with no card and no data: this process is rank 0 of
a default process group of backend ``fake`` (256 or 512 ranks, whose
collectives move nothing), and every tensor is a fake tensor
(``FakeTensorMode``: shapes and dtypes, no storage). The step is the
port's own: ``core/copris.make_train_step`` for ``train_4k``,
``models/model.prefill`` and ``models/model.decode_step`` for serving, on
``DTensor`` s placed by ``launch/sharding``. Its hand kernels charge their
work on fake tensors (``hopper/build.charge``) and launch nothing.
``launch/op_cost.OpCost`` counts rank 0's work op by op: per-device FLOPs,
device-memory bytes, layout bytes, collective bytes by kind, the kernels'
charges, and the memory image from rank 0's live fake storage and its
peak. ``--weight-sync`` adds the weight-sync reshard of each arch
(``core/weight_sync.make_param_resharder``: train layout in, serve layout
out).

The fake tensors live on the ``meta`` device, not on a fake card: on a
build of PyTorch without CUDA, autograd aborts the process on a fake CUDA
tensor (it looks up the CUDA device guard). The kernel wrappers take a
fake tensor down the card's branch on any device (``is_fake``), so the
step takes the card's code path all the same; the mesh is a ``"cuda"``
one, as on the cards, so ``DTensor`` picks NCCL's collectives (on a CPU
mesh it replaces each all-to-all by an all-gather and a chunk).

What it leaves out: the reference's ``lower_s``/``compile_s`` are one
``trace_s`` (the eager step run once), and its ``xla_raw_*`` numbers have
no counterpart (there is no XLA). Every figure is rank 0's; where a dim
does not divide its mesh axes evenly, rank 0 holds the largest piece (the
first chunk), the worst case. The roofline terms are the counts over the
NVIDIA H100 80GB HBM3's datasheet figures, not times measured on a card.
This module refuses to run in a process that holds a real default process
group: run it in a process of its own.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.common.config import (INPUT_SHAPES, LONG_CTX_ARCHS,
                                       InputShape, ModelConfig, TrainConfig)
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.launch.multihost import TRAIN_MICROBATCHES

# NVIDIA H100 80GB HBM3 (SXM, 700 W): datasheet figures
PEAK_FLOPS_BF16 = 989e12        # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12                # device memory, bytes/s
# one 400 Gb/s NDR InfiniBand NIC a GPU, as in a DGX H100: every collective
# of the 16 x 16 mesh crosses hosts of 8 cards on at least one axis
NET_BW = 50e9                   # bytes/s a GPU
# the memory the card reports (torch.cuda.get_device_properties(0)
# .total_memory: the 85 GB of PERF.md)
CARD_MEMORY_BYTES = 85_017_493_504
DRY_DEVICE = torch.device("meta")

F32, BF16, I32 = torch.float32, torch.bfloat16, torch.int32


@functools.lru_cache(maxsize=None)
def fake_mode():
    """The process's one ``FakeTensorMode``: the model caches small
    constant tensors (RoPE frequencies), and a fake tensor of one mode
    cannot meet a fake tensor of another. It takes real inputs (a
    ``torch.tensor`` of a Python scalar on ``meta``) as fake."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def init_fake_group(world_size: int) -> None:
    """This process as rank 0 of a default process group of backend
    ``fake`` with ``world_size`` ranks (one of another size is replaced).
    Refuses a process that holds a real default group."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"the dry run needs a process of its own: this one holds a "
                f"{dist.get_backend()!r} default process group; run "
                f"python -m repro_torch.launch.dryrun in a subprocess")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def dry_mesh(data: int, model: int):
    """A ``"cuda"`` (data, model) mesh over a fake group of ``data *
    model`` ranks (``launch/mesh.make_mesh``): the tests' small meshes."""
    from repro_torch.launch.mesh import make_mesh
    init_fake_group(data * model)
    return make_mesh(data, model, device_type="cuda")


def production_mesh(multi_pod: bool = False):
    """The reference's production mesh over a fake group of 256 or 512
    ranks (``launch/mesh.make_production_mesh``)."""
    from repro_torch.launch.mesh import PRODUCTION_SHAPE, make_production_mesh
    n = 1
    for s in PRODUCTION_SHAPE:
        n *= s
    init_fake_group(2 * n if multi_pod else n)
    return make_production_mesh(multi_pod, device_type="cuda")


def mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.shape)


def dryrun_config(cfg: ModelConfig) -> ModelConfig:
    """The dry run's variant of ``cfg``: the MoE layers dispatch by the
    expert-parallel all-to-all (``moe.dispatch = "shardmap"``,
    ``models/moe_shardmap``), as the reference's production lowering.
    The reference also sets ``embed_impl``/``cache_update = "onehot"``:
    workarounds for XLA's partitioner that the port does not implement
    (it looks rows up and writes the cache in place on each rank's
    shard)."""
    if cfg.moe is not None and cfg.moe.dispatch == "sparse":
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch="shardmap"))
    return cfg


# ---------------------------------------------------------------------------
# fake tensors on the mesh
# ---------------------------------------------------------------------------


def fake_dtensor(shape, dtype, mesh, placements, *, requires_grad=False):
    """A ``DTensor`` of global ``shape`` in ``placements`` whose local
    shard is a fake tensor of rank 0's shape (the largest piece of an
    uneven split) in storage of its own. Call under ``FakeTensorMode``."""
    from torch.distributed.tensor import DTensor, Shard
    shape = torch.Size(shape)
    local_shape = list(shape)
    for n, p in zip(mesh.shape, placements):
        if isinstance(p, Shard):        # torch.chunk's first piece
            local_shape[p.dim] = -(-local_shape[p.dim] // n)
    local = torch.empty(local_shape, dtype=dtype, device=DRY_DEVICE)
    out = DTensor.from_local(local, mesh, list(placements), run_check=False,
                             shape=shape,
                             stride=torch.empty(shape, device="meta").stride())
    return out.requires_grad_() if requires_grad else out


def fake_params(cfg: ModelConfig, mesh, *, serve: bool = False,
                tp_only: bool = True, compute_dtype=None):
    """The parameter tree as fake ``DTensor`` s: ``models/model.init_params``
    on ``meta`` (shapes only) with a ``place`` that lays out each piece as
    ``launch/sharding.init_sharded_params`` does. ``serve``: the serve
    layout (each leaf in its ``serve_form``, the decode placements, no
    gradient), over "model" only with ``tp_only``."""
    from repro_torch.launch import sharding as shd
    from repro_torch.models import model as M
    names = list(mesh.mesh_dim_names)

    def one(path, t):
        if serve:
            t = shd.serve_form(path, t)
        pl = shd.param_placements(path, tuple(t.shape), mesh, cfg,
                                  serve_decode=serve)
        if serve and tp_only:
            pl = tuple(shd.Replicate() if a == "data" else p
                       for a, p in zip(names, pl))
        return fake_dtensor(t.shape, t.dtype, mesh, pl,
                            requires_grad=t.is_floating_point() and not serve)

    return M.init_params(cfg, device=DRY_DEVICE, compute_dtype=compute_dtype,
                         place=lambda path, piece: shd._with_path(
                             one, piece, tuple(path)))


def _rows(mesh, shape, dtype):
    """A batch leaf: rows over the batch axes where they divide them,
    replicated elsewhere (``launch/sharding.shard_batch``)."""
    from repro_torch.launch import sharding as shd
    pl = shd._placements([shd.batch_axes(mesh)] + [None] * (len(shape) - 1),
                         tuple(shape), shd.mesh_shape(mesh))
    return fake_dtensor(shape, dtype, mesh, pl)


def _replicated(mesh, shape, dtype):
    from repro_torch.common.partitioning import replicated
    return fake_dtensor(shape, dtype, mesh, replicated(mesh))


def fake_cache(cfg: ModelConfig, mesh, batch: int, max_len: int, dtype):
    """The stack cache of ``batch`` slots of ``max_len`` positions as fake
    ``DTensor`` s laid out as ``launch/sharding.cache_placements_tree``
    says, ``shard_seq`` at batch 1 (``models/model.init_cache``)."""
    from repro_torch.common.tree import tree_map
    from repro_torch.launch.sharding import cache_placements_tree
    from repro_torch.models import transformer
    shapes = transformer.init_stack_cache(cfg, batch, max_len, dtype,
                                          torch.device("meta"))
    pls = cache_placements_tree(shapes, cfg, mesh, shard_seq=batch == 1)
    return tree_map(lambda t, pl: fake_dtensor(t.shape, t.dtype, mesh, pl),
                    shapes, pls)


# ---------------------------------------------------------------------------
# input specs
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: InputShape, mesh, *,
                serve_dtype=BF16, tcfg: TrainConfig = None):
    """Returns ``(step_fn, args, meta)``: the step and its arguments, fake
    ``DTensor`` s on ``mesh``. Call under ``FakeTensorMode``. ``tcfg``
    overrides the train step's config (default: the reference's, remat
    and its microbatches per arch). Serving holds the weights and the
    cache in ``serve_dtype`` and computes in it (the reference casts the
    weights and the cache to bf16)."""
    from repro_torch.models import model as M
    B, S = shape.global_batch, shape.seq_len
    media = None
    if cfg.uses_media:
        xa = cfg.cross_attn
        media = _rows(mesh, (B, xa.num_media_tokens, xa.d_media),
                      serve_dtype if shape.kind != "train" else F32)

    if shape.kind == "train":
        from repro_torch.core.copris import make_train_step
        from repro_torch.optim import adam
        if tcfg is None:
            tcfg = TrainConfig(microbatches=TRAIN_MICROBATCHES.get(cfg.name,
                                                                   8),
                               remat=True)
        step = make_train_step(cfg, tcfg)
        params = fake_params(cfg, mesh)
        opt = adam.init(params)
        batch = {"tokens": _rows(mesh, (B, S), I32),
                 "loss_mask": _rows(mesh, (B, S), F32),
                 "behaviour_logp": _rows(mesh, (B, S), F32),
                 "advantages": _rows(mesh, (B,), F32)}
        if media is not None:
            batch["media"] = media
        return (step, (params, opt, batch, tcfg.lr),
                {"microbatches": tcfg.microbatches})

    # serving computes in serve_dtype, as its weights and cache are held
    cfg = dataclasses.replace(cfg, dtype=str(serve_dtype).split(".")[-1])
    from repro_torch.launch.sharding import serve_fits_tp_only
    tp_only = serve_fits_tp_only(cfg, mesh, budget_bytes=CARD_MEMORY_BYTES)
    params = fake_params(cfg, mesh, serve=True, tp_only=tp_only,
                         compute_dtype=serve_dtype)
    meta = {"serve_tp_only": tp_only}
    if shape.kind == "prefill":
        cache = fake_cache(cfg, mesh, B, S + 8, serve_dtype)

        @torch.no_grad()
        def prefill_step(params, tokens, lengths, cache, media=None):
            return M.prefill(params, cfg, tokens, lengths, cache,
                             media=media)

        args = (params, _rows(mesh, (B, S), I32), _rows(mesh, (B,), I32),
                cache)
        return prefill_step, args + ((media,) if media is not None else ()), \
            meta

    # decode: ONE new token against a seq_len cache; the media K/V live in
    # the cache, so decode takes no media
    cache = fake_cache(cfg, mesh, B, S, serve_dtype)
    place = _replicated if B == 1 else _rows

    @torch.no_grad()
    def serve_step(params, token, cache, cache_len):
        return M.decode_step(params, cfg, token, cache, cache_len)

    meta["shard_seq"] = B == 1
    return serve_step, (params, place(mesh, (B,), I32), cache,
                        place(mesh, (B,), I32)), meta


# ---------------------------------------------------------------------------
# one combination
# ---------------------------------------------------------------------------


def count_step(step, args, mesh, *, repeat: int = 1):
    """Run ``step(*args)`` ``repeat`` times on ``mesh`` under an
    ``OpCost``. Returns (the last result, the cost record, seconds)."""
    from repro_torch.common.partitioning import set_activation_mesh
    from repro_torch.launch.op_cost import OpCost
    cost = OpCost()
    held = cost.hold(*args)
    set_activation_mesh(mesh)
    t0 = time.perf_counter()
    try:
        with cost:
            for _ in range(repeat):
                out = step(*args)
    finally:
        set_activation_mesh(None)
    return out, cost.record(out, arguments=held), time.perf_counter() - t0


def roofline(rec: dict) -> dict:
    """The per-device roofline terms of a cost record at the card's
    datasheet figures: the card runs layout ops as kernels, so the memory
    term reads ``bytes + layout_bytes``."""
    return {"compute_s": rec["flops"] / PEAK_FLOPS_BF16,
            "memory_s": (rec["bytes"] + rec["layout_bytes"]) / HBM_BW,
            "collective_s": rec["collectives"]["total"] / NET_BW}


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            mesh=None, verbose: bool = True, cfg_override=None) -> dict:
    cfg = dryrun_config(cfg_override or get_config(arch))
    shape = INPUT_SHAPES[shape_name]
    mesh = mesh or production_mesh(multi_pod)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name(mesh),
           "status": "skip"}
    if shape_name == "long_500k" and arch not in LONG_CTX_ARCHS:
        rec["reason"] = ("pure full-attention arch; long_500k requires "
                         "sub-quadratic attention (the reference's "
                         "DESIGN.md §4)")
        return rec
    chips = mesh.size()
    with fake_mode():
        step, args, meta = input_specs(cfg, shape, mesh)
    _, cost, trace_s = count_step(step, args, mesh)
    terms = roofline(cost)
    dominant = max(terms, key=terms.get)
    n_params = cfg.param_count()
    n_active = cfg.param_count(active_only=True)
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    model_flops = (6 if shape.kind == "train" else 2) * n_active * tokens
    rec.update(
        status="ok", chips=chips, trace_s=round(trace_s, 2),
        flops_per_device=cost["flops"], bytes_per_device=cost["bytes"],
        layout_bytes_per_device=cost["layout_bytes"],
        collective_bytes=cost["collectives"], memory=cost["memory"],
        kernels=cost["kernels"], ops=cost["ops"], roofline=terms,
        dominant=dominant.replace("_s", ""), model_flops_total=model_flops,
        params=n_params, active_params=n_active,
        useful_flops_ratio=model_flops / max(cost["flops"] * chips, 1.0),
        meta=meta)
    if verbose:
        mem = cost["memory"]["total_nonalias"]
        print(f"  [{rec['mesh']}] {arch} x {shape_name}: "
              f"compute={terms['compute_s'] * 1e3:.2f}ms "
              f"memory={terms['memory_s'] * 1e3:.2f}ms "
              f"collective={terms['collective_s'] * 1e3:.2f}ms "
              f"dominant={rec['dominant']} "
              f"useful={rec['useful_flops_ratio']:.2f} "
              f"mem/device={mem / 2**30:.2f}GiB (trace {trace_s:.0f}s)",
              flush=True)
    return rec


def run_reshard(arch: str, *, multi_pod: bool = False, mesh=None,
                verbose: bool = True, cfg_override=None) -> dict:
    """The weight-sync reshard of one published version on the production
    mesh: the train layout in, the serve layout out, by the port's
    ``core/weight_sync.make_param_resharder`` (the transfer
    ``ParamStore.publish`` runs a version on one mesh). The interesting
    number is the collective bill."""
    from repro_torch.common.tree import leaves
    from repro_torch.core.weight_sync import make_param_resharder
    cfg = cfg_override or get_config(arch)
    mesh = mesh or production_mesh(multi_pod)
    rec = {"arch": arch, "shape": "weight_sync", "mesh": mesh_name(mesh),
           "status": "ok", "chips": mesh.size()}
    with fake_mode():
        params = fake_params(cfg, mesh)
    reshard, _ = make_param_resharder(cfg, params, mesh)
    (copy, _), cost, trace_s = count_step(reshard, (params,), mesh)
    sync_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    rec.update(trace_s=round(trace_s, 2), params=cfg.param_count(),
               sync_bytes_per_version=sync_bytes,
               collective_bytes=cost["collectives"],
               collective_s=cost["collectives"]["total"] / NET_BW,
               memory=cost["memory"])
    if verbose:
        total = cost["collectives"]["total"]
        print(f"  [{rec['mesh']}] {arch} x weight_sync: "
              f"{sync_bytes / 2**30:.2f}GiB/version, collective "
              f"{total / 2**30:.2f}GiB/device "
              f"({rec['collective_s'] * 1e3:.2f}ms) (trace {trace_s:.0f}s)",
              flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--weight-sync", action="store_true",
                    help="additionally run the weight-sync reshard (train "
                         "layout -> serve layout) for each arch")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = list(ASSIGNED_ARCHS) if (args.all or not args.arch) \
        else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    results = []
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results
            if r.get("status") in ("ok", "skip")}

    for mp in meshes:
        mesh = production_mesh(mp)
        mname = mesh_name(mesh)
        for arch in archs:
            arch_shapes = list(shapes)
            if args.weight_sync:
                arch_shapes.append("weight_sync")
            for shape in arch_shapes:
                if (arch, shape, mname) in done:
                    continue
                try:
                    if shape == "weight_sync":
                        rec = run_reshard(arch, mesh=mesh)
                    else:
                        rec = run_one(arch, shape, mesh=mesh)
                except Exception as e:
                    rec = {"arch": arch, "shape": shape, "mesh": mname,
                           "status": "error", "error": str(e),
                           "trace": traceback.format_exc()[-2000:]}
                    print(f"  [{mname}] {arch} x {shape}: ERROR {e}",
                          flush=True)
                results.append(rec)
                print(json.dumps(rec), flush=True)
                if args.out:
                    os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                                exist_ok=True)
                    with open(args.out, "w") as f:
                        json.dump(results, f, indent=1)

    ok = sum(1 for r in results if r["status"] == "ok")
    skip = sum(1 for r in results if r["status"] == "skip")
    err = sum(1 for r in results if r["status"] == "error")
    print(f"\ndry-run: {ok} ok, {skip} documented skips, {err} errors")
    return 1 if err else 0


if __name__ == "__main__":
    sys.exit(main())
