"""Multi-process launcher of the sharded update: the port of
``repro.launch.multihost``.

One process per card, started by ``torchrun``; the default process group
comes from its environment (NCCL on the card, gloo with ``--device cpu``),
the (data, model) mesh is built over every rank, and the CoPRIS update
runs sharded (``core/copris.make_train_step`` on ``DTensor`` s placed by
``launch/sharding``) on seeded synthetic batches:

    # 8 cards of one host, FSDP over 4 x tensor-parallel over 2:
    torchrun --nproc-per-node 8 -m repro_torch.launch.multihost \\
        --arch llama3.2-1b --mesh 4,2 --steps 100

    # on the CPU, 4 gloo ranks:
    torchrun --nproc-per-node 4 -m repro_torch.launch.multihost \\
        --arch tiny --device cpu --mesh 2,2 --global-batch 8 --seq-len 32 \\
        --steps 2

A mesh whose product is not the world size is refused with exit code 2.
The run size defaults to the reference's ``train_4k`` (global batch 256,
sequence 4096); ``--global-batch`` and ``--seq-len`` set another.
"""
from __future__ import annotations

import argparse
import math
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

LR = 1e-6              # the reference launcher's learning rate

# per-arch microbatch count of the train_4k update (the reference's table):
# keeps activations per device sane
TRAIN_MICROBATCHES = {
    "llama-3.2-vision-90b": 16, "granite-34b": 16, "qwen3-moe-235b-a22b": 16,
    "qwen3-14b": 8,
    # 16 microbatches -> 65536 tokens = exactly one MoE dispatch chunk
    "deepseek-moe-16b": 16,
}


def synthetic_batch(cfg, global_batch: int, seq_len: int, rng):
    """The reference's synthetic update batch: uniform tokens, every
    position in the loss, behaviour log-probs 0, normal advantages. Every
    rank draws the same one from the same seed."""
    B, S = global_batch, seq_len
    return {
        "tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)),
        "loss_mask": torch.ones(B, S),
        "behaviour_logp": torch.zeros(B, S),
        "advantages": torch.from_numpy(
            rng.normal(size=(B,)).astype(np.float32)),
    }


def run(cfg, mesh, *, global_batch: int, seq_len: int, steps: int,
        microbatches: int = 1, log=None):
    """Materialise sharded params and AdamW state on ``mesh`` (the port's
    seeded init made already sharded, ``sharding.init_sharded_params``,
    then ``adam.init`` of the shards) and run ``steps`` sharded updates (lr
    ``LR``) on seeded synthetic batches. Returns ``(params, opt_state,
    losses)``; ``log`` (rank 0 only, if given) receives each step's line,
    and on the card first the peak memory of the init."""
    from repro_torch.common.config import TrainConfig
    from repro_torch.common.partitioning import set_activation_mesh
    from repro_torch.core.copris import make_train_step
    from repro_torch.launch import sharding as shd
    from repro_torch.optim import adam

    set_activation_mesh(mesh)
    dev = torch.device(mesh.device_type, torch.cuda.current_device()
                       if mesh.device_type == "cuda" else None)
    params = shd.init_sharded_params(cfg, mesh, seed=0)
    opt = adam.init(params)
    if log is not None and dist.get_rank() == 0 and dev.type == "cuda":
        log(f"init peak memory {torch.cuda.max_memory_allocated(dev)} bytes, "
            f"params and AdamW state {torch.cuda.memory_allocated(dev)} "
            "bytes (rank 0)")
    step = make_train_step(cfg, TrainConfig(microbatches=microbatches,
                                            remat=True))
    rng = np.random.default_rng(0)
    losses = []
    for i in range(steps):
        # the rollout engine feeds this batch in the integrated system;
        # here the launcher drives the update path end to end
        batch = shd.shard_batch(
            {k: v.to(dev) for k, v in
             synthetic_batch(cfg, global_batch, seq_len, rng).items()},
            mesh)
        params, opt, metrics = step(params, opt, batch, LR)
        losses.append(float(metrics["pg_loss"]))
        if log is not None and dist.get_rank() == 0:
            log(f"step {i}: loss {losses[-1]:.4f} "
                f"grad_norm {float(metrics['grad_norm']):.4f}")
    return params, opt, losses


def _init_process_group(device_type: str):
    """The default process group from torchrun's environment (or one rank
    on an in-process store when run alone), unless one exists already."""
    from repro_torch.launch.mesh import init_single_process_group
    if dist.is_initialized():
        return
    if "WORLD_SIZE" not in os.environ:
        init_single_process_group(device_type)
        return
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method="env://")


def mesh_from_args(spec, device_type: str):
    """The mesh a launcher's ``--mesh`` names over the default process
    group from torchrun's environment: DATA,MODEL a (data, model) mesh
    (None: every rank on "data"), DATA,KVG,MODEL the GQA serve mesh; None,
    after saying why, when its product is not the world size."""
    from repro_torch.launch.mesh import make_gqa_serve_mesh, make_mesh
    _init_process_group(device_type)
    world = dist.get_world_size()
    shape = ((world, 1) if spec is None
             else tuple(int(n) for n in spec.split(",")))
    if math.prod(shape) != world:
        print(f"launcher: mesh {shape} needs {math.prod(shape)} ranks, "
              f"found {world}; launch torchrun --nproc-per-node "
              f"{math.prod(shape)}", file=sys.stderr)
        return None
    if len(shape) == 3:
        return make_gqa_serve_mesh(*shape, device_type=device_type)
    return make_mesh(*shape, device_type=device_type)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: NCCL, one card per rank (LOCAL_RANK); "
                         "cpu: gloo")
    ap.add_argument("--mesh", default=None,
                    help="DATA,MODEL (default: every rank on data)")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--global-batch", type=int, default=256)
    ap.add_argument("--seq-len", type=int, default=4096)
    ap.add_argument("--microbatches", type=int, default=None,
                    help="default: the reference's per-arch train_4k count")
    args = ap.parse_args(argv)

    from repro_torch.common.device import resolve_device
    from repro_torch.configs import get_config

    mesh = mesh_from_args(args.mesh, resolve_device(args.device).type)
    if mesh is None:
        return 2
    cfg = get_config(args.arch)
    k = args.microbatches or TRAIN_MICROBATCHES.get(cfg.name, 8)
    _, _, losses = run(cfg, mesh, global_batch=args.global_batch,
                       seq_len=args.seq_len, steps=args.steps,
                       microbatches=k, log=print)
    if not all(np.isfinite(losses)):
        print(f"multihost launcher: non-finite loss {losses}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    code = main()
    if dist.is_initialized():
        dist.destroy_process_group()
    sys.exit(code)
