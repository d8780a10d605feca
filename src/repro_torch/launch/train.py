"""RL training launcher of the port: the CoPRIS loop on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch llama3.2-1b --mode copris --steps 20 --concurrency 16 \\
        --sft-warmup 5 --out runs/llama_copris

The flags are those of ``repro.launch.train``, plus ``--device`` (the card by
default; ``--device cpu`` runs the plain PyTorch path on the host). Writes
metrics.jsonl per step and checkpoints every --ckpt-every steps, in the JAX
package's checkpoint layout, so ``--resume`` takes a checkpoint of either
package. ``--overlap`` runs rollout on a producer thread (on the card, on a
CUDA stream of its own) while the previous batch trains, at most
``--max-staleness`` updates behind; ``--task multiturn_math`` and
``--task toolcall`` run multi-turn episodes through the async environment
worker (their SFT warmup runs on ``AdditionTask``, as those tasks have no
demonstrations). ``--overlap --disaggregated`` publishes every version
through the train-to-rollout reshard, a copy onto ``--rollout-device``
(default: the train device; the counterpart of the reference's rollout
mesh). On the CPU:

    PYTHONPATH=src python -m repro_torch.launch.train --arch tiny \\
        --device cpu --steps 2 --sft-warmup 3 --overlap \\
        --task multiturn_math --max-response 32 --eval-every 0

Every registered arch but the VLM trains on the GPU: hymba-1.5b and
rwkv6-1.6b (their scans' backward runs in the kernels of
``csrc/ssm_scan.cu`` and ``csrc/wkv6.cu``), and the MoEs deepseek-moe-16b
and qwen3-moe-235b-a22b (the loss adds ``router_aux_coef`` times the
router's load-balance loss). llama-3.2-vision-90b needs media in every
forward but decode, and these tasks' rollouts carry none, as in the
reference; its loss takes ``mb["media"]`` (``core/copris.make_loss_fn``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \\
        --steps 2 --sft-warmup 4 --max-response 124 --eval-every 0

On meshes, one process a rank under ``torchrun`` (NCCL on the cards, gloo
with ``--device cpu``): ``--train-mesh D,M`` alone runs the whole loop on
one (data, model) mesh of every rank, sequentially; with ``--rollout-mesh``
the train and rollout sides run on meshes of their own. The two meshes of
``prod(train) + prod(rollout)`` processes are disjoint
(``make_disaggregated_meshes``: the first ranks train, the next collect;
``--overlap --disaggregated``); of ``prod(train) == prod(rollout)``
processes they are the same ranks in two shapes (D,KVG,M: the GQA serve
mesh), run sequentially. Rank 0 (the first train rank) prints and writes
the metrics and checkpoints; pass@k is not run on a mesh:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch tiny \\
        --device cpu --train-mesh 1,2 --rollout-mesh 1,2 --overlap \\
        --disaggregated --steps 2 --sft-warmup 3 --eval-every 0
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.common.config import RolloutConfig, TrainConfig
from repro_torch.common.device import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.copris import CoPRISTrainer
from repro_torch.data.sft import sft_warmup
from repro_torch.data.tasks import (EOS, AdditionTask, MultiTurnMathTask,
                                    ToolCallTask)
from repro_torch.models import model as M


def make_task(name: str, seed: int):
    """--task registry. Multi-turn tasks expose make_env(spec) and route
    rollouts through the async environment worker."""
    if name == "addition":
        return AdditionTask(max_value=20, seed=seed)
    if name == "multiturn_math":
        return MultiTurnMathTask(max_value=9, num_turns=2, seed=seed)
    if name == "toolcall":
        return ToolCallTask(max_value=9, seed=seed)
    raise ValueError(f"unknown task {name!r}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tiny")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced variant of --arch")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "plain PyTorch versions of the kernels)")
    ap.add_argument("--mode", default="copris",
                    choices=["copris", "sync", "naive_partial"])
    ap.add_argument("--task", default="addition",
                    choices=["addition", "multiturn_math", "toolcall"],
                    help="multiturn_math / toolcall run multi-turn episodes "
                         "through the async environment worker (env tokens "
                         "are loss-masked; slots are yielded during env "
                         "waits)")
    ap.add_argument("--env-timeout", type=float, default=0.0)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--group-size", type=int, default=4)
    ap.add_argument("--concurrency", type=int, default=16)
    ap.add_argument("--max-response", type=int, default=24)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--no-is", action="store_true",
                    help="disable cross-stage IS correction (ablation)")
    ap.add_argument("--overlap", action="store_true",
                    help="rollout on a producer thread (on the GPU, on its "
                         "own CUDA stream) while the previous batch trains")
    ap.add_argument("--max-staleness", type=int, default=1,
                    help="max optimizer updates the train step may be ahead "
                         "of the params that generated its batch")
    ap.add_argument("--disaggregated", action="store_true",
                    help="with --overlap: publish every version through the "
                         "train-to-rollout reshard onto --rollout-device")
    ap.add_argument("--rollout-device", default=None,
                    help="the rollout side's device with --disaggregated "
                         "(default: the train device)")
    ap.add_argument("--train-mesh", default=None,
                    help="DATA,MODEL: train on a mesh (under torchrun)")
    ap.add_argument("--rollout-mesh", default=None,
                    help="DATA,MODEL or DATA,KVG,MODEL: with --train-mesh, "
                         "collect on a mesh of its own: disjoint ranks "
                         "(with --overlap --disaggregated) or the same "
                         "ranks in another shape")
    ap.add_argument("--adaptive-concurrency", action="store_true")
    ap.add_argument("--concurrency-min", type=int, default=0)
    ap.add_argument("--concurrency-max", type=int, default=0)
    ap.add_argument("--sft-warmup", type=int, default=150)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="runs/default")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--eval-every", type=int, default=25)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    # on meshes the process group (and the rank's card) comes first
    meshes = (dict(zip(("train_mesh", "rollout_mesh"),
                       _meshes(args, dev.type)))
              if args.train_mesh is not None else
              dict(device=dev, rollout_device=args.rollout_device))
    main_rank = _rank() == 0
    say = print if main_rank else _quiet
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    task = make_task(args.task, args.seed)
    os.makedirs(args.out, exist_ok=True)

    ro = RolloutConfig(batch_size=args.batch_size, group_size=args.group_size,
                       max_prompt_len=16, max_response_len=args.max_response,
                       concurrency=args.concurrency, mode=args.mode,
                       adaptive_concurrency=args.adaptive_concurrency,
                       concurrency_min=args.concurrency_min,
                       concurrency_max=args.concurrency_max,
                       env_step_timeout=args.env_timeout)
    tc = TrainConfig(lr=args.lr, warmup_steps=5, total_steps=args.steps,
                     use_is_correction=not args.no_is, seed=args.seed,
                     overlap=args.overlap, max_staleness=args.max_staleness,
                     disaggregated=args.disaggregated)

    state = None
    if args.resume:
        state = ckpt.load(args.resume)
        params = convert.params_from_jax(state["params"], cfg, dev)
        say(f"resumed from {args.resume}")
    else:
        params = M.init_params(cfg, seed=args.seed, device=dev)
        if args.sft_warmup > 0:
            say(f"SFT warmup {args.sft_warmup} steps…")
            # multi-turn tasks have no supervised demos; warm up on the
            # single-turn surrogate (digits + EOS — the per-turn answer
            # format every env here shares)
            demo_task = (task if hasattr(task, "demo")
                         else AdditionTask(max_value=20, seed=args.seed))
            params, loss = sft_warmup(params, cfg, demo_task,
                                      steps=args.sft_warmup,
                                      log_every=50 if main_rank else 0)
            say(f"  warmup done (loss {loss:.3f})")

    tr = CoPRISTrainer(cfg, ro, tc, task, eos_id=EOS, params=params,
                       **meshes)
    if state is not None:
        tr.restore(opt_state=convert.opt_state_from_jax(
            state["opt_state"], cfg, dev), stage=state["stage"])

    mpath = os.path.join(args.out, "metrics.jsonl")
    try:
        with open(mpath, "a") as mf:
            for i in range(args.steps):
                out = tr.step()
                if main_rank:
                    mf.write(json.dumps(out) + "\n")
                    mf.flush()
                if i % 5 == 0 and main_rank:
                    extra = (f" stale={out['param_staleness']}"
                             f" saved={out['overlap_saved_time']:.1f}s"
                             if args.overlap else "")
                    if args.disaggregated:
                        extra += f" reshard={out['reshard_time']:.3f}s"
                    if args.adaptive_concurrency:
                        extra += f" N'={out['concurrency_target']}"
                    if out["env_steps"]:
                        extra += (f" env={out['env_steps']}s/"
                                  f"{out['env_turns']}t")
                    print(f"step {out['step']:4d} "
                          f"reward={out['reward_mean']:.3f} "
                          f"loss={out['pg_loss']:+.4f} "
                          f"ratio={out['ratio_mean']:.3f} "
                          f"off={out['off_policy_frac']:.2f} "
                          f"t={out['step_time']:.1f}s{extra}")
                if args.eval_every and (i + 1) % args.eval_every == 0:
                    from repro_torch.eval.passk import evaluate as eval_passk
                    acc = tr.evaluate(n_prompts=16)
                    if args.train_mesh is not None:
                        say(f"  eval@{i}: greedy {acc:.3f}")
                    else:
                        params_now, _ = tr.param_store.acquire()
                        # safe_task serialises prompt sampling against the
                        # overlapped trainer's background rollout thread
                        pk = eval_passk(params_now, cfg, tr.safe_task,
                                        eos_id=EOS, n_prompts=8,
                                        samples_per_prompt=8,
                                        max_response=args.max_response,
                                        ks=(1, 8), device=dev)
                        print(f"  eval@{out['step']}: greedy {acc:.3f} "
                              f"pass@1 {pk['pass@1']:.3f} "
                              f"pass@8 {pk['pass@8']:.3f}")
                if (i + 1) % args.ckpt_every == 0 and tr.role != "rollout":
                    # on a mesh the train ranks gather, rank 0 writes
                    p_full, opt_full = _whole(tr.params), _whole(tr.opt_state)
                    if main_rank:
                        p = os.path.join(args.out, f"ckpt_{tr.stage}.zpkl")
                        ckpt.save(p, {
                            "params": convert.params_to_jax(p_full, cfg),
                            "opt_state": convert.opt_state_to_jax(opt_full,
                                                                  cfg),
                            "stage": tr.stage})
                        print(f"  saved {p}")
        say("final eval:", tr.evaluate(n_prompts=32))
    finally:
        tr.close()
        if args.train_mesh is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


def _quiet(*args, **kwargs):
    pass


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _whole(tree):
    """``tree`` with every ``DTensor`` leaf gathered whole (a collective
    over its mesh)."""
    from repro_torch.common.tree import tree_map
    return tree_map(lambda t: t.full_tensor() if hasattr(t, "full_tensor")
                    else t, tree)


def _meshes(args, device_type):
    """The train and rollout meshes of ``--train-mesh`` /
    ``--rollout-mesh`` over the default process group from torchrun's
    environment: one mesh of every rank; two disjoint ones
    (``make_disaggregated_meshes``) where the world holds both; the same
    ranks in two shapes where each holds the world."""
    import math

    import torch.distributed as dist

    from repro_torch.launch.mesh import (make_disaggregated_meshes,
                                         make_gqa_serve_mesh, make_mesh)
    from repro_torch.launch.multihost import _init_process_group
    _init_process_group(device_type)
    world = dist.get_world_size()
    train = tuple(int(n) for n in args.train_mesh.split(","))
    if args.rollout_mesh is None:
        return make_mesh(*train, device_type=device_type), None
    rollout = tuple(int(n) for n in args.rollout_mesh.split(","))
    if math.prod(train) + math.prod(rollout) == world:
        return make_disaggregated_meshes(train, rollout,
                                         device_type=device_type)
    if math.prod(train) == math.prod(rollout) == world:
        make = make_gqa_serve_mesh if len(rollout) == 3 else make_mesh
        return (make_mesh(*train, device_type=device_type),
                make(*rollout, device_type=device_type))
    raise SystemExit(
        f"--train-mesh {train} and --rollout-mesh {rollout} fit neither "
        f"{world} ranks split between them nor the same {world} ranks")


if __name__ == "__main__":
    main()
