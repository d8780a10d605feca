"""Wall-clock comparison of the three rollout modes on the tiny model with
the PyTorch port: sync (veRL-style), naive partial rollout
(Kimi-K1.5-style), CoPRIS — plus the sequential vs one-step-async
overlapped trainer pipeline. Runs on the card unless ``--device cpu`` is
given; each timed interval ends after the engine's stream has finished its
queued work, so the clock reads compute, not dispatch.

    PYTHONPATH=src python examples/torch_copris_vs_sync.py
    PYTHONPATH=src python examples/torch_copris_vs_sync.py --device cpu
"""
import argparse
import time

from repro_torch.common.config import RolloutConfig, TrainConfig
from repro_torch.common.device import resolve_device
from repro_torch.common.tree import tree_map
from repro_torch.configs import get_config
from repro_torch.core.copris import CoPRISTrainer
from repro_torch.core.rollout import RolloutEngine
from repro_torch.data.tasks import EOS, AdditionTask
from repro_torch.models import model as M
from repro_torch.sampling import prng

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
dev = resolve_device(ap.parse_args().device)

cfg = get_config("tiny")
params = M.init_params(cfg, seed=0, device=dev)

print(f"{'mode':16s} {'pool':>4s} {'tok/s':>8s} {'util':>6s} {'resumed':>8s}")
for mode, conc in [("sync", 0), ("naive_partial", 48), ("copris", 16)]:
    task = AdditionTask(max_value=50, seed=0)
    ro = RolloutConfig(batch_size=8, group_size=4, max_prompt_len=16,
                       max_response_len=48, concurrency=conc, mode=mode)
    eng = RolloutEngine(cfg, ro, task.sample_prompt, eos_id=EOS, device=dev)
    served = eng.prepare_params(params)
    eng.collect(served, 0, prng.PRNGKey(9))        # build the kernels first
    eng.block_until_ready()
    t0, gen, resumed, util = time.perf_counter(), 0, 0, []
    for s in range(3):
        _, st = eng.collect(served, s + 1, prng.PRNGKey(s))
        gen += st["generated"]
        resumed += st["resumed"]
        util.append(st["utilization"])
    eng.block_until_ready()            # don't time queued work's dispatch
    dt = time.perf_counter() - t0
    print(f"{mode:16s} {eng.pool:4d} {gen/dt:8.1f} "
          f"{sum(util)/len(util):6.2f} {resumed:8d}")

# ---------------------------------------------------------------------------
# Trainer pipeline: sequential vs overlapped (one- and multi-step async) vs
# disaggregated. The overlapped trainer collects stage k+K on a background
# thread while stage k trains (tokens carry their stage id, so the
# cross-stage IS correction absorbs up to K updates of staleness);
# disaggregated additionally routes every published params version through
# the ParamStore reshard, here a copy onto the same device. Each step times
# itself (step_time, after the update's stream has finished).
# ---------------------------------------------------------------------------
print(f"\n{'pipeline':16s} {'step_s':>8s} {'stale':>6s} {'saved_s':>8s}")
for name, kw in [("sequential", {}),
                 ("overlap K=1", dict(overlap=True)),
                 ("overlap K=2", dict(overlap=True, max_staleness=2)),
                 ("disaggregated", dict(overlap=True, disaggregated=True))]:
    task = AdditionTask(max_value=50, seed=0)
    ro = RolloutConfig(batch_size=8, group_size=4, max_prompt_len=16,
                       max_response_len=48, concurrency=16, mode="copris")
    tc = TrainConfig(lr=2e-4, warmup_steps=2, **kw)
    with CoPRISTrainer(cfg, ro, tc, task, eos_id=EOS, device=dev,
                       params=tree_map(lambda t: t.detach().clone(),
                                       params)) as tr:
        tr.step()                                  # first builds, warm-up
        outs = [tr.step() for _ in range(3)]
    print(f"{name:16s} "
          f"{sum(o['step_time'] for o in outs)/len(outs):8.2f} "
          f"{max(o['param_staleness'] for o in outs):6d} "
          f"{sum(o['overlap_saved_time'] for o in outs):8.2f}")
