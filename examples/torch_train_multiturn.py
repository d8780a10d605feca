"""Multi-turn environment rollouts through the overlapped CoPRIS trainer of
the PyTorch port.

A TaskMixture draws single-turn addition prompts (lifted through the env
adapter), multi-turn math episodes, and calculator tool-call episodes in
the SAME stage. A multi-turn trajectory decodes a turn, yields its slot
back to continuous-batching admission while the async env worker runs
``env.step``, then re-prefills the observation and decodes the next turn.
Environment tokens enter the sequence with behaviour logp 0 / stage -1 and
are excluded from the GRPO/IS loss by ``pack_groups``' loss mask. Runs on
the card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_train_multiturn.py
    PYTHONPATH=src python examples/torch_train_multiturn.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.common.config import RolloutConfig, TrainConfig
from repro_torch.common.device import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.copris import CoPRISTrainer
from repro_torch.data.sft import sft_warmup
from repro_torch.data.tasks import (EOS, AdditionTask, MultiTurnMathTask,
                                    TaskMixture, ToolCallTask)
from repro_torch.models import model as M

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
dev = resolve_device(ap.parse_args().device)

cfg = get_config("tiny")

# 1. a mixed single+multi-turn curriculum — one rollout path serves all
task = TaskMixture(
    [AdditionTask(max_value=9, seed=0),
     MultiTurnMathTask(max_value=9, num_turns=2, seed=0),
     ToolCallTask(max_value=9, seed=0)],
    weights=[1.0, 1.0, 1.0], seed=0)

# 2. warm up on the shared per-turn answer format (digits + EOS)
params = M.init_params(cfg, seed=0, device=dev)
params, loss = sft_warmup(params, cfg, AdditionTask(max_value=9, seed=0),
                          steps=120, batch_size=32, lr=3e-3)
print(f"warmup done (loss {loss:.3f})")

# 3. overlapped RL: rollouts for stage k+1 run while stage k trains; env
#    waits are overlapped with other slots' decode. The per-step env
#    deadline turns a wedged environment into a finished episode instead
#    of a stalled stage.
ro = RolloutConfig(batch_size=6, group_size=4, max_prompt_len=16,
                   max_response_len=24, concurrency=12, mode="copris",
                   env_step_timeout=5.0)
tc = TrainConfig(lr=3e-4, warmup_steps=2, overlap=True)
tr = CoPRISTrainer(cfg, ro, tc, task, eos_id=EOS, params=params, device=dev)
try:
    for _ in range(4):
        out = tr.step()
        print(f"step {out['step']} reward={out['reward_mean']:.3f} "
              f"off={out['off_policy_frac']:.2f} "
              f"env={out['env_steps']}steps/{out['env_turns']}turns "
              f"timeouts={out['env_timeouts']}")
finally:
    tr.close()

# 4. mask accounting on the last trained batch: env-observation tokens are
#    response positions (response_mask 1) excluded from the loss
#    (loss_mask 0), with behaviour logp pinned to 0 by construction
b = tr.last_batch
resp = np.asarray(b["response_mask"])
lm = np.asarray(b["loss_mask"])
env_positions = (resp > 0) & (lm == 0)
print(f"batch: {int(resp.sum())} response tokens, {int(lm.sum())} in the "
      f"loss, {int(env_positions.sum())} env tokens masked out")
assert (np.asarray(b["behaviour_logp"])[env_positions] == 0.0).all()
assert (np.asarray(b["stage_ids"])[env_positions] == -1).all()

multi = [t for g in tr.last_groups for t in g.trajectories
         if t.num_turns > 1]
if multi:
    t = multi[0]
    print(f"{len(multi)} multi-turn trajectories in the batch; example "
          f"turn starts {t.turn_starts} finish={t.finish_reason}")
print("train_multiturn OK")
