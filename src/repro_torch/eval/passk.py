"""pass@k evaluation harness: the port of ``repro.eval.passk`` (the
paper's protocol: 32 samples per eval prompt at temperature 0.6, reporting
average pass@1).

Runs on the same slot-pool engine as training rollouts (mode="sync",
group_size = samples-per-prompt).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.common.config import ModelConfig, RolloutConfig
from repro_torch.core.rollout import RolloutEngine
from repro_torch.sampling import prng


def pass_at_k(n: int, c: int, k: int) -> float:
    """Unbiased pass@k estimator (Chen et al., 2021): 1 - C(n-c,k)/C(n,k)."""
    if n - c < k:
        return 1.0
    out = 1.0
    for i in range(k):
        out *= (n - c - i) / (n - i)
    return 1.0 - out


def evaluate(params, cfg: ModelConfig, task, *, eos_id: int,
             n_prompts: int = 16, samples_per_prompt: int = 8,
             temperature: float = 0.6, max_response: int = 32,
             ks=(1,), key=None, threshold: float = 1.0,
             engine: Optional[RolloutEngine] = None, device=None) -> dict:
    """Returns {"pass@k": float, ..., "mean_reward": float,
    "mean_len": float}. A sample "passes" when reward >= threshold."""
    key = key if key is not None else prng.PRNGKey(1234)
    ro = RolloutConfig(batch_size=n_prompts, group_size=samples_per_prompt,
                       max_prompt_len=64, max_response_len=max_response,
                       concurrency=0, mode="sync", temperature=temperature)
    eng = engine or RolloutEngine(cfg, ro, task.sample_prompt, eos_id=eos_id,
                                  device=device)
    groups, _ = eng.collect(params, 0, key)

    rewards, lens = [], []
    out = {}
    per_prompt_correct = []
    for g in groups:
        c = 0
        for t in g.trajectories:
            r = task.reward(t.response_tokens, g.answer)
            rewards.append(r)
            lens.append(len(t.response_tokens))
            if r >= threshold:
                c += 1
        per_prompt_correct.append(c)
    n = samples_per_prompt
    for k in ks:
        if k > n:
            continue
        out[f"pass@{k}"] = float(np.mean(
            [pass_at_k(n, c, k) for c in per_prompt_correct]))
    out["mean_reward"] = float(np.mean(rewards))
    out["mean_len"] = float(np.mean(lens))
    return out
