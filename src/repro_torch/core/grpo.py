"""GRPO objective with cross-stage importance sampling (paper eqs. 2–5, 8).

The port of ``repro.core.grpo``, with its names:

* group-relative advantages: A_i = (R_i - mean_group) / std_group, with the
  population std (ddof 0, as ``jnp.std``; ``torch.std`` defaults to ddof 1);
* per-token IS ratio r = exp(logp_current - behaviour_logp); for the
  "w/o IS" ablation the behaviour is replaced by detach(logp_current)
  (pseudo on-policy, ratio == 1);
* asymmetric clip (clip_low=0.2 / clip_high=0.28, Table 3);
* token-mean aggregation;
* optional entropy bonus and low-var KL to a reference policy (β=0 default).

Clips are written as ``torch.minimum(torch.maximum(x, lo), hi)``, never
``torch.clamp``: at a clip boundary the former's gradient is 0.5, as
``jax.grad`` of ``jnp.clip`` gives, while ``torch.clamp``'s is 1. The fused
loss (``hopper/fused_is_grpo.py``) runs its backward through this same
:func:`per_token_objective`, so ties and boundaries follow one convention.
"""
from __future__ import annotations

from typing import Optional

import torch


def _clip(x, lo, hi):
    """``jnp.clip``'s value and subgradient (0.5 at an exact boundary)."""
    return torch.minimum(torch.maximum(x, lo), hi)


def group_advantages(rewards, group_size: int, *, eps: float = 1e-6):
    """rewards: (N,) flattened group-major -> (N,) advantages (eq. 5)."""
    r = rewards.reshape(-1, group_size)
    mean = r.mean(dim=1, keepdim=True)
    std = r.std(dim=1, keepdim=True, correction=0)
    return ((r - mean) / (std + eps)).reshape(-1)


def per_token_objective(logp_new, behaviour_logp, adv, *,
                        clip_low: float = 0.2, clip_high: float = 0.28,
                        use_is: bool = True, is_ratio_cap: float = 10.0,
                        entropy: Optional[torch.Tensor] = None,
                        entropy_coef: float = 0.0,
                        ref_logp: Optional[torch.Tensor] = None,
                        kl_coef: float = 0.0):
    """Elementwise clipped-IS objective. All args broadcast together.

    Returns ``(loss_tok, ratio)`` with the same shape as ``logp_new``.
    ``adv`` must already be broadcastable against ``logp_new`` (callers
    with per-sequence advantages pass ``advantages[:, None]``).
    """
    f32 = dict(dtype=logp_new.dtype, device=logp_new.device)
    if use_is:
        log_ratio = logp_new - behaviour_logp
        # numerical safety: behaviour logps come from a different stage;
        # cap the ratio so one stale token cannot blow up the update
        cap = torch.log(torch.tensor(is_ratio_cap, **f32))
        log_ratio = _clip(log_ratio, -cap, cap)
    else:
        log_ratio = logp_new - logp_new.detach()
    ratio = torch.exp(log_ratio)

    unclipped = ratio * adv
    clipped = _clip(ratio, torch.tensor(1.0 - clip_low, **f32),
                    torch.tensor(1.0 + clip_high, **f32)) * adv
    obj = torch.minimum(unclipped, clipped)
    loss_tok = -obj

    if kl_coef > 0.0 and ref_logp is not None:
        # low-var KL (k3 estimator): exp(ref-new) - (ref-new) - 1
        d = ref_logp - logp_new
        loss_tok = loss_tok + kl_coef * (torch.exp(d) - d - 1.0)
    if entropy_coef > 0.0 and entropy is not None:
        loss_tok = loss_tok - entropy_coef * entropy
    return loss_tok, ratio


def aggregate_loss(loss_tok, ratio, logp_new, behaviour_logp, mask, *,
                   clip_low: float = 0.2, use_is: bool = True,
                   loss_agg: str = "token_mean"):
    """Mask-weighted reduction of per-token losses + the standard metrics.
    Metrics are 0-dim tensors (no host sync here)."""
    denom = mask.sum().clamp_min(1.0)
    if loss_agg == "token_mean":
        loss = (loss_tok * mask).sum() / denom
    elif loss_agg == "seq_mean":
        per_seq = (loss_tok * mask).sum(-1) / mask.sum(-1).clamp_min(1.0)
        loss = per_seq.mean()
    else:
        raise ValueError(loss_agg)

    with torch.no_grad():
        clip_frac = (((ratio - 1.0).abs() > clip_low) * mask).sum() / denom
        approx_kl = (((behaviour_logp - logp_new) * mask).sum() / denom
                     if use_is else torch.zeros((), device=mask.device))
        metrics = {
            "ratio_mean": (ratio * mask).sum() / denom,
            "ratio_max": torch.where(mask > 0, ratio,
                                     torch.ones_like(ratio)).max(),
            "clip_frac": clip_frac,
            "approx_kl": approx_kl,
        }
    return loss, metrics


def grpo_loss(logp_new, behaviour_logp, advantages, mask, *,
              clip_low: float = 0.2, clip_high: float = 0.28,
              use_is: bool = True, is_ratio_cap: float = 10.0,
              loss_agg: str = "token_mean",
              entropy: Optional[torch.Tensor] = None,
              entropy_coef: float = 0.0,
              ref_logp: Optional[torch.Tensor] = None,
              kl_coef: float = 0.0):
    """All (N, T') token-aligned; advantages (N,). Returns (loss, metrics)."""
    loss_tok, ratio = per_token_objective(
        logp_new, behaviour_logp, advantages[:, None],
        clip_low=clip_low, clip_high=clip_high, use_is=use_is,
        is_ratio_cap=is_ratio_cap, entropy=entropy, entropy_coef=entropy_coef,
        ref_logp=ref_logp, kl_coef=kl_coef)
    return aggregate_loss(loss_tok, ratio, logp_new, behaviour_logp, mask,
                          clip_low=clip_low, use_is=use_is, loss_agg=loss_agg)
