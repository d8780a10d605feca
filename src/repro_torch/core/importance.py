"""Cross-stage Importance Sampling Correction — batch packing + ratios.

Packing turns a list of complete groups into fixed-shape tensors. Each token
position carries the *behaviour* log-prob recorded at sampling time by the
stage that generated it (eq. 6: L_i is a concat across stages). The training
step recomputes log-probs under the current policy and uses

    r_t = exp( logp_theta(t) - L_t )                       (eq. 8)

as the per-token IS ratio inside the clipped GRPO objective.

The port's copy of ``repro.core.importance`` (numpy only).
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.core.trajectory import Group


def _round_up(n, m):
    return -(-n // m) * m


def pack_groups(groups: List[Group], *, pad_multiple: int = 64,
                pad_id: int = 0, max_len: int | None = None):
    """Returns a dict of numpy arrays, trajectories flattened over groups in
    order (group-major, so reshaping to (B, G) recovers group structure):

    tokens          (N, T) int32 — prompt + response, right-padded
    prompt_lens     (N,)   int32
    total_lens      (N,)   int32
    response_mask   (N, T) float32 — 1.0 on response token positions
                    (model AND env — the context the model conditioned on)
    loss_mask       (N, T) float32 — 1.0 on MODEL response positions only;
                    THE mask grpo_loss / the IS ratio consume. Env
                    observation tokens are 0 here by construction.
    behaviour_logp  (N, T) float32 — aligned to token positions (response
                    only; 0.0 at env positions — never sampled)
    stage_ids       (N, T) int32  — policy version per MODEL token
                    (-1 elsewhere, including env positions: env tokens
                    carry no staleness — the IS ratio never sees them)
    rewards         (N,)   float32
    group_index     (N,)   int32
    """
    trajs = [t for g in groups for t in g.trajectories]
    N = len(trajs)
    T = max(t.total_len for t in trajs)
    T = _round_up(T, pad_multiple)
    if max_len is not None:
        T = min(T, max_len)

    tokens = np.full((N, T), pad_id, np.int32)
    response_mask = np.zeros((N, T), np.float32)
    loss_mask = np.zeros((N, T), np.float32)
    behaviour = np.zeros((N, T), np.float32)
    stages = np.full((N, T), -1, np.int32)
    prompt_lens = np.zeros(N, np.int32)
    total_lens = np.zeros(N, np.int32)
    rewards = np.zeros(N, np.float32)
    group_index = np.zeros(N, np.int32)

    for n, t in enumerate(trajs):
        full = t.full_tokens()[:T]
        P = len(t.prompt_tokens)
        L = len(full)
        tokens[n, :L] = full
        # max_len truncation guard: a prompt at/over the truncated T leaves
        # no response room (R <= 0). Keep the row — its reward still feeds
        # the group-advantage baseline — with an empty response region
        # instead of slicing behaviour_logps by a negative index, and clamp
        # prompt_lens so P <= L holds for every packed row.
        prompt_lens[n] = min(P, L)
        total_lens[n] = L
        R = max(L - P, 0)
        if R:
            roles = np.asarray(t.roles[:R], np.float32)
            response_mask[n, P:L] = 1.0
            loss_mask[n, P:L] = roles
            # env positions carry behaviour logp 0 / stage -1 BY
            # CONSTRUCTION even if a custom trajectory recorded otherwise —
            # the packed batch is the loss's source of truth
            behaviour[n, P:L] = (np.asarray(t.behaviour_logps[:R], np.float32)
                                 * roles)
            stg = np.asarray(t.stage_ids[:R], np.int32)
            stages[n, P:L] = np.where(roles > 0, stg, -1)
        rewards[n] = 0.0 if t.reward is None else t.reward
        group_index[n] = t.group_id

    return dict(tokens=tokens, prompt_lens=prompt_lens, total_lens=total_lens,
                response_mask=response_mask, loss_mask=loss_mask,
                behaviour_logp=behaviour, stage_ids=stages, rewards=rewards,
                group_index=group_index)
