"""Trajectory and group bookkeeping for partial rollout.

A *trajectory* is one sampled response for one prompt; a *group* is the G
trajectories of a single prompt (GRPO's intra-group advantage unit). CoPRIS's
buffer holds trajectories across training stages, each token annotated with
the behaviour log-prob and the policy version ("stage") that produced it —
eq. (6): L_i = concat(L_i^(1), ..., L_i^(K)).

Multi-turn episodes: the response stream interleaves MODEL-generated turns
with ENVIRONMENT-injected observations. Every response token carries a
*role* (1 = model, 0 = env); env tokens get behaviour logp 0.0 by
construction (they were never sampled) and are excluded from the loss / IS
ratio by the packed loss mask. ``turn_starts`` records where each model
turn begins, so partial-rollout resume and the packers can reason about
turn boundaries without re-parsing the token stream.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

_next_id = itertools.count()


@dataclass
class Trajectory:
    group_id: int
    sample_idx: int                       # position within the group (0..G-1)
    prompt_tokens: np.ndarray             # (P,) int32
    response_tokens: List[int] = field(default_factory=list)
    behaviour_logps: List[float] = field(default_factory=list)   # per response token
    stage_ids: List[int] = field(default_factory=list)           # policy version per token
    roles: List[int] = field(default_factory=list)               # 1 model | 0 env
    # index into response_tokens where each MODEL turn begins (the first
    # turn starts at 0; a new entry is appended after every env observation)
    turn_starts: List[int] = field(default_factory=lambda: [0])
    done: bool = False
    finish_reason: Optional[str] = None   # "eos" | "length" | "env_done"
    reward: Optional[float] = None
    # ---- multi-turn environment state ----
    # the live Environment instance (created lazily by the engine from the
    # task's env factory), reward accumulated across env steps, and whether
    # the trajectory is parked waiting on an async env.step — a parked
    # trajectory owns NO slot and must not be redispatched until the
    # observation lands.
    env: Optional[object] = None
    env_return: float = 0.0
    awaiting_env: bool = False
    # the length budget ran out mid-episode: the pending env step is the
    # episode's last (its observation is discarded, its reward still counts)
    env_final: bool = False
    traj_id: int = field(default_factory=lambda: next(_next_id))
    # bookkeeping for stats
    resume_count: int = 0
    # kv_snapshot resume strategy: per-slot state captured at eviction
    # (cache pytree slice, cache_len, pending last token). Cleared on resume.
    kv_snapshot: Optional[object] = None
    snap_cache_len: int = 0
    snap_last_token: int = 0

    # ------------------------------------------------------------------
    @property
    def num_stages(self) -> int:
        return len(set(self.stage_ids))

    @property
    def num_turns(self) -> int:
        """Model turns started so far (>= 1 once anything was generated)."""
        return len(self.turn_starts)

    def turn_tokens(self) -> List[int]:
        """The current (last) model turn's tokens — what the environment
        consumes as the model's move when the turn completes."""
        return self.response_tokens[self.turn_starts[-1]:]

    @property
    def response_len(self) -> int:
        return len(self.response_tokens)

    @property
    def total_len(self) -> int:
        return len(self.prompt_tokens) + len(self.response_tokens)

    def full_tokens(self) -> np.ndarray:
        return np.concatenate([self.prompt_tokens,
                               np.asarray(self.response_tokens, np.int32)])

    def append(self, token: int, logp: float, stage: int):
        assert not self.done, "appending to a finished trajectory"
        self.response_tokens.append(int(token))
        self.behaviour_logps.append(float(logp))
        self.stage_ids.append(int(stage))
        self.roles.append(1)

    def append_run(self, tokens, logps, stage: int):
        """Append a run of same-stage tokens (a decoded chunk's worth)."""
        assert not self.done, "appending to a finished trajectory"
        n = len(tokens)
        assert len(logps) == n, "token/logp run length mismatch"
        self.response_tokens.extend(int(t) for t in tokens)
        self.behaviour_logps.extend(float(l) for l in logps)
        self.stage_ids.extend([int(stage)] * n)
        self.roles.extend([1] * n)

    def append_env(self, tokens, stage: int):
        """Append an environment observation and open the next model turn.
        Env tokens were never sampled: behaviour logp is 0.0 and role 0 BY
        CONSTRUCTION — the packed loss mask derives from the role, so no
        downstream code can accidentally train on them. Stage-stamped with
        the stage the observation landed in, keeping stage ids
        non-decreasing along the token dim."""
        assert not self.done, "appending to a finished trajectory"
        toks = [int(t) for t in tokens]
        self.response_tokens.extend(toks)
        self.behaviour_logps.extend([0.0] * len(toks))
        self.stage_ids.extend([int(stage)] * len(toks))
        self.roles.extend([0] * len(toks))
        self.turn_starts.append(len(self.response_tokens))

    def check_invariants(self):
        assert len(self.response_tokens) == len(self.behaviour_logps) \
            == len(self.stage_ids) == len(self.roles), \
            "token/logp/stage/role misalignment"
        if self.stage_ids:
            assert all(a <= b for a, b in zip(self.stage_ids, self.stage_ids[1:])), \
                "stage ids must be non-decreasing (concat along token dim)"
        assert all(l == 0.0 for l, r in zip(self.behaviour_logps, self.roles)
                   if r == 0), "env tokens must carry behaviour logp 0.0"
        assert self.turn_starts and self.turn_starts[0] == 0 and all(
            a <= b for a, b in zip(self.turn_starts, self.turn_starts[1:])), \
            "turn starts must begin at 0 and be non-decreasing"
        assert not self.awaiting_env or not self.done, \
            "a finished trajectory cannot be awaiting its environment"


@dataclass
class Group:
    group_id: int
    prompt_tokens: np.ndarray
    answer: object                        # task-specific ground truth
    size: int                             # G
    trajectories: List[Trajectory] = field(default_factory=list)

    def spawn(self) -> Trajectory:
        t = Trajectory(group_id=self.group_id,
                       sample_idx=len(self.trajectories),
                       prompt_tokens=self.prompt_tokens)
        self.trajectories.append(t)
        return t

    @property
    def complete(self) -> bool:
        return (len(self.trajectories) == self.size
                and all(t.done for t in self.trajectories))
