"""Synthetic math-reasoning tasks with rule-based terminal rewards.

The port's copy of the single-turn tasks of ``repro.data.tasks``
(:class:`AdditionTask`, :class:`LengthTask`) and the token constants. The
multi-turn environments come with a later slice of the port.

Stand-in for DeepScaleR (the paper's dataset): verifiable answers, 0/1
terminal reward (optionally partial credit so the tiny CPU model gets a
learnable signal), and naturally long-tailed response lengths — the
property CoPRIS's partial rollout exploits.

Token layout (shared with configs/tiny.py, vocab 64):
    0..9   digit tokens
    10     '+'   11 '='   12 BOS   13 EOS   14 PAD-ish filler
    15     OK (env feedback: previous answer correct)
    16     NO (env feedback: previous answer wrong / malformed tool call)
    17     CALL (tool-call sentinel: a turn starting with CALL is a request)
    18     RESULT (tool observation prefix)
    19..   free (sampled as distractors in some tasks)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

PLUS, EQ, BOS, EOS = 10, 11, 12, 13
OBS_OK, OBS_NO, CALL, RESULT = 15, 16, 17, 18


def _digits(n: int) -> List[int]:
    return [int(c) for c in str(n)]


def _strip_eos(tokens: Sequence[int]) -> List[int]:
    resp = [int(t) for t in tokens]
    if EOS in resp:
        resp = resp[: resp.index(EOS)]
    return resp


def _digit_score(resp: List[int], target: List[int], mode: str) -> float:
    """Shared rule-based scorer: exact 0/1 or per-digit partial credit with
    a length penalty (the single-turn AdditionTask semantics, unchanged)."""
    if mode == "exact":
        return 1.0 if resp == target else 0.0
    hits = sum(1 for i, d in enumerate(target)
               if i < len(resp) and resp[i] == d)
    score = hits / len(target)
    if len(resp) != len(target):
        score *= 0.5
    if resp == target:
        score = 1.0
    return float(score)


@dataclass
class AdditionTask:
    """Prompt: BOS a… '+' b… '='; answer: digits of a+b, then EOS."""

    max_value: int = 99
    reward_mode: str = "partial"      # "exact" (paper-faithful 0/1) | "partial"
    seed: int = 0

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)

    # ------------------------------------------------------------------
    def sample_prompt(self) -> Tuple[np.ndarray, object]:
        a = int(self.rng.integers(0, self.max_value + 1))
        b = int(self.rng.integers(0, self.max_value + 1))
        prompt = np.asarray([BOS] + _digits(a) + [PLUS] + _digits(b) + [EQ],
                            np.int32)
        return prompt, a + b

    def reward(self, response_tokens: List[int], answer: object) -> float:
        """Rule-based terminal reward on the generated response."""
        return _digit_score(_strip_eos(response_tokens),
                            _digits(int(answer)), self.reward_mode)

    # ------------------------------------------------------------------
    def demo(self) -> Tuple[np.ndarray, int]:
        """A supervised demonstration (prompt+answer+EOS) and its prompt
        length — for the SFT warmup used by the end-to-end example."""
        prompt, ans = self.sample_prompt()
        full = np.concatenate([prompt, np.asarray(_digits(int(ans)) + [EOS],
                                                  np.int32)])
        return full, len(prompt)


@dataclass
class LengthTask:
    """Throughput benchmark task with a controllable long-tail: the prompt
    encodes a target length drawn from a lognormal; reward = 1 if the
    response length matches within 10%. Used by the scheduler benchmarks to
    produce a *known* length distribution."""

    mean_len: float = 48.0
    sigma: float = 0.8
    max_len: int = 512
    seed: int = 0

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)

    def sample_prompt(self) -> Tuple[np.ndarray, object]:
        tgt = int(np.clip(self.rng.lognormal(np.log(self.mean_len), self.sigma),
                          1, self.max_len))
        hi, lo = divmod(tgt, 32)
        prompt = np.asarray([BOS, 15 + min(hi, 15), lo % 32, EQ], np.int32)
        return prompt, tgt

    def reward(self, response_tokens: List[int], answer: object) -> float:
        resp = list(response_tokens)
        if EOS in resp:
            resp = resp[: resp.index(EOS)]
        tgt = int(answer)
        return 1.0 if abs(len(resp) - tgt) <= max(1, tgt // 10) else 0.0
