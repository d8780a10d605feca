"""Synthetic math-reasoning tasks with rule-based terminal rewards.

The port's copy of ``repro.data.tasks`` (pure numpy): the single-turn
tasks, the token constants, and the multi-turn environments.

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

Multi-turn tasks expose the :class:`Environment` protocol on top of the
single-turn ``sample_prompt``/``reward`` surface:

    env = task.make_env(spec)         # spec is sample_prompt's answer slot
    prompt = env.reset()              # initial prompt tokens
    obs, r, done = env.step(resp)     # one model turn -> feedback

``step`` consumes the model's turn (its sampled tokens up to and including
the stop), returns observation tokens to inject into the context (role 0,
excluded from loss/IS), an incremental reward, and whether the episode is
over. Environments must be pure functions of their spec — the rollout
engine constructs and steps them on worker threads.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import (List, Optional, Protocol, Sequence, Tuple,
                    runtime_checkable)

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


@runtime_checkable
class Environment(Protocol):
    """One episode's stateful environment side (see module docstring)."""

    def reset(self) -> np.ndarray:
        """Start the episode; returns the initial prompt tokens."""
        ...

    def step(self, response_tokens: Sequence[int]
             ) -> Tuple[np.ndarray, float, bool]:
        """Consume one model turn; returns (observation_tokens,
        incremental_reward, done). Observation tokens are injected into the
        context as role-0 (never trained on); an empty observation with
        done=True ends the episode."""
        ...


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


# ---------------------------------------------------------------------------
# Multi-turn environments
# ---------------------------------------------------------------------------


@dataclass
class MultiStepMathEnv:
    """Running-sum arithmetic with per-turn feedback.

    Turn 1 prompt: ``BOS a0… '+' d1… '='``; the model answers the running
    sum's digits + EOS. The env then replies ``OK|NO '+' d2… '='`` (was the
    last answer right, plus the next delta) and so on for ``len(deltas)``
    turns. The running sum always advances by the TRUE value — a wrong turn
    stays recoverable, keeping every turn independently verifiable.

    Per-turn reward = digit score / num_turns, so the episode return lies
    in [0, 1] like the single-turn tasks.
    """

    start: int
    deltas: Tuple[int, ...]
    reward_mode: str = "partial"
    _turn: int = field(default=0, repr=False)
    _sum: int = field(default=0, repr=False)

    def reset(self) -> np.ndarray:
        self._turn = 0
        self._sum = self.start
        return np.asarray([BOS] + _digits(self.start) + [PLUS]
                          + _digits(self.deltas[0]) + [EQ], np.int32)

    def step(self, response_tokens) -> Tuple[np.ndarray, float, bool]:
        assert self._turn < len(self.deltas), "stepping a finished episode"
        self._sum += self.deltas[self._turn]
        score = _digit_score(_strip_eos(response_tokens),
                             _digits(self._sum), self.reward_mode)
        self._turn += 1
        done = self._turn >= len(self.deltas)
        reward = score / len(self.deltas)
        if done:
            return np.empty(0, np.int32), reward, True
        obs = ([OBS_OK if score == 1.0 else OBS_NO, PLUS]
               + _digits(self.deltas[self._turn]) + [EQ])
        return np.asarray(obs, np.int32), reward, False


@dataclass
class MultiTurnMathTask:
    """Task wrapper sampling MultiStepMathEnv episodes. The spec (the
    ``answer`` slot of ``sample_prompt``) fully determines the episode, so
    ``make_env(spec)`` is pure and thread-safe."""

    max_value: int = 9
    num_turns: int = 2
    reward_mode: str = "partial"
    seed: int = 0

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)

    def sample_prompt(self) -> Tuple[np.ndarray, object]:
        start = int(self.rng.integers(0, self.max_value + 1))
        deltas = tuple(int(self.rng.integers(0, self.max_value + 1))
                       for _ in range(self.num_turns))
        spec = (start, deltas, self.reward_mode)
        return MultiStepMathEnv(*spec).reset(), spec

    def make_env(self, spec) -> MultiStepMathEnv:
        return MultiStepMathEnv(*spec)

    def reward(self, response_tokens: List[int], spec) -> float:
        """Single-shot fallback (greedy eval / inline reward): score the
        response as the FIRST turn only, rescaled to [0, 1]."""
        env = self.make_env(spec)
        env.reset()
        _, r, _ = env.step(response_tokens)
        return r * len(spec[1])


@dataclass
class CalculatorToolEnv:
    """Sandboxed tool-call environment: sum several numbers, with a
    calculator tool available.

    Prompt: ``BOS a… '+' b… '+' c… '='``. Each model turn is either

    * a tool call — ``CALL x… '+' y… [+ …] EOS``: the env evaluates the sum
      of the digit-groups (the "sandbox" parses tokens only; nothing is
      executed) and replies ``RESULT digits '='``. Malformed calls get
      ``NO '='``. No reward either way.
    * a final answer — any turn NOT starting with CALL: scored against the
      true sum, episode done.

    ``max_calls`` bounds the tool budget; exhausting it forces the next
    turn to be treated as the final answer.
    """

    operands: Tuple[int, ...]
    reward_mode: str = "partial"
    max_calls: int = 2
    _calls: int = field(default=0, repr=False)

    def reset(self) -> np.ndarray:
        self._calls = 0
        toks = [BOS]
        for i, v in enumerate(self.operands):
            if i:
                toks.append(PLUS)
            toks.extend(_digits(v))
        toks.append(EQ)
        return np.asarray(toks, np.int32)

    @staticmethod
    def _eval_call(body: List[int]) -> Optional[int]:
        """Parse ``x… '+' y… [+ …]`` into a sum; None if malformed."""
        groups, cur = [], []
        for t in body:
            if 0 <= t <= 9:
                cur.append(t)
            elif t == PLUS and cur:
                groups.append(cur)
                cur = []
            else:
                return None
        if not cur:
            return None
        groups.append(cur)
        return sum(int("".join(map(str, g))) for g in groups)

    def step(self, response_tokens) -> Tuple[np.ndarray, float, bool]:
        resp = _strip_eos(response_tokens)
        if resp and resp[0] == CALL and self._calls < self.max_calls:
            self._calls += 1
            val = self._eval_call(resp[1:])
            if val is None:
                return np.asarray([OBS_NO, EQ], np.int32), 0.0, False
            return (np.asarray([RESULT] + _digits(val) + [EQ], np.int32),
                    0.0, False)
        score = _digit_score(resp, _digits(sum(self.operands)),
                             self.reward_mode)
        return np.empty(0, np.int32), score, True


@dataclass
class ToolCallTask:
    """Task wrapper sampling CalculatorToolEnv episodes."""

    max_value: int = 9
    num_operands: int = 3
    max_calls: int = 2
    reward_mode: str = "partial"
    seed: int = 0

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)

    def sample_prompt(self) -> Tuple[np.ndarray, object]:
        ops = tuple(int(self.rng.integers(0, self.max_value + 1))
                    for _ in range(self.num_operands))
        spec = (ops, self.reward_mode, self.max_calls)
        return CalculatorToolEnv(*spec).reset(), spec

    def make_env(self, spec) -> CalculatorToolEnv:
        return CalculatorToolEnv(*spec)

    def reward(self, response_tokens: List[int], spec) -> float:
        """Single-shot fallback: score the response as a direct answer."""
        return _digit_score(_strip_eos(response_tokens),
                            _digits(sum(spec[0])), spec[1])


# ---------------------------------------------------------------------------
# Single-turn adapter + mixtures
# ---------------------------------------------------------------------------


@dataclass
class SingleTurnEnv:
    """Any single-turn task episode as a trivial one-step environment:
    ``step`` scores the (only) turn and ends the episode with no
    observation."""

    prompt: np.ndarray
    answer: object
    reward_fn: object

    def reset(self) -> np.ndarray:
        return np.asarray(self.prompt, np.int32)

    def step(self, response_tokens) -> Tuple[np.ndarray, float, bool]:
        return (np.empty(0, np.int32),
                float(self.reward_fn(list(response_tokens), self.answer)),
                True)


class SingleTurnEnvTask:
    """Adapter lifting a plain ``sample_prompt``/``reward`` task to the env
    protocol — single-turn tasks become trivial one-step environments, so
    one rollout path serves both."""

    def __init__(self, task):
        self.task = task

    def sample_prompt(self) -> Tuple[np.ndarray, object]:
        prompt, answer = self.task.sample_prompt()
        prompt = np.asarray(prompt, np.int32)
        return prompt, (prompt, answer)

    def make_env(self, spec) -> SingleTurnEnv:
        return SingleTurnEnv(spec[0], spec[1], self.task.reward)

    def reward(self, response_tokens: List[int], spec) -> float:
        return float(self.task.reward(list(response_tokens), spec[1]))


class TaskMixture:
    """Heterogeneous task mixture inside ONE stage: each ``sample_prompt``
    draws a member task by weight. Env-protocol members keep their
    multi-turn environments; plain single-turn members ride through
    :class:`SingleTurnEnvTask` — so a mixed single+multi-turn batch
    exercises the cross-stage IS correction with per-row loss masks.

    The spec tags the member index, making ``make_env``/``reward`` pure
    dispatches."""

    def __init__(self, tasks, weights=None, *, seed: int = 0):
        assert tasks, "empty mixture"
        self.tasks = [t if hasattr(t, "make_env") else SingleTurnEnvTask(t)
                      for t in tasks]
        w = np.ones(len(tasks)) if weights is None else np.asarray(
            weights, np.float64)
        assert len(w) == len(tasks) and (w > 0).all(), \
            "weights must be positive, one per task"
        self._p = w / w.sum()
        self.rng = np.random.default_rng(seed)

    def sample_prompt(self) -> Tuple[np.ndarray, object]:
        m = int(self.rng.choice(len(self.tasks), p=self._p))
        prompt, spec = self.tasks[m].sample_prompt()
        return prompt, (m, spec)

    def make_env(self, spec) -> Environment:
        m, inner = spec
        return self.tasks[m].make_env(inner)

    def reward(self, response_tokens: List[int], spec) -> float:
        m, inner = spec
        return float(self.tasks[m].reward(list(response_tokens), inner))
