"""The traffic generator: one general task that reads a mix's parameters.

Prompts are uniform random tokens of the configuration's vocabulary (never
the end-of-sequence token), drawn from the run's task seed. Their lengths
spread evenly over the mix's ``prompt_len`` range: every block of
``LENGTH_BLOCK`` consecutive prompts takes the same set of lengths, in an
order the seed draws, so every seed gives the same sizes. Response lengths
are not set here: the weights give EOS a steady probability
(``weights.py``). The reward is a fixed function of a response's tokens and
its group's salt, so rewards differ within a group and the update is not
zero; the reference computes it again with :func:`reward_of`.
"""
from __future__ import annotations

import numpy as np

LENGTH_BLOCK = 64


def reward_of(tokens, salt: int) -> float:
    """The share of the response's tokens whose salted hash is even."""
    t = np.asarray(tokens, np.int64)
    if t.size == 0:
        return 0.0
    h = (t * 2654435761 + int(salt)) % 1000003
    return float((h % 2 == 0).mean())


class SeededTask:
    """``sample_prompt() -> (prompt, salt)``; ``reward(tokens, salt)``."""

    def __init__(self, cfg: dict, mix: dict, seed: int):
        self.vocab = cfg["vocab_size"]
        self.eos = cfg["eos_token_id"]
        self.lo, self.hi = mix["prompt_len"]
        self.rng = np.random.default_rng(seed)
        span = self.hi - self.lo + 1
        self._set = self.lo + (np.arange(LENGTH_BLOCK) + 0.5) * span \
            // LENGTH_BLOCK
        self._order = []

    def _length(self) -> int:
        if not self._order:
            self._order = list(self.rng.permutation(self._set))
        return int(self._order.pop())

    def sample_prompt(self):
        n = self._length()
        toks = self.rng.integers(0, self.vocab - 1, n)
        toks[toks >= self.eos] += 1                 # never EOS
        salt = int(self.rng.integers(1, 1 << 31))
        return toks.astype(np.int32), salt

    def reward(self, response_tokens, salt) -> float:
        return reward_of(response_tokens, salt)
