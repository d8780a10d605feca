"""Token sampler: temperature / top-k / top-p, returning the sampled token
AND its log-probability under the actual sampling distribution.

The behaviour log-prob recorded here is what CoPRIS buffers per token
(eq. 6 of the paper): tokens keep the log-prob of the policy *stage* that
generated them, and the cross-stage IS ratio at training time is
``exp(logp_current - behaviour_logp)``.

:func:`sample_rows` is the plain PyTorch version of the sampling kernel
(``hopper/fused_sample.py``) and the port of ``repro.sampling.sampler``:
the same keys and logits give the same tokens.
"""
from __future__ import annotations

import torch

from repro_torch.sampling import prng

NEG_INF = -1e30


def _apply_top_k(logits, k: int):
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    thresh = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < thresh, NEG_INF, logits)


def _apply_top_p(logits, p: float):
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # keep tokens until cumulative prob exceeds p (always keep the first)
    cutoff_mask = cum - probs < p
    thresh = torch.where(cutoff_mask, sorted_logits,
                         torch.inf).amin(dim=-1, keepdim=True)
    return torch.where(logits < thresh, NEG_INF, logits)


def prepare_logits(logits, *, temperature: float, top_p: float = 1.0,
                   top_k: int = -1):
    """Temperature scaling + top-k + top-p masking over the last axis.
    temperature must be > 0. Dropped entries become ``NEG_INF``; ties at
    either threshold are kept. The division is by a float32 tensor, an
    exactly rounded quotient as jax's and the kernel's."""
    t = torch.full((), temperature, dtype=logits.dtype, device=logits.device)
    l = logits / t
    l = _apply_top_k(l, top_k)
    l = _apply_top_p(l, top_p)
    return l


def sample_rows(keys, logits, *, temperature: float = 1.0, top_p: float = 1.0,
                top_k: int = -1):
    """Batched sampling with an INDEPENDENT key per row.

    keys: (B, 2) uint32 raw PRNG keys; logits: (B, V) float32. Row i's draw
    is a pure function of (keys[i], logits[i]). Returns (tokens (B,) int32,
    logps (B,) float32); temperature <= 0 is greedy with logp 0."""
    if temperature <= 0.0:
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return tok, torch.zeros(tok.shape, dtype=torch.float32,
                                device=logits.device)
    l = prepare_logits(logits, temperature=temperature, top_p=top_p,
                       top_k=top_k)
    g = prng.gumbel(keys, l.shape[-1])
    tok = torch.argmax(g + l, dim=-1)
    logp = torch.log_softmax(l, dim=-1).gather(-1, tok[:, None])[:, 0]
    return tok.to(torch.int32), logp
