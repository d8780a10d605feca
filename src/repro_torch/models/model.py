"""LM wrapper: embeddings → block stack → final norm → logits.

Public entry points (plain functions over a parameter dict):

* ``init_params(cfg, seed=..., device=...)`` — the port's own seeded init
* ``cast_params(params, dtype)`` — weights to the compute dtype, once
* ``forward_train(params, cfg, tokens)`` — full-sequence logits
* ``forward_hidden(params, cfg, tokens)`` — final-norm hidden states, for
  the fused loss
* ``prefill(params, cfg, tokens, lengths, cache)`` — seed the slot cache,
  return last-valid-position logits
* ``score_logprobs(params, cfg, tokens, targets)`` — per-token log-probs
  through the fused vocab-blocked kernel, for the legacy loss
* ``decode_step(params, cfg, token, cache, cache_len, paged=None)`` — one
  token, against a dense cache or (``paged``) an ``init_paged_cache`` one
* ``decode_scan(...)`` — ``steps`` decode+sample iterations, no host sync

Parameters: ``{"embed": {"tok": (V, d)}, "layers": [per-layer dict, ...],
"final_norm": (d,)}`` plus ``"lm_head": (d, V)`` for untied embeddings.
``convert.params_from_jax`` builds the same structure from the JAX pytree.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.common.device import resolve_device, torch_dtype
from repro_torch.hopper import fused_logprob as flp
from repro_torch.models import transformer
from repro_torch.models.layers import dense_init, embed_init, rms_norm, softcap
from repro_torch.models.transformer import _gather_last

_MATMUL_KEYS = ("wq", "wk", "wv", "wo", "wi", "wg")


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None):
    """Random parameters made from ``seed`` (a torch.Generator on the target
    device), in ``cfg.param_dtype``, with the reference's structured values
    where it has them (the SSM's A_log, dt_bias and D; rwkv's mixes, decay
    base and norm scale; hymba's fusion weights). Runs on the GPU unless
    device='cpu'."""
    if cfg.uses_media:
        raise NotImplementedError("media (VLM) models are not ported yet")
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.param_dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = {
        "embed": {"tok": embed_init((cfg.vocab_size, cfg.d_model), dtype, dev,
                                    gen)},
        "layers": transformer.init_stack(cfg, dtype, dev, gen),
        "final_norm": torch.ones(cfg.d_model, dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init((cfg.d_model, cfg.vocab_size), dtype,
                                       dev, gen)
    return params


# per-kind leaves that stay float32 at every use in the reference (the SSM's
# dt projection and recurrence constants, rwkv's decay and bonus); every
# other weight is cast to the compute dtype, norm scales keep their own
_F32_KEYS = {"ssm": ("dt_proj", "dt_bias", "A_log", "D"),
             "tm": ("w_base", "dec_b", "u"), "cm": ()}
_NORM_KEYS = ("ln1", "ln2", "fuse_norm_a", "fuse_norm_s")


def cast_params(params, dtype, device=None):
    """Copy of ``params`` with the weights in ``dtype`` and everything on
    ``device``, each leaf in the dtype the reference reads it in: the
    projections, MLP, embedding, lm_head and hymba's ``beta`` in ``dtype``;
    the norm scales in their own dtype, since rms_norm reads them in
    float32; the float32 leaves of ``_F32_KEYS`` as they are. Casting once
    equals the reference's per-use ``.astype``. Tensors already in the
    wanted dtype and device are shared, not copied."""
    def mm(t):
        return t.to(device=device, dtype=dtype)

    def keep(t):
        return t.to(device=device)

    def layer(p):
        out = {}
        for name, v in p.items():
            if name in _NORM_KEYS:
                out[name] = keep(v)
            elif name == "attn":
                out[name] = {k: (mm(t) if k in _MATMUL_KEYS else keep(t))
                             for k, t in v.items()}
            elif name in _F32_KEYS:
                out[name] = {k: (keep(t) if k in _F32_KEYS[name] else mm(t))
                             for k, t in v.items()}
            elif name == "mlp":
                out[name] = {k: mm(t) for k, t in v.items()}
            else:                                       # hymba's beta
                out[name] = mm(v)
        return out

    out = {"embed": {"tok": mm(params["embed"]["tok"])},
           "layers": [layer(p) for p in params["layers"]],
           "final_norm": keep(params["final_norm"])}
    if "lm_head" in params:
        out["lm_head"] = mm(params["lm_head"])
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None):
    dtype = dtype or torch_dtype(cfg.dtype)
    return transformer.init_stack_cache(cfg, batch, max_len, dtype,
                                        resolve_device(device))


def init_paged_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                     page_size: int, num_pages: int, dtype=None,
                     device=None):
    """Paged-KV slot cache: every layer's K/V become physical page pools
    (num_pages, page_size, KV, hd) shared by all ``batch`` slots. Decode
    with ``decode_step(..., paged=(block_table, page_size))``."""
    dtype = dtype or torch_dtype(cfg.dtype)
    return transformer.init_stack_cache(cfg, batch, max_len, dtype,
                                        resolve_device(device),
                                        kv_pages=(num_pages, page_size))


# ---------------------------------------------------------------------------


def _embed(params, cfg: ModelConfig, tokens):
    dt = torch_dtype(cfg.dtype)
    x = F.embedding(tokens, params["embed"]["tok"]).to(dt)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)
    return x


def unembed_weight(params, cfg: ModelConfig):
    """The (d, V) unembedding matrix: the tied (V, d) embedding as a
    transposed view (so its gradient reaches ``embed.tok`` in its own
    layout), or ``lm_head``."""
    return params["embed"]["tok"].T if cfg.tie_embeddings else params["lm_head"]


def _logits(params, cfg: ModelConfig, x):
    """x @ w in the activation dtype, then float32, then the logit softcap."""
    out = (x @ unembed_weight(params, cfg).to(x.dtype)).float()
    if cfg.logit_softcap > 0.0:
        out = softcap(out, cfg.logit_softcap)
    return out


def backbone(params, cfg: ModelConfig, tokens, *, positions=None, cache=None,
             cache_len=None, seq_mask=None, lengths=None, mode="train",
             remat=False, paged=None):
    """Embed + stack + final norm. Returns (hidden (B, S, d), new_cache)."""
    B, S = tokens.shape
    if positions is None:
        if mode == "decode":
            positions = cache_len[:, None]
        else:
            positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    x = _embed(params, cfg, tokens)
    x, new_cache = transformer.apply_stack(
        params["layers"], cfg, x, positions=positions, cache=cache,
        cache_len=cache_len, seq_mask=seq_mask, lengths=lengths, mode=mode,
        remat=remat, paged=paged)
    x = rms_norm(x, params["final_norm"], eps=cfg.rms_eps)
    return x, new_cache


def forward_train(params, cfg: ModelConfig, tokens, *, remat=False):
    """Full-sequence logits (B, S, V) float32 (causal, no cache).
    Differentiable in ``params``; ``remat`` checkpoints each layer."""
    x, _ = backbone(params, cfg, tokens, mode="train", remat=remat)
    return _logits(params, cfg, x)


def forward_hidden(params, cfg: ModelConfig, tokens, *, remat=True):
    """Backbone only: final-norm hidden states (B, S, d) in the compute
    dtype. The pre-unembedding entry point of the fused loss
    (``hopper/fused_is_grpo``), which reads (hidden, unembed_weight) and
    never materialises the (B, S, V) logits."""
    x, _ = backbone(params, cfg, tokens, mode="train", remat=remat)
    return x


def token_logprobs_from_logits(logits, targets):
    """logits: (B, S, V) float32; targets: (B, S) — log p(targets)."""
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets[..., None].long())[..., 0]
    return tgt - lse


def score_logprobs(params, cfg: ModelConfig, tokens, targets, *, remat=True):
    """Per-token log-prob of ``targets`` given ``tokens`` (same length;
    targets[t] is the next-token label of position t), float32 (B, S),
    differentiable in ``params``. The fused vocab-blocked op
    (``hopper/fused_logprob``) reads the final hidden states and the
    unembedding and never materialises the (B, S, V) logits."""
    x = forward_hidden(params, cfg, tokens, remat=remat)
    return flp.fused_logprob(x, unembed_weight(params, cfg), targets,
                             logit_softcap=cfg.logit_softcap)


# -- serving ----------------------------------------------------------------


def prefill(params, cfg: ModelConfig, tokens, lengths, cache):
    """Seed ``cache`` (written in place) with right-padded prompts.

    tokens: (B, S) right-padded; lengths: (B,) true lengths; cache: a stack
    cache with max_len >= S. The recurrent blocks freeze their state over
    the pads (``seq_mask``) and take their carries at each row's last real
    token (``lengths``). Returns (next_token_logits (B, V), cache)."""
    S = tokens.shape[1]
    seq_mask = torch.arange(S, device=tokens.device)[None, :] \
        < lengths[:, None]
    x, new_cache = backbone(params, cfg, tokens, cache=cache,
                            seq_mask=seq_mask, lengths=lengths,
                            mode="prefill")
    last = _gather_last(x, lengths)                      # (B, d)
    return _logits(params, cfg, last), new_cache


def decode_step(params, cfg: ModelConfig, token, cache, cache_len, *,
                paged=None):
    """token: (B,) int — the *input* token; cache_len: (B,) int32. Returns
    logits (B, V) for the next token and the cache, with the token's K/V
    written at cache_len. ``paged=(block_table (B, max_pages) int32,
    page_size)`` decodes against an :func:`init_paged_cache` cache."""
    x, new_cache = backbone(params, cfg, token[:, None], cache=cache,
                            cache_len=cache_len, mode="decode", paged=paged)
    return _logits(params, cfg, x)[:, 0], new_cache


def decode_scan(params, cfg: ModelConfig, cache, last_token, cache_len,
                active, aux, *, steps: int, step_fn, paged=None):
    """Run ``steps`` decode+sample iterations on the device, with no host
    synchronisation inside (no ``.item()``, no ``.cpu()``), so the loop can be
    captured as a CUDA graph. The caller supplies the sampling / stop policy::

        step_fn(logits, cache_len, active, aux) -> (tok, logp, stop, aux')

    where ``cache_len`` is the PRE-increment per-slot length and ``stop``
    (B,) bool marks slots that freeze after consuming ``tok``. Inactive
    slots still flow through the batched decode with their cache_len and
    last token held (their recurrent state advances, as in the
    reference).

    Returns ``((cache, last_token, cache_len, active, aux), ys)`` with
    ``ys = (tokens (steps, B), logps (steps, B), was_active (steps, B))``;
    ``was_active[d]`` is the active mask entering step ``d``. ``paged``
    (the block table and page size) stays fixed over the loop."""
    toks, logps, acts = [], [], []
    clen, last_tok, act, a = cache_len, last_token, active, aux
    for _ in range(steps):
        logits, cache = decode_step(params, cfg, last_tok, cache, clen,
                                    paged=paged)
        tok, logp, stop, a = step_fn(logits, clen, act, a)
        clen = clen + act.to(clen.dtype)
        last_tok = torch.where(act, tok.to(last_tok.dtype), last_tok)
        toks.append(tok)
        logps.append(logp)
        acts.append(act)
        act = act & ~stop
    ys = (torch.stack(toks), torch.stack(logps), torch.stack(acts))
    return (cache, last_tok, clen, act, a), ys
