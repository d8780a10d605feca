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

The train-mode entry points take ``media`` (B, M, d_media), the VLM's
frontend embeddings (which the VLM requires there and in ``prefill``;
decode reads the media K/V its prefill cached), and with ``return_aux``
also return the reference's aux dict ``{"router_aux": sum of the MoE
layers' load-balance losses}``.

Parameters: ``{"embed": {"tok": (V, d)}, "layers": [per-layer dict, ...],
"final_norm": (d,)}`` plus ``"lm_head": (d, V)`` for untied embeddings and
``embed.media_proj`` (d_media, d) for the VLM. ``convert.params_from_jax``
builds the same structure from the JAX pytree.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.common.device import resolve_device, torch_dtype
from repro_torch.common.partitioning import (activation_placements,
                                             is_sharded, local_call, on_mesh,
                                             on_rows, replicated,
                                             shard_activation, vocab_slice)
from repro_torch.hopper import fused_logprob as flp
from repro_torch.models import transformer
from repro_torch.models.layers import dense_init, embed_init, rms_norm, softcap
from repro_torch.models.transformer import _gather_last

_MATMUL_KEYS = ("wq", "wk", "wv", "wo", "wi", "wg")


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None,
                compute_dtype=None, place=None):
    """Random parameters made from ``seed`` (a torch.Generator on the target
    device), in ``cfg.param_dtype``, with the reference's structured values
    where it has them (the SSM's A_log, dt_bias and D; rwkv's mixes, decay
    base and norm scale; hymba's fusion weights). Runs on the GPU unless
    device='cpu'. With ``compute_dtype`` the result is ``cast_params`` of
    those parameters, each layer cast as soon as it is made, so the
    ``param_dtype`` copy of the whole model never exists at once (serving a
    model whose float32 weights do not fit the card). ``place(path,
    piece)`` (``launch/sharding.init_sharded_params``) takes each piece as
    soon as it is made, the embedding, a layer, the final norm, the head,
    with its path from the root, and returns what the tree keeps of it.
    ``device="meta"`` makes the same tree of shapes and dtypes with no
    generator and no data (the dry run's: the counterpart of
    ``jax.eval_shape`` of the reference's init)."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.param_dtype)
    if place is None:
        def place(path, piece):
            return piece
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
    tok = place(("embed", "tok"),
                embed_init((cfg.vocab_size, cfg.d_model), dtype, dev, gen))
    layers = []
    for i, kind in enumerate(transformer.layer_kinds(cfg)):
        layer = transformer.init_block(cfg, kind, dtype, dev, gen)
        layers.append(place(("layers", i), layer if compute_dtype is None
                            else _cast_layer(layer, compute_dtype, dev)))
    params = {
        "embed": {"tok": tok},
        "layers": layers,
        "final_norm": place(("final_norm",), torch.ones(
            cfg.d_model, dtype=dtype, device=dev)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = place(("lm_head",), dense_init(
            (cfg.d_model, cfg.vocab_size), dtype, dev, gen))
    if cfg.uses_media:
        params["embed"]["media_proj"] = place(
            ("embed", "media_proj"),
            dense_init((cfg.cross_attn.d_media, cfg.d_model), dtype, dev,
                       gen))
    if compute_dtype is not None:
        params = _cast_outer(params, layers, compute_dtype, dev)
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
    equals the reference's per-use ``.astype``. The MoE router stays
    float32 (the reference routes in float32); its experts, the shared
    experts, the cross-attention with its gate, ``mlp_gate`` and
    ``media_proj`` take ``dtype``. Tensors already in the wanted dtype and
    device are shared, not copied."""
    return _cast_outer(params, [_cast_layer(p, dtype, device)
                                for p in params["layers"]], dtype, device)


def _cast_outer(params, layers, dtype, device):
    """``params``' embedding, final norm and lm_head as ``cast_params``
    casts them, around the cast ``layers``."""
    def mm(t):
        return t.to(device=device, dtype=dtype)

    out = {"embed": {k: mm(t) for k, t in params["embed"].items()},
           "layers": layers,
           "final_norm": params["final_norm"].to(device=device)}
    if "lm_head" in params:
        out["lm_head"] = mm(params["lm_head"])
    return out


def _cast_layer(p, dtype, device):
    """One layer's leaves as ``cast_params`` casts them."""
    def mm(t):
        return t.to(device=device, dtype=dtype)

    def keep(t):
        return t.to(device=device)

    out = {}
    for name, v in p.items():
        if name in _NORM_KEYS:
            out[name] = keep(v)
        elif name in ("attn", "xattn"):         # xattn's tanh gate: dtype
            out[name] = {k: (mm(t) if k in _MATMUL_KEYS or k == "gate"
                             else keep(t))
                         for k, t in v.items()}
        elif name in _F32_KEYS:
            out[name] = {k: (keep(t) if k in _F32_KEYS[name] else mm(t))
                         for k, t in v.items()}
        elif name in ("mlp", "moe"):
            out[name] = {k: (keep(t) if k == "router"
                             else {kk: mm(tt) for kk, tt in t.items()}
                             if isinstance(t, dict) else mm(t))
                         for k, t in v.items()}
        else:                           # hymba's beta, xattn's mlp_gate
            out[name] = mm(v)
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None, mesh=None, shard_seq=None):
    """A zeroed stack cache of ``batch`` slots of ``max_len`` positions.
    With ``mesh`` every leaf is a ``DTensor`` laid out as
    ``launch/sharding.cache_placements_tree`` says, each rank allocating
    only its own shard (on the mesh's device). ``shard_seq`` (the cache
    length over "data", for one sequence) defaults to ``batch == 1``, as
    the reference picks it for its decode step."""
    dtype = dtype or torch_dtype(cfg.dtype)
    if mesh is None:
        return transformer.init_stack_cache(cfg, batch, max_len, dtype,
                                            resolve_device(device))
    import torch.distributed.tensor as dtensor

    from repro_torch.common.tree import tree_map
    from repro_torch.launch.sharding import cache_placements_tree
    shapes = transformer.init_stack_cache(cfg, batch, max_len, dtype,
                                          torch.device("meta"))
    if shard_seq is None:
        shard_seq = batch == 1
    return tree_map(lambda t, pl: dtensor.zeros(
        *t.shape, dtype=t.dtype, device_mesh=mesh, placements=list(pl)),
        shapes, cache_placements_tree(shapes, cfg, mesh,
                                      shard_seq=shard_seq))


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


def _lookup(tok, tokens):
    """``F.embedding``; under a mesh the vocab-parallel lookup (``tok``
    (V, d) sharded over "model" by vocabulary rows, ``tokens`` over the
    batch axes): each rank looks up the ids of its own vocabulary slice, and
    the partial rows sum over "model"."""
    if not is_sharded(tok):
        return F.embedding(tokens, tok)
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = tok.device_mesh
    names = mesh.mesh_dim_names
    vocab = activation_placements(mesh, tok.shape, "tp", None)
    rows = activation_placements(mesh, tokens.shape, "dp", None)
    split, start, v_local = vocab_slice(mesh, tok.shape[0], vocab, 0)

    def lookup(w, ids):
        if not split:
            return F.embedding(ids, w)
        local = ids.long() - start
        hit = (local >= 0) & (local < v_local)
        out = F.embedding(torch.where(hit, local, 0), w)
        return out * hit[..., None].to(out.dtype)

    out_pl = tuple(Partial() if a in split else r
                   for a, r in zip(names, rows))
    grad_pl = tuple(Shard(0) if a in split
                    else Partial() if r.is_shard() else Replicate()
                    for a, r in zip(names, rows))
    return local_call(lookup, mesh, (tok, tokens), (vocab, rows), out_pl,
                      (grad_pl, None))


def _positions(tokens):
    """(B, S) positions 0..S-1, in ``tokens``' layout under a mesh."""
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device)[None].expand(B, S)
    if not is_sharded(tokens):
        return pos
    from torch.distributed.tensor import DTensor
    mesh = tokens.device_mesh
    return DTensor.from_local(pos, mesh, replicated(mesh), run_check=False
                              ).redistribute(mesh, tokens.placements)


def _embed(params, cfg: ModelConfig, tokens):
    dt = torch_dtype(cfg.dtype)
    x = _lookup(params["embed"]["tok"], tokens).to(dt)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)
    return x


def _project_media(params, cfg: ModelConfig, media, *, mode="train"):
    """media (B, M, d_media) -> (B, M, d) in the compute dtype. A media
    model needs its media in every mode but decode, which reads the media
    K/V its prefill cached."""
    if media is None and cfg.uses_media and mode != "decode":
        raise ValueError(f"{cfg.name} requires media embeddings")
    if media is None:
        return None
    dt = torch_dtype(cfg.dtype)
    w = params["embed"]["media_proj"]
    if is_sharded(w):
        # on a mesh: each rank's rows of the media (the same on every rank
        # when given plain), projected whole over the tensor axes
        if not is_sharded(media):
            media = on_mesh(media, w)
        media = shard_activation(media, "dp", None, None)
        return shard_activation(media.to(dt) @ w.to(dt), "dp", None, None)
    return media.to(dt) @ w.to(dt)


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


def backbone(params, cfg: ModelConfig, tokens, *, positions=None, media=None,
             cache=None, cache_len=None, seq_mask=None, lengths=None,
             mode="train", remat=False, paged=None):
    """Embed + stack + final norm. Returns (hidden (B, S, d), new_cache,
    aux): ``aux`` the sum of the MoE layers' router losses, float32."""
    if is_sharded(tokens) and mode != "train":
        check_mesh_serving(cfg, cache, paged)
    if positions is None:
        if mode == "decode":
            positions = cache_len[:, None]
        else:
            positions = _positions(tokens)
    x = _embed(params, cfg, tokens)
    x = shard_activation(x, "dp", None, None)
    media_p = _project_media(params, cfg, media, mode=mode)
    x, new_cache, aux = transformer.apply_stack(
        params["layers"], cfg, x, positions=positions, media=media_p,
        cache=cache, cache_len=cache_len, seq_mask=seq_mask, lengths=lengths,
        mode=mode, remat=remat, paged=paged)
    x = rms_norm(x, params["final_norm"], eps=cfg.rms_eps)
    return x, new_cache, aux


def check_mesh_serving(cfg: ModelConfig, cache=None, paged=None):
    """Prefill and decode on a mesh: every block kind, over a dense cache
    laid out as ``launch/sharding.cache_placements_tree`` says, in the
    default or the ``shard_seq`` layout (each block writes each rank's
    shard in place, so a cache in another layout would be redistributed
    into a copy and the writes lost). Raises ``NotImplementedError`` for
    the paged cache, which is not ported."""
    if paged is not None:
        raise NotImplementedError(
            "the paged KV cache on a mesh is not ported (ROADMAP queue 1: "
            "the reference has no sharding rule for page pools)")
    if cache is None:
        return
    from repro_torch.launch.sharding import cache_placements
    mesh = next(iter(cache[0].values())).device_mesh
    got = [(i, name, tuple(t.placements), tuple(t.shape))
           for i, layer in enumerate(cache) for name, t in layer.items()]
    for shard_seq in (False, True):
        bad = [(i, name, pl, want) for i, name, pl, shape in got
               if pl != (want := cache_placements(
                   (i, name), shape, cfg, mesh, shard_seq=shard_seq))]
        if not bad:
            return
    i, name, pl, want = bad[0]
    raise ValueError(
        f"cache layer {i} {name!r} is laid out {pl}, not as "
        f"launch/sharding.cache_placements says ({want}): make the cache "
        "with init_cache(..., mesh=)")


def forward_train(params, cfg: ModelConfig, tokens, *, media=None,
                  remat=False, return_aux=False):
    """Full-sequence logits (B, S, V) float32 (causal, no cache), and with
    ``return_aux`` the aux dict. Differentiable in ``params``; ``remat``
    checkpoints each layer."""
    x, _, aux = backbone(params, cfg, tokens, media=media, mode="train",
                         remat=remat)
    logits = _logits(params, cfg, x)
    return (logits, {"router_aux": aux}) if return_aux else logits


def forward_hidden(params, cfg: ModelConfig, tokens, *, media=None,
                   remat=True, return_aux=False):
    """Backbone only: final-norm hidden states (B, S, d) in the compute
    dtype, and with ``return_aux`` the aux dict. The pre-unembedding entry
    point of the fused loss (``hopper/fused_is_grpo``), which reads
    (hidden, unembed_weight) and never materialises the (B, S, V)
    logits."""
    x, _, aux = backbone(params, cfg, tokens, media=media, mode="train",
                         remat=remat)
    return (x, {"router_aux": aux}) if return_aux else x


def token_logprobs_from_logits(logits, targets):
    """logits: (B, S, V) float32; targets: (B, S) — log p(targets)."""
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets[..., None].long())[..., 0]
    return tgt - lse


def score_logprobs(params, cfg: ModelConfig, tokens, targets, *, media=None,
                   remat=True, return_aux=False):
    """Per-token log-prob of ``targets`` given ``tokens`` (same length;
    targets[t] is the next-token label of position t), float32 (B, S),
    differentiable in ``params``. The fused vocab-blocked op
    (``hopper/fused_logprob``) reads the final hidden states and the
    unembedding and never materialises the (B, S, V) logits (on a mesh
    see ``fused_logprob``). With ``return_aux`` also the aux dict."""
    x, aux = forward_hidden(params, cfg, tokens, media=media, remat=remat,
                            return_aux=True)
    lp = flp.fused_logprob(x, unembed_weight(params, cfg), targets,
                           logit_softcap=cfg.logit_softcap)
    return (lp, aux) if return_aux else lp


# -- serving ----------------------------------------------------------------


def prefill(params, cfg: ModelConfig, tokens, lengths, cache, *, media=None):
    """Seed ``cache`` (written in place) with right-padded prompts.

    tokens: (B, S) right-padded; lengths: (B,) true lengths; cache: a stack
    cache with max_len >= S. The recurrent blocks freeze their state over
    the pads (``seq_mask``) and take their carries at each row's last real
    token (``lengths``). A media model's ``media`` (B, M, d_media) seeds
    its xattn layers' media K/V. Returns (next_token_logits (B, V),
    cache)."""
    seq_mask = _positions(tokens) < lengths[:, None]
    x, new_cache, _ = backbone(params, cfg, tokens, media=media, cache=cache,
                               seq_mask=seq_mask, lengths=lengths,
                               mode="prefill")
    last = on_rows(_gather_last, (x, lengths))           # (B, d)
    return _logits(params, cfg, last), new_cache


def decode_step(params, cfg: ModelConfig, token, cache, cache_len, *,
                media=None, paged=None):
    """token: (B,) int — the *input* token; cache_len: (B,) int32. Returns
    logits (B, V) for the next token and the cache, with the token's K/V
    written at cache_len. ``paged=(block_table (B, max_pages) int32,
    page_size)`` decodes against an :func:`init_paged_cache` cache. The
    xattn layers read the media K/V in the cache, so ``media`` is optional
    here (projected, then unused, as in the reference)."""
    x, new_cache, _ = backbone(params, cfg, token[:, None], media=media,
                               cache=cache, cache_len=cache_len,
                               mode="decode", paged=paged)
    return _logits(params, cfg, x)[:, 0], new_cache


def decode_scan(params, cfg: ModelConfig, cache, last_token, cache_len,
                active, aux, *, steps: int, step_fn, media=None,
                paged=None):
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
                                    media=media, paged=paged)
        tok, logp, stop, a = step_fn(logits, clen, act, a)
        clen = clen + act.to(clen.dtype)
        last_tok = torch.where(act, tok.to(last_tok.dtype), last_tok)
        toks.append(tok)
        logps.append(logp)
        acts.append(act)
        act = act & ~stop
    ys = (torch.stack(toks), torch.stack(logps), torch.stack(acts))
    return (cache, last_tok, clen, act, a), ys
