"""Configuration dataclasses of the PyTorch port.

A copy of the architecture, rollout and training configs of
``repro.common.config`` (:class:`ModelConfig` with its sub-configs,
:class:`RolloutConfig` and :class:`TrainConfig`), kept here so that the port
imports nothing of the JAX package. Field names and
defaults are the reference's, so one config value means the same thing in
both packages.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Architecture sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration."""

    num_experts: int
    top_k: int
    d_expert: int                      # hidden dim of EACH routed expert
    num_shared_experts: int = 0        # DeepSeek-MoE style always-on experts
    d_shared: int = 0                  # hidden dim of the shared expert(s)
    router_aux_coef: float = 0.01      # load-balance auxiliary loss weight
    router_jitter: float = 0.0
    capacity_factor: float = 1.25      # used by the dropping dispatcher
    dispatch: str = "sparse"           # "sparse" (capacity-bounded, prod) |
                                       # "dense" (FLOP-exact reference)


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-style selective-state-space configuration (used by hymba)."""

    state_dim: int = 16
    conv_dim: int = 4
    expand: int = 2                    # d_inner = expand * d_model
    dt_rank: int = 0                   # 0 -> ceil(d_model / 16)


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV6 ("Finch") time-mix configuration."""

    head_dim: int = 64
    decay_lora: int = 64               # rank of the data-dependent decay LoRA
    mix_lora: int = 32                 # rank of the token-shift mixing LoRA


@dataclass(frozen=True)
class CrossAttnConfig:
    """VLM cross-attention configuration (vision frontend is a stub)."""

    every: int = 5                     # one cross-attn layer per `every` layers
    num_media_tokens: int = 1601       # image patch embeddings per request
    d_media: int = 4096                # frontend embedding width (pre-projection)


# ---------------------------------------------------------------------------
# ModelConfig
# ---------------------------------------------------------------------------

# Block kinds understood by repro.models.transformer:
#   "attn"   — dense GQA self-attention + gated MLP
#   "local"  — sliding-window GQA self-attention + gated MLP
#   "global" — full GQA self-attention + gated MLP (explicit, for gemma2)
#   "moe"    — dense GQA self-attention + MoE FFN
#   "rwkv"   — RWKV6 time-mix + channel-mix (attention-free)
#   "hymba"  — parallel attention + SSM heads, shared gated MLP
#   "xattn"  — cross-attention to media tokens + gated MLP (VLM)
VALID_BLOCK_KINDS = ("attn", "local", "global", "moe", "rwkv", "hymba", "xattn")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // num_heads

    # Repeating block pattern; layer i is kind pattern[i % len(pattern)].
    # `prefix_pattern` layers come first (e.g. deepseek-moe's leading dense
    # layer) and are executed unrolled, before the scanned repeats.
    block_pattern: Tuple[str, ...] = ("attn",)
    prefix_pattern: Tuple[str, ...] = ()

    # attention options
    qk_norm: bool = False
    rope_theta: float = 500_000.0
    sliding_window: int = 4096         # used by "local" blocks
    attn_softcap: float = 0.0          # gemma2 attention-logit softcap (0 = off)
    logit_softcap: float = 0.0         # gemma2 final-logit softcap (0 = off)
    attn_scale: float = 0.0            # 0 -> 1/sqrt(head_dim)

    # embeddings / output
    tie_embeddings: bool = True
    embed_scale: bool = False          # gemma-style sqrt(d_model) embed scaling
    embed_impl: str = "gather"         # "gather" (CPU) | "onehot" (TPU/SPMD —
                                       # partitions as a matmul, avoiding the
                                       # SPMD gather full-rematerialization)
    cache_update: str = "dus"          # "dus" | "onehot" (select-based write,
                                       # shardable when the cache length dim
                                       # is split across devices)

    # family sub-configs
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    cross_attn: Optional[CrossAttnConfig] = None

    # norms / numerics
    rms_eps: float = 1e-6
    dtype: str = "bfloat16"            # activation / compute dtype
    param_dtype: str = "float32"       # master param dtype

    # citation for the assigned-architecture pool
    source: str = ""

    # ---------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        for k in self.block_pattern + self.prefix_pattern:
            if k not in VALID_BLOCK_KINDS:
                raise ValueError(f"unknown block kind {k!r}")
        body = self.num_layers - len(self.prefix_pattern)
        if body < 0 or body % len(self.block_pattern) != 0:
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} incompatible with "
                f"prefix={self.prefix_pattern} pattern={self.block_pattern}"
            )

    # ---------------------------------------------------------------
    @property
    def num_repeats(self) -> int:
        """How many times the block pattern repeats (the scan length)."""
        return (self.num_layers - len(self.prefix_pattern)) // len(self.block_pattern)

    @property
    def is_subquadratic(self) -> bool:
        """True if every block is sub-quadratic in sequence length (SSM /
        sliding window) — the eligibility rule for the long_500k shape."""
        quad = {"attn", "moe", "xattn"}
        kinds = set(self.block_pattern) | set(self.prefix_pattern)
        # "global" blocks are full attention; gemma2 keeps them but we allow
        # long_500k because *decode* against a KV cache is linear per token
        # and the config may flag global layers as block-sparse for long ctx.
        return not (kinds & quad)

    @property
    def uses_media(self) -> bool:
        return self.cross_attn is not None

    def reduced(self, *, num_layers: int = 2, max_d_model: int = 512,
                max_experts: int = 4, max_vocab: int = 512) -> "ModelConfig":
        """Smoke-test variant of the same family: <=2 layers, d_model<=512,
        <=4 experts. Keeps the block kinds so the family code-path is
        exercised for real."""
        d_model = min(self.d_model, max_d_model)
        # keep head structure: shrink heads so head_dim stays reasonable
        num_heads = max(2, min(self.num_heads, d_model // 64))
        ratio = max(1, self.num_heads // max(1, self.num_kv_heads))
        num_kv_heads = max(1, num_heads // ratio)
        num_heads = num_kv_heads * ratio
        pattern = self.block_pattern
        prefix = self.prefix_pattern[: 1 if self.prefix_pattern else 0]
        body = num_layers - len(prefix)
        if body % len(pattern) != 0:      # shrink pattern to fit 2 layers
            pattern = pattern[: max(1, body)]
            body = (body // len(pattern)) * len(pattern)
        nl = len(prefix) + max(len(pattern), body)
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, max_experts),
                top_k=min(self.moe.top_k, 2),
                d_expert=min(self.moe.d_expert, 256),
                d_shared=min(self.moe.d_shared, 256),
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                dispatch="dense",   # dropless: smoke tests check exact
                                    # decode/full-forward consistency
            )
        rwkv = None
        if self.rwkv is not None:
            rwkv = dataclasses.replace(self.rwkv, head_dim=min(self.rwkv.head_dim, 32),
                                       decay_lora=16, mix_lora=8)
        xa = None
        if self.cross_attn is not None:
            xa = dataclasses.replace(self.cross_attn, num_media_tokens=16, d_media=64,
                                     every=self.cross_attn.every)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=nl,
            d_model=d_model,
            num_heads=num_heads,
            num_kv_heads=num_kv_heads,
            head_dim=0,
            d_ff=min(self.d_ff, 4 * d_model),
            vocab_size=min(self.vocab_size, max_vocab),
            block_pattern=pattern,
            prefix_pattern=prefix,
            sliding_window=min(self.sliding_window, 64),
            moe=moe,
            rwkv=rwkv,
            cross_attn=xa,
            dtype="float32",
        )

    # -- parameter counting (for roofline MODEL_FLOPS) ----------------
    def param_count(self, *, active_only: bool = False) -> int:
        """Analytic parameter count. With ``active_only`` MoE experts are
        counted as top_k (+shared) instead of all experts."""
        hd = self.head_dim
        d = self.d_model
        attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd + self.num_heads * hd * d
        mlp = 3 * d * self.d_ff
        n = 0
        kinds = list(self.prefix_pattern) + list(self.block_pattern) * self.num_repeats
        for k in kinds:
            if k in ("attn", "local", "global"):
                n += attn + mlp
            elif k == "xattn":
                n += attn + mlp + (self.cross_attn.d_media * d if self.cross_attn else 0)
            elif k == "moe":
                m = self.moe
                ne = (m.top_k if active_only else m.num_experts)
                n += attn + 3 * d * m.d_expert * ne
                n += 3 * d * m.d_shared * m.num_shared_experts
                n += d * m.num_experts          # router
            elif k == "rwkv":
                # time-mix: r,k,v,g,o projections + decay/mix loras; channel-mix ~ 3*d*d_ff
                n += 5 * d * d + 3 * d * self.d_ff
            elif k == "hymba":
                s = self.ssm or SSMConfig()
                d_inner = s.expand * d
                n += attn + mlp + 2 * d * d_inner + d_inner * d  # in/out ssm proj
            n += 2 * d                                            # 2 RMSNorm scales
        n += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return n


# ---------------------------------------------------------------------------
# RL / CoPRIS configs (paper Table 3 defaults)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RolloutConfig:
    batch_size: int = 64               # B: prompts per training step
    group_size: int = 8                # G: samples per prompt (GRPO group)
    max_prompt_len: int = 1024
    max_response_len: int = 15360
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = -1
    # --- CoPRIS specific ---
    concurrency: int = 1024            # N': in-flight rollout requests
    mode: str = "copris"               # copris | naive_partial | sync
    resume_strategy: str = "reprefill"  # reprefill | kv_snapshot
    # Device-side decode steps fused per engine step (one jitted lax.scan).
    # The host sees one transfer per chunk instead of one per token; stop
    # detection (EOS / length) runs on device and post-stop samples are
    # trimmed by the host replay. 1 reproduces the step-wise engine.
    decode_chunk: int = 8
    # --- overlap-aware adaptive N' (ROLL-Flash-style) ---
    # The static N' above stays the default. With adaptive_concurrency the
    # trainer adjusts the in-flight target BETWEEN stages from observed
    # finish/refill rates (rollout wall vs the train step it overlaps),
    # clamped to [concurrency_min, concurrency_max]. 0 resolves to
    # max(1, concurrency // 4) and concurrency respectively — by default
    # the controller only ever *shrinks* below the static N' (the slot pool
    # is sized to concurrency_max, so raising it costs KV memory).
    adaptive_concurrency: bool = False
    concurrency_min: int = 0
    concurrency_max: int = 0
    # --- KV cache backend (sampling/kv_cache.py CacheBackend) ---
    # "dense": one max_len KV region per slot (bit-identical to the
    # historical engine). "paged": vLLM-style paged KV — physical page pools
    # shared by all slots, block-table indirection, copy-on-write prefix
    # sharing (one prefill per GRPO group) and page-gated continuous-batching
    # admission. Trajectory content is bit-identical across backends (the
    # per-trajectory PRNG streams are slot/layout independent).
    kv_backend: str = "dense"          # dense | paged
    kv_page_size: int = 16             # tokens per KV page (paged only)
    # Physical pages in the pool. 0 = slot_pool * max_len / page_size (the
    # dense-equivalent HBM budget — no admission pressure). Smaller values
    # trade admission stalls for memory: each slot only consumes pages for
    # tokens it has actually generated, so at equal HBM a paged pool admits
    # ~max_len/mean_len times more concurrent slots.
    kv_num_pages: int = 0
    # Share a group's common prompt pages across its G samples (refcounted,
    # COW on first divergent write): one prefill feeds the whole group.
    kv_prefix_sharing: bool = True
    # --- multi-turn environments ---
    # Per-submit deadline (seconds) for async Environment.step / reward
    # calls. A step that exceeds it ends the episode with the reward
    # accumulated so far (counted in env_failures / env_timeouts) instead of
    # wedging the stage. 0 = no deadline (trust the env to return).
    env_step_timeout: float = 0.0

    @property
    def resolved_concurrency_min(self) -> int:
        return self.concurrency_min or max(1, self.concurrency // 4)

    @property
    def resolved_concurrency_max(self) -> int:
        return self.concurrency_max or self.concurrency

    @property
    def slot_pool(self) -> int:
        """Engine slot-pool (and KV cache) size. B*G for sync's fixed
        workload; otherwise the static N' — raised to the adaptive upper
        bound only when the controller that could ask for it is actually
        on (a leftover concurrency_max from an adaptive experiment must
        not silently inflate the cache allocation)."""
        if self.mode == "sync":
            return self.batch_size * self.group_size
        if self.adaptive_concurrency:
            return max(self.concurrency, self.resolved_concurrency_max)
        return self.concurrency

    def __post_init__(self):
        if self.decode_chunk < 1:
            raise ValueError(f"decode_chunk must be >= 1, got {self.decode_chunk}")
        if self.mode not in ("copris", "naive_partial", "sync"):
            raise ValueError(f"unknown rollout mode {self.mode!r}")
        if self.resume_strategy not in ("reprefill", "kv_snapshot"):
            raise ValueError(
                f"unknown resume strategy {self.resume_strategy!r}")
        if self.kv_backend not in ("dense", "paged"):
            raise ValueError(
                f"unknown kv_backend {self.kv_backend!r} (dense|paged)")
        if self.kv_page_size < 1:
            raise ValueError(
                f"kv_page_size must be >= 1, got {self.kv_page_size}")
        if self.kv_num_pages < 0:
            raise ValueError(
                f"kv_num_pages must be >= 0 (0 = dense-equivalent budget), "
                f"got {self.kv_num_pages}")
        if self.env_step_timeout < 0:
            raise ValueError(
                f"env_step_timeout must be >= 0 (0 = no deadline), "
                f"got {self.env_step_timeout}")
        if self.concurrency_min < 0 or self.concurrency_max < 0:
            raise ValueError(
                "concurrency_min/concurrency_max must be >= 0 (0 = derive "
                f"from concurrency); got min={self.concurrency_min} "
                f"max={self.concurrency_max}")
        if self.adaptive_concurrency:
            if self.mode != "copris":
                raise ValueError(
                    f"adaptive_concurrency requires mode='copris' (got "
                    f"{self.mode!r}): sync dispatches a fixed B*G workload "
                    "and naive_partial never refills, so neither has an "
                    "in-flight target to adapt")
            lo, hi = (self.resolved_concurrency_min,
                      self.resolved_concurrency_max)
            if not (1 <= lo <= self.concurrency <= hi):
                raise ValueError(
                    "adaptive_concurrency bounds must satisfy 1 <= "
                    "concurrency_min <= concurrency <= concurrency_max; "
                    f"resolved to min={lo} concurrency={self.concurrency} "
                    f"max={hi} — adjust concurrency_min/concurrency_max "
                    "(0 derives min=concurrency//4, max=concurrency)")


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-6
    weight_decay: float = 0.01
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 10
    total_steps: int = 1000
    # GRPO
    clip_low: float = 0.2              # paper: clip ratio low 0.2
    clip_high: float = 0.28            # paper: clip ratio high 0.28 (dual clip)
    kl_coef: float = 0.0               # paper: 0.0
    entropy_coef: float = 0.0          # paper: 0.0
    loss_agg: str = "token_mean"       # paper: token mean
    use_is_correction: bool = True     # the CoPRIS cross-stage IS switch
    is_ratio_cap: float = 10.0         # numerical safety cap on exp(logp-L)
    # Route the big-vocab loss through the fused IS+GRPO op
    # (hopper/fused_is_grpo): one pass over the logits computes logp,
    # entropy and the clipped objective, and the custom VJP recomputes
    # per-block softmax stats so the (B, S, V) tensor is never residualized.
    # False falls back to the legacy score_logprobs path, which cannot emit
    # entropy above FUSED_VOCAB_THRESHOLD (make_loss_fn raises if
    # entropy_coef > 0 there rather than silently dropping the bonus).
    fused_loss: bool = True
    microbatches: int = 1
    remat: bool = True
    seed: int = 0
    # --- overlapped (one-step async) pipeline ---
    # overlap=True runs rollout on a background thread: while the train step
    # for batch k executes, the engine already collects batch k+1 under an
    # immutable snapshot of the freshest published params. Tokens carry the
    # snapshot's stage id, so the existing cross-stage IS correction absorbs
    # the one-step staleness. overlap=False is bit-identical to the
    # sequential trainer (same per-trajectory PRNG streams).
    overlap: bool = False
    # Max optimizer updates the training step may be ahead of the params
    # that generated the batch it consumes (pipeline depth). 1 = classic
    # one-step async; K > 1 lets the producer run up to K collects ahead
    # (multi-step async — stage ids carried by tokens keep the cross-stage
    # IS correction exact at any depth). The producer blocks rather than
    # exceed it.
    max_staleness: int = 1
    # Disaggregated rollout/train: route every published params version
    # through the versioned ParamStore reshard (train FSDP layout ->
    # rollout serve_tp_only layout, see core/weight_sync.py). Requires
    # overlap=True — without a producer thread there is no second side to
    # sync weights to.
    disaggregated: bool = False

    def __post_init__(self):
        if self.max_staleness < 1:
            raise ValueError(
                f"max_staleness must be >= 1 (got {self.max_staleness}); "
                "0 would deadlock the overlapped pipeline")
        if self.disaggregated and not self.overlap:
            raise ValueError(
                "disaggregated=True requires overlap=True: the versioned "
                "weight sync feeds the background rollout producer; set "
                "TrainConfig(overlap=True, disaggregated=True) (CLI: "
                "--overlap --disaggregated)")


# ---------------------------------------------------------------------------
# Input shapes of the dry run (the reference's assigned shapes)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                          # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

# long_500k runs only for the sub-quadratic archs (the reference's choice)
LONG_CTX_ARCHS = ("rwkv6-1.6b", "hymba-1.5b", "gemma2-2b")
