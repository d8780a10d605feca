"""The benchmark's FLOP and byte formulas, from a configuration's shapes.

Model FLOPs count what the model needs, not what the program runs: each
token of a trajectory is processed forward once by the rollout and forward
and backward (three forwards' worth) by the update, so a trajectory of L
tokens with a response of R costs ``4 * forward_flops(L, R)``. A forward
counts the matrix products of the layers' parameters at every position, at
2 FLOPs a multiply-add (the embedding lookup is no product), causal
attention over the triangle (the query at position p, 1-based, scores and
mixes p keys), and the unembedding only at the R rows whose logits sample
or score a response token: the last prompt row and every response row but
the last. Recomputed work (checkpointed layers, the re-prefill of a
resumed partial, the padding of a packed batch, rows past a stop, logits
nobody reads) is not counted. The update's current-policy log-probs come
out of its own forward (the fused loss), so they add nothing to it.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12        # H100 SXM, dense bf16 (NVIDIA data sheet)
PEAK_HBM_BYTES = 3.35e12        # H100 SXM, HBM3 bytes/s


def layer_matmul_params(cfg: dict) -> int:
    """Parameters a token multiplies through in the layers of one
    forward: attention projections and the gated MLP."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    H, KV, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    per_layer = d * H * hd + 2 * d * KV * hd + H * hd * d + 3 * d * f
    return cfg["num_hidden_layers"] * per_layer


def attention_flops(cfg: dict, L: int) -> int:
    """Causal self-attention of one sequence of L tokens, all layers:
    4 * hd * H FLOPs a (query, key) pair, over L (L + 1) / 2 pairs."""
    return (cfg["num_hidden_layers"] * 2 * cfg["head_dim"]
            * cfg["num_attention_heads"] * L * (L + 1))


def forward_flops(cfg: dict, L: int, logit_rows: int) -> int:
    """One forward over L tokens with the unembedding at ``logit_rows``
    rows."""
    return (2 * layer_matmul_params(cfg) * L + attention_flops(cfg, L)
            + 2 * cfg["hidden_size"] * cfg["vocab_size"] * logit_rows)


def trajectory_flops(cfg: dict, L: int, R: int) -> int:
    """Rollout forward once, update forward and backward, of a trajectory
    of L tokens whose response has R."""
    return 4 * forward_flops(cfg, L, R)


def loss_kernel_flops(cfg: dict, rows: int) -> int:
    """The fused loss at ``rows`` trained rows: the logits' forward, dh and
    dw, each a (rows x d) by (d x V) product."""
    return 3 * 2 * rows * cfg["hidden_size"] * cfg["vocab_size"]


def decode_attn_bytes(cfg: dict, positions: int, rows: int) -> int:
    """Device bytes the decode attention needs, all layers: K and V of
    ``positions`` cached positions (summed over the active rows of every
    decode step) in bf16, and each active row's query read and output
    written once (``rows`` row-steps)."""
    KV, H, hd = (cfg["num_key_value_heads"], cfg["num_attention_heads"],
                 cfg["head_dim"])
    per_layer = positions * 2 * KV * hd * 2 + rows * 2 * H * hd * 2
    return cfg["num_hidden_layers"] * per_layer
