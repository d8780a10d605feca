"""gemma2-2b — dense: 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.

Alternating local (sliding-window 4096) + global attention, attention- and
final-logit softcaps. Local layers make the arch eligible for long_500k
decode (sub-quadratic sliding window; global layers are linear per decoded
token). [arXiv:2408.00118]
"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    block_pattern=("local", "global"),
    sliding_window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    rope_theta=10_000.0,
    tie_embeddings=True,
    embed_scale=True,
    source="arXiv:2408.00118",
)
