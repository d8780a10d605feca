"""musicgen-medium — audio decoder backbone: 48L d_model=1536 24H d_ff=6144 vocab=2048.

Decoder-only transformer over EnCodec tokens. The EnCodec/conv frontend is a
STUB per the brief — input_specs() provides precomputed frame embeddings; the
backbone consumes token ids from the 2048-entry codebook vocabulary.
[arXiv:2306.05284]
"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    block_pattern=("attn",),
    rope_theta=10_000.0,
    tie_embeddings=False,
    source="arXiv:2306.05284",
)
