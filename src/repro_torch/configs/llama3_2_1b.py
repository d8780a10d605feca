"""llama3.2-1b — dense 16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256.

[hf:meta-llama/Llama-3.2-1B]
"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    block_pattern=("attn",),
    rope_theta=500_000.0,
    tie_embeddings=True,
    source="hf:meta-llama/Llama-3.2-1B",
)
