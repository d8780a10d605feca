"""tiny — real-CPU RL training model (examples + integration tests).

4 layers, d_model=128; small vocab shared with repro_torch.data.tasks.
"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="tiny",
    family="dense",
    num_layers=4,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    d_ff=512,
    vocab_size=64,
    block_pattern=("attn",),
    rope_theta=10_000.0,
    tie_embeddings=True,
    dtype="float32",
    source="(internal)",
)
