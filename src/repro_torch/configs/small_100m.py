"""small-100m — the ~100M-parameter end-to-end target.

12L d_model=768 12H (GQA kv=4) d_ff=2048, vocab 32768. Llama-style; usable
with launch/train.py on real hardware; on this CPU container the integration
tests and examples default to `tiny` for wall-clock reasons.
"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="small-100m",
    family="dense",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=4,
    d_ff=2048,
    vocab_size=32768,
    block_pattern=("attn",),
    rope_theta=10_000.0,
    tie_embeddings=True,
    dtype="float32",
    source="(internal ~100M config)",
)
