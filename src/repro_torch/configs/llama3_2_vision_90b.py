"""llama-3.2-vision-90b — VLM backbone: 100L d_model=8192 64H (GQA kv=8) d_ff=28672.

vocab=128256. Cross-attention image layers every 5th layer (20 of 100). The
ViT vision encoder + projector is a STUB per the brief — input_specs()
provides precomputed patch embeddings. [hf:meta-llama/Llama-3.2-11B-Vision]
"""
from repro_torch.common.config import ModelConfig, CrossAttnConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    block_pattern=("attn", "attn", "attn", "attn", "xattn"),
    rope_theta=500_000.0,
    cross_attn=CrossAttnConfig(every=5, num_media_tokens=1601, d_media=7680),
    tie_embeddings=False,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
