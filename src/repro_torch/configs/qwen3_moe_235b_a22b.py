"""qwen3-moe-235b-a22b — MoE: 94L d_model=4096 64H (GQA kv=4), 128 experts top-8.

d_expert (moe_intermediate)=1536, vocab=151936. [hf:Qwen/Qwen3-30B-A3B family]
"""
from repro_torch.common.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,               # = d_expert for MoE blocks
    vocab_size=151936,
    block_pattern=("moe",),
    qk_norm=True,
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=128, top_k=8, d_expert=1536),
    tie_embeddings=False,
    source="hf:Qwen/Qwen3-30B-A3B",
)
