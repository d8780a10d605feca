"""deepseek-moe-16b — fine-grained MoE: 28L d_model=2048 16H, 64 routed top-6 + 2 shared.

d_expert=1408, vocab=102400. First layer is a dense FFN (prefix), remaining 27
are MoE. [arXiv:2401.06066]
"""
from repro_torch.common.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=10944,              # dense (first) layer FFN width
    vocab_size=102400,
    block_pattern=("moe",),
    prefix_pattern=("attn",),
    rope_theta=10_000.0,
    moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408,
                  num_shared_experts=2, d_shared=1408),
    tie_embeddings=False,
    source="arXiv:2401.06066",
)
