"""rwkv6-1.6b — "Finch": 24L d_model=2048 attention-free, d_ff=7168 vocab=65536.

Data-dependent decay RWKV6 time-mix + channel-mix. [arXiv:2404.05892]
"""
from repro_torch.common.config import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,            # wkv heads = d_model / rwkv.head_dim
    num_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    block_pattern=("rwkv",),
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, mix_lora=32),
    tie_embeddings=False,
    source="arXiv:2404.05892",
)
