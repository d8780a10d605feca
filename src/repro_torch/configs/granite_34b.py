"""granite-34b — dense code model: 88L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.

llama-arch with multi-query attention. [arXiv:2405.04324]
"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    block_pattern=("attn",),
    rope_theta=10_000.0,
    tie_embeddings=True,
    source="arXiv:2405.04324",
)
