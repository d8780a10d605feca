"""hymba-1.5b — hybrid: 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001.

Parallel attention + Mamba(SSM state=16) heads inside every block, outputs
fused by learned scalars. [arXiv:2411.13676]
"""
from repro_torch.common.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    block_pattern=("hymba",),
    sliding_window=1024,      # hymba uses SWA on most attention layers
    rope_theta=10_000.0,
    ssm=SSMConfig(state_dim=16, conv_dim=4, expand=2),
    tie_embeddings=True,
    source="arXiv:2411.13676",
)
