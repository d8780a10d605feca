"""paper-qwen-7b — DeepSeek-R1-Distill-Qwen-7B analogue (Qwen2.5-7B arch).

The paper's main experimental model (Table 1 / Fig 1). 28L d_model=3584 28H
(GQA kv=4) d_ff=18944 vocab=152064.
"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="paper-qwen-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    block_pattern=("attn",),
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    source="hf:deepseek-ai/DeepSeek-R1-Distill-Qwen-7B",
)
