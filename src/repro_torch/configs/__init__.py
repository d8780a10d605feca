"""Architecture registry of the port.

Each ported architecture lives in its own module and exposes ``CONFIG``.
``get_config(name)`` returns the full config; ``get_smoke_config(name)``
returns the reduced (<=2 layer, d_model<=512) variant used by the CPU tests.
Registered: every architecture of the JAX registry. The dense ones
(``attn`` blocks, and gemma2-2b's local/global pair), the hybrid hymba-1.5b,
the attention-free rwkv6-1.6b, the mixtures of experts deepseek-moe-16b (a
dense first layer, then ``moe`` blocks) and qwen3-moe-235b-a22b, and the
VLM llama-3.2-vision-90b (an ``xattn`` block every fifth layer). All of them
run on the card: the attention kernels take head_dim 32, 64, 128 and 256
(gemma2-2b's 256; the 128 of paper-qwen-7b, qwen3-14b, granite-34b, both
MoEs and the VLM) and any GQA ratio (granite-34b's is 48).
"""
from __future__ import annotations

import importlib

from repro_torch.common.config import ModelConfig  # noqa: F401

_ARCH_MODULES = {
    "llama3.2-1b": "llama3_2_1b",
    "tiny": "tiny",
    "small-100m": "small_100m",
    "hymba-1.5b": "hymba_1_5b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "gemma2-2b": "gemma2_2b",
    "qwen3-14b": "qwen3_14b",
    "granite-34b": "granite_34b",
    "musicgen-medium": "musicgen_medium",
    "paper-qwen-7b": "paper_qwen_7b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "llama-3.2-vision-90b": "llama3_2_vision_90b",
}


# the reference's assigned architectures (its dry run's): every one but the
# paper's own setup and the two CPU-scale configs
ASSIGNED_ARCHS = tuple(k for k in _ARCH_MODULES
                       if k not in ("paper-qwen-7b", "tiny", "small-100m"))


def list_archs():
    return list(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; "
                       f"available: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return get_config(name).reduced()
