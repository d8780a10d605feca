"""Architecture registry of the port.

Each ported architecture lives in its own module and exposes ``CONFIG``.
``get_config(name)`` returns the full config; ``get_smoke_config(name)``
returns the reduced (<=2 layer, d_model<=512) variant used by the CPU tests.
Registered: the dense architectures (``attn`` blocks, and gemma2-2b's
local/global pair), the hybrid hymba-1.5b and the attention-free
rwkv6-1.6b. All of them run on the card: the attention kernels take
head_dim 32, 64, 128 and 256 (gemma2-2b's 256; paper-qwen-7b's, qwen3-14b's
and granite-34b's 128) and any GQA ratio (granite-34b's is 48).
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
}


def list_archs():
    return list(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown or not yet ported arch {name!r}; "
                       f"available: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return get_config(name).reduced()
