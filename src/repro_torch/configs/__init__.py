"""Architecture registry: one module per assigned architecture.

A copy of the JAX package's ``configs`` (pure data).

``get_config(arch_id)`` returns the full ModelConfig;
``get_smoke_config(arch_id)`` the reduced same-family variant used by the
CPU smoke tests (2 layers, d_model <= 512, <= 4 experts).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, reduced

ARCHS = (
    "rwkv6_1b6",
    "zamba2_2b7",
    "qwen3_moe_235b",
    "musicgen_large",
    "gemma2_27b",
    "internvl2_1b",
    "internlm2_1b8",
    "llama4_maverick",
    "qwen3_14b",
    "gemma3_12b",
)

# CLI ids (match the assignment list) -> module names
ALIASES = {
    "rwkv6-1.6b": "rwkv6_1b6",
    "zamba2-2.7b": "zamba2_2b7",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "musicgen-large": "musicgen_large",
    "gemma2-27b": "gemma2_27b",
    "internvl2-1b": "internvl2_1b",
    "internlm2-1.8b": "internlm2_1b8",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "qwen3-14b": "qwen3_14b",
    "gemma3-12b": "gemma3_12b",
}


def get_config(arch: str) -> ModelConfig:
    mod_name = ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    if mod_name not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return reduced(get_config(arch))


def all_arch_ids() -> list[str]:
    return sorted(ALIASES.keys())
