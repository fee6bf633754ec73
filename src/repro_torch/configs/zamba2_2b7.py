"""Zamba2 2.7B — Mamba2 backbone + shared-weight attention blocks.

[hybrid] 54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000,
ssm_state=64  [arXiv:2411.15242]

Pattern: 5 Mamba2 blocks then one shared attention block (the paper
interleaves 2 alternating shared blocks with per-site LoRA; we share a
single block and note the simplification in DESIGN.md). Sub-quadratic:
Mamba2 state is O(1); the shared attention uses a sliding window for
long_500k.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    head_dim=80,
    pattern=("mamba2", "mamba2", "mamba2", "mamba2", "mamba2", "shared_attn"),
    ssm_state=64,
    ssm_heads=80,        # expand factor 2: inner = 5120
    window=4096,         # shared_attn treated as local for long-context
    subquadratic=True,
    recurrent_mlp=False,
)
