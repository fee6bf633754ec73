"""Gemma3 12B — 5:1 local:global attention, 128k context.

[dense] 48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144
[hf:google/gemma-3-12b]. window=1024 locals; long_500k runs via the
windowed locals (globals decode O(L) with seq-sharded KV).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_ff=15360,
    vocab=262144,
    head_dim=256,
    pattern=("local", "local", "local", "local", "local", "global"),
    window=1024,
    rope_theta=1000000.0,
    subquadratic=True,
    fsdp=True,
)
