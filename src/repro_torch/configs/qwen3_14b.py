"""Qwen3 14B — dense GQA with qk-norm.

[dense] 40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936
[hf:Qwen/Qwen3-14B]. Pure global attention -> long_500k skipped.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=17408,
    vocab=151936,
    head_dim=128,
    pattern=("global",),
    qk_norm=True,
    rope_theta=1000000.0,
    tie_embeddings=False,
    fsdp=True,
)
