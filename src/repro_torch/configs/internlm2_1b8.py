"""InternLM2 1.8B — dense GQA decoder.

[dense] 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544
[arXiv:2403.17297]. Pure global attention -> long_500k skipped.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="internlm2-1.8b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92544,
    head_dim=128,
    pattern=("global",),
    rope_theta=1000000.0,
)
