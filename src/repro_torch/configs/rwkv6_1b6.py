"""RWKV6 "Finch" 1.6B — attention-free, data-dependent decay.

[ssm] 24L d_model=2048 d_ff=7168 vocab=65536  [arXiv:2404.05892]
Sub-quadratic by construction (O(1) recurrent state) -> runs long_500k.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,          # 2048 / head_size 64
    n_kv_heads=32,       # unused by rwkv blocks; kept for uniform tooling
    d_ff=7168,
    vocab=65536,
    pattern=("rwkv6",),
    rwkv_head_size=64,
    subquadratic=True,
    tie_embeddings=False,
)
