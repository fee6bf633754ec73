"""Qwen3-MoE 235B-A22B — 128 experts, top-8.

[moe] 94L d_model=4096 64H (GQA kv=4) d_ff=1536 vocab=151936
[hf:Qwen/Qwen3-30B-A3B scaled]. d_ff is the per-expert ffn width.
Pure global attention -> long_500k skipped (DESIGN.md §5).
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,
    vocab=151936,
    head_dim=128,
    pattern=("moe",),
    moe=MoEConfig(num_experts=128, top_k=8, expert_d_ff=1536),
    qk_norm=True,
    rope_theta=1000000.0,
    tie_embeddings=False,
    fsdp=True,
)
