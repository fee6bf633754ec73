"""Llama-4 Maverick 400B-A17B — MoE (128 experts top-1 + shared expert),
iRoPE chunked-local attention, early-fusion multimodal.

[moe] 48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e
top-1  [hf:meta-llama/Llama-4 family]. Pattern: MoE every other layer
(dense interleave), 3 chunked-local + 1 global per unit (iRoPE-style); chunked attention gives the
sub-quadratic path for long_500k. d_ff is the per-expert width; a shared
expert is always active (A17B active params).
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    head_dim=128,
    pattern=("chunked_moe", "chunked", "chunked", "moe"),
    chunk=8192,
    moe=MoEConfig(num_experts=128, top_k=1, expert_d_ff=8192,
                  num_shared_experts=1),
    rope_theta=500000.0,
    tie_embeddings=False,
    subquadratic=True,
    fsdp=True,
)
