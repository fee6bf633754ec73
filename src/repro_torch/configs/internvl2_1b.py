"""InternVL2-1B — InternViT frontend + Qwen2-0.5B-class LLM backbone.

[vlm] 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655
[arXiv:2404.16821]. The ViT+projector is the stub frontend: input_specs
provides 256 precomputed patch embeddings prefixed to the text tokens.
Pure global attention -> long_500k skipped.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151655,
    head_dim=64,
    pattern=("global",),
    prefix_embeds=256,
    rope_theta=1000000.0,
)
