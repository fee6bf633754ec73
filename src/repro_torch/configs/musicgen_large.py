"""MusicGen-Large — decoder-only over EnCodec tokens.

[audio] 48L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=2048
[arXiv:2306.05284]. 4 parallel codebooks (delay pattern): embeddings are
summed, one lm head per codebook. The EnCodec conv codec itself is the
modality-frontend stub (input_specs provides frame token ids).
Pure global attention -> long_500k skipped.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=2048,
    head_dim=64,
    pattern=("global",),
    num_codebooks=4,
    tie_embeddings=False,
)
