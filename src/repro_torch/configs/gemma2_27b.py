"""Gemma2 27B — alternating local:global attention, logit softcaps.

[dense] 46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000
[arXiv:2408.00118]. window=4096, attn softcap 50, final softcap 30.
Locals are windowed -> long_500k runs (global layers decode O(L)).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_ff=36864,
    vocab=256000,
    head_dim=128,
    pattern=("local", "global"),
    window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    subquadratic=True,
    fsdp=True,
)
