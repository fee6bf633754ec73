"""Model configuration for the architecture zoo.

A copy of the JAX package's ``models/config.py`` (pure data, no JAX), kept
here so the port imports nothing of that package.

A model is a pattern of block kinds repeated over the depth, over a shared
decoder substrate. Block kinds:

  'global'   — full-attention GQA transformer block
  'local'    — sliding-window GQA block (window tokens)
  'chunked'  — chunked-local GQA block (attend within fixed chunks;
               llama4 iRoPE-style)
  'moe'      — full-attention block with MoE MLP
  'local_moe'/'chunked_moe' — windowed/chunked attention with MoE MLP
  'mamba2'   — Mamba2 (SSD) state-space block
  'rwkv6'    — RWKV6 (Finch) data-dependent-decay linear attention block
  'shared_attn' — zamba2-style *shared-weight* global attention block
               (one param set reused at every occurrence)

The depth pattern is ``pattern`` repeated ``n_units`` times (layers =
n_units * len(pattern)); parameters are stacked per pattern position so
the forward pass is a loop over units.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

ATTENTION_KINDS = ("global", "local", "chunked", "moe", "local_moe", "chunked_moe",
                   "shared_attn")
RECURRENT_KINDS = ("mamba2", "rwkv6")
BLOCK_KINDS = ATTENTION_KINDS + RECURRENT_KINDS


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    expert_d_ff: int = 1024
    num_shared_experts: int = 0  # llama4-style always-on shared expert
    aux_loss_weight: float = 0.01
    capacity_factor: float = 1.25  # tokens over capacity are dropped


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    pattern: Sequence[str] = ("global",)
    window: int = 4096  # sliding window for 'local' blocks
    chunk: int = 8192  # chunk size for 'chunked' blocks
    moe: Optional[MoEConfig] = None
    # attention details
    qk_norm: bool = False
    logit_softcap: Optional[float] = None  # gemma2 final-logit softcap
    attn_softcap: Optional[float] = None  # gemma2 attention softcap
    rope_theta: float = 10000.0
    # ssm details
    ssm_state: int = 64  # mamba2 state dim per head
    ssm_heads: Optional[int] = None
    rwkv_head_size: int = 64
    # frontends (carve-out stubs): number of prefix embedding positions
    # provided by the modality encoder, or 0 for pure text
    prefix_embeds: int = 0
    # musicgen: parallel codebooks (embedding sum + per-codebook heads)
    num_codebooks: int = 1
    # recurrent blocks carry their own MLP (rwkv channel-mix) or not
    # (zamba2-style: only the shared attention block has an MLP)
    recurrent_mlp: bool = True
    # training details
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    remat: bool = True  # activation-checkpoint each block in train_step
    # sharding: shard params over 'data' too (FSDP) when large
    fsdp: bool = False
    # supports the long_500k shape (sub-quadratic path exists)
    subquadratic: bool = False
    dtype: str = "bfloat16"
    # manual expert parallelism (set by the train-step builder for giant
    # MoEs): experts sharded over this manual mesh axis, dispatch via
    # explicit all_to_all. None -> GSPMD-auto expert sharding.
    ep_axis: Optional[str] = None
    ep_ranks: int = 1

    def __post_init__(self):
        if self.n_layers % len(self.pattern) != 0:
            raise ValueError(
                f"{self.arch_id}: n_layers={self.n_layers} not divisible by "
                f"pattern length {len(self.pattern)}")
        for k in self.pattern:
            if k not in BLOCK_KINDS:
                raise ValueError(f"unknown block kind {k!r}")
        if self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError("n_heads must be a multiple of n_kv_heads")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def n_units(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def uses_moe(self) -> bool:
        return any("moe" in k for k in self.pattern)

    def expert_rows(self, rank: int, ranks: int) -> range:
        """The experts rank ``rank`` of ``ranks`` holds under expert
        parallelism, [r·E/n, (r+1)·E/n), as the reference's ``_localize``
        template shards the stacked [n_units, E, ...] leaves; raises when n
        does not divide E."""
        E = self.moe.num_experts
        if E % ranks:
            raise ValueError(f"{self.arch_id}: {E} experts do not shard over {ranks} ranks "
                             "(expert parallelism needs the learner count to divide E)")
        per = E // ranks
        return range(rank * per, (rank + 1) * per)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, ff, hd = self.d_model, self.d_ff, self.resolved_head_dim
        nh, nkv = self.n_heads, self.n_kv_heads
        total = self.vocab * d * self.num_codebooks  # embed
        if not self.tie_embeddings:
            total += self.vocab * d * self.num_codebooks
        shared_attn_counted = False
        for kind in self.pattern:
            blocks = self.n_units
            if kind == "shared_attn":
                if shared_attn_counted:
                    continue
                blocks = 1
                shared_attn_counted = True
            attn = d * hd * (nh + 2 * nkv) + nh * hd * d
            if kind in ("mamba2",):
                nh_s = self.ssm_heads or (self.d_model // 64)
                inner = nh_s * 64
                attn = d * (2 * inner + 2 * nh_s * self.ssm_state) + inner * d + nh_s * 2
            if kind == "rwkv6":
                H = d // self.rwkv_head_size
                attn = d * d * 4 + d * d  # r,k,v,g(w) projections + out
            if "moe" in kind and self.moe is not None:
                m = self.moe
                mlp = m.num_experts * 3 * d * m.expert_d_ff + d * m.num_experts
                mlp += m.num_shared_experts * 3 * d * m.expert_d_ff
            elif kind in ("mamba2", "rwkv6") and not self.recurrent_mlp:
                mlp = 0
            else:
                mlp = 3 * d * ff
            total += blocks * (attn + mlp + 2 * d)
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if not self.uses_moe or self.moe is None:
            return self.param_count()
        m = self.moe
        full_mlp = m.num_experts * 3 * self.d_model * m.expert_d_ff
        act_mlp = (m.top_k + m.num_shared_experts) * 3 * self.d_model * m.expert_d_ff
        moe_blocks = sum(1 for k in self.pattern if "moe" in k) * self.n_units
        return int(self.param_count() - moe_blocks * (full_mlp - act_mlp))


def reduced(cfg: ModelConfig, n_layers: int = 2, d_model: int = 256,
            vocab: int = 512) -> ModelConfig:
    """Smoke-test variant of the same family (<= 4 experts, d_model <= 512).

    Keeps the pattern (truncated/repeated to n_layers), head grouping
    ratio, and block kinds so the smoke test exercises the same code path
    as the full config.
    """
    pattern = tuple(cfg.pattern)
    if n_layers % len(pattern) != 0:
        # shrink the unit but keep at least one of each distinct kind
        kinds = list(dict.fromkeys(pattern))
        pattern = tuple(kinds[: max(1, n_layers)])
        while n_layers % len(pattern) != 0:
            pattern = pattern[:-1]
    hd = 64
    nh = max(2, d_model // hd)
    ratio = max(1, cfg.n_heads // cfg.n_kv_heads)
    nkv = max(1, nh // ratio)
    nh = nkv * ratio
    moe = None
    if cfg.moe is not None:
        moe = MoEConfig(num_experts=min(4, cfg.moe.num_experts),
                        top_k=min(2, cfg.moe.top_k),
                        expert_d_ff=d_model * 2,
                        num_shared_experts=min(1, cfg.moe.num_shared_experts),
                        # no capacity drops in smoke tests: keeps the
                        # decode-vs-forward consistency check exact
                        capacity_factor=4.0)
    return dataclasses.replace(
        cfg,
        arch_id=cfg.arch_id + "-smoke",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=nh,
        n_kv_heads=nkv,
        head_dim=hd,
        d_ff=d_model * 3,
        vocab=vocab,
        pattern=pattern,
        window=64,
        chunk=64,
        moe=moe,
        ssm_state=16,
        ssm_heads=max(2, d_model // 64),
        rwkv_head_size=32,
        prefix_embeds=min(cfg.prefix_embeds, 8),
        remat=False,
        fsdp=False,
    )
