"""Shared decoder substrate: norms, RoPE, GQA attention, gated MLP.

The counterpart of the JAX package's ``models/layers.py`` for the train
and prefill path (no decode cache). Functions on tensors:
``*_init(generator, ...) -> params`` (dicts of tensors) and
``*_apply(params, x, ...)``. The dtypes follow the reference's step by
step, since a plain port differs silently in three places:

* attention scores are an f32 product of q and k upcast to f32 (the
  reference's ``preferred_element_type=f32``; a bf16 x bf16 product is
  exact in f32), and the softmax is cast back to the activations' dtype
  before it multiplies v;
* ``rmsnorm`` computes in f32, but ``1.0 + scale`` stays in the scale's
  dtype (bf16 for the stacked block norms) before it meets the f32
  activations;
* RoPE computes in f32 and casts back.

Products are ``torch.matmul``/``einsum``, as the reference leaves them to
XLA; no library attention kernel is used. Constants enter as Python
scalars, never as tensors made on the card: a host-to-card copy of a
pageable value makes the host wait for the card's queue to drain. The
blockwise attention for S > ``FLASH_THRESHOLD`` (ROADMAP Queue 1 item 2)
and the decode caches (serving, item 1) are not ported yet.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

FLASH_THRESHOLD = 4096  # the reference switches to blockwise attention above this


def _dense_init(generator: torch.Generator, shape, device, scale=None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / np.sqrt(shape[0])
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.float32) * scale


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, device) -> dict:
    return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return rmsnorm_head(params["scale"], x, eps)


def rmsnorm_head(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normalize the trailing dim (per-head qk-norm when it is head_dim)."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    # 1.0 + scale in the scale's own dtype, as jnp's weak-typed 1.0 gives
    return (x * (1.0 + scale)).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, rotate-half convention.

    x: [..., S, H, hd]; positions: broadcastable to [..., S]."""
    hd = x.shape[-1]
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd
    freqs = 1.0 / (float(np.float32(theta)) ** exps)  # an f32 power, as jnp's
    angles = positions[..., None].float() * freqs  # [..., S, hd/2]
    cos = torch.cos(angles)[..., None, :]  # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


def attention_init(generator: torch.Generator, cfg, device) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    params = {
        "wq": _dense_init(generator, (d, nh * hd), device),
        "wk": _dense_init(generator, (d, nkv * hd), device),
        "wv": _dense_init(generator, (d, nkv * hd), device),
        "wo": _dense_init(generator, (nh * hd, d), device),
    }
    if cfg.qk_norm:
        params["q_norm"] = torch.zeros((hd,), dtype=torch.float32, device=device)
        params["k_norm"] = torch.zeros((hd,), dtype=torch.float32, device=device)
    return params


def _attn_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, kind: str, window: int,
               chunk: int) -> torch.Tensor:
    """[..., Sq, Sk] boolean mask. q_pos/k_pos: absolute positions."""
    qp, kp = q_pos[..., :, None], k_pos[..., None, :]
    causal = qp >= kp
    if kind == "local":
        causal = causal & ((qp - kp) < window)
    elif kind == "chunked":
        causal = causal & (torch.div(qp, chunk, rounding_mode="floor")
                           == torch.div(kp, chunk, rounding_mode="floor"))
    return causal


def _dense_attention(qg, k_all, v_all, q_pos, k_pos, cfg, base_kind):
    """Unblocked attention. qg: [B, Sq, nkv, g, hd]; k/v: [B, Sk, nkv, hd]
    (no cache, so every key is valid)."""
    hd = qg.shape[-1]
    scores = torch.einsum("bsngh,btnh->bngst", qg.float(), k_all.float())
    scores = scores / float(np.float32(np.sqrt(hd)))
    if cfg.attn_softcap is not None:
        scores = cfg.attn_softcap * torch.tanh(scores / cfg.attn_softcap)
    mask = _attn_mask(q_pos, k_pos, base_kind, cfg.window, cfg.chunk)
    scores = scores.masked_fill(~mask[:, None, None, :, :], -1e30)
    probs = torch.softmax(scores, dim=-1).to(qg.dtype)
    return torch.einsum("bngst,btnh->bsngh", probs, v_all)


def attention_apply(
    params: dict,
    x: torch.Tensor,
    cfg,
    kind: str = "global",
    positions: Optional[torch.Tensor] = None,
    cache: Optional[dict] = None,
) -> tuple:
    """GQA attention on the train/prefill path. x: [B, S, D].

    Returns (y, None): no decode cache is kept. A cache, or S above
    ``FLASH_THRESHOLD`` (the reference's blockwise path), raises."""
    if cache is not None:
        raise NotImplementedError(
            "attention decode caches are not ported yet (serving: ROADMAP Queue 1 item 1)")
    B, S, D = x.shape
    if S > FLASH_THRESHOLD:
        raise NotImplementedError(
            f"S = {S} > {FLASH_THRESHOLD} needs the blockwise attention, not ported "
            "yet (ROADMAP Queue 1 item 2)")
    hd = cfg.resolved_head_dim
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    groups = nh // nkv
    base_kind = "local" if kind.startswith("local") else (
        "chunked" if kind.startswith("chunked") else "global")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :].expand(B, S)

    q = (x @ params["wq"].to(x.dtype)).reshape(B, S, nh, hd)
    k = (x @ params["wk"].to(x.dtype)).reshape(B, S, nkv, hd)
    v = (x @ params["wv"].to(x.dtype)).reshape(B, S, nkv, hd)
    if cfg.qk_norm:
        q = rmsnorm_head(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm_head(params["k_norm"], k, cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    qg = q.reshape(B, S, nkv, groups, hd)
    out = _dense_attention(qg, k, v, positions, positions, cfg, base_kind)
    y = out.reshape(B, S, nh * hd) @ params["wo"].to(x.dtype)
    return y, None


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU)
# ---------------------------------------------------------------------------


def mlp_init(generator: torch.Generator, d: int, ff: int, device) -> dict:
    return {
        "wi": _dense_init(generator, (d, ff), device),
        "wg": _dense_init(generator, (d, ff), device),
        "wo": _dense_init(generator, (ff, d), device),
    }


def mlp_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = (x @ params["wi"].to(x.dtype)) * torch.nn.functional.silu(
        x @ params["wg"].to(x.dtype))
    return h @ params["wo"].to(x.dtype)
