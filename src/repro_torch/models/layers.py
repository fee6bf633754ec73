"""Shared decoder substrate: norms, RoPE, GQA attention, gated MLP.

The counterpart of the JAX package's ``models/layers.py``: the train,
prefill and decode paths. Functions on tensors:
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
pageable value makes the host wait for the card's queue to drain. Above
``FLASH_THRESHOLD`` tokens, attention is the reference's blockwise online
softmax (``_flash_attention``), loops over q and k blocks in its order:
in training, and in a prefill with a cache or without one, where the keys
are the prompt's own. The reference takes it only without a cache, and a
prefill into a cache there makes [B, H, S, S] f32 scores; the port's
blockwise prefill writes the same cache words, and its logits differ from
the dense path's by the summation order (f32) and, in bf16, by the dense
path's rounding of its probabilities to bf16 before they meet v, where the
blockwise path keeps f32, as in training.

Tensor parallelism (``tp``, the model group's ``World``; the reference's
GSPMD over its 'model' axis, Megatron's layout): each rank holds its
shards (``models/sharding.py``). Attention takes the replicated input
through ``copy_to_model``, projects to its whole q heads (rank j's
``unit_share`` of them, [h0, h1), which may be none: it then adds zeros
through wo and still joins every collective) and the kv heads they read
(wq/wk/wv column-parallel where m divides the kv heads, whole groups a
rank; otherwise the kv heads are replicated, each rank projects the ones
its q heads read, and q head q reads kv head q·nkv/nh through an index,
one kv head a q head, since a rank's q heads may span two kv heads), runs
qk-norm (its scales through ``copy_to_model``, since each rank normalizes
only its heads), RoPE, the masks, the softcap and flash or dense
attention on them, and wo row-parallel behind ``reduce_from_model``; the
MLP splits ff the same way. Norms stay replicated. Serving takes the same
split: the decode cache holds this rank's kv heads where m divides them;
where it does not, the reference's ``cache_pspecs`` replicates the kv
heads over 'model', so every rank projects and writes all of them (the
copies stay equal) and attends with the ones its q heads read.

Sequence-sharded decode (``seq``, the data group's ``World``; the
reference's long_500k layout, ``decode_spec``'s ``seq_axis``): rank i of
n holds the contiguous slots [i·S_c/n, (i+1)·S_c/n) of every attention
cache, the global caches and the ring buffers of local and chunked layers
alike. Only the rank owning the new token's slot (``pos % S_c`` in a
ring buffer, ``min(pos, S_c − 1)`` in a global cache) writes it, and each
rank reads its slots' absolute positions from their global indices. The
attention is the dense path's masking and softcap on the rank's slots in
f32, then a log-sum-exp merge over the group: each rank's max, sum of
exponentials and weighted v, the ``pmax`` of the maxes, each rank's sum
and accumulator rescaled to it, and their ``psum`` (``_merged_attention``).
A prefill into such a cache writes each rank's slots only.

The decode cache follows the reference's dtypes, which a plain port
would not: ``attention_init_cache`` makes bf16 k and v whatever the
model's dtype, a prefill writes its k and v cast to the cache's dtype,
and a decode step reads the cache in the activations' dtype, writes the
new token's k and v at full precision and returns the cache in that
dtype (an f32 model's cache turns f32 at its first decode step). Where
the dtypes agree (the bf16 model) k and v are written into the given
cache in place: the reference's ``.at[].set`` is functional, but a copy
of every layer's cache a step would double the step's bytes and change
no value.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.dist.collectives import copy_to_model, pmax, psum, reduce_from_model
from repro_torch.models.sharding import unit_share

FLASH_THRESHOLD = 4096  # dense attention above this many tokens would not fit
FLASH_QBLOCK = 2048
FLASH_KBLOCK = 1024


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


def _base_kind(kind: str) -> str:
    return "local" if kind.startswith("local") else (
        "chunked" if kind.startswith("chunked") else "global")


def _dense_attention(qg, k_all, v_all, q_pos, k_pos, valid, cfg, base_kind):
    """Unblocked attention (decode and short prefill).

    qg: [B, Sq, nkv, g, hd]; k/v: [B, Sk, nkv, hd]; valid: bool[B, Sk],
    the keys that hold a token, or None where every key does."""
    hd = qg.shape[-1]
    scores = torch.einsum("bsngh,btnh->bngst", qg.float(), k_all.float())
    scores = scores / float(np.float32(np.sqrt(hd)))
    if cfg.attn_softcap is not None:
        scores = cfg.attn_softcap * torch.tanh(scores / cfg.attn_softcap)
    mask = _attn_mask(q_pos, k_pos, base_kind, cfg.window, cfg.chunk)
    if valid is not None:
        mask = mask & valid[..., None, :]
    scores = scores.masked_fill(~mask[:, None, None, :, :], -1e30)
    probs = torch.softmax(scores, dim=-1).to(qg.dtype)
    return torch.einsum("bngst,btnh->bsngh", probs, v_all)


def _merged_attention(qg, k_all, v_all, q_pos, k_pos, valid, cfg, base_kind, seq):
    """``_dense_attention`` over a cache whose slots are spread over the
    ranks of ``seq``: this rank's scores, masked and softcapped as there,
    its max m_i, sum of exponentials l_i and weighted v in f32, merged by
    the log-sum-exp rule — m = pmax(m_i), then psum(l_i·e^(m_i − m)) and
    psum(acc_i·e^(m_i − m)) — and divided once. A rank whose slots are all
    masked has m_i = -1e30, so its rescale is e^(-1e30 − m) = 0."""
    hd = qg.shape[-1]
    scores = torch.einsum("bsngh,btnh->bngst", qg.float(), k_all.float())
    scores = scores / float(np.float32(np.sqrt(hd)))
    if cfg.attn_softcap is not None:
        scores = cfg.attn_softcap * torch.tanh(scores / cfg.attn_softcap)
    mask = _attn_mask(q_pos, k_pos, base_kind, cfg.window, cfg.chunk) & valid[..., None, :]
    scores = scores.masked_fill(~mask[:, None, None, :, :], -1e30)
    m_i = scores.amax(-1, keepdim=True)
    p = torch.exp(scores - m_i)
    m = pmax(m_i, seq)
    rescale = torch.exp(m_i - m)
    l = psum(p.sum(-1, keepdim=True) * rescale, seq)
    acc = psum(torch.einsum("bngst,btnh->bngsh", p, v_all.float()) * rescale, seq)
    return (acc / l).permute(0, 3, 1, 2, 4).to(qg.dtype)  # [B, Sq, nkv, g, hd]


def _prefill_slots(S: int, S_c: int, base_kind: str, seq) -> tuple:
    """(token indices, slots of this rank's cache) a prefill of S tokens
    writes: the last S_c tokens at ``t % S_c`` in a ring buffer, token t at
    slot t in a global cache (only the slots that exist, as JAX drops a
    scatter's out-of-bounds updates), cut to the slots ``seq``'s rank
    holds, S_c being the whole cache's slots."""
    S_w = min(S, S_c)
    if base_kind in ("local", "chunked"):
        toks = np.arange(S - S_w, S)
        slots = toks % S_c
    else:
        toks = np.arange(S - S_w, min(S, S_c))
        slots = toks
    if seq is not None:
        S_loc = S_c // seq.size
        lo = seq.rank * S_loc
        keep = (slots >= lo) & (slots < lo + S_loc)
        toks, slots = toks[keep], slots[keep] - lo
    return toks, slots


def _block(S: int, target: int) -> int:
    """The largest divisor of S not above ``target``, as the reference takes
    it (a frontend's prefix makes S a non-power of two, 4096 + 256 for
    instance); where that is below half the target, as for a prompt of a
    prime length, the target itself, the last block short (the reference's
    divisor would be 1: S² blocks)."""
    b = next(b for b in range(min(target, S), 0, -1) if S % b == 0)
    return b if 2 * b >= min(target, S) else target


def _flash_attention(qg, k_all, v_all, q_pos, k_pos, cfg, base_kind):
    """Blockwise (FlashAttention-style) online-softmax attention, the
    reference's jnp scan as loops: q blocks outside, k blocks inside, the
    running max, sum and accumulator in f32, so the scores are
    [*, qb, kb] at a time. Every key is valid: the keys are the queries'
    own tokens (training, or a prefill that fills a cache)."""
    B, Sq, nkv, g, hd = qg.shape
    Sk = k_all.shape[1]
    qb, kb = _block(Sq, FLASH_QBLOCK), _block(Sk, FLASH_KBLOCK)
    scale = float(np.float32(1.0 / np.sqrt(hd)))  # the reference's weak-typed f32
    outs = []
    for i in range(0, Sq, qb):
        qi, qpi = qg[:, i:i + qb].float(), q_pos[:, i:i + qb]
        n = qi.shape[1]  # qb, or fewer in a short last block
        m = torch.full((B, nkv, g, n), -1e30, dtype=torch.float32, device=qg.device)
        l = torch.zeros((B, nkv, g, n), dtype=torch.float32, device=qg.device)
        acc = torch.zeros((B, nkv, g, n, hd), dtype=torch.float32, device=qg.device)
        for j in range(0, Sk, kb):
            s = torch.einsum("bsngh,btnh->bngst", qi, k_all[:, j:j + kb].float()) * scale
            if cfg.attn_softcap is not None:
                s = cfg.attn_softcap * torch.tanh(s / cfg.attn_softcap)
            mask = _attn_mask(qpi, k_pos[:, j:j + kb], base_kind, cfg.window, cfg.chunk)
            s = s.masked_fill(~mask[:, None, None, :, :], -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bngst,btnh->bngsh", p, v_all[:, j:j + kb].float())
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4).to(qg.dtype))  # [B, qb, nkv, g, hd]
    return torch.cat(outs, dim=1)


def attention_apply(
    params: dict,
    x: torch.Tensor,
    cfg,
    kind: str = "global",
    positions: Optional[torch.Tensor] = None,
    cache: Optional[dict] = None,
    tp=None,
    seq=None,
) -> tuple:
    """GQA attention. x: [B, S, D].

    Train and prefill: S tokens, attended among themselves; a given cache
    (assumed empty) is filled with the last S_c of them. Decode: S == 1
    against ``cache`` = {"k", "v": [B, S_c, nkv, hd], "pos": int32[B]}.
    ``tp``: the model group's World (this rank's heads); ``seq``: the
    group whose ranks hold the cache's slots (see the module docstring).
    Returns (y, new_cache), new_cache None without a cache."""
    B, S, D = x.shape
    hd = cfg.resolved_head_dim
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    base_kind = _base_kind(kind)
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :].expand(B, S)

    wk, wv = params["wk"].to(x.dtype), params["wv"].to(x.dtype)
    q_norm, k_norm = params.get("q_norm"), params.get("k_norm")
    kv_of_q = None  # replicated kv heads: the one each of this rank's q heads reads
    if tp is not None and tp.size > 1:
        m = tp.size
        x = copy_to_model(x, tp)
        h0, h1 = unit_share(nh, m, tp.rank)
        if nkv % m == 0:  # kv heads split, and so whole groups of q heads a rank
            nh, nkv = nh // m, nkv // m
        else:  # kv heads replicated: q head q reads kv head q·nkv/nh
            g = nh // nkv
            lo, hi = (h0 // g, -(-h1 // g)) if h1 > h0 else (0, 0)
            wk, wv = copy_to_model(wk, tp), copy_to_model(wv, tp)
            if cache is None:  # only the kv heads this rank's q heads read
                wk, wv = wk[:, lo * hd:hi * hd], wv[:, lo * hd:hi * hd]
                nkv = hi - lo
            else:  # the cache holds every kv head on every rank: all are written
                lo = 0
            kv_of_q = torch.arange(h0, h1, device=x.device) // g - lo
            nh = h1 - h0
        if cfg.qk_norm:
            q_norm, k_norm = copy_to_model(q_norm, tp), copy_to_model(k_norm, tp)

    q = (x @ params["wq"].to(x.dtype)).reshape(B, S, nh, hd)
    k = (x @ wk).reshape(B, S, nkv, hd)
    v = (x @ wv).reshape(B, S, nkv, hd)
    if cfg.qk_norm:
        q = rmsnorm_head(q_norm, q, cfg.norm_eps)
        k = rmsnorm_head(k_norm, k, cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is None or S > 1:
        k_all, v_all, k_pos, q_pos = k, v, positions, positions
        valid = None
        if cache is not None:
            S_c = cache["k"].shape[1] * (1 if seq is None else seq.size)
            toks, slots = _prefill_slots(S, S_c, base_kind, seq)
            if len(toks):
                toks = torch.from_numpy(toks).to(x.device)
                slots = torch.from_numpy(slots).to(x.device)
                cache["k"][:, slots] = k[:, toks].to(cache["k"].dtype)
                cache["v"][:, slots] = v[:, toks].to(cache["v"].dtype)
            new_cache = {"k": cache["k"], "v": cache["v"], "pos": cache["pos"] + S}
    else:
        S_loc = cache["k"].shape[1]
        S_c, lo = (S_loc, 0) if seq is None else (S_loc * seq.size, seq.rank * S_loc)
        pos = cache["pos"]  # int32[B]: the tokens already in the cache
        bidx = torch.arange(B, device=x.device)
        ar = torch.arange(lo, lo + S_loc, dtype=torch.int32, device=x.device)[None, :]
        if base_kind in ("local", "chunked"):
            # a ring buffer: windowed and chunked layers keep S_c slots only
            slot = (pos % S_c).long()
            abs_pos = pos[:, None] - torch.remainder(pos[:, None] - ar, S_c)
        else:
            slot = torch.clamp_max(pos, S_c - 1).long()
            abs_pos = ar.expand(B, S_loc)
        # in place where the cache already has the activations' dtype
        k_all = cache["k"] if cache["k"].dtype == x.dtype else cache["k"].to(x.dtype)
        v_all = cache["v"] if cache["v"].dtype == x.dtype else cache["v"].to(x.dtype)
        if seq is None:
            k_all[bidx, slot] = k[:, 0]
            v_all[bidx, slot] = v[:, 0]
        else:  # only the rank holding the slot writes it
            local = slot - lo
            owned = ((local >= 0) & (local < S_loc))[:, None, None]
            local = local.clamp(0, S_loc - 1)
            k_all[bidx, local] = torch.where(owned, k[:, 0], k_all[bidx, local])
            v_all[bidx, local] = torch.where(owned, v[:, 0], v_all[bidx, local])
        new_cache = {"k": k_all, "v": v_all, "pos": pos + 1}
        k_pos, q_pos = abs_pos, positions
        # a slot holds a token if 0 <= abs_pos <= pos (ring slots never
        # written carry negative absolute positions)
        valid = (abs_pos <= pos[:, None]) & (abs_pos >= 0)

    if kv_of_q is not None:  # a kv head a q head (a rank's q heads may read two)
        k_all, v_all = k_all.index_select(2, kv_of_q), v_all.index_select(2, kv_of_q)
        qg = q.reshape(B, S, nh, 1, hd)
    else:
        qg = q.reshape(B, S, nkv, nh // nkv, hd)
    if S > FLASH_THRESHOLD:  # the keys are the prompt's own, with a cache or without
        out = _flash_attention(qg, k_all, v_all, q_pos, k_pos, cfg, base_kind)
    elif seq is not None and S == 1:
        out = _merged_attention(qg, k_all, v_all, q_pos, k_pos, valid, cfg, base_kind, seq)
    else:
        out = _dense_attention(qg, k_all, v_all, q_pos, k_pos, valid, cfg, base_kind)
    y = out.reshape(B, S, nh * hd) @ params["wo"].to(x.dtype)
    return reduce_from_model(y, tp), new_cache


def attention_init_cache(cfg, kind: str, batch: int, seq_len: int,
                         dtype=torch.bfloat16, prefilled: bool = True,
                         device="cuda", model_shards: int = 1, seq_shards: int = 1) -> dict:
    """Decode cache of one attention layer: bf16 k and v by default, as the
    reference's; windowed and chunked layers keep only ``window`` or
    ``chunk`` slots (a ring buffer). ``model_shards`` m: a rank's nkv/m
    kv heads where m divides them (all of them, replicated, where it does
    not: the same on every rank); ``seq_shards`` n: this rank's S_c/n
    slots (n must divide S_c)."""
    base_kind = _base_kind(kind)
    S_c = seq_len
    if base_kind == "local":
        S_c = min(cfg.window, seq_len)
    elif base_kind == "chunked":
        S_c = min(cfg.chunk, seq_len)
    if S_c % seq_shards:
        raise ValueError(f"a {kind} cache of {S_c} slots does not split over {seq_shards} "
                         "sequence ranks")
    nkv = cfg.n_kv_heads
    nkv = nkv // model_shards if nkv % model_shards == 0 else nkv
    shape = (batch, S_c // seq_shards, nkv, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((batch,), seq_len if prefilled else 0, dtype=torch.int32,
                              device=device)}


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU)
# ---------------------------------------------------------------------------


def mlp_init(generator: torch.Generator, d: int, ff: int, device) -> dict:
    return {
        "wi": _dense_init(generator, (d, ff), device),
        "wg": _dense_init(generator, (d, ff), device),
        "wo": _dense_init(generator, (ff, d), device),
    }


def mlp_apply(params: dict, x: torch.Tensor, tp=None) -> torch.Tensor:
    """SwiGLU; with ``tp`` (the model group's World) wi/wg column-parallel
    over ff and wo row-parallel."""
    x = copy_to_model(x, tp)
    h = (x @ params["wi"].to(x.dtype)) * torch.nn.functional.silu(
        x @ params["wg"].to(x.dtype))
    return reduce_from_model(h @ params["wo"].to(x.dtype), tp)
