"""Recurrent token mixers: Mamba2 (SSD) and RWKV6 (Finch).

The counterpart of the JAX package's ``models/ssm.py``. Both are linear
recurrences. Train and prefill compute them in the reference's chunked
(matrix) form: a loop over chunks of ``CHUNK`` tokens that carries the
state, with einsums inside each chunk, so the score tensors stay [L, L]
per chunk; with a decode cache the loop starts from the cache's state
(and RWKV6's token shift from its ``prev``) and returns them. Decode is
the single-step recurrence on a cache. The reference runs these scans in jnp, not in
Pallas, so they stay plain PyTorch here. The dtypes follow the
reference's step by step: the scans run in f32, the projections in the
activations' dtype.

The sequence must be a whole number of chunks (or shorter than one), as
the reference asserts. As in the reference, ``rwkv6_init_cache``'s
``prev`` is bf16 whatever the model's dtype, and after a call it is in
the activations' dtype.

One place departs from the reference's code, not its function: the
intra-chunk decays exp(clog_t - clog_s) are masked in the exponent
(``_masked``), where the reference masks them after the exp. For the
masked pairs (s after t) the exponent is positive and grows with the
chunk's summed decay rates; past ~88 the reference's exp is inf in f32,
its ``where`` gives 0 forward, but the backward multiplies the zero
cotangent by that inf and the gradient is NaN. The port's forward is the
same words, and its gradient is the reference's wherever that is finite
(``tests/test_torch_ssm.py``).

Tensor parallelism (``tp``, the model group's ``World``; the reference's
'model' axis, Megatron's layout by head): both mixers take the replicated
input through ``copy_to_model`` and run the chunk scan on this rank's
heads only (its ``unit_share`` of the H heads: ⌈H/m⌉ or ⌊H/m⌋, which may
be none). Mamba2's packed ``in_proj`` is cut by head (z, x and dt
column-parallel; B and C replicated, through ``copy_to_model`` since each
rank reads them for its heads alone); its gated norm takes the sum of
squares over every rank's channels through ``all_reduce_model`` (each
rank then uses the total for its own channels, so its backward is a sum
too) and divides by the full ``inner``; ``out_proj`` is row-parallel. RWKV6's
five projections are column-parallel, its per-head group norm stays
local and ``wo`` is row-parallel. The replicated per-head and per-channel
vectors (A_log, D, dt_bias, norm_scale; w0, u, ln_scale, and RWKV6's
lerp coefficients ``mu``) go through ``copy_to_model`` and are then
sliced to the rank's heads, so each one's gradient is the same on every
rank of the group. Serving splits the same way: a rank's decode cache
holds the states of its heads (the reference's ``cache_pspecs``),
and RWKV6's ``prev`` (the replicated input's last token) and ``pos`` are
replicated over the group.

Simplifications against the source models are the reference's
(DESIGN.md §5): Mamba2 without the depthwise conv1d prefix and with one
B/C group; RWKV6 with a learned-constant token-shift lerp and the
data-dependent decay.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.dist.collectives import all_reduce_model, copy_to_model, reduce_from_model
from repro_torch.models.layers import _dense_init
from repro_torch.models.sharding import unit_share

CHUNK = 64  # the scan's chunk length (bounds the [L, L, H, hd] decay tensors)


def _masked(exponent: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """The exponent where ``keep``, -inf elsewhere: exp of it is the
    reference's ``where(keep, exp(exponent), 0)`` word for word, but the
    masked entries are exp(-inf) = 0 rather than a masked exp that may be
    inf, so the backward never forms 0 · inf."""
    return exponent.masked_fill(~keep, float("-inf"))


def _chunks(S: int) -> tuple:
    """(chunk length, chunk count) of a sequence of S tokens."""
    L = min(CHUNK, S)
    if S % L:
        raise ValueError(f"sequence length {S} is not a whole number of {L}-token chunks "
                         "(the reference asserts the same)")
    return L, S // L


# ---------------------------------------------------------------------------
# Mamba2 (SSD): S_t = a_t·S_{t-1} + dt_t·(B_t ⊗ x_t),  y_t = S_t·C_t + D·x_t
#   a_t = exp(dt_t * A_h)   (A_h < 0 per head; dt via softplus)
# ---------------------------------------------------------------------------


def mamba2_init(generator: torch.Generator, cfg, device) -> dict:
    d = cfg.d_model
    H = cfg.ssm_heads or (d // 64)
    hd, N = 64, cfg.ssm_state
    inner = H * hd
    f32 = dict(dtype=torch.float32, device=device)
    return {
        # fused input projection: [z (gate), x_inner, B, C, dt]
        "in_proj": _dense_init(generator, (d, 2 * inner + 2 * N + H), device),
        "out_proj": _dense_init(generator, (inner, d), device),
        "A_log": torch.zeros(H, **f32),  # A = -exp(A_log)
        "D": torch.ones(H, **f32),
        "dt_bias": torch.zeros(H, **f32),
        "norm_scale": torch.zeros(inner, **f32),
    }


def _mamba2_split(params: dict, x: torch.Tensor, cfg, tp=None):
    """(z, x_inner [B, S, H, 64], B f32, C f32, dt f32, decay a f32) of this
    rank's H heads (every head without ``tp``)."""
    d = cfg.d_model
    H = cfg.ssm_heads or (d // 64)
    hd, N = 64, cfg.ssm_state
    A_log, dt_bias = params["A_log"], params["dt_bias"]
    w = params["in_proj"].to(x.dtype)
    if tp is not None and tp.size > 1:
        # z, x and dt are this rank's heads; B and C are replicated and used
        # for these heads only, so their columns' gradient is summed over
        # the group, as are the per-head vectors' (sliced after the copy)
        h0, h1 = unit_share(H, tp.size, tp.rank)
        H = h1 - h0
        zx, bc, dt_w = torch.split(w, [2 * H * hd, 2 * N, H], dim=-1)
        w = torch.cat([zx, copy_to_model(bc, tp), dt_w], dim=-1)
        heads = slice(h0, h1)
        A_log, dt_bias = copy_to_model(A_log, tp)[heads], copy_to_model(dt_bias, tp)[heads]
    inner = H * hd
    proj = x @ w
    z, xi, Bm, Cm, dt = torch.split(proj, [inner, inner, N, N, H], dim=-1)
    B_, S_ = x.shape[0], x.shape[1]
    xi = xi.reshape(B_, S_, H, hd)
    dt = dt.float() + dt_bias
    dt = torch.logaddexp(dt, torch.zeros_like(dt))  # softplus, as jax.nn.softplus
    a = torch.exp(-torch.exp(A_log) * dt)  # decay in (0, 1)
    return z, xi, Bm.float(), Cm.float(), dt, a


def mamba2_apply(params: dict, x: torch.Tensor, cfg, cache: Optional[dict] = None, tp=None):
    """x: [B, S, d]; cache: {"state": f32[B, H, 64, N], "pos": int32[B]} or
    None. Returns (y, new_cache), new_cache None without a cache. ``tp``:
    the model group's World (this rank's heads; see the module
    docstring)."""
    B_, S_, d = x.shape
    H = cfg.ssm_heads or (d // 64)
    hd, N = 64, cfg.ssm_state
    inner = H * hd  # every rank's channels: the gated norm's divisor
    D, norm_scale = params["D"], params["norm_scale"]
    split = tp is not None and tp.size > 1
    if split:
        x = copy_to_model(x, tp)
        h0, h1 = unit_share(H, tp.size, tp.rank)
        H = h1 - h0
        D = copy_to_model(D, tp)[h0:h1]
        norm_scale = copy_to_model(norm_scale, tp)[h0 * hd:h1 * hd]
    z, xi, Bm, Cm, dt, a = _mamba2_split(params, x, cfg, tp)
    xif = xi.float()
    if cache is not None and S_ == 1:  # single-step decode
        st = cache["state"] * a[:, 0, :, None, None] + torch.einsum(
            "bh,bhp,bn->bhpn", dt[:, 0], xif[:, 0], Bm[:, 0])
        y = torch.einsum("bhpn,bn->bhp", st, Cm[:, 0])[:, None]  # [B,1,H,hd]
        new_cache = {"state": st, "pos": cache["pos"] + 1}
    else:
        L, nc = _chunks(S_)
        causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
        st = cache["state"] if cache is not None else torch.zeros(
            (B_, H, hd, N), dtype=torch.float32, device=x.device)
        ys = []
        for c in range(nc):
            sl = slice(c * L, (c + 1) * L)
            xc, Bc, Cc, dtc, ac = xif[:, sl], Bm[:, sl], Cm[:, sl], dt[:, sl], a[:, sl]
            clog = torch.cumsum(torch.log(torch.clamp_min(ac, 1e-20)), dim=1)  # [B,L,H]
            # carry-in: y_state[t] = exp(clog_t)·C_t·S_prev
            y_in = torch.einsum("blh,bhpn,bln->blhp", torch.exp(clog), st, Cc)
            # intra-chunk: M[t,s] = exp(clog_t - clog_s)·dt_s  (s <= t), the
            # mask applied to the exponent (see the module docstring)
            rel = torch.exp(_masked(clog[:, :, None, :] - clog[:, None, :, :],
                                    causal[None, :, :, None]))  # [B,L,L,H]
            M = rel * dtc[:, None, :, :]
            ctb = torch.einsum("bln,bsn->bls", Cc, Bc)  # [B,L,L]
            y_intra = torch.einsum("blsh,bls,bshp->blhp", M, ctb, xc)
            # state update
            decay_to_end = torch.exp(clog[:, -1:, :] - clog)  # [B,L,H]
            st = st * torch.exp(clog[:, -1])[:, :, None, None] + torch.einsum(
                "blh,blh,blhp,bln->bhpn", decay_to_end, dtc, xc, Bc)
            ys.append(y_in + y_intra)
        y = torch.cat(ys, dim=1)  # [B,S,H,hd]
        new_cache = None if cache is None else {"state": st, "pos": cache["pos"] + S_}
    y = y + D[None, None, :, None] * xif
    y = y.reshape(B_, S_, H * hd).to(x.dtype)
    # gated RMSNorm (mamba2's norm-before-out), over all the heads' channels
    yf = y.float() * F.silu(z.float())
    if split:
        var = all_reduce_model(torch.sum(torch.square(yf), dim=-1, keepdim=True), tp) / inner
    else:
        var = torch.mean(torch.square(yf), dim=-1, keepdim=True)
    yf = yf * torch.rsqrt(var + 1e-6) * (1.0 + norm_scale)
    out = yf.to(x.dtype) @ params["out_proj"].to(x.dtype)
    return reduce_from_model(out, tp), new_cache


def mamba2_init_cache(cfg, batch: int, device="cuda", model_shards: int = 1,
                      model_rank: int = 0) -> dict:
    """Mamba2's decode cache (model rank ``model_rank``'s share of the heads
    with ``model_shards``)."""
    h0, h1 = unit_share(cfg.ssm_heads or (cfg.d_model // 64), model_shards, model_rank)
    H = h1 - h0
    return {"state": torch.zeros((batch, H, 64, cfg.ssm_state), dtype=torch.float32,
                                 device=device),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


# ---------------------------------------------------------------------------
# RWKV6 (Finch): S_t = diag(w_t)·S_{t-1} + k_t ⊗ v_t
#   y_t = r_t · (diag(u)·k_t ⊗ v_t + S_{t-1}),  w_t data-dependent
# ---------------------------------------------------------------------------


def rwkv6_init(generator: torch.Generator, cfg, device) -> dict:
    d = cfg.d_model
    hd = cfg.rwkv_head_size
    H = d // hd
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "wr": _dense_init(generator, (d, d), device),
        "wk": _dense_init(generator, (d, d), device),
        "wv": _dense_init(generator, (d, d), device),
        "wg": _dense_init(generator, (d, d), device),
        "wo": _dense_init(generator, (d, d), device),
        # data-dependent decay: w = exp(-exp(w0 + x @ w_proj))
        "w0": torch.full((d,), -2.0, **f32),
        "w_proj": _dense_init(generator, (d, d), device, scale=0.01),
        "u": torch.zeros((H, hd), **f32),  # per-head bonus
        # token-shift lerp coefficients per projection
        "mu": torch.full((5, d), 0.5, **f32),
        "ln_scale": torch.zeros(d, **f32),
    }


def _rwkv_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Token shift: x_{t-1} per position (prev carries the last token)."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def rwkv6_apply(params: dict, x: torch.Tensor, cfg, cache: Optional[dict] = None, tp=None):
    """x: [B, S, d]; cache: {"state": f32[B, H, hd, hd], "prev": [B, d],
    "pos": int32[B]} or None. Returns (y, new_cache), new_cache None
    without a cache. ``tp``: the model group's World (this rank's heads;
    see the module docstring)."""
    B_, S_, d = x.shape
    hd = cfg.rwkv_head_size
    H = d // hd
    mu, w0, u, ln_scale = params["mu"], params["w0"], params["u"], params["ln_scale"]
    if tp is not None and tp.size > 1:
        # the lerp's inputs enter this rank's column-parallel products, so
        # x's and mu's gradients are summed over the group; the per-head
        # and per-channel vectors are sliced after the copy
        x, mu = copy_to_model(x, tp), copy_to_model(mu, tp)
        h0, h1 = unit_share(H, tp.size, tp.rank)
        H = h1 - h0
        ch = slice(h0 * hd, h1 * hd)
        w0, ln_scale = copy_to_model(w0, tp)[ch], copy_to_model(ln_scale, tp)[ch]
        u = copy_to_model(u, tp)[h0:h1]
    dl = H * hd  # this rank's channels
    prev = cache["prev"].to(x.dtype) if cache is not None else x.new_zeros((B_, d))
    xs = _rwkv_shift(x, prev)
    mu = mu.to(x.dtype)
    xr, xk, xv, xw, xg = (x + mu[i] * (xs - x) for i in range(5))

    r = (xr @ params["wr"].to(x.dtype)).reshape(B_, S_, H, hd)
    k = (xk @ params["wk"].to(x.dtype)).reshape(B_, S_, H, hd)
    v = (xv @ params["wv"].to(x.dtype)).reshape(B_, S_, H, hd)
    g = xg @ params["wg"].to(x.dtype)
    # data-dependent decay (the Finch contribution, arXiv:2404.05892)
    logw = -torch.exp(w0 + (xw @ params["w_proj"].to(x.dtype)).float())
    logw = logw.reshape(B_, S_, H, hd)  # (-inf, 0)
    rf, kf, vf = r.float(), k.float(), v.float()
    u = u.float()  # the reference's einsum promotes a bf16 u to f32

    if cache is not None and S_ == 1:  # decode
        st = cache["state"]  # [B,H,hd(key),hd(value)]
        kv = torch.einsum("bhc,bhw->bhcw", kf[:, 0], vf[:, 0])
        y = torch.einsum("bhc,bhcw->bhw", rf[:, 0], st + u[None, :, :, None] * kv)
        st = torch.exp(logw[:, 0])[..., None] * st + kv
        y = y[:, None]  # [B,1,H,hd]
        new_cache = {"state": st, "prev": x[:, -1, :], "pos": cache["pos"] + 1}
    else:
        L, nc = _chunks(S_)
        strict = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device), diagonal=-1)
        st = cache["state"] if cache is not None else torch.zeros(
            (B_, H, hd, hd), dtype=torch.float32, device=x.device)
        ys = []
        for c in range(nc):
            sl = slice(c * L, (c + 1) * L)
            rc, kc, vc, lwc = rf[:, sl], kf[:, sl], vf[:, sl], logw[:, sl]
            clog = torch.cumsum(lwc, dim=1)  # [B,L,H,hd] inclusive
            # carry-in uses the state before this step: decay exp(clog_{t-1})
            clog_prev = clog - lwc  # exclusive cumsum
            y_in = torch.einsum("blhc,bhcw->blhw", rc * torch.exp(clog_prev), st)
            # intra: s < t strictly; decay exp(clog_{t-1} - clog_s)
            Dm = torch.exp(_masked(clog_prev[:, :, None] - clog[:, None, :],
                                   strict[None, :, :, None, None]))  # [B,L,L,H,hd]
            att = torch.einsum("blhc,blshc,bshc->blsh", rc, Dm, kc)
            y_intra = torch.einsum("blsh,bshw->blhw", att, vc)
            # bonus (current token)
            y_bonus = torch.einsum("blhc,hc,blhc,blhw->blhw", rc, u, kc, vc)
            # state update: S_new = diag(exp(clog_L)) S + Σ_s exp(clog_L - clog_s) k_s ⊗ v_s
            dte = torch.exp(clog[:, -1:] - clog)  # [B,L,H,hd]
            st = torch.exp(clog[:, -1])[..., None] * st + torch.einsum(
                "blhc,blhc,blhw->bhcw", dte, kc, vc)
            ys.append(y_in + y_intra + y_bonus)
        y = torch.cat(ys, dim=1)  # [B,S,H,hd]
        new_cache = None if cache is None else {
            "state": st, "prev": x[:, -1, :], "pos": cache["pos"] + S_}

    # per-head groupnorm (within a head: no collective), then the output gate
    var = torch.mean(torch.square(y), dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + 1e-6)
    y = y.reshape(B_, S_, dl) * (1.0 + ln_scale)
    y = y.to(x.dtype) * F.silu(g)
    return reduce_from_model(y @ params["wo"].to(x.dtype), tp), new_cache


def rwkv6_init_cache(cfg, batch: int, d: int, device="cuda", model_shards: int = 1,
                     model_rank: int = 0) -> dict:
    """RWKV6's decode cache; ``prev`` is bf16 whatever the model's dtype,
    as the reference's (model rank ``model_rank``'s share of the heads'
    states with ``model_shards``; ``prev`` whole)."""
    hd = cfg.rwkv_head_size
    h0, h1 = unit_share(d // hd, model_shards, model_rank)
    H = h1 - h0
    return {"state": torch.zeros((batch, H, hd, hd), dtype=torch.float32, device=device),
            "prev": torch.zeros((batch, d), dtype=torch.bfloat16, device=device),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
