"""Composable decoder: block dispatch and the stacked-unit model.

The counterpart of the JAX package's ``models/transformer.py`` for the
attention kinds ``global``, ``local`` and ``chunked``. Depth is
``cfg.pattern`` repeated ``cfg.n_units`` times, and the parameters are
stacked per pattern position, ``[n_units, ...]``, as the reference stores
them, so the flat layout (``train/flatten.py``) and the weight conversion
(``convert.model_params``) are leaf for leaf. The forward pass loops over
the units and takes unit u's slice of each stacked leaf.

As in the reference's ``Model.init``, a bf16 model stores every leaf with
two or more dims in bf16 — the stacked norm scales ``[n_units, d]``
included — and only ``final_norm`` stays f32.

MoE, Mamba2, RWKV6 and the shared attention block are not ported yet
(ROADMAP Queue 1 item 6) and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (attention_apply, attention_init, mlp_apply,
                                       mlp_init, rmsnorm, rmsnorm_init)
from repro_torch.train.flatten import tree_map

PORTED_KINDS = ("global", "local", "chunked")


def _check_kinds(cfg: ModelConfig) -> None:
    for kind in cfg.pattern:
        if kind not in PORTED_KINDS:
            raise NotImplementedError(
                f"{cfg.arch_id}: block kind {kind!r} is not ported yet (MoE, Mamba2, "
                "RWKV6 and shared attention: ROADMAP Queue 1 item 6)")


def block_init(generator: torch.Generator, cfg: ModelConfig, device) -> dict:
    return {"ln1": rmsnorm_init(cfg.d_model, device),
            "ln2": rmsnorm_init(cfg.d_model, device),
            "attn": attention_init(generator, cfg, device),
            "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff, device)}


def block_apply(params: dict, x: torch.Tensor, cfg: ModelConfig, kind: str,
                positions: torch.Tensor) -> torch.Tensor:
    """Pre-norm residual block (attention kinds, dense MLP)."""
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    mix, _ = attention_apply(params["attn"], h, cfg, kind, positions)
    x = x + mix
    h = rmsnorm(params["ln2"], x, cfg.norm_eps)
    return x + mlp_apply(params["mlp"], h)


def _stack(trees: list) -> dict:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _as_params(tree):
    if isinstance(tree, dict):
        return nn.ParameterDict({k: _as_params(v) for k, v in tree.items()})
    return nn.Parameter(tree)


class Model(nn.Module):
    """Decoder whose parameters are the reference's tree.

    ``tree()`` returns the parameters as the reference's nested dict
    ({"blocks": [per pattern position], "embed", "final_norm"[, "lm_head"]});
    ``apply(params, tokens)`` runs the forward pass on any such tree (a
    learner's copy, for instance), and ``forward(tokens)`` on the model's
    own. Parameters are initialised on ``device`` (the card by default;
    ``"meta"`` gives the shapes alone) from ``generator`` (a fresh one
    seeded 0 if None); bit-equality with ``jax.random`` is not a goal —
    ``convert.model_params`` carries the reference's weights across.
    """

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_kinds(cfg)
        self.cfg = cfg
        device = torch.device(device)
        if generator is None and device.type != "meta":  # meta: shapes only
            generator = torch.Generator(device=device).manual_seed(0)
        embed_shape = ((cfg.num_codebooks, cfg.vocab, cfg.d_model)
                       if cfg.num_codebooks > 1 else (cfg.vocab, cfg.d_model))
        tree = {"embed": torch.randn(embed_shape, generator=generator, device=device) * 0.02,
                "final_norm": rmsnorm_init(cfg.d_model, device)}
        if not cfg.tie_embeddings:
            tree["lm_head"] = torch.randn(embed_shape, generator=generator,
                                          device=device) * 0.02
        blocks = [_stack([block_init(generator, cfg, device) for _ in range(cfg.n_units)])
                  for _ in cfg.pattern]
        # weight matrices (and the stacked norms) in the compute dtype, as
        # the reference casts every leaf with ndim >= 2
        if cfg.dtype == "bfloat16":
            cast = lambda t: t.to(torch.bfloat16) if t.dim() >= 2 else t  # noqa: E731
            tree = tree_map(cast, tree)
            blocks = [tree_map(cast, b) for b in blocks]
        self.embed = nn.Parameter(tree["embed"])
        self.final_norm = _as_params(tree["final_norm"])
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(tree["lm_head"])
        self.blocks = nn.ModuleList([_as_params(b) for b in blocks])

    def tree(self) -> dict:
        """The parameters as the reference's nested dict (the same tensors)."""
        def plain(pd):
            return {k: plain(v) if isinstance(v, nn.ParameterDict) else v
                    for k, v in pd.items()}
        out = {"blocks": [plain(b) for b in self.blocks], "embed": self.embed,
               "final_norm": plain(self.final_norm)}
        if not self.cfg.tie_embeddings:
            out["lm_head"] = self.lm_head
        return out

    def forward(self, tokens: torch.Tensor, prefix_embeds: Optional[torch.Tensor] = None):
        return self.apply(self.tree(), tokens, prefix_embeds)

    def apply(self, params: dict, tokens: torch.Tensor,
              prefix_embeds: Optional[torch.Tensor] = None):
        """tokens: int[B, S] (or [B, S, nc] multi-codebook); prefix_embeds:
        optional f32[B, P, d]. Returns (logits f32, aux) with aux = 0."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
        B, S, _ = x.shape
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :].expand(B, S)
        # one unbind per stacked leaf: its backward writes each unit's
        # gradient into one stacked tensor
        units = [_unbind(b, cfg.n_units) for b in params["blocks"]]
        for u in range(cfg.n_units):
            for pos, kind in enumerate(cfg.pattern):
                bp = units[pos][u]
                if cfg.remat:
                    x = checkpoint(_block_fn(cfg, kind), x, positions, bp,
                                   use_reentrant=False)
                else:
                    x = block_apply(bp, x, cfg, kind, positions)
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = self._logits(params, x)
        return logits, torch.zeros((), dtype=torch.float32, device=x.device)

    def _embed(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        emb = params["embed"].to(torch.bfloat16 if cfg.dtype == "bfloat16"
                                 else torch.float32)
        tokens = tokens.long()
        if cfg.num_codebooks > 1:
            # musicgen: sum the per-codebook embeddings
            x = torch.zeros(tokens.shape[:2] + (cfg.d_model,), dtype=emb.dtype,
                            device=emb.device)
            for c in range(cfg.num_codebooks):
                x = x + emb[c][tokens[..., c]]
        else:
            x = emb[tokens]
        # sqrt(d_model) computed in the activations' dtype, as the reference
        # does, on the host (a value made on the card would stall the host)
        return x * float(torch.tensor(float(cfg.d_model), dtype=x.dtype) ** 0.5)

    def _logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
        head = head.to(x.dtype)
        if cfg.num_codebooks > 1:
            logits = torch.einsum("bsd,cvd->bscv", x, head)
        else:
            logits = torch.einsum("bsd,vd->bsv", x, head)
        logits = logits.float()
        if cfg.logit_softcap is not None:
            logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
        return logits


def _unbind(tree, n: int) -> list:
    """The n units' parameter trees of one stacked tree (views)."""
    if isinstance(tree, dict):
        per_key = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: v[u] for k, v in per_key.items()} for u in range(n)]
    if tree.shape[0] != n:
        raise ValueError(f"stacked leaf: expected {n} units, got shape {tuple(tree.shape)}")
    return list(tree.unbind(0))


def _block_fn(cfg: ModelConfig, kind: str):
    def fn(x, positions, bp):
        return block_apply(bp, x, cfg, kind, positions)
    return fn
