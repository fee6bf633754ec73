"""Composable decoder: block dispatch and the stacked-unit model.

The counterpart of the JAX package's ``models/transformer.py`` for every
block kind, on the train, prefill and decode paths: the attention kinds ``global``,
``local`` and ``chunked``; ``moe``, ``local_moe`` and ``chunked_moe``
(attention plus the MoE MLP, ``models/moe.py``); the recurrent ``mamba2``
and ``rwkv6`` (``models/ssm.py``), with an MLP only when
``cfg.recurrent_mlp``; and ``shared_attn``, zamba2's attention block with
one set of weights shared by every unit. Depth is ``cfg.pattern``
repeated ``cfg.n_units`` times, and the parameters are stacked per
pattern position, ``[n_units, ...]``, as the reference stores them, so
the flat layout (``train/flatten.py``) and the weight conversion
(``convert.model_params``) are leaf for leaf. A ``shared_attn`` position
holds the reference's placeholder ``{"_shared": f32[n_units]}`` in
``blocks`` and the shared, unstacked block sits in ``shared_attn``. The
forward pass loops over the units and takes unit u's slice of each
stacked leaf, and sums the blocks' MoE aux losses.

As in the reference's ``Model.init``, a bf16 model stores every leaf with
two or more dims in bf16 — the stacked norm scales ``[n_units, d]`` and
the stacked SSM vectors included — and only the unstacked vectors
(``final_norm``, the shared block's norms, the placeholder) stay f32.

The placeholder takes no part in the forward pass, so its gradient is
zero; ``param_grads`` gives such leaves a zero gradient where autograd
gives none.

Serving: ``init_cache`` stacks each block's decode cache per pattern
position, ``[n_units, ...]`` a leaf, as the reference does (a
``shared_attn`` position has one cache a unit, and decodes as a global
layer: its kind names no window); ``prefill`` fills a cache from a prompt
and ``decode_step`` takes one token a row. Both return the last
position's logits only. Decode positions are pattern position 0's, unit
0's ``pos``, as the reference takes them.
"""
from __future__ import annotations

import weakref
from typing import Callable, Optional

import torch
from torch import nn
from torch.autograd.graph import saved_tensors_hooks
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (attention_apply, attention_init,
                                       attention_init_cache, mlp_apply, mlp_init, rmsnorm,
                                       rmsnorm_init)
from repro_torch.models.moe import EP_PREFILL_EXPERTS, moe_apply, moe_init
from repro_torch.models.ssm import (mamba2_apply, mamba2_init, mamba2_init_cache, rwkv6_apply,
                                    rwkv6_init, rwkv6_init_cache)
from repro_torch.dist.collectives import (all_gather, copy_to_model, gather_from_model,
                                          reduce_from_model)
from repro_torch.models.sharding import unit_share
from repro_torch.train.flatten import (leaves_with_paths, shard_layout, tree_map,
                                       tree_map_with_path)
from repro_torch.train.loss import next_token_loss, vocab_parallel_loss


def block_init(generator: torch.Generator, cfg: ModelConfig, kind: str, device,
               expert_rows: Optional[range] = None) -> dict:
    p = {"ln1": rmsnorm_init(cfg.d_model, device),
         "ln2": rmsnorm_init(cfg.d_model, device)}
    if kind == "mamba2":
        p["mamba"] = mamba2_init(generator, cfg, device)
    elif kind == "rwkv6":
        p["rwkv"] = rwkv6_init(generator, cfg, device)
    else:  # the attention kinds, shared_attn and *_moe included
        p["attn"] = attention_init(generator, cfg, device)
    if "moe" in kind and cfg.moe is not None:
        p["moe"] = moe_init(generator, cfg.d_model, cfg.moe, device, expert_rows)
    elif kind not in ("mamba2", "rwkv6") or cfg.recurrent_mlp:
        p["mlp"] = mlp_init(generator, cfg.d_model, cfg.d_ff, device)
    return p  # zamba2's recurrent blocks have no channel-mix MLP


def block_apply(params: dict, x: torch.Tensor, cfg: ModelConfig, kind: str,
                positions: torch.Tensor, cache: Optional[dict] = None,
                ep_world=None, tp_world=None, seq_world=None, route=None) -> tuple:
    """Pre-norm residual block. Returns (x, new_cache, aux loss): new_cache
    None without a cache, aux None for a block without MoE (the reference
    adds a zero). ``ep_world``: the learners' World of expert parallelism
    across ranks (``models/moe.py``); ``tp_world``: the model group's
    World of tensor parallelism (``models/layers.py``, ``models/ssm.py``,
    ``models/moe.py``); ``seq_world``: the group over whose ranks the
    attention caches' slots lie (``models/layers.py``); ``route``: the
    Worlds over whose rows the MoE routes the global batch (serving)."""
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    if kind == "mamba2":
        mix, new_cache = mamba2_apply(params["mamba"], h, cfg, cache, tp=tp_world)
    elif kind == "rwkv6":
        mix, new_cache = rwkv6_apply(params["rwkv"], h, cfg, cache, tp=tp_world)
    else:
        mix, new_cache = attention_apply(params["attn"], h, cfg, kind, positions, cache,
                                         tp=tp_world, seq=seq_world)
    x = x + mix
    if "moe" in params:
        h = rmsnorm(params["ln2"], x, cfg.norm_eps)
        ff, aux = moe_apply(params["moe"], h, cfg.moe, ep_axis=cfg.ep_axis,
                            ep_ranks=cfg.ep_ranks, ep_world=ep_world, tp=tp_world,
                            route=route)
        return x + ff, new_cache, aux
    if "mlp" in params:
        h = rmsnorm(params["ln2"], x, cfg.norm_eps)
        return x + mlp_apply(params["mlp"], h, tp=tp_world), new_cache, None
    return x, new_cache, None  # a recurrent block without channel-mix (zamba2): x + 0


def block_init_cache(cfg: ModelConfig, kind: str, batch: int, seq_len: int,
                     prefilled: bool = True, device="cuda", model_shards: int = 1,
                     seq_shards: int = 1, model_rank: int = 0) -> dict:
    """One block's decode cache; a recurrent block's ``pos`` is ``seq_len``
    when ``prefilled``, as an attention block's. ``model_shards``,
    ``model_rank`` and ``seq_shards``: one rank's part
    (``attention_init_cache``; a recurrent block's heads are the rank's
    ``unit_share``)."""
    if kind in ("mamba2", "rwkv6"):
        c = (mamba2_init_cache(cfg, batch, device=device, model_shards=model_shards,
                               model_rank=model_rank)
             if kind == "mamba2" else
             rwkv6_init_cache(cfg, batch, cfg.d_model, device=device, model_shards=model_shards,
                              model_rank=model_rank))
        if prefilled:
            c["pos"].fill_(seq_len)
        return c
    # no dtype: the attention cache is bf16 whatever the model's, as the reference's
    return attention_init_cache(cfg, kind, batch, seq_len, prefilled=prefilled, device=device,
                                model_shards=model_shards, seq_shards=seq_shards)


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
    ({"blocks": [per pattern position], "embed", "final_norm"[, "lm_head"]
    [, "shared_attn"]});
    ``apply(params, tokens)`` runs the forward pass on any such tree (a
    learner's copy, for instance), and ``forward(tokens)`` on the model's
    own. Parameters are initialised on ``device`` (the card by default;
    ``"meta"`` gives the shapes alone) from ``generator`` (a fresh one
    seeded 0 if None); bit-equality with ``jax.random`` is not a goal —
    ``convert.model_params`` carries the reference's weights across.

    ``ep_world``: with ``cfg.ep_axis`` set, the learners' ``World`` of
    expert parallelism across ranks. The model then holds rank r's E/n
    experts, ``[n_units, E/n, ...]`` a leaf (the reference's ``_localize``
    template), equal to rows [r·E/n, (r+1)·E/n) of the model built without
    it from the same generator (``models/moe.py::expert_init`` draws the
    experts one at a time and keeps the rank's), and its MoE blocks
    exchange tokens over the World.

    ``tp_world``: the model group's ``World`` of tensor parallelism (rank j
    of m; the reference's 'model' axis). The model then holds model rank
    j's shards of every leaf (``models/sharding.py::shard_leaf``): each
    full leaf is drawn from the generator in the one-card order, a unit at
    a time, and only its cut kept, so the shards are cuts of the model
    built without it from the same generator. ``tp_dims`` lists each
    leaf's ``Split`` in the flat order (None: replicated). The embedding
    is vocab-parallel (ids outside the shard read zeros, then
    ``reduce_from_model``: one non-zero among zeros, so the embeddings are
    the one-card ones word for word) and the logits column-parallel over
    the vocabulary (words ``vocab_span``, whole words a rank,
    ``models/sharding.py::unit_share``): ``loss`` takes the
    vocabulary-parallel loss on this rank's shard of them, as the
    reference's GSPMD keeps 1/m of the logits a device, and ``apply``,
    ``prefill`` and ``decode_step`` gather them. Every block kind splits by
    whole units, unevenly where m does not divide them (the first ranks
    hold one head or column more; a rank may hold none); zamba2's shared
    block is cut as the dense blocks are and its ``_shared`` placeholder
    stays replicated. With both ``ep_world`` (the
    learners' ring of the grid) and ``tp_world`` a rank holds [E/n, d,
    f/m] of each expert matrix. With ``cfg.remat`` each block is
    checkpointed with its input saved as this rank's share of the token
    rows (``sliced_checkpoint``), where one process keeps the whole input
    (``torch.utils.checkpoint``).

    Serving across ranks: ``init_cache``, ``prefill`` and ``decode_step``
    run on the rank's shards with its part of the reference's cache
    placement (``serve/engine.py::cache_pspecs``): the batch rows the
    caller gives it (the reference's ('pod', 'data') rows), this rank's
    kv heads and recurrent heads over the model group, and with
    ``seq_world`` (long_500k's layout) this rank's slots of every
    attention cache (``models/layers.py``). A MoE's experts lie over
    ``ep_world`` as in training. Each rank routes its own rows where the
    reference's serving takes expert parallelism (the prefill of a MoE of
    ``moe.EP_PREFILL_EXPERTS`` experts or more); elsewhere (decode, and
    the other MoEs' prefill) the routing is the reference's over the global
    batch, the rows of every rank of ``ep_world`` (and, with ``pod_world``,
    of every pod) in rank order (``models/moe.py``).
    """

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None, ep_world=None, tp_world=None,
                 pod_world=None):
        super().__init__()
        self.cfg = cfg
        self.tp_world = tp_world if tp_world is not None and tp_world.size > 1 else None
        self.tp_dims = None
        self.vocab_span = (0, cfg.vocab)
        shard = (lambda path, t: t)  # noqa: E731
        if self.tp_world is not None:
            from repro_torch.models.sharding import check_tp, shard_leaf, tree_dims, unit_share
            m, j = self.tp_world.size, self.tp_world.rank
            check_tp(cfg, m)
            self.tp_dims = tree_dims(Model(cfg, device="meta").tree(), cfg, m)
            self.vocab_span = unit_share(cfg.vocab, m, j)

            def shard(path, t):
                return shard_leaf(path, t, cfg, j, m)
        rows = None
        if ep_world is not None and ep_world.size > 1 and cfg.moe is not None:
            if cfg.ep_axis is None:
                raise ValueError(f"{cfg.arch_id}: ep_world given but cfg.ep_axis is None")
            if cfg.ep_ranks != ep_world.size:
                raise ValueError(f"{cfg.arch_id}: ep_ranks={cfg.ep_ranks} but the expert World "
                                 f"has {ep_world.size} ranks")
            rows = cfg.expert_rows(ep_world.rank, ep_world.size)
        self.ep_world = ep_world if rows is not None else None
        self.pod_world = (pod_world if self.ep_world is not None and pod_world is not None
                          and pod_world.size > 1 else None)
        device = torch.device(device)
        if generator is None and device.type != "meta":  # meta: shapes only
            generator = torch.Generator(device=device).manual_seed(0)
        embed_shape = ((cfg.num_codebooks, cfg.vocab, cfg.d_model)
                       if cfg.num_codebooks > 1 else (cfg.vocab, cfg.d_model))
        tree = {"embed": shard("embed", torch.randn(embed_shape, generator=generator,
                                                    device=device) * 0.02),
                "final_norm": rmsnorm_init(cfg.d_model, device)}
        if not cfg.tie_embeddings:
            tree["lm_head"] = shard("lm_head", torch.randn(embed_shape, generator=generator,
                                                           device=device) * 0.02)
        blocks, shared = [], None
        for kind in cfg.pattern:
            if kind == "shared_attn":
                if shared is None:  # cut as the dense blocks are
                    shared = tree_map_with_path(shard, block_init(generator, cfg, kind, device),
                                                "shared_attn/")
                # the reference's placeholder keeps the stacked structure uniform
                blocks.append({"_shared": torch.zeros(cfg.n_units, dtype=torch.float32,
                                                      device=device)})
                continue
            # a unit at a time, each full leaf cut to this rank's shard
            blocks.append(_stack([tree_map_with_path(shard, block_init(generator, cfg, kind,
                                                                        device, rows))
                                  for _ in range(cfg.n_units)]))
        if shared is not None:
            tree["shared_attn"] = shared
        # weight matrices (and the stacked vectors) in the compute dtype, as
        # the reference casts every leaf with ndim >= 2
        if cfg.dtype == "bfloat16":
            cast = lambda t: t.to(torch.bfloat16) if t.dim() >= 2 else t  # noqa: E731
            tree = tree_map(cast, tree)
            blocks = [tree_map(cast, b) for b in blocks]
        self.embed = nn.Parameter(tree["embed"])
        self.final_norm = _as_params(tree["final_norm"])
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(tree["lm_head"])
        if shared is not None:
            self.shared_attn = _as_params(tree["shared_attn"])
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
        if "shared_attn" in self.cfg.pattern:
            out["shared_attn"] = plain(self.shared_attn)
        return out

    def shard_layout(self, keep: Optional[Callable[[str], bool]] = None) -> list:
        """Where each leaf of this rank's tree sits in the full tree's flat
        vector (``train/flatten.py::shard_layout``), or, with ``keep``, in
        the flat vector of the leaves whose paths it keeps (the SAFE
        partition); with ``tp_world`` only."""
        kept = [(x, sp) for (path, x), sp in zip(leaves_with_paths(self.tree()), self.tp_dims)
                if keep is None or keep(path)]
        return shard_layout([x for x, _ in kept], [sp for _, sp in kept], self.tp_world.rank,
                            self.tp_world.size)

    def forward(self, tokens: torch.Tensor, prefix_embeds: Optional[torch.Tensor] = None):
        return self.apply(self.tree(), tokens, prefix_embeds)

    def apply(self, params: dict, tokens: torch.Tensor,
              prefix_embeds: Optional[torch.Tensor] = None):
        """tokens: int[B, S] (or [B, S, nc] multi-codebook); prefix_embeds:
        optional f32[B, P, d]. Returns (logits f32, aux), aux the f32 sum of
        the MoE blocks' aux losses (0 without MoE)."""
        x, aux = self._hidden(params, tokens, prefix_embeds)
        return self._logits(params, x), aux

    def loss(self, params: dict, tokens: torch.Tensor,
             prefix_embeds: Optional[torch.Tensor] = None):
        """(the mean next-token loss, aux) of ``apply``'s forward pass: with
        ``tp_world``, ``train/loss.py::vocab_parallel_loss`` of this rank's
        f32 vocabulary shard of the logits, which no rank gathers; without
        it, ``next_token_loss`` of the logits."""
        x, aux = self._hidden(params, tokens, prefix_embeds)
        if self.tp_world is None:
            return next_token_loss(self._logits(params, x), tokens, self.cfg.prefix_embeds), aux
        return vocab_parallel_loss(self._logits(params, x, shard=True), tokens,
                                   self.vocab_span[0], self.tp_world,
                                   self.cfg.prefix_embeds), aux

    def _hidden(self, params: dict, tokens: torch.Tensor,
                prefix_embeds: Optional[torch.Tensor] = None):
        """The forward pass up to the head: (the final norm's output, aux)."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
        B, S, _ = x.shape
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :].expand(B, S)
        # one unbind per stacked leaf: its backward writes each unit's
        # gradient into one stacked tensor
        units = [None if kind == "shared_attn" else _unbind(b, cfg.n_units)
                 for kind, b in zip(cfg.pattern, params["blocks"])]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for u in range(cfg.n_units):
            for pos, kind in enumerate(cfg.pattern):
                bp = params["shared_attn"] if kind == "shared_attn" else units[pos][u]
                if cfg.remat and self.tp_world is not None:
                    x, a = sliced_checkpoint(_block_fn(cfg, kind, self.ep_world, self.tp_world),
                                             x, positions, bp, self.tp_world)
                elif cfg.remat:
                    x, a = checkpoint(_block_fn(cfg, kind, self.ep_world, self.tp_world), x,
                                      positions, bp, use_reentrant=False)
                else:
                    x, _, a = block_apply(bp, x, cfg, kind, positions, ep_world=self.ep_world,
                                          tp_world=self.tp_world)
                if a is not None:
                    aux = aux + a
        return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux

    # -- serving -------------------------------------------------------------
    def init_cache(self, batch: int, seq_len: int, prefilled: bool = True,
                   device=None, seq_world=None) -> list:
        """Stacked decode caches, one dict a pattern position, each leaf
        [n_units, ...] (its own memory: the attention writes are in place).
        On the model's device unless ``device`` says otherwise. With
        ``tp_world``, this rank's heads; with ``seq_world``, this rank's
        slots of every attention cache."""
        cfg = self.cfg
        device = self.embed.device if device is None else device
        m, j = (1, 0) if self.tp_world is None else (self.tp_world.size, self.tp_world.rank)
        n = 1 if seq_world is None else seq_world.size
        return [{k: v[None].repeat((cfg.n_units,) + (1,) * v.dim()) for k, v in
                 block_init_cache(cfg, kind, batch, seq_len, prefilled, device, m, n,
                                  j).items()}
                for kind in cfg.pattern]

    def prefill(self, params: dict, tokens: torch.Tensor,
                prefix_embeds: Optional[torch.Tensor] = None,
                cache: Optional[list] = None, seq_world=None) -> tuple:
        """Run the prompt through the model and fill the decode caches (a
        fresh cache of the prompt's length if None). tokens: int[B, S] (or
        [B, S, nc]). ``seq_world``: the cache holds this rank's slots.
        Returns (the last position's logits [B, vocab] (or [B, nc,
        vocab]), cache)."""
        x = self._embed(params, _clamp_vocab(tokens, self.cfg))
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
        B, S, _ = x.shape
        if cache is None:
            cache = self.init_cache(B, S, prefilled=False, device=x.device, seq_world=seq_world)
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :].expand(B, S)
        rank_local = (self.cfg.moe is not None
                      and self.cfg.moe.num_experts >= EP_PREFILL_EXPERTS)
        return self._run_with_cache(params, x, cache, positions, seq_world,
                                    None if rank_local else self._route())

    def decode_step(self, params: dict, tokens: torch.Tensor, cache: list,
                    seq_world=None) -> tuple:
        """One token a row: tokens int[B] (or [B, nc]). Returns (logits
        [B, vocab] (or [B, nc, vocab]), new cache). ``seq_world``: the
        attention caches hold this rank's slots (long_500k's layout).

        ``cache`` is donated, as the reference's decode dry run donates it
        (``jax.jit(decode_step, donate_argnums=(2,))``): k and v are written
        into the caller's tensors where the dtypes agree (the bf16 path), so
        the returned cache shares their storage and the caller keeps only
        the returned one."""
        tok = tokens[:, None] if tokens.dim() == 1 else tokens[:, None, :]
        x = self._embed(params, _clamp_vocab(tok, self.cfg))  # [B, 1, d]
        positions = cache[0]["pos"][0][:, None].to(torch.int32)  # unit 0's; all agree
        return self._run_with_cache(params, x, cache, positions, seq_world, self._route())

    def _route(self) -> Optional[tuple]:
        """The Worlds over whose rows serving's MoE routes the global
        batch (``models/moe.py``): (``ep_world``, ``pod_world``), or None
        on one process."""
        return None if self.ep_world is None else (self.ep_world, self.pod_world)

    def _run_with_cache(self, params: dict, x: torch.Tensor, cache: list,
                        positions: torch.Tensor, seq_world=None, route=None) -> tuple:
        """The units in turn, each on its slice of every stacked cache leaf;
        a leaf written in place comes back as the same stacked tensor, any
        other is restacked. ``cache`` is donated (see ``decode_step``): a
        leaf written in place is the caller's tensor, changed. ``route``:
        the MoE routes the global batch over these Worlds' rows (None: each
        rank its own). Returns (last position's logits, new cache)."""
        cfg = self.cfg
        if seq_world is not None and seq_world.size == 1:
            seq_world = None
        units = [None if kind == "shared_attn" else _unbind(b, cfg.n_units)
                 for kind, b in zip(cfg.pattern, params["blocks"])]
        slices = [{k: [v[u] for u in range(cfg.n_units)] for k, v in c.items()}
                  for c in cache]
        new = [{k: [] for k in c} for c in cache]
        for u in range(cfg.n_units):
            for pos, kind in enumerate(cfg.pattern):
                bp = params["shared_attn"] if kind == "shared_attn" else units[pos][u]
                bc = {k: v[u] for k, v in slices[pos].items()}
                x, nc, _ = block_apply(bp, x, cfg, kind, positions, bc, ep_world=self.ep_world,
                                       tp_world=self.tp_world, seq_world=seq_world,
                                       route=route)
                for k, v in nc.items():
                    new[pos][k].append(v)
        new_cache = [{k: (cache[pos][k] if all(a is b for a, b in zip(vs, slices[pos][k]))
                          else torch.stack(vs)) for k, vs in new[pos].items()}
                     for pos in range(len(cfg.pattern))]
        x = rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
        return self._logits(params, x)[:, 0], new_cache

    def _embed(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        emb = params["embed"].to(torch.bfloat16 if cfg.dtype == "bfloat16"
                                 else torch.float32)
        tokens = tokens.long()
        if self.tp_world is not None:  # vocab-parallel
            x = reduce_from_model(self._embed_shard(emb, tokens), self.tp_world)
            if cfg.num_codebooks > 1:  # the codebooks summed in the one-card order
                parts, x = x, torch.zeros_like(x[0])
                for part in parts:
                    x = x + part
        elif cfg.num_codebooks > 1:
            # musicgen: sum the per-codebook embeddings; a token row without
            # its codebook axis (the serving engine's [B, 1]) reads its last
            # column for every codebook, as JAX clamps a static index
            x = torch.zeros(tokens.shape[:2] + (cfg.d_model,), dtype=emb.dtype,
                            device=emb.device)
            for c in range(cfg.num_codebooks):
                x = x + emb[c][tokens[..., min(c, tokens.shape[-1] - 1)]]
        else:
            x = emb[tokens]
        # sqrt(d_model) computed in the activations' dtype, as the reference
        # does, on the host (a value made on the card would stall the host)
        return x * float(torch.tensor(float(cfg.d_model), dtype=x.dtype) ** 0.5)

    def _embed_shard(self, emb: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the embeddings ([B, S, d], or [nc, B, S, d] a
        codebook each): a token outside the rank's vocabulary shard reads
        zeros."""
        V = emb.shape[-2]
        local = tokens - self.vocab_span[0]
        inside = ((local >= 0) & (local < V))[..., None]
        local = local.clamp(0, V - 1)
        if self.cfg.num_codebooks == 1:
            return torch.where(inside, emb[local], 0)
        last = tokens.shape[-1] - 1
        return torch.stack([torch.where(inside[..., min(c, last), :],
                                        emb[c][local[..., min(c, last)]], 0)
                            for c in range(self.cfg.num_codebooks)])

    def _logits(self, params: dict, x: torch.Tensor, shard: bool = False) -> torch.Tensor:
        """f32 logits after the softcap: with ``tp_world`` column-parallel
        over the vocabulary, this rank's words ``vocab_span`` (``shard``)
        or every rank's gathered."""
        cfg = self.cfg
        head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
        head = head.to(x.dtype)
        if self.tp_world is not None:
            x = copy_to_model(x, self.tp_world)
        if cfg.num_codebooks > 1:
            logits = torch.einsum("bsd,cvd->bscv", x, head)
        else:
            logits = torch.einsum("bsd,vd->bsv", x, head)
        if self.tp_world is not None and not shard:
            logits = self._gather_vocab(logits)
        logits = logits.float()
        if cfg.logit_softcap is not None:
            logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
        return logits

    def _gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """The model group's vocabulary shards of ``logits`` joined along
        the last dim; unequal shards cross padded to rank 0's length."""
        m = self.tp_world.size
        if self.cfg.vocab % m == 0:
            return gather_from_model(logits, self.tp_world, dim=-1)
        from repro_torch.models.sharding import Split
        sp = Split.whole(logits.dim() - 1, self.cfg.vocab)
        full = gather_from_model(sp.pad(logits, m), self.tp_world, dim=-1)
        return torch.cat(sp.trim(list(full.split(sp.size(m, 0), dim=-1))), dim=-1)


def _unbind(tree, n: int) -> list:
    """The n units' parameter trees of one stacked tree (views)."""
    if isinstance(tree, dict):
        per_key = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: v[u] for k, v in per_key.items()} for u in range(n)]
    if tree.shape[0] != n:
        raise ValueError(f"stacked leaf: expected {n} units, got shape {tuple(tree.shape)}")
    return list(tree.unbind(0))


def _clamp_vocab(tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Serving's token ids, clamped below the vocabulary as JAX's gather
    clamps them (PyTorch's would raise, or fault on the card); the
    training path's ``apply`` does not clamp."""
    return tokens.clamp_max(cfg.vocab - 1)


def _block_fn(cfg: ModelConfig, kind: str, ep_world=None, tp_world=None):
    def fn(x, positions, bp):
        x, _, aux = block_apply(bp, x, cfg, kind, positions, ep_world=ep_world,
                                tp_world=tp_world)
        return x, aux
    return fn


class _Stop(Exception):
    """Ends a recompute once every tensor the forward saved is made again."""


class _Held:
    """What a block's graph keeps in place of a saved tensor: the tensor
    itself only once the recompute has made it again."""
    __slots__ = ("tensor", "__weakref__")


class _SlicedFrame:
    """One checkpointed block: its input as this rank's share of the token
    rows, and a handle for each tensor its forward saved (see
    ``sliced_checkpoint``)."""

    def __init__(self, fn, x: torch.Tensor, positions: torch.Tensor, bp: dict, world):
        B, S, d = x.shape
        m = world.size
        lo, hi = unit_share(B * S, m, world.rank)
        rows = unit_share(B * S, m, 0)[1]  # every rank's share padded to rank 0's
        part = x.detach().reshape(B * S, d)[lo:hi]
        self.part = (part.clone() if hi - lo == rows  # not a view: the full x is freed
                     else torch.cat([part, part.new_zeros((rows - (hi - lo), d))]))
        self.fn, self.positions, self.bp, self.world = fn, positions, bp, world
        self.shape, self.requires_grad = x.shape, x.requires_grad
        self.held, self.recomputed = [], False

    def pack(self, t: torch.Tensor) -> _Held:
        h = _Held()
        self.held.append(weakref.ref(h))
        return h

    def unpack(self, h: _Held) -> torch.Tensor:
        if not self.recomputed:
            self._recompute()
        t = h.tensor
        del h.tensor  # the graph unpacks each saved tensor once: it is its node's now
        return t

    def _recompute(self) -> None:
        """The m shares gathered into x, then the block run again until it
        has saved as many tensors as the forward did (``checkpoint``'s
        early stop: the block's trailing ops, which save nothing, and their
        collectives are not run again)."""
        B, S, d = self.shape
        m = self.world.size
        parts = all_gather(self.part, self.world)  # [m, rows, d], before the block's own
        if self.part.shape[0] * m == B * S:
            x = parts.view(B, S, d)
        else:  # each rank's share trimmed of its padding
            shares = [unit_share(B * S, m, r) for r in range(m)]
            x = torch.cat([parts[r, :hi - lo] for r, (lo, hi) in enumerate(shares)])
            x = x.view(B, S, d)
        count = 0

        def pack(t):
            nonlocal count
            t = t.detach()  # a saved output would hold its own graph node: a cycle
            h = self.held[count]()
            count += 1
            if h is not None:  # None: the graph already let that tensor go
                h.tensor = t
            if count == len(self.held):
                raise _Stop
            return t

        try:
            with torch.enable_grad(), saved_tensors_hooks(pack, lambda t: t):
                self.fn(x.requires_grad_(self.requires_grad), self.positions, self.bp)
        except _Stop:
            pass
        self.recomputed = True


def sliced_checkpoint(fn, x: torch.Tensor, positions: torch.Tensor, bp: dict, world):
    """``fn(x, positions, bp)`` (a block: (x, aux)) checkpointed with its
    input x saved as model rank j's ``unit_share`` of the B·S token rows
    of the group of m ranks of ``world``, padded to rank 0's share, where
    ``torch.utils.checkpoint`` would keep the whole x (it holds its inputs
    by reference, so a slice of them frees nothing). The block's forward is
    recorded as usual, but each tensor it saves for the backward is
    replaced by a handle (``saved_tensors_hooks``, the mechanism
    ``checkpoint`` is built on); the first handle the backward reads
    all-gathers the m shares, which rebuild x word for word (x has the same
    bits on every rank of the group: its psums gather and add in rank
    order), and reruns the block until it has saved as many tensors as the
    forward did. So the gradients are ``checkpoint``'s own bits, the
    recompute issues the collectives ``checkpoint``'s does, on every rank,
    after the gather, and holds what it holds."""
    if not torch.is_grad_enabled():
        return fn(x, positions, bp)
    frame = _SlicedFrame(fn, x, positions, bp, world)
    with saved_tensors_hooks(frame.pack, frame.unpack):
        return fn(x, positions, bp)
