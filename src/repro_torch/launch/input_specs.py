"""The arguments of every (arch × input-shape) entry point, for the dry run.

The counterpart of the JAX package's ``launch/input_specs.py``, on two
kinds of mesh:

- ``one`` (``mesh=None``): one card, the only layout the port runs on. A
  spec is the port's real entry point with its arguments as tensors on
  ``device``: on the meta device they allocate nothing
  (``launch/dryrun.py``); on a real device the same call runs for real.
  Parameters and tokens are zeros (values do not move
  memory or matrix-product FLOPs). ``train_4k`` is
  ``make_train_step(...).step_fn`` with n learners as dim 0 (the
  reference's n = mesh 'data' = 16 by default), ``prefill_32k``
  ``Model.prefill``, ``decode_32k`` and ``long_500k`` ``Model.decode_step``
  on a prefilled cache, which it takes as donated.
- a ``DeviceMesh`` (the production meshes of ``launch/mesh.py``, or a test
  mesh): a spec holds each argument's global shape, dtype, partition spec
  and DTensor placements (``ArgSpec``), exactly as the reference's
  ``_with_sharding`` attaches them — parameters by ``param_pspecs``, flat
  vectors over 'data', the experts' AdamW state mirroring their weights,
  caches by ``cache_pspecs`` with the pod re-spec, tokens over the batch
  axes. ``fn`` is None there: those specs hold the placements, which the
  tests hold against the reference's. The program a rank of a grid runs
  is ``per_rank``'s (with ``learners``, ``model_shards``, ``pods`` and
  ``batch``; mesh None): rank 0 of the ('pod', 'data', 'model') grid
  (``dist.grid``) over a fake process group, its entry point called on its
  own meta tensors — the train step on its shards, chunk and ZeRO-1 part;
  prefill and decode on its batch rows (over ('pod', 'data')), its heads
  and, for long_500k, its slots of the sequence-sharded caches. The dry
  run's production-mesh records are that program on their grids.

Where the program reads a value on the host (the train step's optimizer
step counters, ``int(state["fstep"])``), the spec hands it a real 0-d
tensor on the host, as a meta tensor has no value; the program itself is
unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import axes_sizes, param_pspecs, placements
from repro_torch.models.transformer import Model
from repro_torch.optim.adamw import AdamState
from repro_torch.serve.engine import cache_pspecs
from repro_torch.train.flatten import is_expert_path, partition_tree, tree_map

INPUT_SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}

#: learners of the train step on one card: the production mesh's 'data'
ONE_LEARNERS = 16


@dataclasses.dataclass
class ArgSpec:
    """An argument on a mesh: global shape, dtype, partition spec (one
    entry per dim, or fewer: the rest replicated) and the DTensor
    placements the spec gives on the mesh."""

    shape: tuple
    dtype: torch.dtype
    spec: tuple = ()
    placements: tuple = ()

    def local_shape(self, mesh) -> tuple:
        """A device's shard (the counterpart of ``NamedSharding(mesh,
        spec).shard_shape(shape)``)."""
        from repro_torch.compat import compute_local_shape_and_global_offset
        return tuple(compute_local_shape_and_global_offset(self.shape, mesh,
                                                           self.placements)[0])

    def local_bytes(self, mesh) -> int:
        n = 1
        for d in self.local_shape(mesh):
            n *= d
        return n * self.dtype.itemsize


@dataclasses.dataclass
class DryrunSpec:
    """An entry point and its arguments: ``fn(*args, **kwargs)`` on one
    card (``fn`` None on a mesh). ``memory`` names the trees of arguments
    by memory category (parameters, optimizer state, cache, inputs);
    ``bundle`` is the train step's ``TrainStepBundle``."""

    fn: Any
    args: tuple
    description: str
    kwargs: dict = dataclasses.field(default_factory=dict)
    memory: dict = dataclasses.field(default_factory=dict)
    bundle: Any = None


def use_expert_parallel(cfg: ModelConfig) -> bool:
    """Giant MoEs shard experts over the learner axis (DESIGN.md §3)."""
    return cfg.uses_moe and cfg.moe is not None and cfg.moe.num_experts >= 64


def token_shape(cfg: ModelConfig, batch: int, seq: int) -> tuple:
    if cfg.num_codebooks > 1:
        return (batch, seq, cfg.num_codebooks)
    return (batch, seq)


def _arg(shape, dtype, mesh, spec=()) -> ArgSpec:
    return ArgSpec(tuple(shape), dtype, tuple(spec), placements(tuple(spec), mesh))


def _with_sharding(tree, specs, mesh):
    """ArgSpecs of a tree of tensors (or anything with shape and dtype)
    under a matching tree of specs."""
    return tree_map(lambda x, s: _arg(x.shape, x.dtype, mesh, s), tree, specs)


def _zeros(tree, device):
    """Zero tensors of a tree's shapes and dtypes on ``device``."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=p.dtype, device=device), tree)


def params_abstract(model: Model, mesh):
    """The parameters as ArgSpecs with production placements, and their
    specs."""
    params = model.tree()
    specs = param_pspecs(model.cfg, params, axes_sizes(mesh))
    return _with_sharding(params, specs, mesh), specs


def _rank_grid(n: int, m: int, pods: int, device):
    """Rank 0's ``Grid`` of the pods × n × m ranks, over a fake process
    group of that many ranks whose collectives move nothing."""
    from repro_torch.dist import World, grid
    from repro_torch.launch.mesh import start_fake_world
    size = start_fake_world(pods * n * m)
    return grid(World(rank=0, size=size, device=torch.device(device), transport="gloo"), m, pods)


def _serving_model(arch_cfg: ModelConfig, g) -> Model:
    """Rank ``g``'s model on the meta device: its shards over the model
    group and, for a MoE, its experts over the data ranks (routing the
    global batch over the data ranks and the pods where the reference
    does)."""
    cfg = arch_cfg
    if cfg.uses_moe and cfg.moe is not None and g.data.size > 1:
        cfg = dataclasses.replace(cfg, ep_axis="data", ep_ranks=g.data.size)
    return Model(cfg, device="meta", tp_world=g.model, ep_world=g.data, pod_world=g.pod)


def _rank_rows(shape: dict, n: int, pods: int, batch: Optional[int]) -> int:
    """A learner's (or serving rank's) batch rows: ``batch``, or the global
    batch over ('pod', 'data')."""
    rows = batch or shape["global_batch"] // (n * pods)
    if rows < 1:
        raise ValueError(f"a global batch of {shape['global_batch']} does not split over "
                         f"{n * pods} ranks")
    return rows


def _grid_name(n: int, m: int, pods: int) -> str:
    return f"rank 0 of n={n}{f' m={m}' if m > 1 else ''} pods={pods}"


def train_spec(arch_cfg: ModelConfig, mesh, shape: dict, aggregator_mode: str = "safe",
               pipelined: bool = False, subgroups: int = 1,
               chain_model_sharded: bool = False, *, learners: Optional[int] = None,
               batch: Optional[int] = None, per_rank: bool = False,
               model_shards: int = 1, pods: int = 1, device="cuda") -> DryrunSpec:
    """train_4k: the SAFE train step. ``learners`` (default: the mesh's
    'data', 16 on one card) and ``batch`` (sequences a learner; default
    the global batch over the learners) size it. ``per_rank`` (one card,
    ``mesh`` None): rank 0's step with one learner a rank instead — its
    own batch, its ZeRO-1 slice and, for a MoE, its E/n experts — over a
    fake process group of n ranks whose collectives move nothing (rank 0
    initiates the round at counter 0). With ``model_shards`` m > 1, rank 0
    of the ('data', 'model') grid of n·m ranks: learner 0's model shard 0,
    its tensor-parallel shards, its chunk's round and its ZeRO-1 part;
    with ``pods`` P > 1, rank 0 of the ('pod', 'data', 'model') grid of
    P·n·m ranks, its chunk's pod round and the pmean over 'pod'."""
    from repro_torch.core import make_aggregator
    from repro_torch.train.train_step import make_train_step

    axes = {"data": ONE_LEARNERS, "pod": pods} if mesh is None else axes_sizes(mesh)
    n = learners or axes["data"]
    pods = axes.get("pod", 1)
    pod_axis = "pod" if pods > 1 else None
    cfg = arch_cfg
    # the port's step takes every model with expert leaves by expert
    # parallelism (the reference's mesh step only the giant MoEs; the
    # parameters' shapes and the SAFE partition are the same either way)
    if cfg.uses_moe and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, ep_axis="data", ep_ranks=n)
    g = None
    if model_shards > 1 and not per_rank:
        raise ValueError("model_shards sizes one rank of the ('data', 'model') grid: per_rank")
    if per_rank:
        if mesh is not None:
            raise ValueError("per_rank sizes one rank of the one-card layout: mesh must be None")
        g = _rank_grid(n, model_shards, pods, device)
    model = Model(cfg, device="meta", ep_world=g and g.data, tp_world=g and g.model)
    agg = make_aggregator(aggregator_mode, n, pipelined=pipelined, subgroups=subgroups,
                          pod_axis=pod_axis, device=device)
    bundle = make_train_step(model, agg, g, pod_axis=pod_axis, donate=True,
                             chain_model_sharded=chain_model_sharded)
    B_l = _rank_rows(shape, n, pods, batch)
    S = shape["seq_len"]
    lead = (B_l,) if per_rank else (n * pods, B_l)   # a rank's tokens are its own
    tok_shape = lead + token_shape(cfg, 1, S)[1:]
    where = _grid_name(n, model_shards, pods) if per_rank else f"n={n} pods={pods}"
    description = (f"train_step {where} B_l={B_l} agg={aggregator_mode}"
                   f"{'+pipelined' if pipelined else ''}"
                   f"{'+msharded' if chain_model_sharded else ''}"
                   f"{f'+g{subgroups}' if subgroups > 1 else ''}")

    if mesh is None:
        state = bundle.init_state_fn(_zeros(model.tree(), device))
        # the step reads its optimizers' step counters on the host: real 0-d
        # tensors there (a meta tensor has no value)
        state["fstep"] = torch.tensor(0, dtype=torch.int32)
        for k in ("ep_opt", "sec_opt"):
            if state[k] is not None:
                state[k] = state[k]._replace(step=torch.tensor(0, dtype=torch.int32))
        tokens = torch.zeros(tok_shape, dtype=torch.int32, device=device)
        prefix = (torch.zeros(lead + (cfg.prefix_embeds, cfg.d_model),
                              dtype=torch.bfloat16, device=device)
                  if cfg.prefix_embeds else None)
        opt = {k: state[k] for k in ("master", "fm", "fv", "ep_opt", "sec_opt")}
        return DryrunSpec(fn=bundle.step_fn, args=(state, tokens),
                          kwargs=dict(prefix=prefix, counter=0), description=description,
                          memory={"parameters": state["params"], "optimizer state": opt,
                                  "inputs": (tokens, prefix)},
                          bundle=bundle)

    params = model.tree()
    params_in = _with_sharding(params, param_pspecs(cfg, params, axes), mesh)
    flat_len = n if bundle.leafwise else bundle.padded_size
    flat = _arg((flat_len,), torch.float32, mesh, ("data",))
    step0 = _arg((), torch.int32, mesh)
    sec_p, ep_p = partition_tree(params, lambda p: not is_expert_path(p))

    def adam(tree):  # AdamW state: f32 moments placed as their parameters
        mv = tree_map(lambda x, spec: _arg(x.shape, torch.float32, mesh, spec), tree,
                      param_pspecs(cfg, tree, axes))
        return AdamState(step0, mv, mv)

    placeholder = _arg((), torch.float32, mesh)
    sec_state = adam(sec_p) if bundle.leafwise else placeholder
    ep_state = adam(ep_p) if use_expert_parallel(arch_cfg) else placeholder
    batch_axes = ("pod", "data") if pod_axis else ("data",)
    toks = _arg(tok_shape, torch.int32, mesh, (batch_axes,))
    prefix = (_arg((n * pods, B_l, cfg.prefix_embeds, cfg.d_model), torch.bfloat16, mesh,
                   (batch_axes,))
              if cfg.prefix_embeds else _arg((1,), torch.float32, mesh))
    args = (params_in, flat, flat, flat, step0, ep_state, sec_state, toks, prefix,
            _arg((n,), torch.float32, mesh), _arg((), torch.uint32, mesh),
            _arg((n,), torch.float32, mesh))
    return DryrunSpec(fn=None, args=args, description=description, bundle=bundle)


def _serving(fn):
    """A serving entry point as a caller runs it: without autograd."""
    def run(*args, **kwargs):
        with torch.no_grad():
            return fn(*args, **kwargs)
    return run


def prefill_spec(arch_cfg: ModelConfig, mesh, shape: dict, *, device="cuda",
                 per_rank: bool = False, learners: Optional[int] = None,
                 model_shards: int = 1, pods: int = 1,
                 batch: Optional[int] = None) -> DryrunSpec:
    """prefill_32k: ``Model.prefill`` of the global batch on one card, the
    placements on ``mesh``, or with ``per_rank`` rank 0's prefill of its
    ``batch`` rows (default: the global batch over ('pod', 'data')) on its
    shards over a fake grid of ``pods`` × ``learners`` × ``model_shards``
    ranks (a MoE's experts over the data ranks: the reference's manual
    expert parallelism)."""
    B, S = shape["global_batch"], shape["seq_len"]
    if per_rank:
        n = learners or ONE_LEARNERS
        g = _rank_grid(n, model_shards, pods, device)
        model = _serving_model(arch_cfg, g)
        B = _rank_rows(shape, n, pods, batch)
        mesh = None
    else:
        model = Model(arch_cfg, device="meta")
    if mesh is None:
        args = [_zeros(model.tree(), device),
                torch.zeros(token_shape(arch_cfg, B, S), dtype=torch.int32, device=device)]
        if arch_cfg.prefix_embeds:
            args.append(torch.zeros((B, arch_cfg.prefix_embeds, arch_cfg.d_model),
                                    dtype=torch.bfloat16, device=device))
        return DryrunSpec(fn=_serving(model.prefill), args=tuple(args),
                          description=(f"prefill {_grid_name(n, model_shards, pods)} B_r={B} "
                                       f"S={S}" if per_rank else f"prefill B={B} S={S}"),
                          memory={"parameters": args[0], "inputs": tuple(args[1:])})

    axes = axes_sizes(mesh)
    batch_axes = ("pod", "data") if "pod" in axes else ("data",)
    params_in, _ = params_abstract(model, mesh)
    toks = _arg(token_shape(arch_cfg, B, S), torch.int32, mesh, (batch_axes,))
    if use_expert_parallel(arch_cfg) and B % (axes["data"] * axes.get("pod", 1)) == 0:
        # the reference's manual expert parallelism: tokens stay rank-local
        return DryrunSpec(fn=None, args=(params_in, toks),
                          description=f"prefill B={B} S={S} manual-EP")
    args = [params_in, toks]
    if arch_cfg.prefix_embeds:
        args.append(_arg((B, arch_cfg.prefix_embeds, arch_cfg.d_model), torch.bfloat16,
                         mesh, (batch_axes,)))
    return DryrunSpec(fn=None, args=tuple(args), description=f"prefill B={B} S={S}")


def decode_spec(arch_cfg: ModelConfig, mesh, shape: dict, *, device="cuda",
                per_rank: bool = False, learners: Optional[int] = None,
                model_shards: int = 1, pods: int = 1,
                batch: Optional[int] = None) -> DryrunSpec:
    """decode_32k and long_500k: one ``Model.decode_step`` on a prefilled
    cache, which it takes as donated: on one card, the placements on
    ``mesh``, or with ``per_rank`` rank 0's step through
    ``make_serve_step(model, grid)`` — its ``batch`` rows (default: the
    global batch over ('pod', 'data')) and heads, or at batch 1 (long_500k)
    its slots of every attention cache over the data ranks."""
    B, S = shape["global_batch"], shape["seq_len"]
    batch_sharded = B > 1
    seq_axis = None if batch_sharded else "data"
    if per_rank:
        from repro_torch.serve.engine import make_serve_step
        n = learners or ONE_LEARNERS
        g = _rank_grid(n, model_shards, pods, device)
        model = _serving_model(arch_cfg, g)
        B = _rank_rows(shape, n, pods, batch) if batch_sharded else 1
        seq_world = None if batch_sharded else g.data
        tok_shape = (B, arch_cfg.num_codebooks) if arch_cfg.num_codebooks > 1 else (B,)
        params = _zeros(model.tree(), device)
        cache = model.init_cache(B, S, prefilled=True, device=device, seq_world=seq_world)
        tokens = torch.zeros(tok_shape, dtype=torch.int32, device=device)
        return DryrunSpec(fn=make_serve_step(model, g, seq_axis=seq_axis),
                          args=(params, tokens, cache),
                          description=(f"decode {_grid_name(n, model_shards, pods)} B_r={B} "
                                       f"cache={S}{' seq-sharded' if seq_axis else ''}"),
                          memory={"parameters": params, "cache": cache, "inputs": tokens})
    model = Model(arch_cfg, device="meta")
    tok_shape = (B, arch_cfg.num_codebooks) if arch_cfg.num_codebooks > 1 else (B,)
    description = f"decode B={B} cache={S}{' seq-sharded' if seq_axis and mesh else ''}"
    if mesh is None:
        params = _zeros(model.tree(), device)
        cache = model.init_cache(B, S, prefilled=True, device=device)
        tokens = torch.zeros(tok_shape, dtype=torch.int32, device=device)
        # the cache is donated: decode_step writes k and v into it
        return DryrunSpec(fn=_serving(model.decode_step), args=(params, tokens, cache),
                          description=description,
                          memory={"parameters": params, "cache": cache, "inputs": tokens})

    axes = axes_sizes(mesh)
    pod = "pod" in axes
    params_in, _ = params_abstract(model, mesh)
    cache = model.init_cache(B, S, prefilled=True, device="meta")
    specs = cache_pspecs(cache, batch_sharded, seq_axis, model_size=axes.get("model", 1))
    if pod and batch_sharded:  # decode batch over pod×data
        specs = tree_map(lambda _, s: tuple(("pod", "data") if p == "data" else p
                                            for p in s), cache, specs)
    tok_spec = ((("pod", "data") if pod else "data"),) if batch_sharded else ()
    return DryrunSpec(fn=None, args=(params_in, _arg(tok_shape, torch.int32, mesh, tok_spec),
                                     _with_sharding(cache, specs, mesh)),
                      description=description)


RANK_KEYS = ("per_rank", "learners", "model_shards", "pods", "batch")


def build_spec(arch_cfg: ModelConfig, mesh, shape_name: str, *, shape: Optional[dict] = None,
               device="cuda", **train_kw) -> Optional[DryrunSpec]:
    """The spec of ``shape_name`` on ``mesh`` (None: one card), or None
    where the reference skips it (long_500k without sub-quadratic
    attention). ``shape`` replaces ``INPUT_SHAPES[shape_name]``'s sizes;
    ``train_kw`` go to the train spec, and the grid's (``RANK_KEYS``) to
    the serving specs too."""
    shape = shape or INPUT_SHAPES[shape_name]
    if shape_name == "long_500k" and not arch_cfg.subquadratic:
        return None  # documented skip (DESIGN.md §5)
    if shape["kind"] == "train":
        return train_spec(arch_cfg, mesh, shape, device=device, **train_kw)
    rank_kw = {k: v for k, v in train_kw.items() if k in RANK_KEYS}
    if shape["kind"] == "prefill":
        return prefill_spec(arch_cfg, mesh, shape, device=device, **rank_kw)
    return decode_spec(arch_cfg, mesh, shape, device=device, **rank_kw)
