"""The SAFE-secured data-parallel train step on one card.

The counterpart of the JAX package's ``train/train_step.py``. Every
step's gradient goes through the SAFE chain instead of an all-reduce
(the paper's Round 1 over the gradient):

  the n learners one after another (the reference's manual learner axis
  becomes dim 0, as in ``federated.py``)
  ├─ learner l's forward and backward on its batch; its gradient, flat in
  │    the reference's layout (``train/flatten.py``) and zero-padded to
  │    ``padded_size``, is row l of one f32[n, padded_size] matrix
  │    (f32[P, n, padded_size] with a pod axis)
  ├─ ``SecureAggregator.aggregate`` of that matrix at the step's counter,
  │    the initiator rotated by ``counter % (2n + 1)`` (§8)
  ├─ ZeRO-1 in the reference: each rank updates its 1/n slice of the f32
  │    master vector with ``FlatAdamW`` and all-gathers the slices. The
  │    update is elementwise, so on one card it is one ``FlatAdamW`` update
  │    of the whole master vector: the same math on the same words
  └─ the parameters rebuilt from ``master[:sec_size]`` in their dtypes

``leafwise`` aggregates each parameter tensor in its own round (key domain
leaf index + 1, the step's counter in every domain) and updates with the
tree ``AdamW`` (with ``grad_clip``) instead of the flat master; it switches
on by itself when the flat f32 vector would exceed 8 GB, as in the
reference.

Options that shard over a model axis have no meaning on one card: the
``mesh`` and ``learner_axis``, ``chain_model_sharded`` (the reference's
per-model-shard chains, whose published mean is the same) and the
reference's Megatron output anchors (``models/sharding.py``) change no
arithmetic, so they are accepted and do nothing. Expert parallelism
(``cfg.ep_axis``) raises ``NotImplementedError`` until ``models/moe.py`` is
ported. The reference's buffer donation becomes in-place updates: with
``donate`` the step writes the new master vector, moments and parameters
into the state it is given, so the caller keeps only the returned state
(whose tensors are those same ones).
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Callable, Optional

import torch

from repro_torch.core.aggregators import SecureAggregator
from repro_torch.optim.adamw import AdamState, AdamW, FlatAdamW
from repro_torch.train.flatten import leaves, tree_map, tree_size, tree_unflatten
from repro_torch.train.loss import next_token_loss

if TYPE_CHECKING:  # the model package imports this package's flatten
    from repro_torch.models.transformer import Model

LEAFWISE_BYTES = 8e9  # flat f32 vectors above this aggregate leaf by leaf


@dataclasses.dataclass
class TrainStepBundle:
    """``step_fn(state, tokens, prefix=None, weights=None, counter=0,
    alive=None, mark=None) -> (state, metrics)`` takes one step;
    ``init_state_fn(params) -> state`` builds its state from a parameter
    tree. ``sec_size`` is the number of parameter words SAFE aggregates and
    ``padded_size`` the flat vector's length, a multiple of n."""

    step_fn: Any
    init_state_fn: Any
    sec_size: int
    padded_size: int
    leafwise: bool = False


def _write_flat(tree: Any, out: torch.Tensor) -> None:
    """The reference's ``tree_to_flat(tree)`` written into ``out[:size]``."""
    off = 0
    for leaf in leaves(tree):
        k = leaf.numel()
        out[off:off + k].copy_(leaf.detach().reshape(-1))
        off += k


@torch.no_grad()
def _rebuild(params: Any, flat: torch.Tensor, inplace: bool) -> Any:
    """The reference's ``flat_to_tree(flat, params)``: each leaf from its
    words of ``flat``, cast to the leaf's dtype; into the leaves themselves
    when ``inplace``."""
    new, off = [], 0
    for leaf in leaves(params):
        k = leaf.numel()
        src = flat[off:off + k].view(leaf.shape)
        off += k
        if inplace:
            new.append(leaf.copy_(src))
        else:
            new.append(src.to(leaf.dtype, copy=True))
    return tree_unflatten(params, new)


def make_train_step(
    model: Model,
    aggregator: SecureAggregator,
    mesh: Any = None,
    *,
    lr=3e-4,
    learner_axis: str = "data",
    pod_axis: Optional[str] = None,
    grad_clip: float = 1.0,
    weight_decay: float = 0.1,
    donate: bool = True,
    chain_model_sharded: bool = False,
    leafwise: Optional[bool] = None,
) -> TrainStepBundle:
    """Build the SAFE-aggregated train step of ``model`` (the reference's
    arguments; see the module docstring for those without effect here).

    ``step_fn(state, tokens, prefix=None, weights=None, counter=0,
    alive=None, mark=None)``: ``tokens`` int[n, B, S] (int[P·n, B, S],
    pod-major, with the aggregator's pod axis), ``prefix`` optional
    per-learner prefix embeddings, ``weights`` f32[n] (returned as the
    ``weight`` metric, not aggregated, as in the reference), ``counter``
    the step's first counter word (reserve ``padded_size + 2`` words a step
    with ``aggregator.reserve_round`` so no pad is reused), ``alive`` a 0/1
    [n] bitmap. ``mark(name)``, when given, is called after each part of
    the step ("forward_backward" and "flatten" once per learner, then
    "aggregate", "optimizer", "rebuild") so a caller can time the parts.
    Returns the new state and the metrics ``loss`` (mean over the
    learners), ``grad_scale`` (norm of the published gradient) and
    ``weight``, as 0-d tensors on the parameters' device."""
    cfg = model.cfg
    if cfg.ep_axis is not None:
        raise NotImplementedError(
            f"{cfg.arch_id}: expert parallelism (ep_axis={cfg.ep_axis!r}) waits for "
            "models/moe.py (ROADMAP Queue 1 item 6)")
    agg_pods = aggregator.cfg.pod_axis
    if pod_axis is not None and pod_axis != agg_pods:
        raise ValueError(f"pod_axis={pod_axis!r} but the aggregator's is {agg_pods!r}")
    n = aggregator.cfg.num_learners
    flat_opt = FlatAdamW(lr=lr, weight_decay=weight_decay)
    sec_opt = AdamW(lr=lr, weight_decay=weight_decay, grad_clip=grad_clip)

    sec_size = tree_size(model.tree())
    shard_len = -(-sec_size // n)
    padded_size = shard_len * n
    if leafwise is None:
        leafwise = sec_size * 4 > LEAFWISE_BYTES

    def init_state_fn(params):
        """The step's state from a parameter tree. The state's parameters
        are the tree's tensors (detached), so a donating step updates them
        where they are."""
        params = tree_map(lambda t: t.detach(), params)
        dev = leaves(params)[0].device
        sec_state = None
        if leafwise:
            flat = torch.zeros(n, dtype=torch.float32, device=dev)  # placeholder
            s = sec_opt.init(params)
            sec_state = AdamState(torch.zeros((), dtype=torch.int32), s.m, s.v)
        else:
            flat = torch.zeros(padded_size, dtype=torch.float32, device=dev)
            _write_flat(params, flat)
        return {"params": params, "master": flat, "fm": torch.zeros_like(flat),
                "fv": torch.zeros_like(flat), "fstep": torch.zeros((), dtype=torch.int32),
                "ep_opt": None, "sec_opt": sec_state, "step": 0}

    def learner_grads(params, tokens, prefix, mark):
        """Each learner's loss and gradient, written into its row(s) of the
        flat matrix (or of one matrix per leaf when leafwise)."""
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        plist = leaves(p)
        dev, rows = plist[0].device, tokens.shape[0]
        if leafwise:
            mats = [torch.empty((rows, t.numel()), dtype=torch.float32, device=dev)
                    for t in plist]
        else:
            mat = torch.empty((rows, padded_size), dtype=torch.float32, device=dev)
            mat[:, sec_size:].zero_()
        losses = []
        for l in range(rows):
            batch = tokens[l]
            with torch.enable_grad():
                logits, aux = model.apply(p, batch, None if prefix is None else prefix[l])
                loss = next_token_loss(logits, batch, cfg.prefix_embeds) + aux
                grads = torch.autograd.grad(loss, plist)
            del logits
            losses.append(loss.detach())
            mark("forward_backward")
            with torch.no_grad():
                if leafwise:
                    for g, m in zip(grads, mats):
                        m[l].copy_(g.reshape(-1))
                else:
                    _write_flat(list(grads), mat[l])
            del grads
            mark("flatten")
        return torch.stack(losses), (mats if leafwise else mat)

    def step_fn(state, tokens, prefix=None, weights=None, counter=0, alive=None,
                mark: Optional[Callable[[str], None]] = None):
        mark = mark or (lambda name: None)
        params = state["params"]
        dev = leaves(params)[0].device
        tokens = torch.as_tensor(tokens).to(dev)
        if tokens.dim() < 2 or tokens.shape[0] % n or (agg_pods is None and tokens.shape[0] != n):
            raise ValueError(f"tokens: expected [{'P·' if agg_pods else ''}{n}, B, S], "
                             f"got shape {tuple(tokens.shape)}")
        pods = tokens.shape[0] // n
        if prefix is not None:
            prefix = torch.as_tensor(prefix).to(dev)
        weights = torch.ones(n) if weights is None else torch.as_tensor(weights)
        counter = int(counter) & 0xFFFFFFFF
        rotate = counter % (2 * n + 1)  # §8: rotate the initiator every round

        def as_values(m):  # [P·n, V] -> [P, n, V] for the pod axis
            return m.view(pods, n, -1) if agg_pods else m

        losses, grads = learner_grads(params, tokens, prefix, mark)
        if leafwise:
            avg = [aggregator.aggregate(as_values(m), counter, alive=alive, domain=idx + 1,
                                        rotate=rotate).view(leaf.shape)
                   for idx, (m, leaf) in enumerate(zip(grads, leaves(params)))]
            del grads
            mark("aggregate")
            grad_norm = torch.sqrt(sum(torch.sum(torch.square(a)) for a in avg))
            s = state["sec_opt"]
            new, s = sec_opt.update(tree_unflatten(params, avg), AdamState(int(s.step), s.m, s.v),
                                    params)
            sec_state = AdamState(torch.tensor(s.step, dtype=torch.int32), s.m, s.v)
            master, fm, fv, fstep = state["master"], state["fm"], state["fv"], state["fstep"]
            mark("optimizer")
            if donate:
                with torch.no_grad():
                    for old, t in zip(leaves(params), leaves(new)):
                        old.copy_(t)
                new = params
            mark("rebuild")
        else:
            avg = aggregator.aggregate(as_values(grads), counter, alive=alive, rotate=rotate)
            del grads
            mark("aggregate")
            grad_norm = torch.sqrt(torch.sum(torch.square(avg[:sec_size])))
            fs = AdamState(int(state["fstep"]), state["fm"], state["fv"])
            master, fs = flat_opt.update(avg, fs, state["master"], inplace=donate)
            del avg
            fm, fv, fstep = fs.m, fs.v, torch.tensor(fs.step, dtype=torch.int32)
            sec_state = None
            mark("optimizer")
            new = _rebuild(params, master[:sec_size], inplace=donate)
            mark("rebuild")
        metrics = {"loss": losses.view(pods, n).mean(dim=1).mean(),
                   "grad_scale": grad_norm,
                   "weight": weights.reshape(-1)[0].to(device=dev, dtype=torch.float32)}
        new_state = {"params": new, "master": master, "fm": fm, "fv": fv, "fstep": fstep,
                     "ep_opt": None, "sec_opt": sec_state, "step": state["step"] + 1}
        return new_state, metrics

    return TrainStepBundle(step_fn=step_fn, init_state_fn=init_state_fn,
                           sec_size=sec_size, padded_size=padded_size, leafwise=leafwise)
