"""Dry run: size every (arch × input-shape) without running it.

The counterpart of the JAX package's ``launch/dryrun.py``, which lowers and
compiles each entry point on 512 placeholder devices and reads XLA's
memory and cost analyses. Here, per combination and mesh:

``one`` (the default): one card, the only layout the port runs on.
  1. builds the port's real entry point and its arguments
     (``launch/input_specs.py``) as meta tensors: shapes, dtypes and
     storage sizes, no data, nothing allocated, no kernel run;
  2. runs the entry point on them. ``LiveBytes`` follows every storage as
     it is made and freed (the arguments by category, the rest as the
     run's temporaries), each rounded up to the CUDA caching allocator's
     512-byte block as ``torch.cuda.max_memory_allocated`` counts it;
     ``FlopCounterMode`` counts the matrix products; and the SAFE
     kernels, custom ops, pass through their shape functions, which count
     calls and the bytes each kernel would move (``kernels/ops.py``);
  3. records the peak bytes by category (``total_per_device_bytes`` is the
     peak) and the temporaries alive at the peak by the op that made them
     (``temporaries_by_op``), ``matmul_flops`` (the matrix products only: not XLA's full
     cost), the kernels' calls and bytes, and whether the peak fits the
     card: ``H100_USABLE_BYTES``, what a process on the H100 80GB can
     allocate (see ``capacity``). A shape that does not fit at its
     published depth gets ``max_units_that_fit``: memory is affine in
     ``n_units``, so two runs at 1 and 2 units give the line, and runs at
     the prediction and one unit above confirm it.
  ``collectives`` is empty by construction: the learners' ring is a roll
  of dim 0 of a learner-major tensor.

  ``--per-rank``: rank 0's program with one grid position a rank
  (``repro_torch.dist``) instead, over a fake process group whose
  collectives move nothing; what one card a rank must hold under
  ``torch.distributed.run``. train_4k: its own batch, its ZeRO-1 slice of
  the master vector and moments and, for a MoE, its E/n experts (rank 0
  initiates the round at counter 0: it holds the initiator's mask too).
  With ``--model-shards m`` rank 0 of the ('data', 'model') grid of n·m
  ranks: learner 0's model shard 0, with its tensor-parallel shards, its
  chunk's round and its ZeRO-1 part of that chunk. prefill_32k,
  decode_32k and long_500k: its ``--batch`` rows (default: the global
  batch over the data ranks) on its shards, long_500k's caches split by
  slot over the data ranks. ``collectives`` then holds the bytes each
  collective call of the rank would send, by op
  (``dist/collectives.py``'s count).

  The count is the program's own tensors: cuBLAS's workspace (64 MiB on
  the H100, allocated at a process's first matrix product) is not in it,
  and ``H100_USABLE_BYTES`` leaves it out of the card's room instead.

  Meta tensors, not ``FakeTensorMode``'s fake CUDA tensors: the program
  takes the card's branches on them (``device.type != "cpu"``) and gives
  the same bytes and FLOPs, three to seven times faster on the host (the
  Mamba2 and RWKV6 chunk loops issue hundreds of thousands of ops), and a
  torch built without CUDA cannot slice a fake CUDA tensor.

``pod256`` / ``pod512`` (``--multi-pod``): the reference's production
  meshes, 16 data × 16 model ranks and two pods of them. The record is
  rank 0's program on meta tensors over a fake process group of 256 or 512
  ranks (``MESH_GRIDS``; the specs' ``per_rank``: every rank of the grid
  runs the same program on shards of the same shapes): the train step of the ('pod',
  'data', 'model') grid, or its serving step, measured as above, with the
  bytes its collectives would send by op (a MoE's pod512 train step
  counts its experts' f32 gradient sum over the pods under ``psum``).

The reference's ``_shape_bytes`` and ``parse_collectives`` read XLA's HLO
text and have no counterpart here. Records go to
``results/dryrun_torch/<arch>__<shape>__<mesh>[__<tag>].json``.

Usage:
  python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape train_4k
  python -m repro_torch.launch.dryrun --arch qwen3-14b --shape decode_32k --mesh pod256
  python -m repro_torch.launch.dryrun --all          # everything missing, serially
  python -m repro_torch.launch.dryrun --arch qwen3-moe-235b-a22b --shape train_4k \
      --learners 4 --batch 2 --seq-len 256 --per-rank --tag rank   # a card a rank
  python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape train_4k \
      --learners 4 --batch 2 --seq-len 256 --per-rank --model-shards 2 --tag rank_tp2
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results",
                           "dryrun_torch")
MESHES = ("one", "pod256", "pod512")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
CUDA_BLOCK = 512            # the CUDA caching allocator rounds every block to this
# What one process can allocate on an H100 80GB HBM3: the bytes free to the
# caching allocator once the CUDA context, the port's kernels and cuBLAS's
# workspace are in place (84.163 GB, torch 2.11), less what the allocator
# reserved beyond what it allocated in a train step that fills the card
# (0.776 GB): 83.387 GB, rounded down. chip_smoke.py's dry-run phase prints
# both and fails if the card has less than this.
H100_USABLE_BYTES = 83_000_000_000


class LiveBytes(TorchDispatchMode):
    """Bytes alive on the meta device through a run, by category.

    ``add(tensor, category)`` registers an argument's storage; every
    storage an op makes during the run is a temporary. A storage counts
    once (views share it), rounded up to a multiple of ``block``, and stops
    counting when it is freed. ``peak`` is the most bytes alive at once,
    ``at_peak`` their split by category and ``ops_at_peak`` the
    temporaries' split by the op that made them (``aten`` op names)."""

    def __init__(self, block: int = CUDA_BLOCK):
        super().__init__()
        self.block = block
        self._seen = WeakIdKeyDictionary()
        self.now = collections.Counter()
        self.ops = collections.Counter()
        self.total = self.peak = 0
        self.at_peak: dict = {}
        self.ops_at_peak: dict = {}

    def add(self, t, category: str, op: str = "") -> None:
        if not isinstance(t, torch.Tensor) or t.device.type != "meta":
            return
        st = t.untyped_storage()
        if st in self._seen:
            return
        nbytes = -(-st.nbytes() // self.block) * self.block
        self._seen[st] = category
        weakref.finalize(st, self._free, nbytes, category, op)
        self.now[category] += nbytes
        self.ops[op] += nbytes
        self.total += nbytes
        if self.total > self.peak:
            self.peak, self.at_peak = self.total, dict(self.now)
            self.ops_at_peak = dict(self.ops)

    def _free(self, nbytes: int, category: str, op: str) -> None:
        self.now[category] -= nbytes
        self.ops[op] -= nbytes
        self.total -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            self.add(t, "temporaries", func.overloadpacket.__name__)
        return out

    def temporaries_by_op(self, top: int = 12) -> dict:
        """The temporaries alive at the peak by the op that made them: the
        ``top`` largest, the rest summed as ``other``."""
        ops = sorted(((k, v) for k, v in self.ops_at_peak.items() if k and v),
                     key=lambda kv: -kv[1])
        out = dict(ops[:top])
        if ops[top:]:
            out["other"] = sum(v for _, v in ops[top:])
        return out


def capacity() -> tuple:
    """(bytes, where the number comes from) of the card the run sizes for:
    one number for the H100 80GB, whether or not a card is present."""
    return H100_USABLE_BYTES, ("H100_USABLE_BYTES: what one process can allocate on an "
                               "H100 80GB HBM3, measured by chip_smoke.py")


def measure(cfg, shape_name: str, *, shape=None, block: int = CUDA_BLOCK,
            **train_kw) -> dict:
    """One run of ``shape_name``'s entry point for ``cfg`` on one card, on
    meta tensors; ``shape`` overrides the input shape's sizes, ``train_kw``
    go to the train spec, ``block`` is the allocation rounding. Returns the
    memory, FLOP and kernel figures, or None where the reference skips the
    shape."""
    from repro_torch.compat import FlopCounterMode
    from repro_torch.dist import collectives
    from repro_torch.kernels import ops
    from repro_torch.launch.input_specs import build_spec
    from repro_torch.train.flatten import leaves

    t0 = time.time()
    spec = build_spec(cfg, None, shape_name, shape=shape, device="meta", **train_kw)
    if spec is None:
        return None
    mem = LiveBytes(block)
    for category, tree in spec.memory.items():
        for t in leaves(tree):
            mem.add(t, category)
    arguments = mem.total
    ops.reset_fake_calls()
    collectives.reset_stats()
    with mem, FlopCounterMode(display=False) as flops:
        spec.fn(*spec.args, **spec.kwargs)
    return {"description": spec.description, "argument_bytes": arguments,
            "peak_bytes": mem.peak, "peak_by_category": dict(sorted(mem.at_peak.items())),
            "temporaries_by_op": mem.temporaries_by_op(),
            "matmul_flops": int(flops.get_total_flops()),
            "kernels": {k: dict(v) for k, v in ops.fake_calls.items() if v["calls"]},
            "collective_bytes": dict(sorted(collectives.stats["bytes"].items())),
            "run_s": round(time.time() - t0, 2)}


def max_units_that_fit(cfg, shape_name: str, cap: int, peak_at_depth: int, *, shape=None,
                       **train_kw) -> dict:
    """The most units (pattern repeats) whose peak fits ``cap``, for a
    config whose published depth (``peak_at_depth`` bytes) does not fit.
    Two runs at 1 and 2 units fix an affine line; runs at its prediction
    and one unit above confirm it. Should the peak leave the line, the
    answer steps down (or up) a unit at a time, each step a run."""
    pattern = len(cfg.pattern)
    runs = {cfg.n_units: peak_at_depth}

    def fits(units):
        if units not in runs:
            runs[units] = measure(dataclasses.replace(cfg, n_layers=units * pattern),
                                  shape_name, shape=shape, **train_kw)["peak_bytes"]
        return runs[units] <= cap

    def by_units():
        return {str(k): v for k, v in sorted(runs.items())}

    if not fits(1):
        return {"max_units_that_fit": 0, "max_layers_that_fit": 0, "predicted_units": 0,
                "peak_bytes_by_units": by_units()}
    fits(2)
    per_unit = runs[2] - runs[1]
    predicted = (cfg.n_units - 1 if per_unit <= 0
                 else max(1, min(cfg.n_units - 1, 1 + int((cap - runs[1]) // per_unit))))
    u = predicted
    while u > 1 and not fits(u):
        u -= 1
    while u + 1 < cfg.n_units and fits(u + 1):
        u += 1
    return {"max_units_that_fit": u, "max_layers_that_fit": u * pattern,
            "predicted_units": predicted, "bytes_at_1_unit": runs[1], "bytes_per_unit": per_unit,
            "peak_bytes_by_units": by_units()}


#: the production meshes' grids: the reference's 16 x 16 mesh, and two pods of it
MESH_GRIDS = {"pod256": dict(learners=16, model_shards=16, pods=1),
              "pod512": dict(learners=16, model_shards=16, pods=2)}


def run_one(arch: str, shape_name: str, mesh: str = "one", aggregator_mode: str = "safe",
            pipelined: bool = False, subgroups: int = 1, tag: str = "",
            chain_model_sharded: bool = False, capacity_factor: float = 0.0,
            smoke: bool = False, seq_len: int = 0, n_layers: int = 0, **size_kw) -> dict:
    """The record of one (arch × shape) on ``mesh`` (``smoke``: the arch's
    smoke configuration; ``seq_len``: the shape's sequence length, if not
    its own; ``n_layers``: the depth, if not the configuration's).
    ``size_kw`` (``learners``, ``batch``, ``per_rank``, ``model_shards``)
    size the grid (the serving specs read them with ``per_rank``); on
    ``pod256`` / ``pod512`` the record is rank 0's program of that mesh's
    grid."""
    from repro_torch.launch.input_specs import INPUT_SHAPES
    from repro_torch.configs import get_config, get_smoke_config

    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if capacity_factor and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=capacity_factor))
    record = {"arch": arch, "shape": shape_name, "mesh": mesh,
              "aggregator": aggregator_mode, "pipelined": pipelined, "subgroups": subgroups,
              "params": cfg.param_count(), "active_params": cfg.active_param_count(),
              "status": "pending"}
    if smoke:
        record["config"] = cfg.arch_id
    if n_layers:
        record["n_layers"] = n_layers
    spec_kw = {k: v for k, v in size_kw.items() if v}  # the serving specs read the grid's
    if shape_name == "train_4k":
        spec_kw.update(aggregator_mode=aggregator_mode, pipelined=pipelined,
                       subgroups=subgroups, chain_model_sharded=chain_model_sharded)
    if seq_len:
        record["seq_len"] = seq_len
        spec_kw["shape"] = dict(INPUT_SHAPES[shape_name], seq_len=seq_len)
    skipped = {"status": "skipped",
               "reason": ("long_500k requires sub-quadratic attention; "
                          f"{arch} is pure global attention (DESIGN.md §5)")}
    if mesh != "one":
        spec_kw.update(per_rank=True, **MESH_GRIDS[mesh])
    m = measure(cfg, shape_name, **spec_kw)
    if m is None:
        record.update(skipped)
        return record
    cap, cap_from = capacity()
    record.update({
        "description": m["description"],
        "status": "ok",
        "device": {"tensors": "meta", "capacity_bytes": cap, "capacity_from": cap_from},
        "memory": {"argument_bytes": m["argument_bytes"],
                   "peak_by_category": m["peak_by_category"],
                   "temporaries_by_op": m["temporaries_by_op"],
                   "total_per_device_bytes": m["peak_bytes"]},
        "matmul_flops": m["matmul_flops"],
        "kernels": m["kernels"],
        "collectives": ({"total_bytes": sum(m["collective_bytes"].values()),
                         "by_op": m["collective_bytes"],
                         "note": "bytes rank 0's collective calls would send"}
                        if spec_kw.get("per_rank") else
                        {"total_bytes": 0, "note": "none by construction on one card: the "
                         "learners' ring is a roll of dim 0 of a learner-major tensor"}),
        "n_units": cfg.n_units,
        "fits": m["peak_bytes"] <= cap,
        "run_s": m["run_s"],
    })
    if not record["fits"]:
        record.update(max_units_that_fit(cfg, shape_name, cap, m["peak_bytes"],
                                         **spec_kw))
    print(f"[dryrun] {arch} {shape_name} {mesh}: peak {m['peak_bytes'] / 1e9:.2f} GB "
          f"({'fits' if record['fits'] else 'does not fit'} {cap / 1e9:.1f} GB"
          + ("" if record["fits"] else f"; {record['max_units_that_fit']} of "
             f"{cfg.n_units} units fit") + f") matmul {m['matmul_flops'] / 1e12:.2f} TFLOP "
          f"({m['run_s']} s)", flush=True)
    return record


def result_path(arch, shape, mesh="one", tag="", out_dir=None):
    suffix = f"__{tag}" if tag else ""
    out_dir = out_dir or RESULTS_DIR
    os.makedirs(out_dir, exist_ok=True)
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh}{suffix}.json")


def table(out_dir=None, mesh="one", tag="") -> str:
    """The records of ``mesh`` (and ``tag``) as a markdown table, one row an arch: on one
    card each shape's peak GB, fit (or the units that fit), matrix-product
    TFLOP and, for train_4k, the SAFE kernels' GB; on a pod mesh each
    shape's argument GB a device."""
    out_dir = out_dir or RESULTS_DIR
    rows = collections.defaultdict(dict)
    for name in sorted(os.listdir(out_dir)):
        parts = name[:-len(".json")].split("__")
        if not name.endswith(".json") or parts[2:] != [mesh] + ([tag] if tag else []):
            continue
        with open(os.path.join(out_dir, name)) as f:
            r = json.load(f)
        if r["status"] == "skipped":
            cell = "skipped"
        elif r["status"] != "ok":
            cell = r["status"]
        else:
            fit = ("fits" if r["fits"] else
                   f"{r['max_units_that_fit']}/{r['n_units']} units fit")
            cell = (f"{r['memory']['total_per_device_bytes'] / 1e9:.2f} GB, {fit}, "
                    f"{r['matmul_flops'] / 1e12:.1f} TFLOP")
            if r["kernels"]:
                cell += f", SAFE {sum(k['bytes'] for k in r['kernels'].values()) / 1e9:.1f} GB"
        rows[parts[0]][parts[1]] = cell
    lines = ["| arch | " + " | ".join(SHAPES) + " |", "|---" * (len(SHAPES) + 1) + "|"]
    lines += [f"| {arch} | " + " | ".join(cells.get(s, "") for s in SHAPES) + " |"
              for arch, cells in sorted(rows.items())]
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=SHAPES)
    ap.add_argument("--mesh", choices=MESHES, default=None,
                    help="one card (default), or rank 0's program on a production mesh")
    ap.add_argument("--multi-pod", action="store_true", help="the same as --mesh pod512")
    ap.add_argument("--aggregator", default="safe", choices=["safe", "saf", "insec", "bon"])
    ap.add_argument("--pipelined", action="store_true",
                    help="beyond-paper segmented chain schedule")
    ap.add_argument("--chain-model-sharded", action="store_true",
                    help="the reference's per-model-shard chains (no effect on one card)")
    ap.add_argument("--subgroups", type=int, default=1)
    ap.add_argument("--capacity", type=float, default=0.0,
                    help="override MoE capacity factor")
    ap.add_argument("--smoke", action="store_true", help="the archs' smoke configurations")
    ap.add_argument("--learners", type=int, default=None,
                    help="train_4k's learners, with --per-rank the data ranks (default: the "
                         "mesh's 'data', 16)")
    ap.add_argument("--batch", type=int, default=None,
                    help="train_4k's sequences a learner (default: 256 over the learners); "
                         "with --per-rank a serving rank's rows (default: the global batch "
                         "over the data ranks)")
    ap.add_argument("--per-rank", action="store_true",
                    help="rank 0's program with one grid position a rank (a card a rank)")
    ap.add_argument("--model-shards", type=int, default=1,
                    help="with --per-rank: rank 0 of the ('data', 'model') grid, its model "
                         "split over this many ranks")
    ap.add_argument("--n-layers", type=int, default=0,
                    help="cut the configuration to this many layers (a whole number of its "
                         "pattern)")
    ap.add_argument("--seq-len", type=int, default=0,
                    help="the shape's sequence length, if not its own")
    ap.add_argument("--out", default=None, help=f"record directory (default {RESULTS_DIR})")
    ap.add_argument("--tag", default="", help="suffix for the result file")
    ap.add_argument("--all", action="store_true",
                    help="run every missing (arch × shape) on this mesh")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--table", action="store_true",
                    help="print the mesh's (and tag's) records as a markdown table and exit")
    args = ap.parse_args(argv)
    if args.multi_pod and args.mesh not in (None, "pod512"):
        ap.error("--multi-pod means --mesh pod512")
    mesh = "pod512" if args.multi_pod else (args.mesh or "one")
    if args.table:
        print(table(args.out, mesh, args.tag))
        return 0

    from repro_torch.configs import all_arch_ids

    if args.all:
        combos = [(arch, shape) for arch in all_arch_ids() for shape in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        combos = [(args.arch, args.shape)]

    failures = 0
    for arch, shape in combos:
        path = result_path(arch, shape, mesh, args.tag, args.out)
        if os.path.exists(path) and not args.force:
            print(f"[dryrun] cached: {path}")
            continue
        try:
            rec = run_one(arch, shape, mesh, args.aggregator, args.pipelined, args.subgroups,
                          args.tag, args.chain_model_sharded, args.capacity, args.smoke,
                          args.seq_len, args.n_layers, learners=args.learners, batch=args.batch,
                          per_rank=args.per_rank, model_shards=args.model_shards)
        except Exception as e:  # noqa: BLE001 — record the failure, go on with the rest
            rec = {"arch": arch, "shape": shape, "mesh": mesh, "status": "error",
                   "error": repr(e), "traceback": traceback.format_exc()[-4000:]}
            failures += 1
            print(f"[dryrun] FAILED {arch} {shape}: {e}", flush=True)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
