"""SAFE-secured data-parallel training of a model through the program's
train step (``make_train_step(...).step_fn``).

The configuration names its plain reference (``reference``: the module
``perfbench/reference/<name>.py``), which lists the parameters
(``layout``), computes a sequence's loss (``sequence_loss``) and counts the
model's FLOPs (``train_flops``); the configuration's keys that the
program's ``ModelConfig`` has build the program's model. So a model of
another family is a configuration and, where no reference fits it, a
reference of its own.

Set-up builds one model and step from the benchmark's own weights (drawn
on the device from the seed, in the configuration's dtype) and drives it
through ``checked_steps`` steps on batches that all differ, reading after
each what the reference is held against: the mean loss over the learners,
after the first step each leaf's norm of the published gradient (from
FlatAdamW's first moment, m = (1 - b1) g), after the last each leaf's norm
of the f32 master's change. The same object then trains through the
window, a new batch of random tokens every step, each step's kernel
launches held against the SAFE round's (``drivers.short_of_protocol``).
Counters come from ``reserve_round``; when the key pair's counters are
spent (at this size every ~7 steps) the keys rotate: a new aggregator
from seeds derived from the run's seed, and a new step around the same
state.

After the window the program's state is freed and the plain float32
reference (``reference/train.py``) trains again from the same weights on
the same batches.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import time

import torch

from perfbench.drivers import launch_counts, short_of_protocol
from perfbench.harness import Check, sync
from perfbench.inputs import derive, generator
from perfbench.reference.decoder import no_tf32
from perfbench.reference.train import gaps, leaf_gaps, train_steps


def reference_of(cfg: dict):
    """The configuration's plain reference module."""
    return importlib.import_module(f"perfbench.reference.{cfg['reference']}")


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The initial parameters from the seed: N(0, 1) x the leaf's scale,
    drawn on the device in f32 a leaf at a time and stored in the
    configuration's dtype (norm scales start at 0)."""
    g = generator(seed, "weights", device=device)
    out = {}
    for path, (shape, std, dtype) in reference_of(cfg).layout(cfg).items():
        if std == 0.0:
            out[path] = torch.zeros(shape, dtype=dtype, device=device)
        else:
            out[path] = torch.randn(shape, generator=g, device=device).mul_(std).to(dtype)
    return out


def make_batches(cfg: dict, traffic: dict, seed: int, device):
    """An endless stream of int64[n, B, S] token batches from the seed."""
    g = generator(seed, "tokens", device=device)
    shape = (traffic["learners"], traffic["batch"], traffic["seq"])
    while True:
        yield torch.randint(0, cfg["vocab"], shape, generator=g, device=device)


def program_config(cfg: dict):
    """The program's ``ModelConfig`` from the configuration's keys that it
    has (lists as tuples)."""
    from repro_torch.models.config import ModelConfig
    keys = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in cfg.items() if k in keys})


def leaf_spans(tree) -> dict:
    """{path: (offset, size)} of each leaf in the program's flat vector."""
    from repro_torch.train.flatten import leaves_with_paths
    out, off = {}, 0
    for path, leaf in leaves_with_paths(tree):
        out[path] = (off, leaf.numel())
        off += leaf.numel()
    return out


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from repro_torch.models import Model
        self.cfg, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.n = int(traffic["learners"])
        model = Model(program_config(config), device="meta")
        model.to_empty(device=self.device)
        weights = make_weights(config, seed, self.device)
        tree = model.tree()
        self.leaves = leaf_spans(tree)
        if set(self.leaves) != set(weights):
            raise ValueError(f"the reference's layout {sorted(weights)} is not the program's "
                             f"parameters {sorted(self.leaves)}")
        with torch.no_grad():
            for path in self.leaves:
                _leaf(tree, path).copy_(weights[path])
        del weights
        self.model = model
        self.batches = make_batches(config, traffic, seed, self.device)
        self.epoch = -1
        self._new_step()
        self.state = self.bundle.init_state_fn(model.tree())
        self.readings = {"losses": []}
        self.step_flops = reference_of(config).train_flops(config, self.n, traffic["batch"],
                                                           traffic["seq"])
        self.attempted = self.failed = self.short = 0

    def _new_step(self) -> None:
        """A Round-0 key rotation: a new aggregator, and the step around it."""
        from repro_torch.core.aggregators import make_aggregator
        from repro_torch.train import make_train_step
        self.epoch += 1
        self.agg = make_aggregator(self.cfg["aggregator"], self.n,
                                   scale_bits=self.cfg["scale_bits"],
                                   provisioning_seed=derive(self.seed, "prov", self.epoch),
                                   learner_master=derive(self.seed, "master", self.epoch),
                                   device=str(self.device))
        self.bundle = make_train_step(self.model, self.agg, lr=self.traffic["lr"],
                                      weight_decay=self.cfg["optimizer"]["weight_decay"])

    def _step(self, tokens, mark=None):
        words = self.bundle.padded_size + 2
        try:
            counter = self.agg.reserve_round(words)
        except OverflowError:
            self._new_step()
            counter = self.agg.reserve_round(words)
        self.state, metrics = self.bundle.step_fn(self.state, tokens, counter=counter, mark=mark)
        return metrics

    def _norms(self, flat: torch.Tensor, scale: float = 1.0) -> dict:
        return {p: float(torch.linalg.vector_norm(flat[o:o + k].double())) * scale
                for p, (o, k) in self.leaves.items()}

    def warmup(self) -> None:
        """The checked steps: they warm every shape the window runs."""
        b1 = self.cfg["optimizer"]["b1"]
        for i in range(int(self.traffic["checked_steps"])):
            m = self._step(next(self.batches))
            self.readings["losses"].append(float(m["loss"]))
            if i == 0:
                self.readings["grad_norms"] = self._norms(self.state["fm"], 1.0 / (1 - b1))
        # the change from the initial weights, made again from the seed
        start = make_weights(self.cfg, self.seed, self.device)
        master = self.state["master"]
        self.readings["change_norms"] = {
            p: float(torch.linalg.vector_norm((master[o:o + k].view(start[p].shape)
                                               - start[p].float()).double()))
            for p, (o, k) in self.leaves.items()}
        del start
        sync(self.device)

    def window(self, seconds: float, spans, run, marks: bool = False) -> None:
        events = []
        start = time.perf_counter()
        deadline = start + seconds
        steps = 0
        last = launch_counts()
        while True:
            tokens = next(self.batches)
            mark = None
            if marks and self.device.type == "cuda":
                ev = [("start", _event())]
                events.append(ev)
                mark = (lambda ev: lambda name: ev.append((name, _event())))(ev)
            with spans("train.step"):
                self._step(tokens, mark)
            steps += 1
            now = launch_counts()
            self.short += short_of_protocol(last, now, self.n, 1, batched=False)
            last = now
            if time.perf_counter() >= deadline:
                break
        sync(self.device)
        run.window_s = time.perf_counter() - start
        run.units, self.attempted = steps, steps
        run.tokens = steps * self.n * self.traffic["batch"] * self.traffic["seq"]
        run.flops = steps * self.step_flops
        for ev in events:
            per = {}
            for (_, a), (name, b) in zip(ev, ev[1:]):
                per[name] = per.get(name, 0.0) + a.elapsed_time(b)
            for name, ms in per.items():
                run.parts.setdefault(name, []).append(ms)

    def release(self) -> None:
        self.state = self.model = self.bundle = self.agg = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, lr=None, **kw) -> dict:
        """The float32 reference's readings on this run's weights and
        batches (``lr``, ``kw``: ``mm``, ``learners``, ``alter`` for a
        control or a fault)."""
        weights = make_weights(self.cfg, self.seed, self.device)
        stream = make_batches(self.cfg, self.traffic, self.seed, self.device)
        batches = [next(stream) for _ in range(int(self.traffic["checked_steps"]))]
        with no_tf32():
            return train_steps(weights, batches, self.cfg, self.cfg["optimizer"],
                               self.traffic["lr"] if lr is None else lr,
                               self.cfg["scale_bits"], loss=reference_of(self.cfg).sequence_loss,
                               **kw)

    def check(self, limits: dict) -> list:
        """``loss_gap``, ``grad_gap``, ``change_gap`` (``reference/train.py``
        ``gaps``), and ``short_rounds``: the window's steps whose SAFE
        round's launches fell short of the protocol's."""
        got = dict(gaps(self.readings, self.reference()), short_rounds=self.short)
        checks = [Check(k, got[k], limits[k]) for k in got]
        self.failed = sum(not c.ok for c in checks)
        return checks


def _event():
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def _leaf(tree, path: str) -> torch.Tensor:
    for part in path.split("/"):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


def train_readings(config: dict, traffic: dict, seed: int, device, program: bool = True,
                   variants=("fp8", "half_batch", "altered")) -> dict:
    """For ``perfbench/control.py``: the program's gaps from the f32
    reference after its checked steps (no window), and each variant's: the
    reference put in the program's place in fp8 products (the control),
    with half the learners (the mean over the rest), with one word of the
    published gradient altered, or with its parameters left unchanged (lr
    0: only its losses stand for that fault, whose gradient and change
    read 1 without a run)."""
    from perfbench.reference.precision import fp8_matmul
    drv = Driver(config, traffic, seed, device)
    out = {}
    if program:
        drv.warmup()
    prog = dict(drv.readings)
    drv.release()
    ref = drv.reference()
    if program:
        out["program"] = gaps(prog, ref)
        out["program_leaves"] = {k: leaf_gaps(prog, ref, k) for k in ("grad_norms",
                                                                       "change_norms")}
    kw = {"fp8": {"mm": fp8_matmul},
          "half_batch": {"learners": list(range(drv.n // 2))},
          "altered": {"alter": True}, "unchanged": {"lr": 0.0}}
    for v in variants:
        out[v] = gaps(drv.reference(**kw[v]), ref)
    return out
