"""The multi-session engine one learner a rank, behind one broker.

``AggregationEngine(..., world=)`` holds each rank's own f32[V] row of
every session: every rank must submit the same sessions in the same order
and step together. A broker (``net.SafeBroker``) is one process, and a
wire tenant uploads all n rows of a session to it. This module joins the
two, as the reference's one broker process drives a ``shard_map`` engine
over every device:

- rank 0 wraps its engine in an ``EngineLead``, which presents the
  interface the broker drives (``n``, ``V``, ``queue``, ``active``,
  ``on_complete``, ``submit(values f32[n, V], ...)``, ``step`` and
  ``run_until_done``), so ``SafeBroker(engine=lead)`` serves wire tenants
  with the wire contract unchanged;
- every other rank runs ``follow(engine)`` around its own engine.

Before each step the lead sends what was submitted since the last one: a
command header (the command and the number of sessions), one broadcast of
the sessions' metadata (rounds, seeds, rotation, and the alive and weight
floats' bits, one int64 row a session), and the sessions' rows scattered
so that rank i receives row i. Every rank then submits them in the same order, so the
session ids agree without being sent, and steps once. The per-rank engine
makes each published mean every rank's, bit for bit, so rank 0 answers
``wait_session`` from its own sessions; a follower's finished sessions
reach its engine's ``on_complete`` hook. ``EngineLead.close`` (which
``SafeBroker.stop`` calls) drops the sessions not yet sent and sends the
stop command, a header alone, that ends the followers' loops. The broker's own host state (its session table and their TTL, the
chunk uploads) is rank 0's alone and never reaches an engine, so it cannot
set the ranks apart.

The header and the metadata are host data: they cross on a gloo group of
the world's ranks whose timeout (``COMMAND_TIMEOUT``) outlasts any idle
spell of the broker, since a follower waits there for its next command.
Each rank makes that group once for its world, and every later lead or
follower on the same world uses it again.
The rows cross on the world's own transport: gloo on the CPU, ``host``
for ranks sharing a card, ``nccl`` for a card a rank.

A submission is checked on rank 0 before anything is sent, so a bad one
is refused there and no follower sees it. A raise from the engine's
``on_complete`` hook comes after the step's last collective: it is held
until the step has recorded every session and counted itself, so every
rank stays in step, and then the lead re-raises it to the broker, which
counts it in ``engine_errors`` and steps on, as the reference's broker
does; a follower counts it (``follow`` returns the count) and goes on.
Any other raise in a step (the rows' scatter, a collective of the
rounds) may leave the ranks at different points of the step's
collectives, and a failed NCCL collective cannot be resumed without
forming the world again. So it tears down that rank's groups, so that
the others' collectives fail instead of waiting for it (at once over
gloo; NCCL ranks wait out the world's ``dist.world.TIMEOUT_S``), and
raises there: the error reaches every rank. The lead then refuses every
later step.
"""
from __future__ import annotations

import datetime
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.core.session import AggSession
from repro_torch.dist import collectives
from repro_torch.dist.world import World, close_world
from repro_torch.serve.agg_engine import AggregationEngine

STOP, STEP = 0, 1
#: how long a follower waits for its next command
COMMAND_TIMEOUT = datetime.timedelta(days=30)
#: each world's command group, by the world's process group
_COMMAND_WORLDS: dict = {}


def _world_key(world: World):
    import torch.distributed as dist
    return dist.group.WORLD if world.group is None else world.group


def _command_world(world: World) -> World:
    """A gloo ``World`` of ``world``'s ranks for host tensors, with the
    command timeout, made at the first call for ``world``. Every rank of
    ``world`` calls it, and no other."""
    import torch.distributed as dist
    key = _world_key(world)
    if key not in _COMMAND_WORLDS:
        group = dist.new_group([world.global_rank(r) for r in range(world.size)],
                               timeout=COMMAND_TIMEOUT, backend="gloo",
                               use_local_synchronization=True)
        _COMMAND_WORLDS[key] = World(rank=world.rank, size=world.size,
                                     device=torch.device("cpu"), transport="gloo",
                                     group=group)
    return _COMMAND_WORLDS[key]


def _step_holding(engine: AggregationEngine) -> tuple:
    """``engine.step()`` with its ``on_complete`` hook's raises held: the
    hook runs for every finished session and the step ends. Returns (the
    step's result, the hook's raises); the hook is restored after it."""
    hook, held = engine.on_complete, []
    if hook is None:
        return engine.step(), held

    def holding(sess):
        try:
            hook(sess)
        except Exception as e:  # noqa: BLE001 — raised again once the step is whole
            held.append(e)

    engine.on_complete = holding
    try:
        return engine.step(), held
    finally:
        engine.on_complete = hook


def _tear_down(world: World, cmd: World) -> None:
    """End this rank's part in both groups, so that peers waiting on it in
    a collective fail."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return
    del _COMMAND_WORLDS[_world_key(world)]
    dist.destroy_process_group(cmd.group)
    if world.group is None:
        close_world()
    else:
        dist.destroy_process_group(world.group)


class EngineLead:
    """Rank 0's per-rank ``AggregationEngine`` as one broker's engine: the
    sessions' rows go to their ranks at each step (module docstring).
    Every other rank of the engine's world runs ``follow`` meanwhile."""

    def __init__(self, engine: AggregationEngine):
        if engine.world is None or engine.world.rank != 0:
            raise ValueError("EngineLead wraps rank 0's AggregationEngine(..., world=); "
                             "the other ranks run follow(engine)")
        self.engine = engine
        self.n, self.V = engine.n, engine.V
        self._cmd = _command_world(engine.world)
        self._pending: list = []
        self._state = "open"        # "closed" after close, "failed" after a failed step

    @property
    def queue(self) -> List[AggSession]:
        return self.engine.queue

    @property
    def active(self) -> int:
        return self.engine.active

    @property
    def steps(self) -> int:
        return self.engine.steps

    @property
    def on_complete(self) -> Optional[Callable[[AggSession], None]]:
        return self.engine.on_complete

    @on_complete.setter
    def on_complete(self, hook) -> None:
        self.engine.on_complete = hook

    def _check_open(self) -> None:
        if self._state != "open":
            raise RuntimeError(f"the engine lead is {self._state}")

    def submit(self, values, *, rounds: int = 1, provisioning_seed: int = 0xC0FFEE,
               learner_master: int = 0x5EED, alive: Optional[np.ndarray] = None,
               weights: Optional[np.ndarray] = None, rotate0: int = 0) -> AggSession:
        """Queue a session of every learner's f32[n, V] rows (on the host
        or the device), with ``AggregationEngine.submit``'s arguments. It
        is checked here; rank 0 queues row 0 at once and returns its
        session, and each other rank receives its row at the next step."""
        self._check_open()
        values = torch.as_tensor(values, dtype=torch.float32)
        if tuple(values.shape) != (self.n, self.V):
            raise ValueError(f"session shape {tuple(values.shape)} != the engine's "
                             f"{(self.n, self.V)}")
        rows = []
        for name, a in (("alive", alive), ("weights", weights)):
            a = np.ones(self.n, np.float32) if a is None else np.asarray(a, np.float32)
            if a.shape != (self.n,):
                raise ValueError(f"{name} must have shape ({self.n},), got {a.shape}")
            rows.append(a)
        alive, weights = rows
        sess = self.engine.submit(values[0], rounds=rounds, provisioning_seed=provisioning_seed,
                                  learner_master=learner_master, alive=alive,
                                  weights=weights, rotate0=rotate0)
        bits = np.concatenate([alive, weights]).view(np.int32).astype(np.int64)
        meta = np.concatenate([[rounds, provisioning_seed, learner_master, rotate0], bits])
        self._pending.append((torch.from_numpy(meta.astype(np.int64)), values))
        return sess

    def _send(self, op: int, pending: list) -> None:
        collectives.broadcast(torch.tensor([op, len(pending)], dtype=torch.int64), 0,
                              self._cmd)
        if pending:
            metas, rows = zip(*pending)
            collectives.broadcast(torch.stack(metas), 0, self._cmd)
            collectives.scatter(torch.stack(rows, dim=1), (len(rows), self.V),
                                torch.float32, 0, self.engine.world)

    def step(self) -> int:
        """Send the sessions submitted since the last step to their ranks,
        then step every rank's engine once (``AggregationEngine.step``).
        A raise of the ``on_complete`` hook
        comes back once the step is whole, the world up; any other tears
        the world down (module docstring)."""
        self._check_open()
        pending, self._pending = self._pending, []
        try:
            self._send(STEP, pending)
            done, held = _step_holding(self.engine)
        except BaseException:
            self._state = "failed"
            _tear_down(self.engine.world, self._cmd)
            raise
        if held:
            raise held[0]
        return done

    def run_until_done(self, max_steps: int = 10_000) -> None:
        while (self.queue or self.active) and self.steps < max_steps:
            self.step()

    def close(self) -> None:
        """Drop the sessions not yet sent and send the stop command,
        ending the followers' loops. Does nothing after a close or a failed
        step."""
        if self._state != "open":
            return
        self._state = "closed"
        self._pending = []
        try:
            self._send(STOP, [])
        except BaseException:
            _tear_down(self.engine.world, self._cmd)
            raise


def follow(engine: AggregationEngine) -> int:
    """Rank r > 0's loop around its per-rank engine while rank 0's
    ``EngineLead`` leads: at each step command, submit the sessions the
    lead sent, this rank's row of each, then step once (each finished
    session goes to ``engine.on_complete``, as on rank 0); return at the
    stop command the number of raises of the hook, which it counted and
    went on. Any other raise tears the world down (module docstring)."""
    world = engine.world
    if world is None or world.rank == 0:
        raise ValueError("follow runs on ranks 1.. of an AggregationEngine(..., world=); "
                         "rank 0 holds the EngineLead")
    cmd = _command_world(world)
    hook_errors = 0
    try:
        while True:
            op, k = collectives.broadcast(torch.empty(2, dtype=torch.int64), 0, cmd).tolist()
            if op == STOP:
                return hook_errors
            if k:
                metas = collectives.broadcast(torch.empty((k, 4 + 2 * engine.n),
                                                          dtype=torch.int64), 0, cmd)
                aws = metas[:, 4:].to(torch.int32).view(torch.float32).view(k, 2, engine.n)
                rows = collectives.scatter(None, (k, engine.V), torch.float32, 0, world)
                for (rounds, pseed, master, rotate0), (alive, weights), row in zip(
                        metas[:, :4].tolist(), aws.numpy(), rows):
                    engine.submit(row, rounds=rounds, provisioning_seed=pseed,
                                  learner_master=master, alive=alive, weights=weights,
                                  rotate0=rotate0)
            hook_errors += len(_step_holding(engine)[1])
    except BaseException:
        _tear_down(world, cmd)
        raise
