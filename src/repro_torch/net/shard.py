"""Sharded broker runtime: N worker processes behind one port.

``BENCH_net_load.json`` showed the single asyncio loop — not the
aggregation math — is the wall between the protocol plane and the
ROADMAP's many-tenants story: one process tops out near 25 rounds/s at
S=4 while the batched engine plane absorbs hundreds. The paper's
controller is "a mere message broker" (§5, Appendix A), and a broker
shards trivially: session state is per-tenant (one ``Controller`` +
transfer buffers per session, no cross-session reads), so partitioning
*sessions* across worker processes needs no cross-process coordination
at all. This module does exactly that:

  * :class:`ShardBroker` — the per-worker broker: the unmodified
    :class:`~repro_torch.net.broker.SafeBroker` loop plus shard-aware session
    addressing. Worker ``i`` of ``N`` allocates session ids with
    ``sid % N == i`` (the consistent hash is the id itself, stable
    across processes and restarts: :func:`shard_of`), answers
    ``get_shard_map``, and redirects any op for a session it does not
    own to the owner's direct port — the shared-nothing control
    channel is the static port map, distributed once at startup.
  * :class:`ShardedBroker` — the manager: spawns N worker processes,
    each binding the one shared port with ``SO_REUSEPORT`` (the kernel
    load-balances first contacts) plus a direct per-shard port
    (sessions are pinned to their owner; clients dial it directly once
    ``create_session`` reveals it). On platforms without
    ``SO_REUSEPORT`` — or with ``use_reuseport=False`` — a tiny
    accept-and-hand-off dispatcher serves the shared port instead,
    answering every first contact with the §12 redirect.

The engine plane stays unsharded (one device program wants one
process); sharded workers run the protocol + chunk planes only.
Workers are plain ``multiprocessing`` spawn targets — numpy-only, like
everything under ``repro_torch.net``.

The PyTorch port's copy of the JAX package's ``net/shard.py``, with the same
semantics.
"""
from __future__ import annotations

import asyncio
import itertools
import multiprocessing
import socket
from typing import Optional, Tuple

from repro_torch.net import wire
from repro_torch.net.broker import SafeBroker
from repro_torch.obs import MetricsRegistry

Addr = Tuple[str, int]


def shard_of(session: int, shards: int) -> int:
    """The worker that owns ``session`` — a pure function of the id, so
    every process (and the doc, §12) computes the same routing. Session
    ids are allocated by the owner with ``sid % shards == shard_index``,
    which makes the id itself the consistent hash."""
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    return int(session) % int(shards)


class ShardBroker(SafeBroker):
    """One shard worker: a SafeBroker that owns sessions with
    ``sid % num_shards == shard_index`` and redirects the rest.

    The redirect is a normal OK response ``{"status": "redirect",
    "shard": k, "port": p}`` (PROTOCOL.md §12): the client re-dials the
    owner's direct port and replays the request. ``create_session``
    responses carry this worker's ``shard``/``port`` so session-aware
    runtimes dial the owner directly and never bounce again."""

    def __init__(self, shard_index: int, num_shards: int, **broker_kw):
        if not 0 <= shard_index < num_shards:
            raise ValueError(
                f"shard_index {shard_index} outside 0..{num_shards - 1}")
        super().__init__(**broker_kw)
        self.shard_index = shard_index
        self.num_shards = num_shards
        # sid allocation IS the shard hash: count(i, N) ≡ i (mod N)
        self._sids = itertools.count(shard_index, num_shards)
        self.shard_ports: list = []
        self.direct_port: Optional[int] = None
        self.redirects = 0

    def set_shard_map(self, ports) -> None:
        """Install the cluster's direct-port map (one entry per shard),
        distributed by the manager once every worker has bound."""
        ports = [int(p) for p in ports]
        if len(ports) != self.num_shards:
            raise ValueError(
                f"port map has {len(ports)} entries for "
                f"{self.num_shards} shards")
        self.shard_ports = ports
        self.direct_port = ports[self.shard_index]

    def _shard_map(self) -> dict:
        # workers hold no fleet-liveness view (shared-nothing): their
        # map reports every peer alive; the MANAGER's dispatcher path
        # (ShardedBroker._dispatch_conn / get_shard_map) is the
        # authoritative source for shard_alive — it owns the worker
        # process handles (death visibility)
        return {"shards": self.num_shards, "shard": self.shard_index,
                "ports": list(self.shard_ports),
                "shard_alive": [True] * self.num_shards}

    async def _dispatch(self, op: str, kwargs: dict):
        sid = kwargs.get("session")
        if isinstance(sid, int) \
                and shard_of(sid, self.num_shards) != self.shard_index:
            owner = shard_of(sid, self.num_shards)
            self.redirects += 1
            self._m_redirects.inc()
            return {"status": "redirect", "shard": owner,
                    "port": self.shard_ports[owner]}
        res = await super()._dispatch(op, kwargs)
        if op == "create_session" and isinstance(res, dict):
            res = dict(res, shard=self.shard_index,
                       port=self.direct_port or 0)
        return res


async def _shard_serve(shard_index: int, num_shards: int, host: str,
                       shared_port: Optional[int], broker_kw: dict,
                       conn, stop_ev) -> None:
    broker = ShardBroker(shard_index, num_shards, **broker_kw)
    _, direct_port = await broker.start(host, 0)
    loop = asyncio.get_running_loop()
    conn.send(direct_port)
    ports = await loop.run_in_executor(None, conn.recv)
    broker.set_shard_map(ports)
    if shared_port is not None:
        # join the SO_REUSEPORT group on the shared port — the kernel
        # spreads first contacts across the workers' listeners
        await broker.add_listener(host, shared_port, reuse_port=True)
    conn.send("serving")
    try:
        while not stop_ev.is_set():
            await asyncio.sleep(0.05)
    finally:
        await broker.stop()


def _shard_worker_main(shard_index: int, num_shards: int, host: str,
                       shared_port: Optional[int], broker_kw: dict,
                       conn, stop_ev) -> None:
    """Spawn target for one worker process (module-level: picklable)."""
    asyncio.run(_shard_serve(shard_index, num_shards, host, shared_port,
                             broker_kw, conn, stop_ev))


class ShardedBroker:
    """Manager for an N-process sharded broker (protocol plane).

    ``start()`` spawns the workers, distributes the direct-port map and
    returns the one shared address clients dial first; ``stop()`` shuts
    the fleet down. Broker keyword args (``aggregation_timeout``,
    ``progress_timeout``, ``monitor_interval``) forward to every worker.

    ``use_reuseport=None`` auto-detects ``SO_REUSEPORT``; without it the
    shared port is served by an in-process accept-and-hand-off
    dispatcher that answers every request with the owner's redirect
    (create_session round-robins across shards). Either way, session
    traffic flows worker-direct after first contact — the manager is
    never on the data path.
    """

    def __init__(self, shards: int = 2, *, host: str = "127.0.0.1",
                 use_reuseport: Optional[bool] = None,
                 start_timeout: float = 60.0, **broker_kw):
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        self.shards = shards
        self.host = host
        self.use_reuseport = (hasattr(socket, "SO_REUSEPORT")
                              if use_reuseport is None else use_reuseport)
        self.start_timeout = start_timeout
        self.broker_kw = dict(broker_kw)
        self.shard_ports: list = []
        self.shared_port: Optional[int] = None
        self._procs: list = []
        self._pipes: list = []
        self._stop_ev = None
        self._reserve_sock: Optional[socket.socket] = None
        self._dispatcher: Optional[asyncio.AbstractServer] = None
        self._rr = itertools.count()
        # shard-death visibility: the manager owns the worker
        # process handles, so it is the one place liveness is observable
        # without a heartbeat protocol. Deaths are marked lazily on the
        # dispatcher/get_shard_map path; full rebalancing stays a future
        # ROADMAP item — dead shards' sessions error, they don't move.
        self.metrics = MetricsRegistry()
        self._m_shard_deaths = self.metrics.counter(
            "safe_shard_deaths_total")
        self._dead: set = set()

    def dead_shards(self) -> set:
        """Re-check worker liveness and return the dead shard indices.
        A ``stop()``-ed fleet reports whatever was marked before the
        teardown (the handles are gone)."""
        for i, proc in enumerate(self._procs):
            if i not in self._dead and not proc.is_alive():
                self._dead.add(i)
                self._m_shard_deaths.inc()
        return set(self._dead)

    @property
    def shard_deaths(self) -> int:
        return self._m_shard_deaths.value

    async def _recv(self, pipe, what: str):
        loop = asyncio.get_running_loop()
        ok = await loop.run_in_executor(None, pipe.poll, self.start_timeout)
        if not ok:
            raise RuntimeError(
                f"shard worker did not report {what} within "
                f"{self.start_timeout}s")
        return await loop.run_in_executor(None, pipe.recv)

    async def start(self) -> Addr:
        """Spawn the workers; returns the shared (host, port)."""
        shared_port = None
        if self.use_reuseport:
            # reserve the shared port with a bound-but-never-listening
            # SO_REUSEPORT socket: TCP routes connections only to
            # LISTENING members of the reuseport group, so this holds
            # the number without stealing a single connect
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            sock.bind((self.host, 0))
            self._reserve_sock = sock
            shared_port = sock.getsockname()[1]
        # spawn (not fork): workers re-import repro_torch.net fresh — no
        # inherited event loops, and safe under a CUDA-initialized parent
        ctx = multiprocessing.get_context("spawn")
        self._stop_ev = ctx.Event()
        for i in range(self.shards):
            parent, child = ctx.Pipe()
            proc = ctx.Process(
                target=_shard_worker_main,
                args=(i, self.shards, self.host, shared_port,
                      self.broker_kw, child, self._stop_ev),
                daemon=True)
            proc.start()
            child.close()
            self._procs.append(proc)
            self._pipes.append(parent)
        ports = [int(await self._recv(p, "its direct port"))
                 for p in self._pipes]
        self.shard_ports = ports
        for pipe in self._pipes:
            pipe.send(ports)
        for pipe in self._pipes:  # all shared listeners up before we
            await self._recv(pipe, "serving")  # hand the addr out
        if not self.use_reuseport:
            self._dispatcher = await asyncio.start_server(
                self._dispatch_conn, self.host, 0)
            shared_port = self._dispatcher.sockets[0].getsockname()[1]
        self.shared_port = shared_port
        return self.host, shared_port

    async def _dispatch_conn(self, reader, writer) -> None:
        """The SO_REUSEPORT fallback: a dispatcher that owns no session
        state and hands every first contact off to its shard with the
        §12 redirect (create_session round-robins — the chosen worker
        then allocates a sid it owns)."""
        try:
            while True:
                body = await wire.read_frame(reader)
                if body is None:
                    break
                try:
                    op, kwargs = wire.decode_request(body,
                                                     copy_arrays=False)
                    sid = kwargs.get("session")
                    dead = self.dead_shards()
                    if op == "get_shard_map":
                        out = wire.encode_response_parts(
                            {"shards": self.shards, "shard": None,
                             "ports": list(self.shard_ports),
                             "shard_alive": [i not in dead
                                             for i in range(self.shards)],
                             "shard_deaths": len(dead)})
                    elif isinstance(sid, int):
                        owner = shard_of(sid, self.shards)
                        if owner in dead:
                            # fail fast instead of redirecting the
                            # client into a dead worker's port (a hang
                            # or a bare connection refusal): the session
                            # is gone with its shard — rebalancing is a
                            # future ROADMAP item
                            raise wire.WireError(
                                f"shard {owner} is dead; session {sid} "
                                f"is unavailable (no rebalancing)")
                        out = wire.encode_response_parts(
                            {"status": "redirect", "shard": owner,
                             "port": self.shard_ports[owner]})
                    else:
                        live = [i for i in range(self.shards)
                                if i not in dead]
                        if not live:
                            raise wire.WireError(
                                "every shard worker is dead")
                        owner = live[next(self._rr) % len(live)]
                        out = wire.encode_response_parts(
                            {"status": "redirect", "shard": owner,
                             "port": self.shard_ports[owner]})
                except wire.WireError as e:
                    out = [wire.encode_error(str(e))]
                writer.writelines(wire.encode_frame_parts(out))
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionResetError,
                wire.WireDecodeError, asyncio.CancelledError):
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:  # noqa: BLE001
                pass

    async def stop(self) -> None:
        loop = asyncio.get_running_loop()
        if self._dispatcher is not None:
            self._dispatcher.close()
            await self._dispatcher.wait_closed()
            self._dispatcher = None
        if self._stop_ev is not None:
            self._stop_ev.set()
        for proc in self._procs:
            await loop.run_in_executor(None, proc.join, 5.0)
        for proc in self._procs:
            if proc.is_alive():
                proc.terminate()
                await loop.run_in_executor(None, proc.join, 1.0)
        self._procs.clear()
        for pipe in self._pipes:
            pipe.close()
        self._pipes.clear()
        if self._reserve_sock is not None:
            self._reserve_sock.close()
            self._reserve_sock = None
