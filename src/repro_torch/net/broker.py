"""Asyncio broker server: the SAFE controller behind the wire codec.

The paper's claim is that chain aggregation "reduces the controller of
the aggregation to a mere message broker" (§5, Appendix A). This module
is that broker as a real server: an asyncio TCP listener speaking
:mod:`repro_torch.net.wire`, with

  * the *identical* :class:`repro_torch.core.controller.Controller` per tenant
    session — the broker adds transport, long-poll scheduling and a
    wall clock, never protocol semantics (dispatch goes through the
    same ``call``/``probe``/``consume`` registry the discrete-event
    kernel uses);
  * long-poll waits: ``check_aggregate`` / ``get_aggregate`` /
    ``get_average`` park on a per-session condition until the probe is
    satisfiable or the client's timeout lapses (timeouts do **not**
    touch the message counters — exactly the sim kernel's accounting);
  * the external progress monitor (§5.3) as a background task ordering
    reposts on wall-clock timeouts;
  * optionally, an *engine plane*: ``submit_session``/``wait_session``
    ops that feed a :class:`repro_torch.serve.agg_engine.AggregationEngine`,
    so many wire tenants batch through one engine step on the card;
  * the *chunked transfer plane* (docs/PROTOCOL.md §6): arrays larger
    than one frame stream as ``post_chunk``/``get_chunk`` frames with
    per-chunk sequence numbers. The broker is store-and-forward at
    chunk granularity — a downstream learner can pull chunk k of a
    transfer whose chunk k+1 is still uploading, so chain hops overlap
    (the §8 pipelined schedule, at the wire). Chunk frames never touch
    ``MessageStats`` (one completed transfer = one logical message);
    they are tallied separately in ``get_stats``.

One TCP connection serves one client; requests on a connection are
processed in order (a parked long-poll blocks only its own connection),
which matches the one-outstanding-request HTTP clients of the paper's
deployment.

The PyTorch port's copy of the JAX package's ``net/broker.py``, with the same
semantics. The one change: the engine plane copies a finished session's
results off the engine's device once (``_engine_results``), since
the port's engine keeps them as torch tensors on the card.
"""
from __future__ import annotations

import asyncio
import dataclasses
import itertools
import secrets
import ssl as _ssl
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.bon_controller import BON_CALL_OPS, BON_TIMED_OPS, \
    BON_WAIT_KINDS, BonController
from repro_torch.core.controller import CALL_OPS, TIMED_OPS, WAIT_KINDS, \
    Controller, ParentController
from repro_torch.net import wire
from repro_torch.obs import MetricsRegistry, Tracer

#: Default per-session in-flight-chunk-bytes budget (admission
#: control): the sum of a session's buffered-but-not-yet-posted
#: transfer bytes past which new transfers are answered
#: ``{"status": "busy", "retry_after": t}`` instead of buffered. Sized
#: far above any legitimate round (4x MAX_FRAME) so only a genuinely
#: flooding tenant — many concurrent un-posted uploads — is shed, and
#: only sheds *itself* (the budget is per session). ``None`` disables.
DEFAULT_CHUNK_BUDGET_BYTES = 4 * wire.MAX_FRAME

#: Session ops whose kwargs name the acting learner (PROTOCOL.md §15):
#: a node-scoped token must match this field, so node A cannot post,
#: consume or elect as node B. ``get_key(node=...)`` names the key's
#: OWNER, not the caller (any chain neighbour fetches it) — absent here
#: by design. Chunk frames check the field of the logical op they carry.
IDENTITY_FIELDS = {
    "post_aggregate": "from_node",
    "post_average": "node",
    "check_aggregate": "node",
    "get_aggregate": "node",
    "should_initiate": "node",
    "register_key": "node",
}

#: Session ops only the session-scoped (admin) token may invoke:
#: destructive round/lifecycle control a single learner must not hold.
ADMIN_ONLY_OPS = frozenset({
    "reset_round", "advance_round", "delete_session",
})


def _auth_failed(op: str, reason: str) -> dict:
    """The counted-neutral rejection (PROTOCOL.md §15): an OK-framed
    response no Controller ever sees — uncounted, untimed, exactly like
    the admin-class ops, so the §5 closed forms cannot observe a denied
    request."""
    return {"status": "auth_failed", "op": op, "reason": reason}


class _Transfer:
    """One in-flight chunked upload (docs/PROTOCOL.md §6).

    Keyed on the session by the round and the *destination* of the
    eventual logical op — ``("agg", round, group, to_node)`` for
    post_aggregate, ``("avg", round, group)`` for post_average — so the
    receiving side can stream chunks out of a partially-arrived transfer
    (the §8-style pipelining: the broker relays chunk k downstream while
    chunk k+1 is still uploading), and so round r+1's transfers coexist
    with round r's while the tail drains (§11 cross-round pipelining).
    A transfer for a round ahead of the session's current one buffers
    and relays normally but its logical op is *deferred*: ``posted``
    stays False (with ``asm.complete`` True) until ``advance_round``
    delivers it — MessageStats only ever moves for the current round.
    """

    __slots__ = ("owner", "xfer", "op", "kwargs", "asm", "chunk_words",
                 "posted", "last_chunk_at", "created_at", "nbytes")

    def __init__(self, owner: int, xfer: int, op: str, kwargs: dict,
                 total: int, chunk_words: int, now: float):
        # transfer identity is (owner, xfer): xfer counters are only
        # unique per uploader process, so two orgs' streams must never
        # be merged on a bare xfer match
        self.owner = owner
        self.xfer = xfer
        self.op = op
        self.kwargs = kwargs      # logical-op kwargs minus the payload
        self.asm = wire.ChunkAssembler(total)
        self.chunk_words = chunk_words
        self.posted = False       # logical op executed (transfer complete)
        self.last_chunk_at = now  # staleness clock for slot ownership
        self.created_at = now     # trace span start
        self.nbytes = 0           # buffered payload bytes (backlog series)

    def same_transfer(self, owner: int, xfer: int) -> bool:
        return self.owner == owner and self.xfer == xfer


class _Session:
    """One tenant: a Controller plus the broker-side wait machinery."""

    __slots__ = ("sid", "ctrl", "bon", "cond", "closed", "monitor_reposts",
                 "initiator_elections", "transfers", "chunk_frames_in",
                 "chunk_frames_out", "transfers_completed",
                 # cross-round pipelining (PROTOCOL.md §11)
                 "round", "chunk_frames_future",
                 # observability plane — observes, never alters
                 "round_t0", "round_published", "rounds_completed",
                 "pending_bytes", "busy_rejections",
                 # transport hardening (PROTOCOL.md §15)
                 "token", "node_tokens", "token_nodes", "auth_failures",
                 # hierarchical chain-of-chains (PROTOCOL.md §15, §5.10)
                 "parent", "upstream", "org_average", "parent_global",
                 "uplink_errors")

    def __init__(self, sid: int, ctrl: Controller, now: float = 0.0,
                 bon: Optional[BonController] = None,
                 parent: Optional[ParentController] = None,
                 upstream: Optional[dict] = None):
        self.sid = sid
        self.ctrl = ctrl
        # BON tenant (PROTOCOL.md §14): the session speaks the baseline
        # protocol instead; SAFE ops still see a (quiescent) Controller
        self.bon = bon
        # hierarchical roles (PROTOCOL.md §15): a PARENT session folds
        # anonymized org averages (ParentController); a CHILD session
        # posts its own global (= org average) UP to `upstream` on
        # publication and withholds learners' get_average until the
        # parent's fold comes back down
        self.parent = parent
        self.upstream = upstream
        self.org_average: Optional[dict] = None   # child: own fold snapshot
        self.parent_global: Optional[dict] = None  # child: installed fold
        self.uplink_errors = 0
        # transport hardening (PROTOCOL.md §15): a session-scoped admin
        # token plus one token per enrolled node, minted at creation,
        # rotated wholesale by reset_round (stale rounds cannot replay)
        self.token = secrets.token_hex(16)
        self.node_tokens: Dict[int, str] = {
            n: secrets.token_hex(16)
            for chain in ctrl.groups.values() for n in chain}
        self.token_nodes: Dict[str, int] = {
            t: n for n, t in self.node_tokens.items()}
        self.auth_failures = 0
        self.cond = asyncio.Condition()
        self.closed = False
        self.monitor_reposts = 0
        self.initiator_elections = 0
        # chunked-transfer plane (never touches MessageStats)
        self.transfers: Dict[tuple, _Transfer] = {}
        self.chunk_frames_in = 0
        self.chunk_frames_out = 0
        self.transfers_completed = 0
        # cross-round pipelining (§11): the session's current round —
        # ops tagged with a later round park/buffer until advance_round
        # catches up; untagged ops always address the current round
        self.round = 0
        #: chunk frames accepted for a round AHEAD of the current one —
        #: the direct evidence that round r+1's bytes moved while round
        #: r was still open (asserted by the pipelining tests/bench)
        self.chunk_frames_future = 0
        # round lifecycle series: round_t0 restarts at create/reset, the
        # latency histogram observes it on global publication
        self.round_t0 = now
        self.round_published = False
        self.rounds_completed = 0
        # admission control: buffered-but-un-posted transfer bytes
        self.pending_bytes = 0
        self.busy_rejections = 0

    def rotate_tokens(self) -> dict:
        """Mint a fresh admin token and fresh per-node tokens (the
        reset_round rotation, PROTOCOL.md §15): every credential of the
        aborted round is dead, so a captured token cannot replay into
        the restarted round. Returns the wire-shaped grant."""
        self.token = secrets.token_hex(16)
        self.node_tokens = {n: secrets.token_hex(16)
                            for n in self.node_tokens}
        self.token_nodes = {t: n for n, t in self.node_tokens.items()}
        return {"token": self.token, "node_tokens": dict(self.node_tokens)}

    def forget_transfer(self, key: tuple) -> Optional[_Transfer]:
        """The single transfer-removal path: un-posted buffers leave the
        backlog accounting when they leave the table (posted buffers
        already left it at posting time)."""
        tr = self.transfers.pop(key, None)
        if tr is not None and not tr.posted:
            self.pending_bytes -= tr.nbytes
        return tr

    def drop_group_transfers(self, group: int) -> None:
        """Forget every (partial or posted) transfer of one group in the
        CURRENT round — the round restarted (§5.4), so its stale chunks
        must not be served. Buffers already accepted for later rounds
        survive the restart (cross-round pipelining, §11): the restart
        replays only the round that aborted."""
        for key in [k for k in self.transfers
                    if k[1] == self.round and k[2] == group]:
            self.forget_transfer(key)

    def clear_transfers(self) -> None:
        for key in list(self.transfers):
            self.forget_transfer(key)


async def _cond_wait(cond: asyncio.Condition, deadline: Optional[float]) -> bool:
    """One parked wait on ``cond`` (held). Returns False when the
    deadline lapsed, True when notified — callers re-check their
    predicate either way. The single place that owns the
    wait_for/Condition timeout interaction."""
    if deadline is None:
        await cond.wait()
        return True
    remaining = deadline - asyncio.get_running_loop().time()
    if remaining <= 0:
        return False
    try:
        await asyncio.wait_for(cond.wait(), remaining)
    except asyncio.TimeoutError:
        return False
    return True


async def _park(cond: asyncio.Condition, probe, deadline: Optional[float]):
    """The broker's long-poll skeleton, shared by every parked wait
    (protocol waits, chunk reads, engine-session waits): hold ``cond``,
    re-run ``probe`` on each wakeup, return its first non-None result —
    or None when the deadline lapses. The loop's load-bearing subtlety
    lives here once: after a lapsed deadline the probe runs one final
    time, so a notify racing the timeout is never a spurious timeout.
    ``probe`` executes under the condition lock; it may raise (session
    deleted) and may perform consuming side effects on success."""
    async with cond:
        timed_out = False
        while True:
            res = probe()
            if res is not None:
                return res
            if timed_out:
                return None
            timed_out = not await _cond_wait(cond, deadline)


class SafeBroker:
    """Wire-level SAFE broker (protocol plane + optional engine plane).

    Args:
      aggregation_timeout: default §5.4 round timeout (wall seconds) for
        sessions that don't specify their own.
      progress_timeout: §5.3 stuck-posting threshold (wall seconds).
      monitor_interval: progress-monitor tick period.
      engine: optional ``AggregationEngine``; enables ``submit_session``
        / ``wait_session``. The engine is stepped on the event loop (its
        ``step()`` is one batched round of kernel launches), with completion
        signalled through the engine's ``on_complete`` hook.
    """

    def __init__(self, aggregation_timeout: float = 30.0,
                 progress_timeout: float = 1.0,
                 monitor_interval: float = 0.25,
                 engine=None, engine_session_ttl: float = 300.0,
                 chunk_budget_bytes: Optional[int]
                 = DEFAULT_CHUNK_BUDGET_BYTES,
                 busy_retry_after: float = 0.05,
                 inflight_rounds: int = 2,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 ssl_certfile: Optional[str] = None,
                 ssl_keyfile: Optional[str] = None):
        # optional TLS (PROTOCOL.md §15): kept as PATHS, not a built
        # SSLContext, so a sharded deployment can pickle them across the
        # worker-process spawn; the context is built in start()
        self.ssl_certfile = ssl_certfile
        self.ssl_keyfile = ssl_keyfile
        self.aggregation_timeout = aggregation_timeout
        self.progress_timeout = progress_timeout
        self.monitor_interval = monitor_interval
        self.engine_session_ttl = engine_session_ttl
        # cross-round pipelining window (PROTOCOL.md §11): chunk frames
        # tagged for rounds [current, current + inflight_rounds) are
        # accepted; frames beyond the window answer busy (the client's
        # ordinary backoff retries until advance_round opens it)
        self.inflight_rounds = max(1, int(inflight_rounds))
        # admission control (PROTOCOL.md §13): per-session
        # budget on buffered-but-un-posted chunk bytes; the suggested
        # client back-off rides the busy response
        self.chunk_budget_bytes = chunk_budget_bytes
        self.busy_retry_after = busy_retry_after
        # observability plane: a per-broker registry (each
        # shard worker process reports its own series) and a ring-buffer
        # tracer, disabled unless a caller opts in
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer()
        self._m_rounds = self.metrics.counter("safe_rounds_completed_total")
        self._m_round_lat = self.metrics.histogram(
            "safe_round_latency_seconds")
        self._m_reposts = self.metrics.counter("safe_monitor_reposts_total")
        self._m_elections = self.metrics.counter(
            "safe_initiator_elections_total")
        self._m_busy = self.metrics.counter("safe_busy_responses_total")
        self._m_chunks_in = self.metrics.counter(
            "safe_chunk_frames_in_total")
        self._m_chunks_out = self.metrics.counter(
            "safe_chunk_frames_out_total")
        self._m_transfers = self.metrics.counter(
            "safe_transfers_completed_total")
        self._m_sessions_created = self.metrics.counter(
            "safe_sessions_created_total")
        self._m_redirects = self.metrics.counter("safe_redirects_total")
        self._m_active = self.metrics.gauge("safe_active_sessions")
        self._m_backlog = self.metrics.gauge("safe_chunk_backlog_bytes")
        self._sessions: Dict[int, _Session] = {}
        self._sids = itertools.count()
        self._server: Optional[asyncio.AbstractServer] = None
        self._extra_servers: list = []
        self._tasks: list = []
        self._conn_tasks: set = set()
        self._t0 = 0.0
        #: §5.3 monitor passes that hit a tenant exception (observability
        #: for the per-session guard in _monitor_loop)
        self.monitor_errors = 0
        #: engine steps that raised (the loop keeps serving; see
        #: _engine_loop's guard)
        self.engine_errors = 0
        # engine plane
        self.engine = engine
        self._engine_sessions: Dict[int, object] = {}
        # engine-plane chunked transfers (oversized submit values /
        # result fetches routed over the §6 transfer plane): staged
        # uploads keyed (owner, xfer); per sid, the results copied to
        # the host once and their flattened form
        self._engine_uploads: Dict[tuple, dict] = {}
        self._engine_host: Dict[int, list] = {}
        self._engine_flat: Dict[int, np.ndarray] = {}
        self.engine_chunk_frames_in = 0
        self.engine_chunk_frames_out = 0
        # sid -> completion wall time; entries older than
        # engine_session_ttl are pruned (abandoned submissions — a
        # tenant that crashed between submit_session and wait_session
        # must not pin its AggSession forever)
        self._engine_done: Dict[int, float] = {}
        self._engine_cond = asyncio.Condition()
        self._engine_wake = asyncio.Event()
        if engine is not None:
            # completion hook fires inside step() on the event-loop
            # thread; waiters are notified after the step returns.
            engine.on_complete = (
                lambda sess: self._engine_done.setdefault(
                    sess.sid, asyncio.get_running_loop().time()))

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    async def start(self, host: str = "127.0.0.1", port: int = 0,
                    *, reuse_port: bool = False) -> Tuple[str, int]:
        """Bind and serve; returns the (host, port) actually bound.

        ``reuse_port`` sets ``SO_REUSEPORT`` on the listener so several
        broker processes can share one port (the sharded runtime,
        repro_torch.net.shard)."""
        loop = asyncio.get_running_loop()
        self._t0 = loop.time()
        self._server = await asyncio.start_server(
            self._handle, host, port, reuse_port=reuse_port or None,
            ssl=self._server_ssl())
        self._tasks.append(asyncio.ensure_future(self._monitor_loop()))
        if self.engine is not None:
            self._tasks.append(asyncio.ensure_future(self._engine_loop()))
        sock = self._server.sockets[0]
        addr = sock.getsockname()
        return addr[0], addr[1]

    async def add_listener(self, host: str, port: int,
                           *, reuse_port: bool = False) -> Tuple[str, int]:
        """Serve the same broker on an additional address — a sharded
        worker answers on its direct per-shard port AND the shared
        ``SO_REUSEPORT`` port. Closed with the broker on ``stop()``."""
        server = await asyncio.start_server(
            self._handle, host, port, reuse_port=reuse_port or None,
            ssl=self._server_ssl())
        self._extra_servers.append(server)
        addr = server.sockets[0].getsockname()
        return addr[0], addr[1]

    def _server_ssl(self) -> Optional[_ssl.SSLContext]:
        """Server-side TLS context from the configured cert/key paths —
        built lazily per listener (contexts are not picklable; the
        sharded workers each build their own)."""
        if self.ssl_certfile is None:
            return None
        ctx = _ssl.SSLContext(_ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(self.ssl_certfile, self.ssl_keyfile)
        return ctx

    async def stop(self) -> None:
        # stop accepting FIRST so no handler can slip in behind the
        # cancellation snapshot below
        if self._server is not None:
            self._server.close()
        for server in self._extra_servers:
            server.close()
        # cancel parked connection handlers too: a client long-polling
        # with timeout=None would otherwise leak (and on Python >= 3.12
        # make Server.wait_closed() block forever)
        pending = list(self._tasks) + list(self._conn_tasks)
        for t in pending:
            t.cancel()
        for t in pending:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        # second sweep: a connection accepted just before close() only
        # registers once its handler task first runs, which may be
        # during the awaits above — the accept stream is closed, so
        # this drains in finitely many passes
        while self._conn_tasks:
            late = list(self._conn_tasks)
            self._conn_tasks.difference_update(late)
            for t in late:
                t.cancel()
            for t in late:
                try:
                    await t
                except (asyncio.CancelledError, Exception):
                    pass
        self._tasks.clear()
        if self._server is not None:
            await self._server.wait_closed()
            self._server = None
        for server in self._extra_servers:
            await server.wait_closed()
        self._extra_servers.clear()

    def now(self) -> float:
        """Broker wall clock (seconds since start) — the ``now`` every
        Controller call sees, mirroring the sim's virtual clock."""
        return asyncio.get_running_loop().time() - self._t0

    # ------------------------------------------------------------------
    # connection handling
    # ------------------------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        self._conn_tasks.add(asyncio.current_task())
        try:
            while True:
                body = await wire.read_frame(reader)
                if body is None:
                    break
                try:
                    # zero-copy relay (PROTOCOL.md §12): array values
                    # decode as read-only views into the frame buffer —
                    # the broker stores and re-serves payloads, never
                    # does arithmetic on them (except §5.5 averaging of
                    # group averages, which allocates fresh output)
                    op, kwargs = wire.decode_request(body,
                                                     copy_arrays=False)
                    payload = await self._dispatch(op, kwargs)
                    out = wire.encode_response_parts(payload)
                except asyncio.CancelledError:
                    raise
                except wire.WireError as e:
                    out = [wire.encode_error(str(e))]
                except Exception as e:  # noqa: BLE001 — report, keep serving
                    out = [wire.encode_error(f"{type(e).__name__}: {e}")]
                try:
                    framed = wire.encode_frame_parts(out)
                except wire.WireError as e:
                    # response exceeded MAX_FRAME (e.g. a wait_session
                    # result with many large rounds): answer with the
                    # error instead of dying mid-connection
                    framed = [wire.encode_frame(wire.encode_error(str(e)))]
                # scatter-gather: relayed chunk payloads go to the
                # socket straight from the receive buffer they arrived
                # in — no per-frame copy on the hot path
                writer.writelines(framed)
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionResetError,
                wire.WireDecodeError, asyncio.CancelledError):
            pass  # client went away / stream corrupt / shutdown
        finally:
            self._conn_tasks.discard(asyncio.current_task())
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:  # noqa: BLE001
                pass

    def _session(self, kwargs: dict) -> _Session:
        sid = kwargs.pop("session", None)
        sess = self._sessions.get(sid)
        if sess is None:
            raise wire.WireError(f"unknown session {sid!r}")
        return sess

    def _check_auth(self, sess: _Session, op: str,
                    kwargs: dict) -> Optional[dict]:
        """Token gate for every session-addressed op (PROTOCOL.md §15).

        Returns None when the request may proceed, or the
        counted-neutral ``auth_failed`` response. Three rules:

        * every op must present the session's admin token or one of its
          per-node tokens (minted at create_session, rotated wholesale
          by reset_round — a stale round's credential never replays);
        * a node token must match the op's identity field
          (``IDENTITY_FIELDS``) — node A cannot post, consume or elect
          as node B. Chunk frames are checked against the logical op
          they carry;
        * round/lifecycle control (``ADMIN_ONLY_OPS``) takes the admin
          token only.

        The check runs before any Controller interaction and the denial
        is an ordinary OK-framed response: uncounted, untimed, invisible
        to MessageStats and the §5 closed forms.
        """
        token = kwargs.pop("token", None)
        if token is None:
            sess.auth_failures += 1
            return _auth_failed(op, "missing token")
        if token == sess.token:
            return None  # session-scoped (admin) token: any op
        node = sess.token_nodes.get(token)
        if node is None:
            sess.auth_failures += 1
            return _auth_failed(op, "unknown token")
        if op in ADMIN_ONLY_OPS:
            sess.auth_failures += 1
            return _auth_failed(op, f"{op} needs the session token")
        # chunk frames authenticate as the logical op they carry
        field = IDENTITY_FIELDS.get(op)
        if op == "post_chunk":
            field = IDENTITY_FIELDS.get(kwargs.get("op"))
        elif op == "get_chunk":
            field = IDENTITY_FIELDS.get(kwargs.get("kind"))
        if field is not None and field in kwargs \
                and int(kwargs[field]) != node:
            sess.auth_failures += 1
            return _auth_failed(
                op, f"token of node {node} cannot act as "
                    f"{field}={kwargs[field]}")
        return None

    def _shard_map(self) -> dict:
        """Shard topology for shard-aware clients (PROTOCOL.md §12).
        The single-process broker is its own sole shard; the sharded
        runtime (repro_torch.net.shard) overrides this with the real map."""
        return {"shards": 1, "shard": 0, "ports": [], "shard_alive": [True]}

    # ------------------------------------------------------------------
    # observability plane (docs/PROTOCOL.md §13)
    # ------------------------------------------------------------------
    def _refresh_gauges(self) -> None:
        """Point-in-time gauges are computed at read time (the hot path
        never sums across sessions)."""
        self._m_backlog.set(
            sum(s.pending_bytes for s in self._sessions.values()))
        self._m_active.set(len(self._sessions))

    def _get_metrics(self, kwargs: dict) -> dict:
        """Live metrics snapshot (opcode ``get_metrics``, admin-class:
        uncounted, untimed — MessageStats and the §5 closed forms cannot
        see it). ``session`` (optional) narrows the per-session map; on
        a sharded broker a session-addressed request redirects to the
        owner like any other session op, a sessionless one is answered
        by whichever worker the socket reached (per-shard series)."""
        self._refresh_gauges()
        up = self.now()
        rate_base = max(up, 1e-9)
        only = kwargs.get("session")
        sessions = {}
        for sid, s in self._sessions.items():
            if only is not None and sid != only:
                continue
            sessions[sid] = {
                "rounds_completed": s.rounds_completed,
                "monitor_reposts": s.monitor_reposts,
                "initiator_elections": s.initiator_elections,
                "chunk_backlog_bytes": s.pending_bytes,
                "transfers_completed": s.transfers_completed,
                "busy_rejections": s.busy_rejections,
            }
        shard_map = self._shard_map()
        return {
            "uptime_s": up,
            "shard": shard_map.get("shard"),
            "shards": shard_map.get("shards"),
            "rounds_completed": self._m_rounds.value,
            "rounds_per_s": self._m_rounds.value / rate_base,
            "round_latency_p50_s": self._m_round_lat.percentile(50.0),
            "round_latency_p99_s": self._m_round_lat.percentile(99.0),
            "monitor_reposts": self._m_reposts.value,
            "initiator_elections": self._m_elections.value,
            "busy_rejections": self._m_busy.value,
            "redirects": self._m_redirects.value,
            "chunk_backlog_bytes": int(self._m_backlog.value),
            "active_sessions": len(self._sessions),
            "sessions": sessions,
            "series": self.metrics.snapshot(),
            "trace_spans": len(self.tracer),
        }

    async def start_metrics_http(self, host: str = "127.0.0.1",
                                 port: int = 0) -> Tuple[str, int]:
        """Optional plaintext HTTP exporter: ``GET /metrics`` answers
        the registry in Prometheus text exposition format (stdlib only
        — a hand-rolled HTTP/1.0 responder, one request per
        connection). Closed with the broker on ``stop()``."""
        server = await asyncio.start_server(
            self._handle_metrics_http, host, port)
        self._extra_servers.append(server)
        addr = server.sockets[0].getsockname()
        return addr[0], addr[1]

    async def _handle_metrics_http(self, reader: asyncio.StreamReader,
                                   writer: asyncio.StreamWriter) -> None:
        self._conn_tasks.add(asyncio.current_task())
        try:
            request_line = await reader.readline()
            parts = request_line.decode("latin-1", "replace").split()
            path = parts[1] if len(parts) >= 2 else "/"
            while True:  # drain headers until the blank line
                h = await reader.readline()
                if h in (b"\r\n", b"\n", b""):
                    break
            if path.split("?", 1)[0] == "/metrics":
                self._refresh_gauges()
                shard = self._shard_map().get("shard", 0)
                body = self.metrics.render_prometheus(
                    labels=f'shard="{shard}"').encode()
                status = "200 OK"
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            else:
                body = b"try /metrics\n"
                status = "404 Not Found"
                ctype = "text/plain; charset=utf-8"
            writer.write((
                f"HTTP/1.0 {status}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(body)}\r\n"
                f"Connection: close\r\n\r\n").encode("latin-1") + body)
            await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionResetError,
                asyncio.CancelledError):
            pass
        finally:
            self._conn_tasks.discard(asyncio.current_task())
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:  # noqa: BLE001
                pass

    async def _dispatch(self, op: str, kwargs: dict):
        if op == "get_shard_map":
            return self._shard_map()
        if op == "get_metrics":
            # admin-class (PROTOCOL.md §13): never counted, never
            # timed, no Controller interaction — answered before the
            # session lookup so it needs no session to exist
            return self._get_metrics(kwargs)
        if op == "create_session":
            return self._create_session(kwargs)
        if op == "submit_session":
            return self._submit_session(kwargs)
        if op == "wait_session":
            return await self._wait_session(kwargs)
        # engine payloads beyond one frame ride the same chunk ops as
        # protocol arrays, but address the engine plane (no protocol
        # session): op/kind routes them before the session lookup
        if op == "post_chunk" and kwargs.get("op") == "submit_session":
            return self._post_engine_chunk(kwargs)
        if op == "get_chunk" and kwargs.get("kind") == "wait_session":
            return await self._get_engine_chunk(kwargs)

        sess = self._session(kwargs)
        denied = self._check_auth(sess, op, kwargs)
        if denied is not None:
            return denied
        if op == "post_org_average":
            return await self._post_org_average(sess, kwargs)
        if op == "get_org_average":
            return await self._get_org_average(sess, kwargs)
        if op == "post_chunk":
            return await self._post_chunk(sess, kwargs)
        if op == "get_chunk":
            return await self._get_chunk(sess, kwargs)
        if op == "delete_session":
            # tear the tenant down: unpark any stragglers, stop the
            # monitor from scanning it, free the Controller state
            self._sessions.pop(sess.sid, None)
            self._m_active.set(len(self._sessions))
            async with sess.cond:
                sess.closed = True
                sess.cond.notify_all()
            return None
        if op in BON_WAIT_KINDS:
            return await self._bon_long_poll(sess, op, kwargs)
        if op in BON_CALL_OPS:
            bon = self._require_bon(sess)
            if op in BON_TIMED_OPS:
                kwargs = dict(kwargs, now=self.now())
            async with sess.cond:
                res = bon.call(op, **kwargs)
                sess.cond.notify_all()
            return res
        if op in WAIT_KINDS:
            return await self._long_poll(sess, op, kwargs)
        if op in CALL_OPS:
            # cross-round pipelining (§11): a call tagged for a FUTURE
            # round parks until advance_round opens that round — the
            # controller only ever sees current-round ops, so the §5
            # closed forms hold per round boundary. A call tagged for a
            # PAST round is a straggler of a round that already closed:
            # executing it would poison the new round's state, so it is
            # dropped (None; should_initiate answers False).
            rnd = kwargs.pop("round", None)
            if rnd is not None:
                rnd = int(rnd)
                parked = await self._park_for_round(sess, rnd)
                if not parked:
                    return False if op == "should_initiate" else None
            if op == "post_aggregate":
                # transport-boundary hygiene: a posting addressed outside
                # the session's chain could never be consumed or reposted
                # around (order_repost indexes the chain) — reject it at
                # the RPC instead of letting it poison the monitor
                group = kwargs.get("group", 0)
                chain = sess.ctrl.groups.get(group)
                if chain is None:
                    raise wire.WireError(f"unknown group {group!r}")
                if kwargs.get("to_node") not in chain:
                    raise wire.WireError(
                        f"to_node {kwargs.get('to_node')!r} is not in "
                        f"group {group}'s chain")
            if op in TIMED_OPS:
                kwargs = dict(kwargs, now=self.now())
            async with sess.cond:
                res = sess.ctrl.call(op, **kwargs)
                if op == "should_initiate" and res:
                    sess.initiator_elections += 1
                    self._m_elections.inc()
                    # round restarted (§5.4): stale chunk buffers of the
                    # aborted round must not be served to the new chain
                    sess.drop_group_transfers(kwargs.get("group", 0))
                elif op == "post_average":
                    self._note_post_average(sess)
                sess.cond.notify_all()
            return res
        if op == "peek_average":
            if sess.parent is not None:
                # parent session: uncounted admin view — one org's
                # posted average with org=g, the cross-org fold without
                # (HierStats only moves on the counted hier ops)
                if kwargs.get("org") is not None:
                    return sess.parent.peek_org(int(kwargs["org"]))
                return sess.parent.try_get_org_average()
            if sess.bon is not None:
                avg = sess.bon.average
                return None if avg is None else {"average": avg}
            return sess.ctrl.try_get_average()
        if op == "get_stats":
            if sess.bon is not None:
                return sess.bon.stats_dict()
            stats = dataclasses.asdict(sess.ctrl.stats)
            stats["aggregation_total"] = sess.ctrl.stats.aggregation_total
            stats["key_exchange_total"] = sess.ctrl.stats.key_exchange_total
            stats["monitor_reposts"] = sess.monitor_reposts
            stats["initiator_elections"] = sess.initiator_elections
            stats["chunk_frames_in"] = sess.chunk_frames_in
            stats["chunk_frames_out"] = sess.chunk_frames_out
            stats["chunk_frames_future"] = sess.chunk_frames_future
            stats["transfers_completed"] = sess.transfers_completed
            stats["busy_rejections"] = sess.busy_rejections
            stats["round"] = sess.round
            stats["auth_failures"] = sess.auth_failures
            if sess.parent is not None:
                # parent level (§5.10): HierStats, never MessageStats —
                # the 2(c−f) closed form reads off these two counters
                stats["post_org_average"] = sess.parent.stats.post_org_average
                stats["get_org_average"] = sess.parent.stats.get_org_average
                stats["hierarchy_total"] = sess.parent.stats.hierarchy_total
                stats["crashed_orgs"] = list(sess.parent.crashed_orgs)
            if sess.upstream is not None:
                stats["uplink_errors"] = sess.uplink_errors
            return stats
        if op == "reset_round":
            # destructive restart of the SAME logical round: every
            # transfer dies, including any future-round buffers — a
            # pipelined session uses advance_round instead
            async with sess.cond:
                sess.ctrl.reset_round()
                sess.clear_transfers()
                if sess.parent is not None:
                    sess.parent.reset_round()
                sess.org_average = None
                sess.parent_global = None
                # next round's latency clock starts at the reset
                sess.round_published = False
                sess.round_t0 = self.now()
                # §15: the aborted round's credentials die with it — a
                # replayed stale token cannot touch the new round. The
                # fresh grant rides the response; only the resetting
                # admin sees it and redistributes.
                grant = sess.rotate_tokens()
                sess.cond.notify_all()
            return grant
        if op == "advance_round":
            # non-destructive round boundary (§11): complete the current
            # round, open the next, keep round r+1's buffers — then
            # deliver any transfer that finished uploading while parked
            # (its logical op executes NOW, on the new round's clean
            # controller, which is what keeps per-round stats deltas and
            # the §5 closed forms exact under pipelining)
            async with sess.cond:
                if sess.closed:
                    raise wire.WireError(f"session {sess.sid} deleted")
                sess.ctrl.advance_round()
                sess.round += 1
                for key in [k for k in sess.transfers if k[1] < sess.round]:
                    sess.forget_transfer(key)
                if sess.parent is not None:
                    sess.parent.reset_round()
                sess.org_average = None
                sess.parent_global = None
                sess.round_published = False
                sess.round_t0 = self.now()
                for key in sorted(k for k in sess.transfers
                                  if k[1] == sess.round):
                    tr = sess.transfers[key]
                    if tr.asm.complete and not tr.posted:
                        self._deliver_transfer(sess, tr)
                sess.cond.notify_all()
            return {"round": sess.round}
        raise wire.WireError(f"unhandled op {op!r}")

    async def _park_for_round(self, sess: _Session, rnd: int) -> bool:
        """Hold a round-tagged call until the session's round catches up
        (woken by advance_round). True when the call may execute, False
        for a stale round. The deadline scales with the round gap: each
        in-flight round ahead of this op may legitimately consume a full
        aggregation timeout (churn recovery runs the stragglers' polls
        to expiry), and the op then deserves its own budget once its
        round opens — but a caller that dies without advancing must
        still not pin its learners' connections forever."""
        loop = asyncio.get_running_loop()
        gap = max(0, rnd - sess.round)
        deadline = loop.time() + (gap + 1) * sess.ctrl.aggregation_timeout

        def ready():
            if sess.closed:
                raise wire.WireError(f"session {sess.sid} deleted")
            return True if sess.round >= rnd else None

        ok = await _park(sess.cond, ready, deadline)
        if ok is None:
            raise wire.WireError(
                f"round {rnd} never opened (session at {sess.round})")
        return sess.round == rnd

    def _note_post_average(self, sess: _Session) -> None:
        """Round-lifecycle observation (holds ``sess.cond``): the first
        post_average after which the *global* average is published
        completes the session's round — count it and observe its
        latency. A pure peek (``try_get_average``): the protocol result
        is untouched."""
        if sess.round_published:
            return
        if sess.ctrl.try_get_average() is None:
            return
        sess.round_published = True
        sess.rounds_completed += 1
        self._m_rounds.inc()
        now = self.now()
        self._m_round_lat.observe(now - sess.round_t0)
        if self.tracer.enabled:
            self.tracer.record("round", sess.round_t0, now,
                               session=sess.sid,
                               round=sess.rounds_completed - 1)
        if sess.upstream is not None:
            # child role (§5.10): this session's global IS the org
            # average — snapshot it and ship it upward; learners'
            # get_average stays parked until the parent fold lands
            sess.org_average = dict(sess.ctrl.try_get_average())
            self._tasks.append(asyncio.ensure_future(self._uplink(sess)))

    # ------------------------------------------------------------------
    # hierarchical plane (docs/PROTOCOL.md §15, paper §5.10)
    # ------------------------------------------------------------------
    async def _post_org_average(self, sess: _Session, kwargs: dict):
        """Parent-side up-post: one child org's anonymized average lands
        in the ParentController (counted + timed in HierStats, never
        MessageStats). The fold publishes once every enrolled org posted
        — or earlier via the monitor's ``maybe_elide`` when whole orgs
        crashed."""
        if sess.parent is None:
            raise wire.WireError(
                f"session {sess.sid} is not a parent session")
        wavg = kwargs.get("weight_avg")
        async with sess.cond:
            sess.parent.post_org_average(
                int(kwargs.get("org", 0)),
                np.asarray(kwargs.get("average")),
                None if wavg is None else float(wavg),
                now=self.now())
            sess.cond.notify_all()
        return {"status": "ok"}

    async def _get_org_average(self, sess: _Session, kwargs: dict):
        """Parent-side down-fetch: long-poll the cross-org fold (counted
        in HierStats on consumption; a lapsed deadline counts nothing —
        the same park/probe/consume discipline as the §5 waits)."""
        if sess.parent is None:
            raise wire.WireError(
                f"session {sess.sid} is not a parent session")
        timeout = kwargs.pop("timeout", None)
        loop = asyncio.get_running_loop()
        deadline = None if timeout is None else loop.time() + float(timeout)

        def probe():
            if sess.closed:
                raise wire.WireError(f"session {sess.sid} deleted")
            if sess.parent.try_get_org_average() is None:
                return None
            res = sess.parent.get_org_average()
            sess.cond.notify_all()
            return res

        res = await _park(sess.cond, probe, deadline)
        return res if res is not None else {"status": "timeout"}

    async def _uplink(self, sess: _Session) -> None:
        """Child role (§5.10): ship the just-published org average UP to
        the parent session, long-poll the fold back DOWN, install it as
        what this broker's learners receive from ``get_average``. One
        anonymized vector crosses the org trust boundary per round —
        never an individual learner's aggregate."""
        up = sess.upstream
        org_avg = dict(sess.org_average)
        try:
            reader, writer = await asyncio.open_connection(
                up["host"], int(up["port"]))
        except OSError:
            sess.uplink_errors += 1
            return
        try:
            async def rpc(op: str, kw: dict):
                writer.write(wire.encode_frame(wire.encode_request(op, kw)))
                await writer.drain()
                body = await wire.read_frame(reader)
                if body is None:
                    raise wire.WireError("parent closed the uplink")
                return wire.decode_response(body)

            base = {"session": up["session"], "token": up["token"]}
            res = await rpc("post_org_average", dict(
                base, org=int(up["org"]), average=org_avg["average"],
                weight_avg=org_avg.get("weight_avg")))
            if isinstance(res, dict) and res.get("status") == "auth_failed":
                raise wire.WireError(
                    f"uplink rejected: {res.get('reason')}")
            glob = await rpc("get_org_average", dict(
                base, timeout=up.get("timeout")))
            if not isinstance(glob, dict) or "average" not in glob:
                raise wire.WireError(f"no parent fold: {glob!r}")
            async with sess.cond:
                sess.parent_global = {
                    "average": np.asarray(glob["average"]),
                    "weight_avg": glob.get("weight_avg"),
                    "time": float(glob.get("time", 0.0)),
                    "orgs": list(glob.get("orgs", [])),
                    "crashed_orgs": list(glob.get("crashed_orgs", [])),
                }
                sess.cond.notify_all()
        except (wire.WireError, OSError, asyncio.IncompleteReadError):
            sess.uplink_errors += 1
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:  # noqa: BLE001
                pass

    # ------------------------------------------------------------------
    # protocol plane
    # ------------------------------------------------------------------
    def _create_session(self, kwargs: dict) -> dict:
        raw_groups = kwargs.get("groups")
        if not isinstance(raw_groups, dict) or not raw_groups:
            raise wire.WireError("create_session needs a non-empty groups map")
        groups = {int(g): [int(x) for x in nodes]
                  for g, nodes in raw_groups.items()}
        for g, chain in groups.items():
            if not chain:
                # an empty chain can never post its group average, so
                # the session could never publish globally — every
                # learner would long-poll/elect forever
                raise wire.WireError(f"group {g} has an empty chain")
        timeout = kwargs.get("aggregation_timeout")
        if timeout is None:
            timeout = self.aggregation_timeout
        protocol = kwargs.get("protocol", "safe")
        bon = None
        if protocol == "bon":
            # BON tenant (additive kwarg, PROTOCOL.md §14): one flat
            # node set (the union of the groups map keeps the call
            # shape), its own threshold and dropout wait
            nodes = sorted({x for chain in groups.values() for x in chain})
            bon = BonController(
                nodes, threshold=kwargs.get("threshold"),
                roster_timeout=float(kwargs.get("roster_timeout", 1.0)),
                scale_bits=int(kwargs.get("scale_bits", 16)))
        elif protocol != "safe":
            raise wire.WireError(f"unknown protocol {protocol!r}")
        # hierarchical roles (additive kwargs, PROTOCOL.md §15). orgs=[..]
        # makes a PARENT session: it folds anonymized org averages with
        # the same arithmetic as §5.5 and elides whole crashed orgs on
        # its aggregation timeout (the SAFE ops still see a quiescent
        # Controller, mirroring the BON tenant shape).
        parent = None
        if kwargs.get("orgs") is not None:
            orgs = [int(o) for o in kwargs["orgs"]]
            if not orgs:
                raise wire.WireError("parent session needs a non-empty orgs list")
            parent = ParentController(
                orgs, aggregation_timeout=float(timeout))
        # upstream={host,port,session,org,token} makes a CHILD session:
        # on publishing its own global (= the org average) it posts that
        # one anonymized vector up and serves the parent's fold to its
        # learners once it arrives.
        upstream = kwargs.get("upstream")
        if upstream is not None:
            need = {"host", "port", "session", "org", "token"}
            if not isinstance(upstream, dict) or not need <= set(upstream):
                raise wire.WireError(
                    f"upstream needs the keys {sorted(need)}")
            upstream = dict(upstream)
        sid = next(self._sids)
        sess = _Session(
            sid, Controller(groups, aggregation_timeout=float(timeout)),
            now=self.now(), bon=bon, parent=parent, upstream=upstream)
        self._sessions[sid] = sess
        self._m_sessions_created.inc()
        self._m_active.set(len(self._sessions))
        return {"session": sid, "aggregation_timeout": float(timeout),
                "token": sess.token,
                "node_tokens": dict(sess.node_tokens)}

    async def _long_poll(self, sess: _Session, kind: str, kwargs: dict):
        """Park until the probe is satisfiable, then consume (counted),
        or answer {"status": "timeout"} (not counted — sim parity).

        ``elide_payload=True`` (set by chunk-aware clients that already
        streamed the array via ``get_chunk``) strips the bulk array from
        the response — the logical consume still happens and still
        counts, but the bytes travel only once. ``expect_time`` guards
        that consume: the probe only counts as satisfiable when the
        stored entry's timestamp matches, so a client can never consume
        (and discard, elided) a posting other than the one it streamed
        — a §5.4 reset racing the final consume parks it instead, and
        the ordinary timeout path takes over."""
        timeout = kwargs.pop("timeout", None)
        elide = bool(kwargs.pop("elide_payload", False))
        expect_time = kwargs.pop("expect_time", None)
        # §11: a wait tagged for a future round parks until advance_round
        # opens it (the controller holds nothing for that round yet) —
        # and its OWN timeout budget only starts then, because a full
        # predecessor round may legitimately stand between arrival and
        # eligibility. One tagged for a PAST round can never be
        # satisfied — its round's state is gone — so it answers the
        # ordinary timeout
        rnd = kwargs.pop("round", None)
        if rnd is not None and int(rnd) > sess.round:
            try:
                if not await self._park_for_round(sess, int(rnd)):
                    return {"status": "timeout"}
            except wire.WireError:
                if sess.closed:
                    raise
                return {"status": "timeout"}  # round never opened
        loop = asyncio.get_running_loop()
        deadline = None if timeout is None else loop.time() + float(timeout)

        def probe():
            if sess.closed:
                raise wire.WireError(f"session {sess.sid} deleted")
            if rnd is not None and sess.round != int(rnd):
                return None
            probed = sess.ctrl.probe(kind, **kwargs)
            if kind == "get_average" and sess.upstream is not None \
                    and sess.parent_global is None:
                # child session (§15/§5.10): the org's own fold never
                # reaches learners — distribution waits for the parent
                probed = None
            if probed is not None and expect_time is not None \
                    and float(probed.get("time", 0.0)) != float(expect_time):
                probed = None  # not the entry the client streamed
            if probed is None:
                return None
            res = sess.ctrl.consume(kind, **kwargs)
            if kind == "get_aggregate":
                # the posting is consumed — its chunk buffer (if it
                # streamed in) has nothing left to serve
                sess.forget_transfer(
                    ("agg", sess.round, kwargs.get("group", 0),
                     kwargs.get("node")))
                if elide:
                    res = dict(res, aggregate=None, chunked=True)
            elif kind == "get_average":
                if sess.upstream is not None:
                    # serve the parent fold (still ONE counted
                    # get_average per learner — the §5 per-org closed
                    # forms are untouched). Served inline: the chunked
                    # distribution path streams the org-level buffer,
                    # so elide is ignored on child sessions.
                    res = dict(res, **sess.parent_global)
                elif elide:
                    res = dict(res, average=None, chunked=True)
            # consuming get_aggregate resolves the poster's pending
            # check_aggregate — wake its waiter
            sess.cond.notify_all()
            return res

        res = await _park(sess.cond, probe, deadline)
        while (res is None and kind == "get_average"
               and sess.upstream is not None
               and sess.org_average is not None
               and sess.uplink_errors == 0):
            # child session whose OWN round already published: the only
            # thing pending is the parent fold (§15), and an uplink in
            # flight must not read as a stalled aggregation — answering
            # "timeout" here would push a finished org's learners into
            # a spurious §5.4 re-election. Re-park on the caller's own
            # cadence until the fold lands or the uplink dies.
            res = await _park(sess.cond, probe,
                              None if timeout is None
                              else loop.time() + float(timeout))
        return res if res is not None else {"status": "timeout"}

    # ------------------------------------------------------------------
    # BON baseline plane (docs/PROTOCOL.md §14)
    # ------------------------------------------------------------------
    @staticmethod
    def _require_bon(sess: _Session) -> BonController:
        if sess.bon is None:
            raise wire.WireError(
                f"session {sess.sid} is not a BON session")
        return sess.bon

    async def _bon_long_poll(self, sess: _Session, kind: str, kwargs: dict):
        """BON waits under the same park/probe/consume discipline as the
        SAFE long-polls: only consumption counts (in BonStats), a lapsed
        deadline answers {"status": "timeout"} and counts nothing."""
        bon = self._require_bon(sess)
        timeout = kwargs.pop("timeout", None)
        loop = asyncio.get_running_loop()
        deadline = None if timeout is None else loop.time() + float(timeout)

        def probe():
            if sess.closed:
                raise wire.WireError(f"session {sess.sid} deleted")
            if bon.probe(kind, **kwargs) is None:
                return None
            return bon.consume(kind, **kwargs)

        res = await _park(sess.cond, probe, deadline)
        return res if res is not None else {"status": "timeout"}

    # ------------------------------------------------------------------
    # chunked transfer plane (docs/PROTOCOL.md §6)
    # ------------------------------------------------------------------
    async def _post_chunk(self, sess: _Session, kwargs: dict):
        """One chunk of a chunked upload. On the final chunk the logical
        op (post_aggregate / post_average) executes with the assembled
        array — that is the only point MessageStats moves."""
        op = kwargs.get("op")
        if op not in ("post_aggregate", "post_average"):
            raise wire.WireError(f"post_chunk cannot carry {op!r}")
        group = int(kwargs.get("group", 0))
        chain = sess.ctrl.groups.get(group)
        if chain is None:
            raise wire.WireError(f"unknown group {group!r}")
        xfer = int(kwargs["xfer"])
        seq = int(kwargs["seq"])
        total = int(kwargs["total"])
        chunk_words = int(kwargs["chunk_words"])
        payload = kwargs.get("payload")
        if not isinstance(payload, np.ndarray) or payload.ndim != 1:
            raise wire.WireError("post_chunk payload must be a flat array")
        if op == "post_aggregate":
            to_node = kwargs.get("to_node")
            if to_node not in chain:
                # same transport-boundary hygiene as the unchunked RPC
                raise wire.WireError(
                    f"to_node {to_node!r} is not in group {group}'s chain")
            owner = int(kwargs.get("from_node"))
            base = {"from_node": owner, "to_node": to_node, "group": group}
        else:
            to_node = None
            owner = int(kwargs.get("node"))
            base = {"node": owner, "group": group,
                    "weight_avg": kwargs.get("weight_avg")}
        round_kw = kwargs.get("round")
        now = self.now()
        async with sess.cond:
            if sess.closed:
                # parity with the parked paths: a frame racing
                # delete_session must not execute on the torn-down
                # Controller and ack success
                raise wire.WireError(f"session {sess.sid} deleted")
            sess.chunk_frames_in += 1
            self._m_chunks_in.inc()
            # §11 round routing: untagged frames address the current
            # round; frames within the in-flight window buffer (and
            # relay) with their logical op deferred to advance_round;
            # frames past the window are shed with the ordinary busy
            # backoff; frames for a CLOSED round are superseded — that
            # round's slot will never be consumed
            rnd = sess.round if round_kw is None else int(round_kw)
            if rnd < sess.round:
                return {"seq": seq, "received": 0, "total": total,
                        "complete": False, "superseded": True,
                        "stale_round": True}
            if rnd >= sess.round + self.inflight_rounds:
                sess.busy_rejections += 1
                self._m_busy.inc()
                return {"status": "busy",
                        "retry_after": self.busy_retry_after}
            if rnd > sess.round:
                sess.chunk_frames_future += 1
            key = (("agg", rnd, group, to_node) if op == "post_aggregate"
                   else ("avg", rnd, group))
            tr = sess.transfers.get(key)
            if tr is not None and tr.same_transfer(owner, xfer) \
                    and tr.posted:
                # at-least-once repeat of a completed transfer (e.g. a
                # final chunk re-sent after a lost ack): idempotent ack,
                # never a fresh buffer — PROTOCOL.md §6 repeat rule
                return {"seq": seq, "received": tr.asm.total,
                        "total": tr.asm.total, "complete": True}
            if (tr is not None and tr.owner == owner
                    and xfer < tr.xfer):
                # stale frame of this uploader's own ABANDONED stream
                # (xfer ids are monotone per uploader; a streaming
                # combine restarts under a fresh xfer after an upstream
                # identity change): discard — it must never clobber the
                # newer stream's buffer
                return {"seq": seq, "received": 0, "total": total,
                        "complete": False, "superseded": True}
            if (tr is not None and not tr.same_transfer(owner, xfer)
                    and tr.owner != owner
                    and not tr.posted
                    and now - tr.last_chunk_at < self.progress_timeout):
                # the slot is owned by a DIFFERENT uploader's transfer
                # that is still actively receiving chunks: discard this
                # frame instead of replacing the buffer (last-writer-
                # wins would let two interleaved uploads clobber each
                # other forever). The losing uploader sees `superseded`
                # and falls back to the protocol's own reset/timeout
                # path. An uploader's own NEWER xfer is exempt: it
                # always replaces its older stream (uploaders are
                # sequential — a new xfer for the slot is a deliberate
                # restart, e.g. a partial combine abandoned after a
                # repost upstream).
                return {"seq": seq, "received": 0, "total": total,
                        "complete": False, "superseded": True}
            if tr is None or not tr.same_transfer(owner, xfer) or tr.posted:
                # admission control (PROTOCOL.md §13): a NEW
                # transfer that would push the session's un-posted
                # backlog past its budget is shed with a retry hint —
                # the budget is per session, so a flooding tenant
                # throttles itself, never its neighbors. Continuation
                # chunks of an admitted transfer are always accepted
                # (completing a transfer *drains* the backlog), and a
                # session with an empty backlog is always admitted —
                # both rules together make the budget deadlock-free.
                if (self.chunk_budget_bytes is not None
                        and sess.pending_bytes > 0
                        and sess.pending_bytes + payload.nbytes
                        > self.chunk_budget_bytes):
                    sess.busy_rejections += 1
                    self._m_busy.inc()
                    return {"status": "busy",
                            "retry_after": self.busy_retry_after}
                # a new transfer identity replaces a posted or gone-
                # stale buffer for this slot (repost retry, next round)
                sess.forget_transfer(key)
                tr = _Transfer(owner, xfer, op, base, total, chunk_words,
                               now)
                sess.transfers[key] = tr
            if tr.asm.total != total or tr.chunk_words != chunk_words:
                raise wire.WireError(
                    "chunk total/chunk_words mismatch within transfer "
                    f"{xfer}")
            tr.last_chunk_at = now
            fresh = seq not in tr.asm.chunks
            done = tr.asm.add(seq, payload)
            if fresh and not tr.posted:
                tr.nbytes += payload.nbytes
                sess.pending_bytes += payload.nbytes
            if done and not tr.posted and rnd == sess.round:
                # current round: the logical op executes NOW. A future-
                # round transfer stays buffered (posted=False,
                # asm.complete=True) until advance_round delivers it —
                # the uploader still sees complete=True below: its
                # upload obligation is met either way.
                self._deliver_transfer(sess, tr)
            elif self.tracer.enabled and not done:
                self.tracer.record("chunk", now, self.now(),
                                   session=sess.sid, op=op, owner=owner,
                                   xfer=xfer, seq=seq)
            sess.cond.notify_all()
        return {"seq": seq, "received": len(tr.asm.chunks), "total": total,
                "complete": tr.posted or tr.asm.complete}

    def _deliver_transfer(self, sess: _Session, tr: _Transfer) -> None:
        """Execute a completed transfer's logical op (holds
        ``sess.cond``) — the only point MessageStats moves for a chunked
        upload. Called from ``_post_chunk`` on a current-round final
        chunk, and from ``advance_round`` for transfers that completed
        while their round was still parked."""
        tr.posted = True
        # the buffer leaves the backlog accounting the moment the
        # logical op executes (it stays in the table only as the §6
        # idempotency record)
        sess.pending_bytes -= tr.nbytes
        sess.transfers_completed += 1
        self._m_transfers.inc()
        if self.tracer.enabled:
            self.tracer.record("transfer", tr.created_at, self.now(),
                               session=sess.sid, op=tr.op, owner=tr.owner,
                               xfer=tr.xfer, chunks=tr.asm.total)
        call_kw = dict(tr.kwargs, now=self.now())
        field = "payload" if tr.op == "post_aggregate" else "average"
        call_kw[field] = tr.asm.assemble()
        sess.ctrl.call(tr.op, **call_kw)
        if tr.op == "post_average":
            self._note_post_average(sess)
        # the posted buffer stays (for post_average too, even though
        # averages are served from controller state): it is the
        # idempotency record that lets a repeated final chunk be
        # re-acked instead of re-executing the op

    async def _get_chunk(self, sess: _Session, kwargs: dict):
        """Long-poll for one chunk of an inbound array.

        ``kind=get_aggregate`` serves from the live transfer buffer the
        moment chunk ``seq`` has arrived (store-and-forward pipelining —
        the upload need not be complete), falling back to slicing a
        completed unchunked posting. ``kind=get_average`` slices the
        published global average. Never counted in MessageStats; the
        client issues the logical consume (with ``elide_payload``) after
        the last chunk."""
        kind = kwargs.get("kind")
        if kind not in ("get_aggregate", "get_average"):
            raise wire.WireError(f"get_chunk cannot serve {kind!r}")
        group = int(kwargs.get("group", 0))
        node = kwargs.get("node")
        round_kw = kwargs.get("round")
        seq = int(kwargs["seq"])
        words = int(kwargs.get("words", wire.DEFAULT_CHUNK_WORDS))
        if words < 1:
            raise wire.WireError(f"words must be >= 1, got {words}")
        timeout = kwargs.get("timeout")
        loop = asyncio.get_running_loop()
        deadline = None if timeout is None else loop.time() + float(timeout)

        def slice_of(arr: np.ndarray, extra: dict) -> dict:
            arr = np.asarray(arr).ravel()
            total = wire.num_chunks(arr.size, words)
            if seq >= total:
                raise wire.WireError(f"chunk seq {seq} >= total {total}")
            return dict(extra, seq=seq, total=total, last=seq == total - 1,
                        payload=wire.chunk_slice(arr, seq, words))

        # Every response carries the transfer identity (`xfer`): the
        # uploader's id for buffered streams, the posting/publication
        # timestamp for slices of stored arrays. A reader seeing the
        # identity change mid-stream knows the underlying array was
        # replaced (repost after §5.3, re-election after §5.4) and must
        # restart assembly — mixing chunks of two transfers would hand
        # the state machine a corrupt ciphertext.
        def probe():
            # §11 round routing: a reader tagged for a round within the
            # window streams straight out of that round's live buffer —
            # this is the cross-round relay (round r+1 chunks flow hop
            # to hop while round r is still open). Controller-state
            # fallbacks (stored postings, the published average) only
            # exist for the CURRENT round, so future-round readers park
            # on the buffer alone until advance_round catches up.
            rnd = sess.round if round_kw is None else int(round_kw)
            if kind == "get_aggregate":
                tr = sess.transfers.get(("agg", rnd, group, node))
                if tr is not None and seq in tr.asm.chunks:
                    if tr.chunk_words != words:
                        raise wire.WireError(
                            f"transfer chunk size {tr.chunk_words} != "
                            f"requested {words}")
                    out = {"seq": seq, "total": tr.asm.total,
                           "last": seq == tr.asm.total - 1,
                           "from_node": tr.kwargs.get("from_node"),
                           # full identity (owner, xfer): bare xfer
                           # counters collide across uploader processes
                           "xfer": ("u", tr.owner, tr.xfer),
                           "payload": tr.asm.chunks[seq]}
                    if tr.posted:
                        # the consume-guard timestamp (`expect_time`)
                        # for the logical read that follows — on EVERY
                        # post-completion chunk, because out-of-order
                        # refetches mean the client's final received
                        # chunk need not be seq total-1. `posted` (the
                        # §5.3 contributor count) rides along so the
                        # streaming unmask can start publishing average
                        # slices before the final consume.
                        peek = sess.ctrl.probe("get_aggregate", node=node,
                                               group=group)
                        if peek is not None:
                            out["time"] = float(peek["time"])
                            out["posted"] = int(peek["posted"])
                    return out
                if rnd != sess.round:
                    return None  # future round: only the buffer serves
                peek = sess.ctrl.probe("get_aggregate", node=node,
                                       group=group)
                if peek is not None:
                    return slice_of(peek["aggregate"],
                                    {"from_node": peek["from_node"],
                                     "time": float(peek["time"]),
                                     "posted": int(peek["posted"]),
                                     "xfer": ("t", float(peek["time"]),
                                              peek["from_node"])})
                return None
            if rnd != sess.round:
                return None  # the average of a parked round: not yet
            peek = sess.ctrl.try_get_average()
            if peek is None:
                return None
            t = float(peek.get("time", 0.0))
            return slice_of(peek["average"], {"time": t, "xfer": ("avg", t)})

        def guarded():
            if sess.closed:
                raise wire.WireError(f"session {sess.sid} deleted")
            res = probe()
            if res is not None:
                sess.chunk_frames_out += 1
                self._m_chunks_out.inc()
            return res

        res = await _park(sess.cond, guarded, deadline)
        return res if res is not None else {"status": "timeout"}

    async def _monitor_loop(self) -> None:
        """External progress monitor (§5.3) on the wall clock: scan every
        session for postings stuck longer than ``progress_timeout`` and
        order reposts around the dead target."""
        while True:
            await asyncio.sleep(self.monitor_interval)
            now = self.now()
            if self.engine is not None:
                # expire abandoned engine sessions even when no new
                # submissions arrive to trigger the on-submit prune
                self._prune_engine_sessions()
            for sess in list(self._sessions.values()):
                # per-session guard: one tenant's bad state (e.g. a
                # posting addressed outside its chain) must not kill
                # the monitor task and silently disable §5.3 failover
                # for every other tenant
                try:
                    if sess.bon is not None:
                        # BON tenants: the roster settles by wall time
                        # when dropouts leave Round 2 short — nothing
                        # else wakes the parked roster waits
                        async with sess.cond:
                            if sess.bon.maybe_close_roster(now):
                                sess.cond.notify_all()
                        continue
                    if sess.parent is not None:
                        # parent level (§5.10): a whole child org that
                        # never posts is elided on the aggregation
                        # timeout, exactly like a dead learner
                        async with sess.cond:
                            if sess.parent.maybe_elide(now):
                                sess.cond.notify_all()
                    async with sess.cond:
                        for group in sess.ctrl.groups:
                            stuck = sess.ctrl.stuck_posting(
                                group, now, self.progress_timeout)
                            if stuck is None:
                                continue
                            poster, failed = stuck
                            if sess.ctrl.order_repost(
                                    group, poster, failed) is None:
                                # stalled: the chain finished but its
                                # consumer died — the §5.4 election
                                # recovers; no repost was ordered
                                continue
                            # the dead target's chunk buffer dies with
                            # its posting — the repost streams afresh
                            # (current round only: the monitor can only
                            # see current-round postings)
                            sess.forget_transfer(
                                ("agg", sess.round, group, failed))
                            sess.monitor_reposts += 1
                            self._m_reposts.inc()
                            sess.cond.notify_all()
                except asyncio.CancelledError:
                    raise
                except Exception:  # noqa: BLE001
                    self.monitor_errors += 1
                    continue

    # ------------------------------------------------------------------
    # engine plane
    # ------------------------------------------------------------------
    def _require_engine(self):
        if self.engine is None:
            raise wire.WireError("broker started without an engine")
        return self.engine

    def _prune_engine_sessions(self) -> None:
        """Drop completed-but-never-claimed sessions past the TTL (and
        with them their flattened-result cache and any staged chunk
        uploads abandoned mid-stream)."""
        now = asyncio.get_running_loop().time()
        cutoff = now - self.engine_session_ttl
        for sid, done_at in list(self._engine_done.items()):
            if done_at < cutoff:
                self._engine_done.pop(sid, None)
                self._engine_sessions.pop(sid, None)
                self._engine_host.pop(sid, None)
                self._engine_flat.pop(sid, None)
        for key, ent in list(self._engine_uploads.items()):
            if ent["at"] < cutoff:
                del self._engine_uploads[key]

    def _engine_results(self, sid: int, sess) -> list:
        """A finished session's results as host f32 arrays, copied off
        the engine's device once and cached. The port's engine keeps
        them as torch tensors on its device (the card by default), which
        numpy cannot read in place."""
        host = self._engine_host.get(sid)
        if host is None:
            host = [np.asarray(r.detach().cpu() if hasattr(r, "detach")
                               else r, np.float32) for r in sess.results]
            self._engine_host[sid] = host
        return host

    def _submit_session(self, kwargs: dict) -> dict:
        engine = self._require_engine()
        self._prune_engine_sessions()
        values = np.asarray(kwargs["values"], np.float32)
        weights = kwargs.get("weights")
        alive = kwargs.get("alive")
        # validate at the RPC boundary what engine.submit doesn't (it
        # only checks values.shape): a wrong-length alive/weights array
        # would otherwise blow up inside a later step() and take the
        # engine loop down for every tenant
        for name, arr in (("alive", alive), ("weights", weights)):
            if arr is not None and np.asarray(arr).shape != (engine.n,):
                raise wire.WireError(
                    f"{name} must have shape ({engine.n},), got "
                    f"{np.asarray(arr).shape}")
        rounds = int(kwargs.get("rounds", 1))
        sess = engine.submit(
            values,
            rounds=rounds,
            provisioning_seed=int(kwargs.get("provisioning_seed", 0xC0FFEE)),
            learner_master=int(kwargs.get("learner_master", 0x5EED)),
            alive=None if alive is None else np.asarray(alive, np.float32),
            weights=None if weights is None else np.asarray(weights,
                                                            np.float32),
            rotate0=int(kwargs.get("rotate0", 0)))
        self._engine_sessions[sess.sid] = sess
        self._engine_wake.set()
        return {"sid": sess.sid}

    async def _wait_session(self, kwargs: dict):
        self._require_engine()
        sid = int(kwargs["sid"])
        sess = self._engine_sessions.get(sid)
        if sess is None:
            raise wire.WireError(f"unknown engine session {sid}")
        timeout = kwargs.get("timeout")
        elide = bool(kwargs.get("elide_results", False))
        loop = asyncio.get_running_loop()
        deadline = None if timeout is None else loop.time() + float(timeout)
        # completion is signalled by the engine's on_complete hook
        # (fires inside step(), before the post-step notify)
        done = await _park(
            self._engine_cond,
            lambda: (sid in self._engine_done or sess.done) or None,
            deadline)
        if done is None:
            return {"status": "timeout"}
        # NOT evicted here: if the response fails to frame/send, the
        # tenant can re-issue wait_session (idempotent read); eviction
        # happens via the engine_session_ttl prune after completion
        if elide:
            # chunk-aware client: it streamed (or will stream) the
            # results via get_chunk kind=wait_session — the completion
            # handshake travels without the bulk arrays
            return {"status": "done", "rounds": sess.rounds_done,
                    "results": None, "chunked": True}
        results = self._engine_results(sid, sess)
        if sum(int(r.size) for r in results) * 4 > wire.MAX_FRAME - 4096:
            raise wire.WireError(
                f"wait_session results for sid={sid} exceed one frame; "
                f"fetch them chunked (get_chunk kind=wait_session, then "
                f"wait_session with elide_results)")
        return {"status": "done", "rounds": sess.rounds_done,
                "results": results}

    def _post_engine_chunk(self, kwargs: dict):
        """One chunk of an oversized submit_session values upload. On
        the final chunk the reassembled flat f32 vector is reshaped to
        (engine.n, V) and submitted — the ack then carries the ``sid``.
        Repeats after completion re-ack the same sid (idempotent)."""
        engine = self._require_engine()
        owner = int(kwargs.get("node", 0))
        xfer = int(kwargs["xfer"])
        seq = int(kwargs["seq"])
        total = int(kwargs["total"])
        chunk_words = int(kwargs["chunk_words"])
        payload = kwargs.get("payload")
        if not isinstance(payload, np.ndarray) or payload.ndim != 1:
            raise wire.WireError("post_chunk payload must be a flat array")
        self.engine_chunk_frames_in += 1
        key = (owner, xfer)
        ent = self._engine_uploads.get(key)
        if ent is not None and ent["sid"] is not None:
            return {"seq": seq, "received": ent["asm"].total,
                    "total": ent["asm"].total, "complete": True,
                    "sid": ent["sid"]}
        if ent is None:
            meta = {k: v for k, v in kwargs.items()
                    if k not in ("payload", "op", "xfer", "seq", "total",
                                 "chunk_words", "node", "session")}
            ent = {"asm": wire.ChunkAssembler(total),
                   "chunk_words": chunk_words, "meta": meta, "sid": None,
                   "at": asyncio.get_running_loop().time()}
            self._engine_uploads[key] = ent
        if ent["asm"].total != total or ent["chunk_words"] != chunk_words:
            raise wire.WireError(
                f"chunk total/chunk_words mismatch within transfer {xfer}")
        ent["at"] = asyncio.get_running_loop().time()
        done = ent["asm"].add(seq, payload)
        res = {"seq": seq, "received": len(ent["asm"].chunks),
               "total": total, "complete": done}
        if done:
            flat = ent["asm"].assemble().astype(np.float32, copy=False)
            if flat.size % engine.n:
                raise wire.WireError(
                    f"submit values of {flat.size} words do not divide "
                    f"into {engine.n} learners")
            values = flat.reshape(engine.n, flat.size // engine.n)
            sub = self._submit_session(dict(ent["meta"], values=values))
            ent["sid"] = sub["sid"]
            res["sid"] = sub["sid"]
        return res

    async def _get_engine_chunk(self, kwargs: dict):
        """Long-poll for one chunk of a completed engine session's
        results, flattened round-major (rounds × V f32). Never counted;
        the client issues ``wait_session`` with ``elide_results`` for
        the completion handshake."""
        self._require_engine()
        sid = int(kwargs["sid"])
        seq = int(kwargs["seq"])
        words = int(kwargs.get("words", wire.DEFAULT_CHUNK_WORDS))
        if words < 1:
            raise wire.WireError(f"words must be >= 1, got {words}")
        sess = self._engine_sessions.get(sid)
        if sess is None:
            raise wire.WireError(f"unknown engine session {sid}")
        timeout = kwargs.get("timeout")
        loop = asyncio.get_running_loop()
        deadline = None if timeout is None else loop.time() + float(timeout)

        def probe():
            if not (sid in self._engine_done or sess.done):
                return None
            flat = self._engine_flat.get(sid)
            if flat is None:
                host = self._engine_results(sid, sess)
                flat = (np.concatenate([r.ravel() for r in host])
                        if host else np.empty(0, np.float32))
                self._engine_flat[sid] = flat
            total = wire.num_chunks(flat.size, words)
            if seq >= total:
                raise wire.WireError(f"chunk seq {seq} >= total {total}")
            self.engine_chunk_frames_out += 1
            return {"seq": seq, "total": total, "last": seq == total - 1,
                    "rounds": sess.rounds_done,
                    "payload": wire.chunk_slice(flat, seq, words)}

        res = await _park(self._engine_cond, probe, deadline)
        return res if res is not None else {"status": "timeout"}

    async def _engine_loop(self) -> None:
        """Step the engine while work is queued. ``step()`` runs on the
        loop thread — one batched round of kernel launches per step — with a
        ``sleep(0)`` between steps so submissions/waiters interleave."""
        engine = self.engine
        while True:
            await self._engine_wake.wait()
            self._engine_wake.clear()
            while engine.queue or engine.active:
                try:
                    engine.step()
                except asyncio.CancelledError:
                    raise
                except Exception:  # noqa: BLE001 — keep the plane alive
                    # a poisoned step must not silently kill the loop
                    # for every tenant; back off so a persistently
                    # failing step can't busy-spin
                    self.engine_errors += 1
                    await asyncio.sleep(self.monitor_interval)
                async with self._engine_cond:
                    self._engine_cond.notify_all()
                await asyncio.sleep(0)
