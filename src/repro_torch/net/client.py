"""Wire-plane learner runtime: the SAFE state machines over asyncio.

Drives the *identical* generator coroutines from
:mod:`repro_torch.core.machines` — the ones the discrete-event kernel runs in
virtual time — over a real TCP transport to :class:`~repro_torch.net.broker.
SafeBroker`, mapping each yield onto awaits:

  ("compute", seconds)          -> optional scaled ``asyncio.sleep``
  ("call", op, kwargs, nbytes)  -> one request/response RPC
  ("wait", kind, kwargs, nbytes, timeout)
                                -> long-poll RPC; the broker parks the
                                   request until data or timeout
  ("stream", ...), ("unmask", ...)
                                -> fused chunk-granular hops: receive+
                                   combine+post (non-initiator) and
                                   receive+unmask+publish (initiator),
                                   overlapped chunk-by-chunk; both lower
                                   to the plain wait when unchunked

Because the machines, the ``Controller`` and the round construction
(:func:`~repro_torch.core.machines.build_round_machines`) are shared with the
sim, the published average here is bit-identical to the sim's for the
same seeds/topology, and the ``MessageStats`` counters still satisfy
§5's closed forms (asserted in ``tests/test_net.py``).

Payloads larger than ``chunk_words`` stream over the chunked transfer
plane (docs/PROTOCOL.md §6) transparently: the runtime splits uploads
into ``post_chunk`` frames and pulls downloads chunk-by-chunk via
``get_chunk`` — with one request kept in flight ahead of the chunk
being processed, and the broker relaying chunks downstream before the
upload completes, so chain hops overlap the way the §8 pipelined
schedule overlaps segments. The state machines never see chunks: the
logical consume still happens (with ``elide_payload`` so the bulk bytes
travel exactly once) and the reassembled array is injected into its
response, keeping bits and §5 message counts identical to the
unchunked path.

Faults are injected at this layer via :mod:`repro_torch.net.faults`
interceptors — latency, request drops (with at-most-once retry: a
dropped frame never reached the broker), and crash/churn schedules.

:func:`run_federated_round_net` is the training entry point: each
learner runs a real local FedAvg step (an injected callable, so this
module stays numpy-only) and ships its model delta through the broker.
``repro_torch.train.make_wire_federated`` makes those callables from a
model: each runs the local steps on the model's device and hands back a
numpy delta.

The PyTorch port's copy of the JAX package's ``net/client.py``, with the same
semantics.
"""
from __future__ import annotations

import asyncio
import collections
import dataclasses
import itertools
import time
from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np

from repro_torch.core.bon_machines import build_bon_machines
from repro_torch.core.bon_protocol import bon_expected_messages
from repro_torch.core.costs import CostModel, EDGE
from repro_torch.core.machines import LearnerCrypto, LearnerGen, build_round_machines
from repro_torch.core.session import RoundCursor
from repro_torch.net import wire
from repro_torch.net.faults import DropPacket, Interceptor, LearnerCrashed
from repro_torch.topology import RingTopology

Addr = Tuple[str, int]

#: auto-chunk threshold: payloads above this many elements stream even
#: when the caller didn't ask for chunking (4·8M = 32 MiB of uint32 —
#: half of MAX_FRAME, so headers/retries never graze the frame cap).
AUTO_CHUNK_WORDS = 8 << 20

#: adaptive chunk sizing targets this many chunks per payload — enough
#: for the §8 pipeline to overlap transfer and crypto, few enough that
#: per-chunk framing overhead stays negligible.
AUTO_CHUNK_TARGET = 8

_xfer_ids = itertools.count(1)


class ShardDeadError(wire.WireError):
    """The session's owning shard worker is gone (PROTOCOL.md §12):
    the dispatcher refused the session as unavailable, a redirect dialed
    a dead worker's port, or the worker's socket closed under a live
    request. Sessions never migrate (no rebalancing), so the one
    deterministic recovery is to create a FRESH session — which a
    surviving shard will own — and re-run the round (tested end-to-end
    in the JAX package's tests/test_shard.py, whose load harness tenants
    do exactly this).
    Subclasses :class:`~repro_torch.net.wire.WireError`, so callers that treat
    shard death as any other broker failure keep working."""


def backoff_delay(attempt: int, *, base: float, cap: float = 0.5,
                  seed: int = 0) -> float:
    """Capped exponential backoff with deterministic jitter.

    ``base * 2**attempt`` capped at ``cap``, scaled by a multiplicative
    jitter in ``[0.5, 1.0)`` derived from a Knuth hash of
    ``(seed, attempt)`` — NOT from a global RNG, so fault-injection
    tests replay the exact same sleep schedule run after run. Shared by
    the drop-retry loop (:meth:`WireClient._send`) and the
    busy/retry-after loop (:meth:`WireClient.request`); ``seed`` is the
    node id, so co-tenant learners desynchronize instead of
    thundering-herding the broker on the same tick.
    """
    h = ((seed * 1_000_003 + attempt) * 2_654_435_761) & 0xFFFFFFFF
    return min(cap, base * (1 << min(attempt, 16))) * (0.5 + h / 2**33)


def auto_chunk_words(payload_words: int,
                     cost: Optional[CostModel] = None) -> int:
    """Derive a chunk size from the payload size,
    optionally floored by the link's bandwidth-delay product.

    Targets :data:`AUTO_CHUNK_TARGET` chunks per payload, clamped to a
    multiple of ``wire.MIN_STREAM_WORDS`` (so the streaming combine's
    small-chunk regression regime is never entered) and capped at
    ``wire.DEFAULT_CHUNK_WORDS`` (so no chunk approaches the frame
    limit). Payloads at or below one ``MIN_STREAM_WORDS`` quantum come
    back larger than the payload — i.e. unchunked, which is faster for
    small vectors (BENCH_streaming.json's small-n ablation).

    With a fitted :class:`~repro_torch.core.costs.CostModel`, the target is
    additionally floored at the link's bandwidth-delay product —
    ``t_msg`` is the per-message round trip and ``1/t_byte`` the
    bandwidth, so ``t_msg/t_byte`` bytes (÷8 for the 8-byte fixed-point
    words) is the smallest chunk that keeps the pipe full: any smaller
    and each chunk's ack round-trip outweighs its transfer time, which
    is exactly the regime the 50 ms WAN profile's fixed-8192 ablation
    sits in (BENCH_streaming.json's WAN row). On the stock EDGE model
    the BDP floor (~1.7k words) sits below one ``MIN_STREAM_WORDS``
    quantum, so LAN-scale sizing is unchanged.
    """
    target = -(-int(payload_words) // AUTO_CHUNK_TARGET)  # ceil div
    if cost is not None:
        bdp_words = cost.t_msg / cost.t_byte / 8.0
        target = max(target, int(bdp_words))
    quanta = max(1, round(target / wire.MIN_STREAM_WORDS))
    return min(quanta * wire.MIN_STREAM_WORDS, wire.DEFAULT_CHUNK_WORDS)


def _resolve_chunk_words(chunk_words, payload_words: int,
                         cost: Optional[CostModel] = None):
    """The shared chunk-size defaulting rule: ``"auto"`` derives from
    the payload and the link's cost model (RTT-aware — see
    :func:`auto_chunk_words`); ``None`` stays unchunked until the
    payload clears ``AUTO_CHUNK_WORDS`` and then derives the same way
    (which at that scale is exactly ``wire.DEFAULT_CHUNK_WORDS`` — the
    legacy fixed default, so existing byte-level expectations hold); an
    int is taken as-is."""
    if chunk_words == "auto":
        return auto_chunk_words(payload_words, cost)
    if chunk_words is None and payload_words > AUTO_CHUNK_WORDS:
        return auto_chunk_words(payload_words, cost)
    return chunk_words


class WireClient:
    """One connection to the broker; one outstanding request at a time
    (the learner state machines are strictly sequential). The chunk
    loops below briefly keep a second request in flight — that is safe
    on the same connection because the broker answers frames in order."""

    def __init__(self, host: str, port: int, node: int = 0,
                 interceptor: Optional[Interceptor] = None,
                 retry_backoff: float = 0.02,
                 token: Optional[str] = None, ssl=None):
        self.host = host
        self.port = port
        self.node = node
        self.interceptor = interceptor
        self.retry_backoff = retry_backoff
        # transport hardening (PROTOCOL.md §15): the bearer token stamped
        # onto every session-addressed request. Learned automatically
        # from create_session / reset_round responses on this connection,
        # or set explicitly (a learner client carries its own node token)
        self.token = token
        #: per-node token grant from the last create_session/reset_round
        #: this client performed (the admin redistributes these)
        self.node_tokens: Optional[dict] = None
        # optional TLS: an ssl.SSLContext (or True for default verify)
        # handed to open_connection
        self._ssl = ssl
        self.bytes_sent = 0
        self.bytes_received = 0
        self.requests = 0
        self.chunk_frames = 0
        self.streamed_combines = 0
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._aux: Optional["WireClient"] = None

    async def connect(self) -> "WireClient":
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port, ssl=self._ssl)
        return self

    def set_token(self, token: Optional[str]) -> None:
        """Adopt a (possibly rotated) bearer token — aux channel
        included, so a streaming combine started after a reset_round
        rotation authenticates on both connections."""
        self.token = token
        if self._aux is not None:
            self._aux.token = token

    @property
    def total_bytes_sent(self) -> int:
        """Bytes sent including a still-open aux channel (whose counters
        only fold into this client on close)."""
        return self.bytes_sent + (
            self._aux.bytes_sent if self._aux is not None else 0)

    async def aux(self) -> "WireClient":
        """Lazily-connected second connection to the same broker — the
        upload channel of the streaming combine (inbound chunks arrive
        on this connection while outbound chunks ship on the aux one, so
        neither direction queues behind the other's responses). Shares
        the node id and interceptor (churn schedules count ops across
        both), and folds its byte counters into this client on close."""
        if self._aux is None:
            self._aux = await WireClient(
                self.host, self.port, node=self.node,
                interceptor=self.interceptor,
                retry_backoff=self.retry_backoff,
                token=self.token, ssl=self._ssl).connect()
        return self._aux

    async def close(self) -> None:
        if self._aux is not None:
            aux, self._aux = self._aux, None
            await aux.close()
            self.bytes_sent += aux.bytes_sent
            self.bytes_received += aux.bytes_received
            self.requests += aux.requests
            self.chunk_frames += aux.chunk_frames
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except Exception:  # noqa: BLE001
                pass
            self._writer = None
            self._reader = None

    # -- low-level halves (chunk pipelining needs send/recv split) --------
    async def _send(self, op: str, kwargs: dict) -> None:
        """Fire one request frame, interceptor-gated (drops retry here —
        the frame never left, so resending is at-most-once). Sent as a
        scatter-gather parts list (PROTOCOL.md §12): bulk array payloads
        go to the socket from where they already live, uncopied."""
        if self.token is not None and "session" in kwargs \
                and "token" not in kwargs:
            # §15: stamp the bearer token onto every session-addressed
            # request (a copy — the caller's kwargs stay replayable)
            kwargs = dict(kwargs, token=self.token)
        framed = wire.encode_frame_parts(
            wire.encode_request_parts(op, kwargs))
        nbytes = wire.parts_nbytes(framed)
        attempt = 0
        while True:
            if self.interceptor is not None:
                try:
                    await self.interceptor.on_request(
                        self.node, op, nbytes)
                except DropPacket:
                    # capped exponential + deterministic jitter: a bursty
                    # drop schedule stops hammering the loop, and the
                    # schedule replays exactly (seeded by node id)
                    await asyncio.sleep(backoff_delay(
                        attempt, base=self.retry_backoff, seed=self.node))
                    attempt += 1
                    continue
            self._writer.writelines(framed)
            await self._writer.drain()
            self.bytes_sent += nbytes
            self.requests += 1
            return

    async def _recv(self, op: str) -> Any:
        try:
            resp = await wire.read_frame(self._reader)
        except (ConnectionResetError, asyncio.IncompleteReadError) as exc:
            # the worker died mid-request — deterministic surface
            # instead of a raw OSError escaping the learner task
            raise ShardDeadError(
                f"connection lost mid-{op} (worker dead?): {exc}") from exc
        if resp is None:
            raise ShardDeadError(
                f"broker closed the connection mid-{op}")
        self.bytes_received += len(resp) + 4
        if self.interceptor is not None:
            await self.interceptor.on_response(self.node, op, len(resp) + 4)
        try:
            return wire.decode_response(resp)
        except wire.WireError as exc:
            # the §12 dispatcher names a dead owner in its error — map
            # it onto the typed surface the recovery path switches on
            if "is dead" in str(exc):
                raise ShardDeadError(str(exc)) from exc
            raise

    async def redirect(self, port: int) -> None:
        """Move this client (and any aux channel) to another broker
        port — the §12 shard redirect. Subsequent requests, including
        the split-send chunk loops, dial the new port."""
        if self._aux is not None:
            aux, self._aux = self._aux, None
            await aux.close()
            self.bytes_sent += aux.bytes_sent
            self.bytes_received += aux.bytes_received
            self.requests += aux.requests
            self.chunk_frames += aux.chunk_frames
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except Exception:  # noqa: BLE001
                pass
        self.port = int(port)
        try:
            await self.connect()
        except OSError as exc:
            # a dead shard worker's port refuses/RSTs — surface a clear
            # error instead of letting the raw OSError (or a hang on a
            # half-open socket) escape to the learner task
            raise ShardDeadError(
                f"redirect to port {port} failed — shard worker "
                f"unreachable (dead?): {exc}") from exc

    async def request(self, op: str, kwargs: dict) -> Any:
        """One RPC. A DropPacket from the interceptor loses the frame
        *before* transmission; we back off and retry (safe: the broker
        never saw it). LearnerCrashed propagates to the runtime.

        A ``{"status": "redirect", "port": p}`` response (a sharded
        broker, PROTOCOL.md §12) reconnects to the owning shard and
        replays the request — sessions never migrate, so at most one
        hop settles every subsequent op onto the right worker.

        A ``{"status": "busy", "retry_after": t}`` response (admission
        control, PROTOCOL.md §13) sleeps at least ``retry_after`` —
        raised to the capped-exponential backoff as rejections repeat —
        then replays the same frame. The broker rejected it wholesale
        (nothing was buffered), so the replay is exact-once in effect."""
        await self._send(op, kwargs)
        res = await self._recv(op)
        hops = 0
        attempt = 0
        while isinstance(res, dict):
            if (res.get("status") == "redirect"
                    and res.get("port") is not None):
                hops += 1
                if hops > 4:
                    raise wire.WireError(
                        f"redirect loop for {op} (port {res.get('port')})")
                await self.redirect(int(res["port"]))
            elif res.get("status") == "busy":
                await asyncio.sleep(max(
                    float(res.get("retry_after") or 0.0),
                    backoff_delay(attempt, base=self.retry_backoff,
                                  seed=self.node)))
                attempt += 1
            else:
                break
            await self._send(op, kwargs)
            res = await self._recv(op)
        if op in ("create_session", "reset_round") \
                and isinstance(res, dict) and res.get("token") is not None:
            # §15: adopt the (possibly rotated) session token and hold
            # the per-node grant for the caller to redistribute
            self.token = res["token"]
            self.node_tokens = res.get("node_tokens")
            if self._aux is not None:
                self._aux.token = self.token
        return res

    # -- chunked transfer plane (docs/PROTOCOL.md §6) ---------------------
    async def post_chunked(self, op: str, kwargs: dict, payload_field: str,
                           session: int, chunk_words: int) -> None:
        """Upload one logical post as a chunk stream. Keeps one frame in
        flight ahead of the previous response, so the broker can relay
        chunk k downstream while chunk k+1 is still on this socket.

        An upload the broker supersedes or drops mid-stream (the round
        reset under us, or another active transfer owns the slot) is
        swallowed, not raised: the state machine's own
        ``check_aggregate`` / timeout path observes that the post never
        landed and recovers through the §5.3/§5.4 machinery — exactly
        as it would for an unchunked post lost to a reset.

        A chunk refused by admission control (``status: "busy"``,
        PROTOCOL.md §13 — only possible while this transfer has nothing
        buffered yet, since continuations are always admitted) is noted
        and replayed after the pipelined pass: the replay rides
        :meth:`request`, whose busy loop honors ``retry_after``, and
        once ONE chunk lands the rest are continuations."""
        arr = np.ascontiguousarray(kwargs[payload_field]).ravel()
        total = wire.num_chunks(arr.size, chunk_words)
        meta = {k: v for k, v in kwargs.items() if k != payload_field}
        xfer = next(_xfer_ids)
        busy: list = []

        def frame(seq: int) -> dict:
            return dict(meta, session=session, op=op, xfer=xfer, seq=seq,
                        total=total, chunk_words=chunk_words,
                        payload=wire.chunk_slice(arr, seq, chunk_words))

        await self._send("post_chunk", frame(0))
        for seq in range(1, total):
            await self._send("post_chunk", frame(seq))
            self.chunk_frames += 1
            res = await self._recv("post_chunk")  # ack of frame(seq-1)
            if res.get("status") == "busy":
                busy.append(seq - 1)
            elif res.get("superseded"):
                # drain the frame already in flight, then stop wasting
                # bytes — this upload lost its slot
                self.chunk_frames += 1
                await self._recv("post_chunk")
                return
        self.chunk_frames += 1
        res = await self._recv("post_chunk")  # ack of the last frame
        if res.get("status") == "busy":
            busy.append(total - 1)
        elif res.get("superseded"):
            return
        for seq in busy:
            res = await self.request("post_chunk", frame(seq))
            self.chunk_frames += 1
            if res.get("superseded"):
                return

    async def _chunk_stream(self, kind: str, kwargs: dict, session: int,
                            chunk_words: int, deadline: Optional[float],
                            depth: int, on_chunk=None, on_restart=None,
                            on_meta=None):
        """Shared inbound chunk pump: pull one logical array chunk-by-
        chunk with up to ``depth`` get_chunk requests in flight ahead of
        the chunk being processed (requests for the lowest missing seqs;
        responses come back in request order on this connection).

        ``on_chunk(seq, payload, from_node, total)`` fires (awaited) for
        every chunk first seen under the current transfer identity — the
        streaming combine's hook. An identity change mid-stream (the
        array was reposted / re-elected away) restarts assembly and
        fires ``on_restart()`` so a partially-combined buffer is
        abandoned, never mixed across identities. ``on_meta(res)`` fires
        (sync) with each raw chunk response of the current identity —
        the streaming unmask reads the broker's post-completion
        ``posted`` count off it.

        Returns ``(assembler, consume_guard_time)`` on completion or a
        ``{"status": "timeout"}`` dict when the deadline lapses."""
        loop = asyncio.get_running_loop()

        def remaining() -> Optional[float]:
            return None if deadline is None else deadline - loop.time()

        def chunk_req(seq: int) -> dict:
            return dict(kwargs, session=session, kind=kind, seq=seq,
                        words=chunk_words, timeout=remaining())

        async def drain(inflight) -> None:
            for _ in range(len(inflight)):
                await self._recv("get_chunk")
                self.chunk_frames += 1
            inflight.clear()

        asm: Optional[wire.ChunkAssembler] = None
        xid: Any = None
        tid: Any = None  # consume-guard timestamp of the current identity
        inflight: collections.deque = collections.deque()
        cursor = 1  # lowest seq never requested under the current identity
        await self._send("get_chunk", chunk_req(0))
        inflight.append(0)
        while True:
            rem = remaining()
            if rem is not None and rem <= 0:
                await drain(inflight)  # each request carried a deadline
                return {"status": "timeout"}
            res = await self._recv("get_chunk")
            inflight.popleft()
            self.chunk_frames += 1
            if res.get("status") == "timeout":
                await drain(inflight)
                return res
            if (asm is None or res.get("xfer") != xid
                    or int(res["total"]) != asm.total):
                # first chunk — or the transfer identity changed under
                # us (the array was reposted / re-elected away):
                # restart assembly rather than mix two transfers
                restarted = asm is not None
                asm = wire.ChunkAssembler(int(res["total"]))
                xid = res.get("xfer")
                tid = None
                cursor = 0
                if restarted and on_restart is not None:
                    on_restart()
            if on_meta is not None:
                on_meta(res)
            if res.get("time") is not None:
                tid = res["time"]
            seq = int(res["seq"])
            fresh = seq not in asm.chunks
            done = asm.add(seq, res["payload"])
            if fresh and on_chunk is not None:
                await on_chunk(seq, res["payload"], res.get("from_node"),
                               asm.total)
            if done:
                if inflight:  # stale prefetches from before a restart
                    await drain(inflight)
                return asm, tid
            # top the pipeline up to `depth`; the ascending cursor finds
            # the lowest unrequested chunk in O(1) amortized (it only
            # rewinds on an identity restart, where the in-flight checks
            # keep requests unique), and each request rides ahead of the
            # broker-side wait (and, in the streaming combine, of the
            # chunk's crypto)
            while len(inflight) < depth:
                while cursor < asm.total and (cursor in asm.chunks
                                              or cursor in inflight):
                    cursor += 1
                if cursor >= asm.total:
                    break
                await self._send("get_chunk", chunk_req(cursor))
                inflight.append(cursor)
                cursor += 1

    async def get_chunked(self, kind: str, kwargs: dict, session: int,
                          chunk_words: int, deadline: Optional[float],
                          depth: int = wire.DEFAULT_PREFETCH_DEPTH) -> Any:
        """Pull one logical array as a chunk stream, then issue the
        logical consume (``elide_payload=True``) and inject the
        reassembled array into its response. Returns the consume
        response, or ``{"status": "timeout"}`` when the deadline lapses
        mid-stream (matching the plain long-poll contract)."""
        got = await self._chunk_stream(kind, kwargs, session, chunk_words,
                                       deadline, depth)
        if isinstance(got, dict):
            return got  # timeout
        asm, tid = got
        loop = asyncio.get_running_loop()
        # the logical consume, guarded by the streamed entry's
        # timestamp: the broker refuses to consume (and elide) any
        # OTHER posting — a reset racing us parks into the normal
        # timeout path instead of corrupting the round
        final = await self.request(kind, dict(
            kwargs, session=session, elide_payload=True,
            expect_time=tid,
            timeout=None if deadline is None else deadline - loop.time()))
        if final.get("status") == "timeout":
            return final
        field = "aggregate" if kind == "get_aggregate" else "average"
        return dict(final, **{field: asm.assemble()})

    async def stream_combine(self, skwargs: dict, session: int,
                             chunk_words: int, deadline: Optional[float],
                             depth: int = wire.DEFAULT_PREFETCH_DEPTH,
                             round_tag: Optional[int] = None) -> Any:
        """The fused §5.1.2 hop: pull the inbound aggregate chunk-by-
        chunk and, per chunk, run the machine's combine closure
        (seekable-pad decrypt + add + re-encrypt) and ship the result
        downstream via ``post_chunk`` on the aux connection — chunk k's
        crypto and upload overlap chunk k+1's transfer, and the broker
        relays uploaded chunks onward before this upload completes (§8's
        pipelined schedule end-to-end on the wire).

        Resolves the machine's ``("stream", ...)`` yield with
        ``{"status": "streamed", "combined": <plaintext partial>,
        "uploaded": bool, ...consume fields...}``. An upstream identity
        change restarts the combine under a fresh upload xfer (the
        broker replaces our own older stream; stale frames can't clobber
        it); a superseded upload degrades to ``uploaded=False`` and the
        machine posts the whole vector itself. Timeouts match the plain
        long-poll contract."""
        node = skwargs["node"]
        group = skwargs["group"]
        to_node = skwargs["to_node"]
        combine = skwargs["combine"]
        up = await self.aux()
        loop = asyncio.get_running_loop()

        rkw = {} if round_tag is None else {"round": round_tag}
        st = {"xfer": next(_xfer_ids), "dead": False, "complete": False,
              "sent": 0}
        acks: collections.deque = collections.deque()  # xfer per sent frame
        combs: Dict[int, np.ndarray] = {}

        async def drain_ack() -> None:
            ack = await up._recv("post_chunk")
            up.chunk_frames += 1
            xf = acks.popleft()
            if xf != st["xfer"]:
                return  # ack of an abandoned stream
            if ack.get("superseded") or ack.get("status") == "busy":
                # lost the slot — or admission control refused the
                # stream (§13). Either way stop uploading; the machine
                # falls back to posting the whole vector itself, and
                # THAT path retries busy via request()
                st["dead"] = True
            elif ack.get("complete"):
                st["complete"] = True

        async def on_chunk(seq, payload, src, total) -> None:
            out, comb = combine(seq * chunk_words, payload, src)
            combs[seq] = comb
            if st["dead"]:
                return
            await up._send("post_chunk", dict(
                rkw, session=session, op="post_aggregate", xfer=st["xfer"],
                seq=seq, total=total, chunk_words=chunk_words,
                from_node=node, to_node=to_node, group=group,
                payload=out))
            acks.append(st["xfer"])
            st["sent"] += 1
            while len(acks) > depth:
                await drain_ack()

        def on_restart() -> None:
            # upstream identity changed under a partial combine: abandon
            # it — fresh upload xfer (replaces our older stream at the
            # broker), fresh plaintext buffer
            combs.clear()
            st.update(xfer=next(_xfer_ids), dead=False, complete=False,
                      sent=0)

        got = await self._chunk_stream(
            "get_aggregate", dict(rkw, node=node, group=group), session,
            chunk_words, deadline, depth, on_chunk=on_chunk,
            on_restart=on_restart)
        while acks:
            await drain_ack()
        if isinstance(got, dict):
            return got  # timeout (partial upload is left to go stale)
        asm, tid = got
        uploaded = (st["complete"] and not st["dead"]
                    and st["sent"] == asm.total)
        # the counted consume of the inbound posting, expect_time-guarded
        # exactly like the buffered path
        final = await self.request("get_aggregate", dict(
            rkw, node=node, group=group, session=session,
            elide_payload=True, expect_time=tid,
            timeout=None if deadline is None else deadline - loop.time()))
        if final.get("status") == "timeout":
            return final
        if uploaded:
            self.streamed_combines += 1
        combined = np.concatenate([combs[s] for s in range(asm.total)])
        return dict(final, status="streamed", combined=combined,
                    uploaded=uploaded)

    async def unmask_stream(self, ukwargs: dict, session: int,
                            chunk_words: int, deadline: Optional[float],
                            depth: int = wire.DEFAULT_PREFETCH_DEPTH,
                            round_tag: Optional[int] = None) -> Any:
        """The fused §5.1.1 initiator tail: pull the final hop's
        aggregate chunk-by-chunk and, per chunk, run the machine's
        unmask closure (hop decrypt + subtract the R slice + decode) —
        then, the moment the posting's contributor count is known
        (``posted`` rides the broker's post-completion chunk
        responses), publish the decoded average chunk-by-chunk via
        ``post_chunk`` on the aux connection. Chunk k's unmask and
        publish overlap chunk k+1's last hop, so the round's published
        average starts shipping while the tail of the aggregate is
        still on the wire — the §8 pipeline extended through the
        initiator's own endpoint.

        Resolves the machine's ``("unmask", ...)`` yield with
        ``{"status": "unmasked", "decoded": <plaintext>, "posted": k,
        "published": bool, ...consume fields...}``. Each published
        average chunk is ``decoded_chunk / posted`` — elementwise, so
        the assembled average is bit-identical to the machine's own
        whole-vector ``dec / posted``. A superseded or refused
        publication (or a ``posted`` count that only arrives with the
        consume — e.g. a round still parked behind the §11 window)
        degrades to ``published=False`` and the machine posts the whole
        average itself; an upstream identity change restarts the decode
        under a fresh upload xfer. Timeouts match the plain long-poll
        contract (the machine's §5.4 election path)."""
        node = ukwargs["node"]
        group = ukwargs["group"]
        unmask = ukwargs["unmask"]
        up = await self.aux()
        loop = asyncio.get_running_loop()

        rkw = {} if round_tag is None else {"round": round_tag}
        st = {"xfer": next(_xfer_ids), "dead": False, "complete": False,
              "sent": 0, "posted": None, "total": None}
        acks: collections.deque = collections.deque()  # xfer per sent frame
        decs: Dict[int, np.ndarray] = {}
        shipped: set = set()

        async def drain_ack() -> None:
            ack = await up._recv("post_chunk")
            up.chunk_frames += 1
            xf = acks.popleft()
            if xf != st["xfer"]:
                return  # ack of an abandoned stream
            if ack.get("superseded") or ack.get("status") == "busy":
                st["dead"] = True
            elif ack.get("complete"):
                st["complete"] = True

        async def ship(seq: int) -> None:
            await up._send("post_chunk", dict(
                rkw, session=session, op="post_average", xfer=st["xfer"],
                seq=seq, total=st["total"], chunk_words=chunk_words,
                node=node, group=group, weight_avg=None,
                payload=decs[seq] / st["posted"]))
            acks.append(st["xfer"])
            st["sent"] += 1
            shipped.add(seq)
            while len(acks) > depth:
                await drain_ack()

        def on_meta(res: dict) -> None:
            if res.get("posted") is not None:
                st["posted"] = int(res["posted"])

        async def on_chunk(seq, payload, src, total) -> None:
            st["total"] = total
            decs[seq] = unmask(seq * chunk_words, payload, src)
            if st["dead"] or st["posted"] is None:
                # the upstream upload hasn't completed (its logical post
                # hasn't executed), so the contributor count isn't known
                # yet — decode now, ship the backlog when it is
                return
            for s in sorted(decs):
                if s not in shipped and not st["dead"]:
                    await ship(s)

        def on_restart() -> None:
            decs.clear()
            shipped.clear()
            st.update(xfer=next(_xfer_ids), dead=False, complete=False,
                      sent=0, posted=None, total=None)

        got = await self._chunk_stream(
            "get_aggregate", dict(rkw, node=node, group=group), session,
            chunk_words, deadline, depth, on_chunk=on_chunk,
            on_restart=on_restart, on_meta=on_meta)
        while acks:
            await drain_ack()
        if isinstance(got, dict):
            return got  # timeout (a partial publication goes stale)
        asm, tid = got
        # the counted consume of the inbound posting, expect_time-guarded
        # exactly like the buffered path
        final = await self.request("get_aggregate", dict(
            rkw, node=node, group=group, session=session,
            elide_payload=True, expect_time=tid,
            timeout=None if deadline is None else deadline - loop.time()))
        if final.get("status") == "timeout":
            return final
        posted = st["posted"]
        if posted is None:
            posted = int(final["posted"])
        published = (st["complete"] and not st["dead"]
                     and st["sent"] == asm.total)
        decoded = np.concatenate([decs[s] for s in range(asm.total)])
        return dict(final, status="unmasked", decoded=decoded,
                    posted=posted, published=published)

    # -- engine plane over the chunk ops (oversized payloads) -------------
    async def submit_session_chunked(self, kwargs: dict,
                                     chunk_words: int) -> dict:
        """``submit_session`` whose ``values`` ride the §6 chunk plane —
        for contribution matrices beyond one frame (the broker reshapes
        the reassembled flat vector to its engine's (n, V)). Returns
        ``{"sid": ...}`` like the plain op."""
        values = np.ascontiguousarray(
            np.asarray(kwargs["values"], np.float32)).ravel()
        total = wire.num_chunks(values.size, chunk_words)
        meta = {k: v for k, v in kwargs.items() if k != "values"}
        xfer = next(_xfer_ids)
        sid = None
        for seq in range(total):
            res = await self.request("post_chunk", dict(
                meta, op="submit_session", node=self.node, xfer=xfer,
                seq=seq, total=total, chunk_words=chunk_words,
                payload=wire.chunk_slice(values, seq, chunk_words)))
            self.chunk_frames += 1
            if res.get("complete"):
                sid = res["sid"]
        return {"sid": sid}

    async def wait_session_chunked(self, sid: int, *,
                                   timeout: Optional[float] = None,
                                   chunk_words: int =
                                   wire.DEFAULT_CHUNK_WORDS) -> dict:
        """``wait_session`` whose results ride the §6 chunk plane — for
        rounds × V beyond one frame. The elided handshake carries
        completion; the flat round-major results stream as get_chunk
        frames and are reshaped back to per-round arrays here.
        ``timeout`` bounds the WHOLE call (one shared deadline, like
        every other long-poll), not each chunk."""
        loop = asyncio.get_running_loop()
        deadline = None if timeout is None else loop.time() + float(timeout)

        def remaining() -> Optional[float]:
            return None if deadline is None else deadline - loop.time()

        final = await self.request("wait_session", {
            "sid": sid, "timeout": timeout, "elide_results": True})
        if final.get("status") != "done":
            return final
        rounds = int(final["rounds"])
        parts, total, seq = [], None, 0
        while total is None or seq < total:
            rem = remaining()
            if rem is not None and rem <= 0:
                return {"status": "timeout"}
            res = await self.request("get_chunk", {
                "kind": "wait_session", "sid": sid, "seq": seq,
                "words": chunk_words, "timeout": rem})
            if res.get("status") == "timeout":
                return res
            self.chunk_frames += 1
            total = int(res["total"])
            parts.append(res["payload"])
            seq += 1
        flat = (np.concatenate(parts) if parts
                else np.empty(0, np.float32))
        V = flat.size // rounds if rounds else 0
        return {"status": "done", "rounds": rounds,
                "results": [flat[r * V:(r + 1) * V] for r in range(rounds)]}


async def drive_learner(gen: LearnerGen, client: WireClient, session: int,
                        *, aggregation_timeout: float,
                        timeout_scale: float = 1.0,
                        compute_scale: float = 0.0,
                        chunk_words: Optional[int] = None,
                        payload_words: Optional[int] = None,
                        prefetch_depth: Optional[int] = None,
                        stream: Optional[bool] = None,
                        round_tag: Optional[int] = None) -> Any:
    """Run one state machine to completion over the wire.

    ``timeout`` mapping for ``wait`` yields: ``"aggregation"`` becomes
    the session's wall-clock aggregation timeout, numeric (virtual
    seconds) scale by ``timeout_scale``, ``None`` waits forever.
    ``compute_scale`` turns the machines' virtual compute costs into
    wall sleeps (0 = infinitely fast learners; the default, since the
    wire plane measures transport, not the cost model).

    With ``chunk_words`` set and ``payload_words`` (the round's vector
    length, weighted word included) exceeding it, array traffic takes
    the chunked plane; the machines are driven unchanged either way.
    ``prefetch_depth`` caps in-flight chunk requests (default
    ``wire.DEFAULT_PREFETCH_DEPTH``). ``stream`` governs the chunk-
    granular combine for the machine's ``("stream", ...)`` yield:
    ``None`` (default) streams only when the payload clears
    ``wire.MIN_STREAM_WORDS`` — below that the per-chunk overhead loses
    to the buffered path (the small-n regression in
    BENCH_streaming.json) and the whole chunk plane is bypassed (the
    payload rides one frame anyway); ``True`` forces streaming,
    ``False`` disables it but keeps the buffered chunk plane (the
    ablation baseline of ``benchmarks/streaming.py``). Either path is
    bit- and count-identical.

    ``round_tag`` stamps every logical op and chunk frame with a §11
    round number: the broker parks ops tagged for a future round until
    ``advance_round`` opens it, while tagged chunk frames buffer (and
    relay) within the in-flight window — the cross-round pipelining
    used by :meth:`PersistentNetSession.run_rounds_pipelined`.
    """
    chunked = (chunk_words is not None and payload_words is not None
               and payload_words > chunk_words)
    stream_auto = stream is None
    if stream is None:
        stream = (payload_words is not None
                  and payload_words >= wire.MIN_STREAM_WORDS)
    if (chunked and stream_auto and not stream
            and payload_words * 8 + 65536 <= wire.MAX_FRAME):
        # small-payload fast path: below the
        # streaming threshold the chunk plane only adds per-chunk
        # get_chunk/consume handshakes (the x0.81 small-n row in
        # BENCH_streaming.json), and a payload this size rides one
        # frame with room to spare — skip chunking wholesale. An
        # explicit ``stream=False`` keeps the buffered chunk plane (the
        # ablation baseline and the chunk-plane unit tests).
        chunked = False
    depth = (wire.DEFAULT_PREFETCH_DEPTH if prefetch_depth is None
             else max(1, int(prefetch_depth)))
    loop = asyncio.get_running_loop()

    def tag(kw: dict) -> dict:
        return kw if round_tag is None else dict(kw, round=round_tag)

    def wall_timeout(timeout) -> Optional[float]:
        if timeout == "aggregation":
            return aggregation_timeout
        if timeout is None:
            return None
        return float(timeout) * timeout_scale

    send_value = None
    while True:
        try:
            item = gen.send(send_value)
        except StopIteration as stop:
            return stop.value
        kind = item[0]
        if kind == "compute":
            if compute_scale > 0.0:
                await asyncio.sleep(item[1] * compute_scale)
            send_value = None
        elif kind == "call":
            _, op, kwargs, _nbytes = item
            payload_field = {"post_aggregate": "payload",
                             "post_average": "average"}.get(op)
            arr = kwargs.get(payload_field) if payload_field else None
            if (chunked and isinstance(arr, np.ndarray)
                    and arr.size > chunk_words):
                await client.post_chunked(op, tag(kwargs), payload_field,
                                          session, chunk_words)
                send_value = None
            else:
                send_value = await client.request(
                    op, dict(tag(kwargs), session=session))
        elif kind == "wait":
            _, wkind, kwargs, _nbytes, timeout = item
            wall = wall_timeout(timeout)
            if chunked and wkind in ("get_aggregate", "get_average"):
                deadline = None if wall is None else loop.time() + wall
                send_value = await client.get_chunked(
                    wkind, tag(kwargs), session, chunk_words, deadline,
                    depth)
            else:
                send_value = await client.request(
                    wkind, dict(tag(kwargs), session=session,
                                timeout=wall))
        elif kind == "stream":
            # the fused receive+combine+post hop: stream when the
            # payload is chunked, otherwise resolve as the plain
            # get_aggregate wait (the machine falls back to the
            # whole-vector combine — identical bits and counts)
            _, skwargs, _nbytes, timeout = item
            wall = wall_timeout(timeout)
            wait_kw = tag(dict(node=skwargs["node"],
                               group=skwargs["group"]))
            if chunked and stream:
                deadline = None if wall is None else loop.time() + wall
                send_value = await client.stream_combine(
                    skwargs, session, chunk_words, deadline, depth,
                    round_tag=round_tag)
            elif chunked:
                deadline = None if wall is None else loop.time() + wall
                send_value = await client.get_chunked(
                    "get_aggregate", wait_kw, session, chunk_words,
                    deadline, depth)
            else:
                send_value = await client.request(
                    "get_aggregate",
                    dict(wait_kw, session=session, timeout=wall))
        elif kind == "unmask":
            # the fused receive+unmask+publish initiator tail: stream
            # when the payload is chunked and unweighted (the weighted
            # average needs the decoded vector's trailing weight word
            # before any element divides), otherwise resolve as the
            # plain get_aggregate wait — the machine falls back to the
            # whole-vector unmask, identical bits and counts either way
            _, ukwargs, _nbytes, timeout = item
            wall = wall_timeout(timeout)
            wait_kw = tag(dict(node=ukwargs["node"],
                               group=ukwargs["group"]))
            if chunked and stream and not ukwargs.get("weighted"):
                deadline = None if wall is None else loop.time() + wall
                send_value = await client.unmask_stream(
                    ukwargs, session, chunk_words, deadline, depth,
                    round_tag=round_tag)
            elif chunked:
                deadline = None if wall is None else loop.time() + wall
                send_value = await client.get_chunked(
                    "get_aggregate", wait_kw, session, chunk_words,
                    deadline, depth)
            else:
                send_value = await client.request(
                    "get_aggregate",
                    dict(wait_kw, session=session, timeout=wall))
        else:
            raise ValueError(f"unknown yield {item!r}")


async def _drive_round_machines(machines: Dict[int, LearnerGen], acquire,
                                release, session: int, *,
                                aggregation_timeout: float,
                                timeout_scale: float, compute_scale: float,
                                chunk_words: Optional[int],
                                payload_words: int,
                                prefetch_depth: Optional[int],
                                stream: Optional[bool],
                                round_tag: Optional[int] = None):
    """Drive one round's machines to completion, one task per live
    learner — the round core shared by :func:`run_safe_round_net` and
    :class:`PersistentNetSession`. ``acquire(node)`` supplies the node's
    connected client; ``release(node, client, crashed)`` disposes or
    retains it afterwards. Returns ``(wall_s, crashed_nodes,
    streamed_combines)``; the first learner exception (other than a
    churn crash) re-raises after every task settled."""
    crashed: list = []
    streamed = [0]

    async def one(node: int, gen: LearnerGen) -> Any:
        client = await acquire(node)
        before = client.streamed_combines
        node_crashed = False
        try:
            return await drive_learner(
                gen, client, session,
                aggregation_timeout=aggregation_timeout,
                timeout_scale=timeout_scale, compute_scale=compute_scale,
                chunk_words=chunk_words, payload_words=payload_words,
                prefetch_depth=prefetch_depth, stream=stream,
                round_tag=round_tag)
        except LearnerCrashed:
            node_crashed = True
            crashed.append(node)  # mid-round churn: learner just stops
            return None
        finally:
            streamed[0] += client.streamed_combines - before
            await release(node, client, node_crashed)

    t0 = time.perf_counter()
    # return_exceptions: let every learner settle (each releases its
    # own connection) instead of abandoning running tasks on the first
    # error, then surface the first failure
    settled = await asyncio.gather(
        *(one(node, gen) for node, gen in machines.items()),
        return_exceptions=True)
    for r in settled:
        if isinstance(r, BaseException):
            raise r
    return time.perf_counter() - t0, tuple(crashed), streamed[0]


@dataclasses.dataclass
class NetResult:
    """Wire-plane mirror of :class:`repro_torch.core.protocol.SimResult` —
    ``stats`` is the broker's MessageStats as a dict (plus totals and
    the chunk-plane frame counters)."""

    average: Optional[np.ndarray]
    weight_avg: Optional[float]
    wall_time: float
    stats: Dict[str, int]
    bytes_sent: int
    monitor_reposts: int
    initiator_elections: int
    crashed_nodes: tuple = ()
    #: hops that ran the chunk-granular streaming combine end-to-end
    #: (inbound decrypt+add+re-encrypt per chunk, outbound landed)
    streamed_combines: int = 0


async def run_safe_round_net(
    values: np.ndarray,
    addr: Addr,
    *,
    mode: str = "safe",
    subgroups: int = 1,
    failed_nodes: Iterable[int] = (),
    initiator_fails: bool = False,
    weights: Optional[np.ndarray] = None,
    cost: CostModel = EDGE,
    aggregation_timeout: Optional[float] = None,
    symmetric_only: bool = False,
    scale_bits: int = 16,
    provisioning_seed: int = 0xC0FFEE,
    learner_master: int = 0x5EED,
    counter: int = 0,
    interceptor: Optional[Interceptor] = None,
    timeout_scale: float = 1.0,
    compute_scale: float = 0.0,
    chunk_words: Optional[int] = None,
    prefetch_depth: Optional[int] = None,
    stream: Optional[bool] = None,
    ssl=None,
) -> NetResult:
    """One full aggregation round over the wire — the transport twin of
    :func:`repro_torch.core.protocol.run_safe_round` (same signature spirit,
    wall-clock timeouts). Builds the same topology, elects the same
    initiators, constructs the same machines, then runs one asyncio
    task + one TCP connection per live learner against the broker at
    ``addr``.

    ``failed_nodes`` are dead before the round (their clients never
    start — discovered by the broker's monitor, §5.3). ``mode`` must be
    'safe' or 'saf': INSEC needs a parsing, averaging controller, which
    the wire broker deliberately is not (the paper's point).

    ``chunk_words`` enables the chunked transfer plane for payloads
    longer than that many elements; by default it switches on
    automatically once the payload could not safely fit one frame
    (AUTO_CHUNK_WORDS). Pass the string ``"auto"`` to derive the chunk
    size from the payload instead (:func:`auto_chunk_words` — ~8
    chunks, clamped to ``MIN_STREAM_WORDS`` multiples). Chunked hops run the chunk-granular streaming
    combine (crypto overlapped with transfer inside each hop) when the
    payload clears ``wire.MIN_STREAM_WORDS`` — ``stream=True`` forces
    it, ``stream=False`` disables it (see :func:`drive_learner`);
    ``prefetch_depth`` caps each learner's in-flight chunk requests
    (default ``wire.DEFAULT_PREFETCH_DEPTH``).

    Against a sharded broker (:class:`repro_torch.net.shard.ShardedBroker`)
    the ``create_session`` response names the owning shard's direct
    port; every learner dials it straight away, so the round never pays
    a redirect bounce past first contact.
    """
    if mode not in ("safe", "saf"):
        raise ValueError(f"wire plane runs 'safe'/'saf', got {mode!r}")
    values = np.asarray(values, np.float32)
    n, V = values.shape
    payload_words = V + 1 if weights is not None else V
    chunk_words = _resolve_chunk_words(chunk_words, payload_words, cost)
    topo = RingTopology(n, subgroups)
    topo.validate_privacy()
    groups = topo.group_chains(node_base=1)
    initiators = {r + 1 for r in topo.elect_initiators()}
    failed = set(failed_nodes)

    machines = build_round_machines(
        values, topo, groups, initiators, mode=mode, weights=weights,
        cost=cost, symmetric_only=symmetric_only, scale_bits=scale_bits,
        provisioning_seed=provisioning_seed, learner_master=learner_master,
        counter=counter, subgroups=subgroups, failed=failed,
        initiator_fails=initiator_fails)

    admin = await WireClient(*addr, ssl=ssl).connect()
    sid = None
    try:
        created = await admin.request("create_session", {
            "groups": groups, "aggregation_timeout": aggregation_timeout})
        sid = created["session"]
        wall_agg = created["aggregation_timeout"]
        # sharded broker: the session lives on one worker — dial its
        # direct port so learners land on the owner without a bounce
        learner_addr = ((addr[0], int(created["port"]))
                        if created.get("port") else addr)

        async def acquire(node: int) -> WireClient:
            # §15: each learner authenticates as ITSELF — its node token
            # from the create_session grant (the broker refuses a post
            # or consume under any other node's identity)
            tok = (admin.node_tokens or {}).get(node, admin.token)
            return await WireClient(*learner_addr, node=node,
                                    interceptor=interceptor,
                                    token=tok, ssl=ssl).connect()

        async def release(node: int, client: WireClient, _crashed: bool):
            await client.close()  # folds the aux channel's counters in
            admin.bytes_sent += client.bytes_sent

        wall, crashed, streamed = await _drive_round_machines(
            machines, acquire, release, sid,
            aggregation_timeout=wall_agg, timeout_scale=timeout_scale,
            compute_scale=compute_scale, chunk_words=chunk_words,
            payload_words=payload_words, prefetch_depth=prefetch_depth,
            stream=stream)

        stats = await admin.request("get_stats", {"session": sid})
        final = await admin.request("peek_average", {"session": sid})
    finally:
        # free the tenant on the broker even when a learner errored —
        # a long-lived broker must not accumulate one Controller per
        # round (best-effort: the broker may already be gone)
        if sid is not None:
            try:
                await admin.request("delete_session", {"session": sid})
            except Exception:  # noqa: BLE001
                pass
        await admin.close()

    return NetResult(
        average=None if final is None else final["average"],
        weight_avg=None if final is None else final.get("weight_avg"),
        wall_time=wall,
        stats=stats,
        bytes_sent=admin.bytes_sent,
        monitor_reposts=stats["monitor_reposts"],
        initiator_elections=stats["initiator_elections"],
        crashed_nodes=crashed,
        streamed_combines=streamed,
    )


@dataclasses.dataclass
class HierNetResult:
    """One §5.10 chain-of-chains round over real brokers — the wire twin
    of :class:`repro_torch.core.protocol.HierSimResult`. ``average`` is the
    parent's cross-org fold; ``org_results`` holds each surviving org's
    own :class:`NetResult` (whose ``average`` is the org-level fold, the
    one anonymized vector that crossed the trust boundary upward);
    ``parent_stats`` is the parent session's ``get_stats`` dict, whose
    ``hierarchy_total`` satisfies the parent-level closed form
    ``2(c - f)`` — one up-post plus one down-fetch per surviving org."""

    average: Optional[np.ndarray]
    weight_avg: Optional[float]
    wall_time: float
    org_results: Dict[int, NetResult]
    org_averages: Dict[int, np.ndarray]
    elided_orgs: tuple
    parent_stats: Dict[str, Any]


async def run_hierarchical_round_net(
    values: np.ndarray,
    parent_addr: Addr,
    child_addrs: Mapping[int, Addr],
    *,
    failed_orgs: Iterable[int] = (),
    failed_nodes: Iterable[int] = (),
    initiator_fails: bool = False,
    weights: Optional[np.ndarray] = None,
    cost: CostModel = EDGE,
    aggregation_timeout: Optional[float] = None,
    parent_timeout: Optional[float] = None,
    symmetric_only: bool = False,
    scale_bits: int = 16,
    provisioning_seed: int = 0xC0FFEE,
    learner_master: int = 0x5EED,
    counter: int = 0,
    timeout_scale: float = 1.0,
    compute_scale: float = 0.0,
    chunk_words: Optional[int] = None,
) -> HierNetResult:
    """One hierarchical round on the wire (paper §5.10, PROTOCOL.md
    §15): each child org runs its own FULL SAFE chain — failover
    included — on its own broker, whose session posts the org's
    anonymized average UP to the parent session at ``parent_addr`` and
    serves the parent's fold back to its learners. A whole org in
    ``failed_orgs`` never runs: the parent elides it after its
    aggregation timeout, exactly like a dead learner inside a chain.

    ``child_addrs`` maps org id (0-based, one per topology subgroup) to
    that org's broker address; several orgs may share one broker (they
    get separate sessions). The topology, seeds and machine construction
    are the GLOBAL ones of ``run_safe_round(values, subgroups=len
    (child_addrs))`` — so every org average, and the parent fold, is
    bit-identical to the flat sim/wire planes (asserted in
    tests/test_conformance.py)."""
    values = np.asarray(values, np.float32)
    n, V = values.shape
    orgs = sorted(int(g) for g in child_addrs)
    payload_words = V + 1 if weights is not None else V
    topo = RingTopology(n, len(orgs))
    topo.validate_privacy()
    groups = topo.group_chains(node_base=1)
    initiators = {r + 1 for r in topo.elect_initiators()}
    failed = set(failed_nodes)
    dead_orgs = {int(g) for g in failed_orgs}

    machines = build_round_machines(
        values, topo, groups, initiators, mode="safe", weights=weights,
        cost=cost, symmetric_only=symmetric_only, scale_bits=scale_bits,
        provisioning_seed=provisioning_seed, learner_master=learner_master,
        counter=counter, subgroups=len(orgs), failed=failed,
        initiator_fails=initiator_fails)

    parent = await WireClient(*parent_addr).connect()
    children: Dict[int, WireClient] = {}
    psid = None
    child_sids: Dict[int, int] = {}
    try:
        created = await parent.request("create_session", {
            # the placeholder chain keeps the call shape; the parent's
            # protocol state lives in its ParentController
            "groups": {0: [0]}, "orgs": orgs,
            "aggregation_timeout": parent_timeout})
        psid = created["session"]
        wall_parent = created["aggregation_timeout"]

        async def run_org(g: int) -> Tuple[int, NetResult]:
            chain = groups[g]
            admin = await WireClient(*child_addrs[g]).connect()
            children[g] = admin
            made = await admin.request("create_session", {
                "groups": {g: chain},
                "aggregation_timeout": aggregation_timeout,
                "upstream": {
                    "host": parent_addr[0], "port": parent_addr[1],
                    "session": psid, "org": g, "token": parent.token,
                    # the child's down-fetch must outlast the parent's
                    # whole-org elision window
                    "timeout": wall_parent + 5.0,
                }})
            sid = made["session"]
            child_sids[g] = sid
            wall_agg = made["aggregation_timeout"]
            learner_addr = ((child_addrs[g][0], int(made["port"]))
                            if made.get("port") else child_addrs[g])
            org_machines = {node: machines[node] for node in chain
                            if node in machines}

            async def acquire(node: int) -> WireClient:
                tok = (admin.node_tokens or {}).get(node, admin.token)
                return await WireClient(*learner_addr, node=node,
                                        token=tok).connect()

            async def release(node: int, client: WireClient, _c: bool):
                await client.close()
                admin.bytes_sent += client.bytes_sent

            wall, crashed, streamed = await _drive_round_machines(
                org_machines, acquire, release, sid,
                aggregation_timeout=wall_agg, timeout_scale=timeout_scale,
                compute_scale=compute_scale, chunk_words=chunk_words,
                payload_words=payload_words, prefetch_depth=None,
                stream=None)
            stats = await admin.request("get_stats", {"session": sid})
            # the child's peek is the ORG average — the learners got the
            # parent fold, but the org-level bits are what went upward
            org_avg = await admin.request("peek_average", {"session": sid})
            return g, NetResult(
                average=None if org_avg is None else org_avg["average"],
                weight_avg=(None if org_avg is None
                            else org_avg.get("weight_avg")),
                wall_time=wall, stats=stats, bytes_sent=admin.bytes_sent,
                monitor_reposts=stats["monitor_reposts"],
                initiator_elections=stats["initiator_elections"],
                crashed_nodes=crashed, streamed_combines=streamed)

        live = [g for g in orgs if g not in dead_orgs]
        if not live:
            raise ValueError("every child org is in failed_orgs")
        t0 = time.perf_counter()
        settled = await asyncio.gather(*(run_org(g) for g in live))
        wall = time.perf_counter() - t0
        org_results = {g: r for g, r in settled}

        # every surviving org's learners finished, which means the fold
        # was published and distributed — the peek cannot race it
        fold = await parent.request("peek_average", {"session": psid})
        pstats = await parent.request("get_stats", {"session": psid})
    finally:
        for g, admin in children.items():
            try:
                if g in child_sids:
                    await admin.request("delete_session",
                                        {"session": child_sids[g]})
            except Exception:  # noqa: BLE001
                pass
            await admin.close()
        if psid is not None:
            try:
                await parent.request("delete_session", {"session": psid})
            except Exception:  # noqa: BLE001
                pass
        await parent.close()

    return HierNetResult(
        average=None if fold is None else fold["average"],
        weight_avg=None if fold is None else fold.get("weight_avg"),
        wall_time=wall,
        org_results=org_results,
        org_averages={g: r.average for g, r in org_results.items()},
        elided_orgs=tuple(pstats.get("crashed_orgs", ())),
        parent_stats=pstats,
    )


@dataclasses.dataclass
class BonNetResult:
    """One BON round over the wire (the baseline's NetResult twin).
    ``stats`` is the broker's BonStats as a dict (one counter per
    ``bon_*`` op plus ``total`` and ``shares_reconstructed``)."""

    average: Optional[np.ndarray]
    wall_time: float
    stats: Dict[str, int]
    bytes_sent: int
    messages: int
    expected_messages: int
    crashed_nodes: tuple = ()


async def run_bon_round_net(
    values: np.ndarray,
    addr: Addr,
    *,
    failed_nodes: Iterable[int] = (),
    threshold: Optional[int] = None,
    seed: int = 7,
    scale_bits: int = 16,
    roster_timeout: float = 0.5,
    aggregation_timeout: Optional[float] = None,
    interceptor: Optional[Interceptor] = None,
    timeout_scale: float = 1.0,
) -> BonNetResult:
    """One BON aggregation over the real broker — the transport twin of
    :func:`repro_torch.core.bon_protocol.run_bon_round`, so the Bonawitz-style
    baseline and SAFE are measured on the *same* wire (the
    paper's §6.1 comparison was half cost-model before this).

    Unlike SAFE, ``failed_nodes`` here run Rounds 0–1 over real sockets
    (advertise, share secrets) and then vanish — the protocol's
    designed-for worst case. The broker's BON session declares them
    dropped ``roster_timeout`` wall-seconds after the first masked
    input, and the server-side recovery (Shamir reconstruction + pad
    regeneration — the compute SAFE's "mere message broker" never does)
    runs inside the broker process.

    Per-op traffic is counted in ``BonStats`` with the same only-
    consumption-counts discipline as MessageStats; a completed clean
    round totals exactly ``bon_expected_messages(n, f)``. Payloads are
    single-frame by design (a masked vector at BON's practical n is far
    below MAX_FRAME); the chunk plane is not wired to ``bon_*`` ops.
    """
    values = np.asarray(values, np.float32)
    n, V = values.shape
    t = int(threshold) if threshold else (n // 2 + 1)
    failed = {int(x) for x in failed_nodes}
    if n - len(failed) < t:
        raise ValueError("not enough survivors to reach the threshold")

    machines = build_bon_machines(
        values, failed_nodes=failed, threshold=t, seed=seed,
        scale_bits=scale_bits)

    admin = await WireClient(*addr).connect()
    sid = None
    try:
        created = await admin.request("create_session", {
            "groups": {0: list(range(1, n + 1))},
            "aggregation_timeout": aggregation_timeout,
            "protocol": "bon", "threshold": t,
            "roster_timeout": roster_timeout, "scale_bits": scale_bits})
        sid = created["session"]
        wall_agg = created["aggregation_timeout"]
        learner_addr = ((addr[0], int(created["port"]))
                        if created.get("port") else addr)

        async def acquire(node: int) -> WireClient:
            tok = (admin.node_tokens or {}).get(node, admin.token)
            return await WireClient(*learner_addr, node=node,
                                    interceptor=interceptor,
                                    token=tok).connect()

        async def release(node: int, client: WireClient, _crashed: bool):
            await client.close()
            admin.bytes_sent += client.bytes_sent

        wall, crashed, _ = await _drive_round_machines(
            machines, acquire, release, sid,
            aggregation_timeout=wall_agg, timeout_scale=timeout_scale,
            compute_scale=0.0, chunk_words=None, payload_words=V,
            prefetch_depth=None, stream=False)

        stats = await admin.request("get_stats", {"session": sid})
        final = await admin.request("peek_average", {"session": sid})
    finally:
        if sid is not None:
            try:
                await admin.request("delete_session", {"session": sid})
            except Exception:  # noqa: BLE001
                pass
        await admin.close()

    return BonNetResult(
        average=None if final is None else final["average"],
        wall_time=wall,
        stats=stats,
        bytes_sent=admin.bytes_sent,
        messages=stats["total"],
        expected_messages=bon_expected_messages(n, len(failed) +
                                                len(crashed)),
        crashed_nodes=crashed,
    )


class PersistentNetSession:
    """One broker session, one set of learner connections, R rounds.

    The per-round path of :func:`run_safe_round_net` rebuilds everything
    every round: a fresh broker session, n fresh TCP connections, and n
    fresh :class:`LearnerCrypto` objects (full key re-derivation). This
    class keeps all three alive across rounds — ``reset_round`` clears
    the controller's round state between rounds, a
    :class:`repro_torch.core.session.RoundCursor` hands each round a fresh
    counter base (no pad reuse), and the crypto cache means **no key
    derivation after Round 0** — the paper's Round-0 amortization, at
    the transport. Each round's published average is bit-identical to
    an independent ``run_safe_round(values, counter=base)`` sim round,
    and the per-round MessageStats delta still satisfies the §5 closed
    forms (asserted in tests/test_net.py).

    Usage::

        sess = PersistentNetSession(addr, n, chunk_words=4096)
        await sess.open()
        try:
            for r in range(R):
                res = await sess.run_round(values_r)
        finally:
            await sess.close()

    (or ``async with PersistentNetSession(...) as sess:``.)
    """

    def __init__(self, addr: Addr, n: int, *,
                 mode: str = "safe",
                 subgroups: int = 1,
                 cost: CostModel = EDGE,
                 aggregation_timeout: Optional[float] = None,
                 symmetric_only: bool = False,
                 scale_bits: int = 16,
                 provisioning_seed: int = 0xC0FFEE,
                 learner_master: int = 0x5EED,
                 interceptor: Optional[Interceptor] = None,
                 timeout_scale: float = 1.0,
                 compute_scale: float = 0.0,
                 chunk_words: Optional[int] = None,
                 prefetch_depth: Optional[int] = None,
                 stream: Optional[bool] = None,
                 words_per_round: Optional[int] = None,
                 counter0: int = 0):
        if mode not in ("safe", "saf"):
            raise ValueError(f"wire plane runs 'safe'/'saf', got {mode!r}")
        self.addr = addr
        self.n = n
        self.mode = mode
        self.subgroups = subgroups
        self.cost = cost
        self.aggregation_timeout = aggregation_timeout
        self.symmetric_only = symmetric_only
        self.scale_bits = scale_bits
        self.provisioning_seed = provisioning_seed
        self.learner_master = learner_master
        self.interceptor = interceptor
        self.timeout_scale = timeout_scale
        self.compute_scale = compute_scale
        self.chunk_words = chunk_words
        self.prefetch_depth = prefetch_depth
        self.stream = stream
        self._words_per_round = words_per_round
        self._counter0 = counter0
        self.topo = RingTopology(n, subgroups)
        self.topo.validate_privacy()
        self.groups = self.topo.group_chains(node_base=1)
        self.initiators = {r + 1 for r in self.topo.elect_initiators()}
        self.sid: Optional[int] = None
        self.rounds_done = 0
        self._admin: Optional[WireClient] = None
        self._clients: Dict[int, WireClient] = {}
        self._crypto_cache: Dict[int, LearnerCrypto] = {}
        self._cursor: Optional[RoundCursor] = None
        self._wall_agg: float = 30.0
        self._prev_stats: Dict[str, int] = {}
        self._prev_bytes = 0
        self._closed_bytes = 0  # bytes of connections dropped mid-session
        self._learner_addr: Addr = addr  # owning shard's addr after open()
        # §11 cross-round pipelining state: in-flight round tasks
        # (ordered — rounds collect oldest-first), the broker's round
        # counter as last reported by advance_round, one connection set
        # per pipeline slot (two concurrent rounds must never share a
        # connection: its request/response pairing is sequential, and a
        # future-round op PARKS), and whether a plain run_round left a
        # published round that the next pipelined round must close out
        self._pipe: collections.deque = collections.deque()
        self._pipe_clients: Dict[Tuple[int, int], WireClient] = {}
        self._pipe_window: Optional[int] = None
        self._broker_round = 0
        self._plain_pending = False

    async def open(self) -> "PersistentNetSession":
        self._admin = await WireClient(*self.addr).connect()
        created = await self._admin.request("create_session", {
            "groups": self.groups,
            "aggregation_timeout": self.aggregation_timeout})
        self.sid = created["session"]
        self._wall_agg = created["aggregation_timeout"]
        # sharded broker: pin every learner connection to the session's
        # owning shard (see run_safe_round_net)
        self._learner_addr = ((self.addr[0], int(created["port"]))
                              if created.get("port") else self.addr)
        return self

    async def __aenter__(self) -> "PersistentNetSession":
        return await self.open()

    async def __aexit__(self, *exc) -> None:
        await self.close()

    def _node_token(self, node: int) -> Optional[str]:
        """The node's CURRENT credential (§15): its entry in the admin's
        latest grant (create_session or the last reset_round rotation),
        falling back to the session token."""
        if self._admin is None:
            return None
        grant = self._admin.node_tokens or {}
        return grant.get(node, self._admin.token)

    async def _client(self, node: int) -> WireClient:
        c = self._clients.get(node)
        if c is None:
            c = await WireClient(*self._learner_addr, node=node,
                                 interceptor=self.interceptor,
                                 token=self._node_token(node)).connect()
            self._clients[node] = c
        return c

    async def _drop_client(self, node: int) -> None:
        c = self._clients.pop(node, None)
        if c is not None:
            await c.close()
            self._closed_bytes += c.bytes_sent

    def _total_bytes(self) -> int:
        return (self._admin.bytes_sent + self._closed_bytes
                + sum(c.total_bytes_sent for c in self._clients.values())
                + sum(c.total_bytes_sent
                      for c in self._pipe_clients.values()))

    # -- §11 cross-round pipelining ---------------------------------------
    @property
    def pipeline_depth(self) -> int:
        """Rounds launched but not yet collected."""
        return len(self._pipe)

    async def _pipe_client(self, node: int, slot: int) -> WireClient:
        key = (node, slot)
        c = self._pipe_clients.get(key)
        if c is None:
            c = await WireClient(*self._learner_addr, node=node,
                                 interceptor=self.interceptor,
                                 token=self._node_token(node)).connect()
            self._pipe_clients[key] = c
        return c

    async def start_round_pipelined(self, values: np.ndarray, *,
                                    weights: Optional[np.ndarray] = None,
                                    failed_nodes: Iterable[int] = (),
                                    initiator_fails: bool = False,
                                    window: int = 2) -> None:
        """Launch one aggregation round WITHOUT waiting for the previous
        round to finish — the §11 cross-round pipeline. Every op and
        chunk frame is tagged with the round's broker round number: the
        broker buffers (and relays) the new round's chunk streams while
        the previous round's tail drains, parking only the logical ops
        until :meth:`collect_round_pipelined` advances the boundary.
        The counter base still comes from the session's
        :class:`~repro_torch.core.session.RoundCursor` — pad streams never
        collide across overlapped rounds.

        At most ``window`` rounds may be in flight (the broker sheds
        frames beyond its own ``inflight_rounds`` window anyway); each
        in-flight round drives its learners over a dedicated connection
        set, because a future-round op PARKS and would head-of-line
        block the previous round on a shared connection."""
        if self._pipe_window is None:
            self._pipe_window = max(1, int(window))
        if len(self._pipe) >= self._pipe_window:
            raise RuntimeError(
                "pipeline window full — collect_round_pipelined first")
        values = np.asarray(values, np.float32)
        if values.shape[0] != self.n:
            raise ValueError(
                f"values has {values.shape[0]} rows for n={self.n}")
        V = values.shape[1]
        payload_words = V + 1 if weights is not None else V
        if self._cursor is None:
            self._cursor = RoundCursor(
                self._words_per_round or payload_words, self._counter0)
        if payload_words > self._cursor.words_per_round:
            raise ValueError(
                f"payload of {payload_words} words exceeds this "
                f"session's {self._cursor.words_per_round} words/round "
                f"counter stride — size words_per_round for the widest "
                f"round up front")
        counter = self._cursor.next_round()
        chunk_words = _resolve_chunk_words(self.chunk_words, payload_words,
                                           self.cost)
        if self._plain_pending:
            # a plain run_round left its round published on the broker:
            # close it out non-destructively so this round's tag lands
            # on a fresh controller round
            resp = await self._admin.request("advance_round",
                                             {"session": self.sid})
            self._broker_round = int(resp["round"])
            self._plain_pending = False

        rnd = self._broker_round + len(self._pipe)
        slot = rnd % self._pipe_window
        failed = set(failed_nodes)
        machines = build_round_machines(
            values, self.topo, self.groups, self.initiators,
            mode=self.mode, weights=weights, cost=self.cost,
            symmetric_only=self.symmetric_only, scale_bits=self.scale_bits,
            provisioning_seed=self.provisioning_seed,
            learner_master=self.learner_master, counter=counter,
            subgroups=self.subgroups, failed=failed,
            initiator_fails=initiator_fails,
            crypto_cache=self._crypto_cache)

        async def acquire(node: int) -> WireClient:
            return await self._pipe_client(node, slot)

        async def release(node: int, _client: WireClient, crashed: bool):
            if crashed:
                c = self._pipe_clients.pop((node, slot), None)
                if c is not None:
                    await c.close()
                    self._closed_bytes += c.bytes_sent

        task = asyncio.ensure_future(_drive_round_machines(
            machines, acquire, release, self.sid,
            aggregation_timeout=self._wall_agg,
            timeout_scale=self.timeout_scale,
            compute_scale=self.compute_scale, chunk_words=chunk_words,
            payload_words=payload_words,
            prefetch_depth=self.prefetch_depth, stream=self.stream,
            round_tag=rnd))
        self._pipe.append(task)

    async def collect_round_pipelined(self) -> NetResult:
        """Wait for the OLDEST in-flight round, read its results, then
        ``advance_round`` — which delivers any already-buffered next-
        round transfers and un-parks its ops. Collected strictly in
        launch order, so the per-round MessageStats delta taken here
        contains exactly the finished round's ops (later rounds' ops
        are still parked) and the §5 closed forms hold round-by-round
        even while the chunk plane overlaps rounds on the wire."""
        if not self._pipe:
            raise RuntimeError("no pipelined round in flight")
        task = self._pipe.popleft()
        wall, crashed, streamed = await task
        raw = await self._admin.request("get_stats", {"session": self.sid})
        stats = {k: (raw[k] - self._prev_stats.get(k, 0)
                     if isinstance(raw.get(k), int) else raw[k])
                 for k in raw}
        self._prev_stats = {k: v for k, v in raw.items()
                            if isinstance(v, int)}
        final = await self._admin.request("peek_average",
                                          {"session": self.sid})
        resp = await self._admin.request("advance_round",
                                         {"session": self.sid})
        self._broker_round = int(resp["round"])
        self.rounds_done += 1
        self._plain_pending = False
        bytes_now = self._total_bytes() - self._prev_bytes
        self._prev_bytes += bytes_now
        return NetResult(
            average=None if final is None else final["average"],
            weight_avg=None if final is None else final.get("weight_avg"),
            wall_time=wall,
            stats=stats,
            bytes_sent=bytes_now,
            monitor_reposts=stats["monitor_reposts"],
            initiator_elections=stats["initiator_elections"],
            crashed_nodes=crashed,
            streamed_combines=streamed,
        )

    async def run_rounds_pipelined(self, rounds_values, *,
                                   window: int = 2,
                                   weights: Optional[np.ndarray] = None,
                                   failed_by_round: Optional[
                                       Mapping[int, Iterable[int]]] = None
                                   ) -> list:
        """R rounds with up to ``window`` overlapped on the wire —
        round r+1's uploads start while round r's tail drains. Returns
        one :class:`NetResult` per round, in round order; per-round
        stats deltas, bit-identity and counter bases are exactly those
        of the sequential :meth:`run_round` loop (asserted in
        tests/test_conformance.py's ``pipelined`` column)."""
        failed_by_round = dict(failed_by_round or {})
        results: list = []
        for r, values in enumerate(rounds_values):
            while len(self._pipe) >= max(1, int(
                    self._pipe_window or window)):
                results.append(await self.collect_round_pipelined())
            await self.start_round_pipelined(
                values, weights=weights,
                failed_nodes=set(failed_by_round.get(r, ())),
                window=window)
        while self._pipe:
            results.append(await self.collect_round_pipelined())
        return results

    async def run_round(self, values: np.ndarray, *,
                        weights: Optional[np.ndarray] = None,
                        failed_nodes: Iterable[int] = (),
                        initiator_fails: bool = False,
                        counter: Optional[int] = None) -> NetResult:
        """One aggregation round on the live session. Rounds after the
        first begin with ``reset_round``; the counter base comes from
        the session's :class:`RoundCursor` unless ``counter`` pins it
        (parity tests). Learner connections and key material are reused;
        a learner that crashed last round reconnects (crash-resume
        across the round boundary)."""
        values = np.asarray(values, np.float32)
        if values.shape[0] != self.n:
            raise ValueError(
                f"values has {values.shape[0]} rows for n={self.n}")
        V = values.shape[1]
        payload_words = V + 1 if weights is not None else V
        if self._cursor is None:
            self._cursor = RoundCursor(
                self._words_per_round or payload_words, self._counter0)
        if payload_words > self._cursor.words_per_round:
            # a payload wider than the per-round counter stride would
            # overlap the next round's pad words — silent keystream
            # reuse, the one invariant this class must never break
            raise ValueError(
                f"payload of {payload_words} words exceeds this "
                f"session's {self._cursor.words_per_round} words/round "
                f"counter stride — size words_per_round for the widest "
                f"round up front")
        if counter is None:
            counter = self._cursor.next_round()
        chunk_words = _resolve_chunk_words(self.chunk_words, payload_words,
                                           self.cost)
        if self._pipe:
            raise RuntimeError(
                "run_round while pipelined rounds are in flight — "
                "collect_round_pipelined them first")

        failed = set(failed_nodes)
        machines = build_round_machines(
            values, self.topo, self.groups, self.initiators,
            mode=self.mode, weights=weights, cost=self.cost,
            symmetric_only=self.symmetric_only, scale_bits=self.scale_bits,
            provisioning_seed=self.provisioning_seed,
            learner_master=self.learner_master, counter=counter,
            subgroups=self.subgroups, failed=failed,
            initiator_fails=initiator_fails,
            crypto_cache=self._crypto_cache)

        if self.rounds_done > 0:
            # new FL iteration on the same tenant: clear round state and
            # stale chunk buffers, keep keys/counters/connections warm.
            # The reset ROTATES every token (§15) — the admin client
            # adopts its own from the response; redistribute the fresh
            # per-node grant to the live learner connections
            await self._admin.request("reset_round", {"session": self.sid})
            for node, c in self._clients.items():
                c.set_token(self._node_token(node))
            for (node, _slot), c in self._pipe_clients.items():
                c.set_token(self._node_token(node))

        async def release(node: int, _client: WireClient, crashed: bool):
            if crashed:
                # the connection may hold half-sent frames / parked
                # polls — drop it so the node rejoins cleanly next round
                await self._drop_client(node)

        wall, crashed, streamed = await _drive_round_machines(
            machines, self._client, release, self.sid,
            aggregation_timeout=self._wall_agg,
            timeout_scale=self.timeout_scale,
            compute_scale=self.compute_scale, chunk_words=chunk_words,
            payload_words=payload_words,
            prefetch_depth=self.prefetch_depth, stream=self.stream)

        raw = await self._admin.request("get_stats", {"session": self.sid})
        stats = {k: (raw[k] - self._prev_stats.get(k, 0)
                     if isinstance(raw.get(k), int) else raw[k])
                 for k in raw}
        self._prev_stats = {k: v for k, v in raw.items()
                            if isinstance(v, int)}
        final = await self._admin.request("peek_average",
                                          {"session": self.sid})
        self.rounds_done += 1
        self._plain_pending = True
        bytes_now = self._total_bytes() - self._prev_bytes
        self._prev_bytes += bytes_now
        return NetResult(
            average=None if final is None else final["average"],
            weight_avg=None if final is None else final.get("weight_avg"),
            wall_time=wall,
            stats=stats,
            bytes_sent=bytes_now,
            monitor_reposts=stats["monitor_reposts"],
            initiator_elections=stats["initiator_elections"],
            crashed_nodes=crashed,
            streamed_combines=streamed,
        )

    async def close(self) -> None:
        while self._pipe:  # abandoned in-flight rounds die with us
            task = self._pipe.popleft()
            task.cancel()
            try:
                await task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
        for key in list(self._pipe_clients):
            c = self._pipe_clients.pop(key)
            await c.close()
            self._closed_bytes += c.bytes_sent
        for node in list(self._clients):
            await self._drop_client(node)
        if self._admin is not None:
            if self.sid is not None:
                try:
                    await self._admin.request("delete_session",
                                              {"session": self.sid})
                except Exception:  # noqa: BLE001
                    pass
            await self._admin.close()
            self._admin = None
        self.sid = None


async def run_federated_round_net(
    state: Any,
    local_fns: Mapping[int, Callable[[Any], np.ndarray]],
    apply_fn: Callable[[Any, np.ndarray], Any],
    addr: Addr,
    *,
    weights: Optional[np.ndarray] = None,
    counter: int = 0,
    failed_nodes: Iterable[int] = (),
    chunk_words: Optional[int] = None,
    **round_kw,
) -> Tuple[Any, NetResult]:
    """One FedAvg round over the wire plane (the paper's actual use
    case: learners chained, traffic encrypted, controller a broker).

    Each live learner runs its *real* local update — ``local_fns[node]``
    maps the shared model state to that node's f32[P] model delta (injected
    as a callable so this module stays numpy-only;
    ``train.make_wire_federated`` makes them) — then the deltas travel
    the SAFE chain through the broker at ``addr``, chunk-streamed when
    longer than ``chunk_words``. The published (weighted) mean delta is
    merged via ``apply_fn`` and the new state returned.

    Local updates run in the default executor so a co-hosted broker (or
    other tenants on this loop) keeps serving while learners compute.
    Callers advance ``counter`` by at least P (+1 when weighted) words
    per round — the pad no-reuse invariant.

    ``failed_nodes`` never compute and never connect: the §5.3/5.4
    failover machinery publishes the survivors' mean, exactly as in the
    paper's dropped-org experiment.
    """
    failed = set(failed_nodes)
    nodes = sorted(local_fns)
    if nodes != list(range(1, len(nodes) + 1)):
        raise ValueError(f"local_fns must be keyed 1..n, got {nodes}")
    if not set(nodes) - failed:
        raise ValueError("no live learners: every node is in failed_nodes")
    values = await _collect_deltas(state, local_fns, failed, nodes)

    res = await run_safe_round_net(
        values, addr, weights=weights, counter=counter,
        failed_nodes=failed, chunk_words=chunk_words, **round_kw)
    if res.average is None:
        return state, res
    return apply_fn(state, res.average), res


async def _collect_deltas(state: Any, local_fns, failed: set,
                          nodes: list) -> np.ndarray:
    """Run each live learner's local update in the default executor and
    pack the deltas learner-major (shared by the single- and multi-round
    federated runners)."""
    loop = asyncio.get_running_loop()
    deltas: Dict[int, np.ndarray] = {}
    for node in nodes:
        if node in failed:
            continue
        out = await loop.run_in_executor(None, local_fns[node], state)
        deltas[node] = np.asarray(out, np.float32).ravel()
    sizes = {d.size for d in deltas.values()}
    if len(sizes) != 1:
        raise ValueError(f"learners produced mixed delta sizes {sizes}")
    values = np.zeros((len(nodes), sizes.pop()), np.float32)
    for node, d in deltas.items():
        values[node - 1] = d
    return values


async def run_federated_rounds_net(
    state: Any,
    local_fns: Mapping[int, Callable[[Any], np.ndarray]],
    apply_fn: Callable[[Any, np.ndarray], Any],
    addr: Addr,
    *,
    rounds: int,
    weights: Optional[np.ndarray] = None,
    counter0: int = 0,
    words_per_round: Optional[int] = None,
    failed_by_round: Optional[Mapping[int, Iterable[int]]] = None,
    pipeline: bool = False,
    window: int = 2,
    **session_kw,
) -> Tuple[Any, list]:
    """R federated rounds on ONE persistent broker session — the full
    §8 pipeline on the wire, amortized the way the paper amortizes
    Round 0.

    Where :func:`run_federated_round_net` rebuilds session, connections
    and key material every round, this keeps a
    :class:`PersistentNetSession` alive for all ``rounds``: one
    ``create_session``, one set of learner TCP connections, **no key
    derivation after Round 0** (``machines.key_derivations()`` stays
    flat), with ``reset_round`` + :class:`~repro_torch.core.session.
    RoundCursor` counter bases between rounds (no pad reuse). Deltas
    chunk-stream through the chunk-granular combine by default.

    ``failed_by_round`` maps round index → nodes dead that round (they
    neither compute nor connect; §5.3/5.4 publish the survivors' mean,
    and the nodes rejoin the next round — crash-resume across the round
    boundary). ``session_kw`` forwards to
    :class:`PersistentNetSession` (``chunk_words``, ``prefetch_depth``,
    ``stream``, ``aggregation_timeout``, ...).

    ``pipeline=True`` overlaps up to ``window`` rounds on the wire
    (§11): round r+1's local updates compute — and its deltas upload —
    while round r's aggregation is still in flight. That makes the FL
    loop *staleness-1*: with the default ``window=2``, round r+1's
    deltas are computed from the state through round r−1 (round r has
    not been collected when they launch). Each round's published
    average is still the exact SAFE mean of the deltas that round
    actually shipped — the staleness is an FL-optimizer property
    (standard one-step asynchronous/pipelined SGD), not an aggregation
    approximation.

    Returns ``(final_state, [NetResult per round])``.
    """
    nodes = sorted(local_fns)
    if nodes != list(range(1, len(nodes) + 1)):
        raise ValueError(f"local_fns must be keyed 1..n, got {nodes}")
    failed_by_round = dict(failed_by_round or {})
    results: list = []
    sess = PersistentNetSession(
        addr, len(nodes), counter0=counter0,
        words_per_round=words_per_round, **session_kw)
    await sess.open()

    def fold(res: NetResult, state: Any) -> Any:
        results.append(res)
        return (state if res.average is None
                else apply_fn(state, res.average))

    try:
        for r in range(rounds):
            failed = set(failed_by_round.get(r, ()))
            if not set(nodes) - failed:
                raise ValueError(
                    f"round {r}: every node is in failed_by_round")
            if pipeline:
                while sess.pipeline_depth >= max(1, int(window)):
                    state = fold(await sess.collect_round_pipelined(),
                                 state)
                values = await _collect_deltas(state, local_fns, failed,
                                               nodes)
                await sess.start_round_pipelined(
                    values, weights=weights, failed_nodes=failed,
                    window=window)
            else:
                values = await _collect_deltas(state, local_fns, failed,
                                               nodes)
                state = fold(await sess.run_round(
                    values, weights=weights, failed_nodes=failed), state)
        while sess.pipeline_depth:
            state = fold(await sess.collect_round_pipelined(), state)
    finally:
        await sess.close()
    return state, results
