"""Binary wire codec for the SAFE broker protocol.

Compact, length-prefixed, versioned framing for every controller op in
:mod:`repro_torch.core.controller` plus the engine-plane session ops. The
design goals, in order:

  1. **Exactness** — masked payloads are uint32 ring elements and the
     published average must survive the wire bit-for-bit, so arrays
     travel as raw little-endian bytes with their dtype tagged (no JSON
     float round-tripping; this is also 2–3x smaller than the base64
     JSON the paper's Flask broker shipped, §6.2).
  2. **Self-description** — requests/responses carry a one-byte version
     and a tagged value tree, so the codec round-trips every op payload
     (property-tested in ``tests/test_wire.py``) and unknown frames fail
     loudly instead of misparsing.
  3. **No heavyweight deps** — pure ``struct`` + numpy; the broker can
     run on a host with no accelerator stack.

Frame layout (everything big-endian except raw array bytes, which are
little-endian numpy canonical):

    frame    := u32 body_len | body                (body_len <= MAX_FRAME)
    request  := u8 version | u8 opcode | value     (value: kwargs dict)
    response := u8 version | u8 status | value     (status 0 ok, 1 error)

Value encoding is a tagged tree: ``u8 tag`` followed by tag-specific
bytes — None/bool singletons, i64 ints, f64 floats, length-prefixed
utf-8 strings and bytes, lists, dicts (arbitrary encodable keys, so
``{group: [nodes]}`` int-keyed maps survive), and ndarrays
(``u8 dtype | u8 ndim | u32 dims… | raw``).

Arrays larger than one frame do not travel as one value: the chunked
transfer path (``post_chunk``/``get_chunk``, rules in docs/PROTOCOL.md
§6) splits a flat vector into ``chunk_words``-sized slices with
per-chunk sequence numbers, streamed as ordinary frames and reassembled
by :class:`ChunkAssembler`. The authoritative spec for the whole layer
— frames, opcodes, value tags, chunking, versioning — is
``docs/PROTOCOL.md``; ``tests/test_docs.py`` asserts its tables match
the registries below, so the book cannot silently drift from the code.

**Zero-copy discipline** (docs/PROTOCOL.md §12): decoding works over
any buffer object — ``bytes``, ``bytearray`` or a ``memoryview`` at a
non-zero offset into a larger receive buffer — without slicing it into
intermediate ``bytes``. ``decode_request(..., copy_arrays=False)``
returns array values as read-only ``np.frombuffer`` views straight into
the frame buffer (the broker's store-and-forward path relays these
views untouched); the default ``copy_arrays=True`` hands out writable
copies, which the state machines require. On the encode side the
``*_parts`` variants return a list of buffer segments — small scalars
coalesced into ``bytearray`` runs, large arrays/bytes as zero-copy
``memoryview``s — for ``StreamWriter.writelines`` scatter-gather sends,
so a relayed chunk is materialized exactly once (at the socket read).

The PyTorch port's copy of the JAX package's ``net/wire.py``, with the same
semantics and the same bytes on the wire, so either package's
brokers and learners can talk to the other's.
"""
from __future__ import annotations

import asyncio
import struct
from typing import Any, Iterable, Optional, Tuple

import numpy as np

#: bump on breaking frame-layout changes; decoders reject other versions.
WIRE_VERSION = 1

#: hard cap on one frame's body — a 64 MiB vector is ~16M ring words,
#: far beyond any payload this repo ships; bigger lengths are treated as
#: stream corruption rather than an allocation request.
MAX_FRAME = 64 << 20


class WireError(Exception):
    """Protocol-level failure (broker returned an error response)."""


class WireDecodeError(WireError):
    """Malformed frame: bad version, unknown tag/opcode, truncation."""


# ---------------------------------------------------------------------------
# Opcodes — every controller op plus session management / engine plane
# ---------------------------------------------------------------------------

OPS: Tuple[str, ...] = (
    # session management
    "create_session",
    # controller call ops (core/controller.CALL_OPS)
    "post_aggregate",
    "post_average",
    "should_initiate",
    "register_key",
    "get_key",
    # controller long-poll kinds (core/controller.WAIT_KINDS)
    "check_aggregate",
    "get_aggregate",
    "get_average",
    # observability / admin (non-counting, mirrors the sim kernel's view)
    "peek_average",
    "get_stats",
    "reset_round",
    # engine plane (serve/agg_engine.AggregationEngine behind the broker)
    "submit_session",
    "wait_session",
    # session teardown (a long-lived broker must not accumulate tenants)
    "delete_session",
    # chunked transfer plane (docs/PROTOCOL.md §6) — transport frames
    # for arrays larger than one frame; never counted in MessageStats
    "post_chunk",
    "get_chunk",
    # sharded deployments (docs/PROTOCOL.md §12): the shard topology a
    # client uses to dial a session's owning worker directly. Appended
    # per the §9 additive-opcode policy — no version bump.
    "get_shard_map",
    # observability plane (docs/PROTOCOL.md §13): a live metrics
    # snapshot — rounds/s, latency percentiles, backlog, per-session
    # series. Admin-class: never counted in MessageStats, never timed.
    # Appended per the §9 additive-opcode policy — no version bump.
    "get_metrics",
    # BON baseline plane (docs/PROTOCOL.md §14): the Bonawitz-style
    # 4-round protocol (core/bon_controller.py) on the same transport,
    # for the head-to-head bake-off of benchmarks/bon_wire.py. Counted
    # in BonStats (never MessageStats). Appended per §9 — no bump.
    "bon_advertise",
    "bon_post_share",
    "bon_post_masked",
    "bon_post_unmask",
    "bon_get_keys",
    "bon_get_share",
    "bon_get_roster",
    "bon_get_average",
    # cross-round pipelining (docs/PROTOCOL.md §11): non-destructive
    # round boundary for persistent sessions — completes the current
    # round and opens the next without dropping round r+1 transfer
    # buffers already in flight. Admin-class: never counted, never
    # timed. Appended per the §9 additive-opcode policy — no bump.
    "advance_round",
    # hierarchical chain-of-chains (docs/PROTOCOL.md §15, paper §5.10):
    # a child org's broker posts its anonymized group average UP to a
    # parent session (post_org_average, counted+timed in HierStats) and
    # long-polls the folded parent average back DOWN (get_org_average,
    # counted in HierStats). Never counted in MessageStats — the §5
    # per-org closed forms stay exact. Appended per §9 — no bump.
    "post_org_average",
    "get_org_average",
)
OPCODE = {name: i + 1 for i, name in enumerate(OPS)}
OPNAME = {i + 1: name for i, name in enumerate(OPS)}

#: Value-tag registry (names are the canonical spellings used by
#: docs/PROTOCOL.md §4 — the doc-sync test compares this mapping).
VALUE_TAGS = {
    "none": 0,
    "true": 1,
    "false": 2,
    "int": 3,
    "float": 4,
    "str": 5,
    "bytes": 6,
    "list": 7,
    "dict": 8,
    "array": 9,
}

_T_NONE = VALUE_TAGS["none"]
_T_TRUE = VALUE_TAGS["true"]
_T_FALSE = VALUE_TAGS["false"]
_T_INT = VALUE_TAGS["int"]
_T_FLOAT = VALUE_TAGS["float"]
_T_STR = VALUE_TAGS["str"]
_T_BYTES = VALUE_TAGS["bytes"]
_T_LIST = VALUE_TAGS["list"]
_T_DICT = VALUE_TAGS["dict"]
_T_ARRAY = VALUE_TAGS["array"]

#: array dtype codes — little-endian canonical forms only (public: the
#: doc-sync test pins docs/PROTOCOL.md §5 to this table)
ARRAY_DTYPES = {
    0: np.dtype("<u4"),
    1: np.dtype("<f4"),
    2: np.dtype("<f8"),
    3: np.dtype("<i4"),
    4: np.dtype("<i8"),
    5: np.dtype("<u1"),
}
_DTYPES = ARRAY_DTYPES
_DTYPE_CODES = {dt.str: code for code, dt in _DTYPES.items()}


# ---------------------------------------------------------------------------
# Value tree
# ---------------------------------------------------------------------------

#: arrays / bytes at or above this many bytes travel as their own
#: zero-copy segment in the parts encoders; smaller ones are coalesced
#: into the adjacent scalar run (one tiny iovec per int is slower than
#: one memcpy).
_SEGMENT_BYTES = 1024


def _tail(parts: list) -> bytearray:
    """The growable scalar run at the end of ``parts``."""
    if not parts or not isinstance(parts[-1], bytearray):
        parts.append(bytearray())
    return parts[-1]


def _enc_value(v: Any, parts: list) -> None:
    """Append ``v``'s encoding to ``parts`` — bytearray runs for
    scalars/headers, zero-copy buffer segments for bulk arrays/bytes."""
    out = _tail(parts)
    if v is None:
        out.append(_T_NONE)
    elif v is True:
        out.append(_T_TRUE)
    elif v is False:
        out.append(_T_FALSE)
    elif isinstance(v, (int, np.integer)):
        out.append(_T_INT)
        out += struct.pack(">q", int(v))
    elif isinstance(v, (float, np.floating)):
        out.append(_T_FLOAT)
        out += struct.pack(">d", float(v))
    elif isinstance(v, str):
        raw = v.encode("utf-8")
        out.append(_T_STR)
        out += struct.pack(">I", len(raw))
        out += raw
    elif isinstance(v, (bytes, bytearray, memoryview)):
        raw = memoryview(v)
        if raw.ndim != 1 or raw.itemsize != 1:
            raw = raw.cast("B")
        out.append(_T_BYTES)
        out += struct.pack(">I", raw.nbytes)
        if raw.nbytes >= _SEGMENT_BYTES:
            parts.append(raw)  # zero-copy: the segment references v
        else:
            out += raw
    elif isinstance(v, np.ndarray):
        dt = v.dtype.newbyteorder("<")
        code = _DTYPE_CODES.get(dt.str)
        if code is None:
            raise WireError(f"unsupported array dtype {v.dtype}")
        if v.ndim > 255:
            raise WireError(f"array rank {v.ndim} too large")
        out.append(_T_ARRAY)
        out += struct.pack(">BB", code, v.ndim)
        for d in v.shape:
            out += struct.pack(">I", d)
        arr = np.ascontiguousarray(v, dtype=dt)  # no-op when already so
        if arr.nbytes >= _SEGMENT_BYTES and arr.ndim > 0:
            # scatter-gather segment straight over the array's memory —
            # works for read-only views (relayed chunks) too
            parts.append(memoryview(arr).cast("B"))
        else:
            out += arr.tobytes()
    elif isinstance(v, (list, tuple)):
        out.append(_T_LIST)
        out += struct.pack(">I", len(v))
        for item in v:
            _enc_value(item, parts)
    elif isinstance(v, dict):
        out.append(_T_DICT)
        out += struct.pack(">I", len(v))
        for k, item in v.items():
            _enc_value(k, parts)
            _enc_value(item, parts)
    else:
        raise WireError(f"unencodable value of type {type(v).__name__}")


def parts_nbytes(parts: Iterable) -> int:
    """Total byte length of a parts list (buffers of any itemsize)."""
    return sum(memoryview(p).nbytes for p in parts)


class _Cursor:
    """Bounds-checked reader over one frame body — any buffer object,
    including a ``memoryview`` at a non-zero offset into a larger
    receive buffer (the zero-copy decode contract, PROTOCOL.md §12)."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf, pos: int = 0):
        mv = memoryview(buf)
        if mv.ndim != 1 or mv.itemsize != 1:
            mv = mv.cast("B")
        self.buf = mv
        self.pos = pos

    def take(self, n: int) -> memoryview:
        if n < 0 or self.pos + n > len(self.buf):
            raise WireDecodeError(
                f"truncated frame: need {n} bytes at offset {self.pos}, "
                f"have {len(self.buf) - self.pos}")
        chunk = self.buf[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def u8(self) -> int:
        return self.take(1)[0]

    def u32(self) -> int:
        return struct.unpack(">I", self.take(4))[0]


def _dec_value(cur: _Cursor, copy_arrays: bool = True) -> Any:
    tag = cur.u8()
    if tag == _T_NONE:
        return None
    if tag == _T_TRUE:
        return True
    if tag == _T_FALSE:
        return False
    if tag == _T_INT:
        return struct.unpack(">q", cur.take(8))[0]
    if tag == _T_FLOAT:
        return struct.unpack(">d", cur.take(8))[0]
    if tag == _T_STR:
        return str(cur.take(cur.u32()), "utf-8")
    if tag == _T_BYTES:
        return bytes(cur.take(cur.u32()))
    if tag == _T_ARRAY:
        code, ndim = struct.unpack(">BB", cur.take(2))
        dt = _DTYPES.get(code)
        if dt is None:
            raise WireDecodeError(f"unknown array dtype code {code}")
        shape = tuple(cur.u32() for _ in range(ndim))
        count = 1
        for d in shape:  # python ints: no silent overflow on huge dims
            count *= d
        nbytes = count * dt.itemsize
        if nbytes > len(cur.buf) - cur.pos:
            raise WireDecodeError(
                f"array shape {shape} claims more bytes than the frame holds")
        # decode straight out of the frame buffer: a writable copy by
        # default (frombuffer views are read-only and the state machines
        # do arithmetic on received payloads) — or, for relay paths that
        # never mutate (copy_arrays=False), the view itself, which keeps
        # the frame buffer alive and is re-encoded as a zero-copy
        # segment on the way out
        arr = np.frombuffer(cur.buf, dtype=dt, count=count,
                            offset=cur.pos).reshape(shape)
        if copy_arrays:
            arr = arr.copy()
        else:
            # pin read-only even over writable source buffers
            # (bytearray receive buffers): relay views must never be
            # mutated, or the shared frame bytes corrupt under fan-out
            arr.flags.writeable = False
        cur.pos += nbytes
        return arr
    if tag == _T_LIST:
        return [_dec_value(cur, copy_arrays) for _ in range(cur.u32())]
    if tag == _T_DICT:
        n = cur.u32()
        out = {}
        for _ in range(n):
            k = _dec_value(cur, copy_arrays)
            out[k] = _dec_value(cur, copy_arrays)
        return out
    raise WireDecodeError(f"unknown value tag {tag}")


def encode_value(v: Any) -> bytes:
    return b"".join(encode_value_parts(v))


def encode_value_parts(v: Any) -> list:
    """Encode one value as a list of buffer segments (see module doc)."""
    parts: list = []
    _enc_value(v, parts)
    return parts


def decode_value(buf, copy_arrays: bool = True) -> Any:
    cur = _Cursor(buf)
    v = _dec_value(cur, copy_arrays)
    if cur.pos != len(cur.buf):
        raise WireDecodeError(
            f"{len(cur.buf) - cur.pos} trailing bytes after value")
    return v


# ---------------------------------------------------------------------------
# Requests / responses / frames
# ---------------------------------------------------------------------------


def encode_request_parts(op: str, kwargs: dict) -> list:
    """Request body as buffer segments: version, opcode, kwargs tree."""
    code = OPCODE.get(op)
    if code is None:
        raise WireError(f"unknown op {op!r}")
    parts: list = [bytearray(struct.pack(">BB", WIRE_VERSION, code))]
    _enc_value(dict(kwargs), parts)
    return parts


def encode_request(op: str, kwargs: dict) -> bytes:
    """Request body (unframed): version, opcode, kwargs value-tree."""
    return b"".join(encode_request_parts(op, kwargs))


def decode_request(body, copy_arrays: bool = True) -> Tuple[str, dict]:
    cur = _Cursor(body)
    version, code = struct.unpack(">BB", cur.take(2))
    if version != WIRE_VERSION:
        raise WireDecodeError(f"wire version {version} != {WIRE_VERSION}")
    op = OPNAME.get(code)
    if op is None:
        raise WireDecodeError(f"unknown opcode {code}")
    kwargs = _dec_value(cur, copy_arrays)
    if cur.pos != len(cur.buf):
        raise WireDecodeError("trailing bytes after request")
    if not isinstance(kwargs, dict):
        raise WireDecodeError("request kwargs must decode to a dict")
    return op, kwargs


_ST_OK = 0
_ST_ERR = 1


def encode_response_parts(payload: Any) -> list:
    parts: list = [bytearray(struct.pack(">BB", WIRE_VERSION, _ST_OK))]
    _enc_value(payload, parts)
    return parts


def encode_response(payload: Any) -> bytes:
    return b"".join(encode_response_parts(payload))


def encode_error(message: str) -> bytes:
    parts: list = [bytearray(struct.pack(">BB", WIRE_VERSION, _ST_ERR))]
    _enc_value(message, parts)
    return b"".join(parts)


def decode_response(body, copy_arrays: bool = True) -> Any:
    """Decode a response body; raises :class:`WireError` on error status."""
    cur = _Cursor(body)
    version, status = struct.unpack(">BB", cur.take(2))
    if version != WIRE_VERSION:
        raise WireDecodeError(f"wire version {version} != {WIRE_VERSION}")
    payload = _dec_value(cur, copy_arrays)
    if cur.pos != len(cur.buf):
        raise WireDecodeError("trailing bytes after response")
    if status == _ST_ERR:
        raise WireError(str(payload))
    if status != _ST_OK:
        raise WireDecodeError(f"unknown response status {status}")
    return payload


def encode_frame(body: bytes) -> bytes:
    if len(body) > MAX_FRAME:
        raise WireError(f"frame body {len(body)} exceeds MAX_FRAME")
    return struct.pack(">I", len(body)) + body


def encode_frame_parts(body_parts: list) -> list:
    """Frame a parts-encoded body for ``StreamWriter.writelines``: the
    u32 length prefix followed by the body segments, no concatenation —
    bulk segments go to the socket straight from where they already
    live (the §12 scatter-gather send)."""
    total = parts_nbytes(body_parts)
    if total > MAX_FRAME:
        raise WireError(f"frame body {total} exceeds MAX_FRAME")
    return [struct.pack(">I", total)] + body_parts


# ---------------------------------------------------------------------------
# Chunked array transfer (docs/PROTOCOL.md §6)
# ---------------------------------------------------------------------------

#: default chunk size in array elements — 1 Mi ring words = 4 MiB of
#: uint32 per chunk, comfortably inside MAX_FRAME with headers to spare.
DEFAULT_CHUNK_WORDS = 1 << 20

#: default number of get_chunk requests a downloading client keeps in
#: flight ahead of the chunk it is processing. 2 keeps the socket and
#: the combine busy simultaneously without triple-buffering memory;
#: picked by the prefetch-depth ablation in ``benchmarks/streaming.py``
#: (depth 1 leaves the link idle during each combine, depth 4 measured
#: no further gain on the localhost profile).
DEFAULT_PREFETCH_DEPTH = 2


#: words below which the chunk-granular streaming combine loses to the
#: buffered reassemble-then-combine path: per-chunk crypto calls, ack
#: round-trips and the aux connection cost a fixed overhead that short
#: vectors cannot amortize (BENCH_streaming.json measured the streamed
#: hop at x0.92 of buffered for V=4096 rounds). Clients resolve a
#: ``("stream", ...)`` yield to the buffered path below this threshold
#: unless the caller forces streaming; 16Ki words = 64 KiB of ring
#: payload, several chunks' worth at every benchmarked chunk size.
MIN_STREAM_WORDS = 1 << 14


def num_chunks(words: int, chunk_words: int) -> int:
    """Chunks needed for a ``words``-element vector (>= 1: a zero-length
    vector still travels as one empty chunk so metadata arrives)."""
    if chunk_words < 1:
        raise WireError(f"chunk_words must be >= 1, got {chunk_words}")
    return max(1, -(-words // chunk_words))


def chunk_slice(arr: np.ndarray, seq: int, chunk_words: int) -> np.ndarray:
    """Chunk ``seq`` of a flat array: elements [seq*cw, (seq+1)*cw).

    The last chunk is short when the length is not a multiple of
    ``chunk_words``; a length that is an exact multiple produces no
    empty trailing chunk (the boundary case tests pin this down).
    """
    if arr.ndim != 1:
        raise WireError(
            f"chunked transfer carries flat vectors, got rank {arr.ndim}")
    return arr[seq * chunk_words:(seq + 1) * chunk_words]


class ChunkAssembler:
    """Reassemble one chunked transfer; order-independent, duplicate-safe.

    Chunks may arrive in any order (each carries its own ``seq`` and the
    transfer-wide ``total``); a repeated ``seq`` overwrites (at-least-
    once delivery upstream is safe because chunk payloads are immutable
    within one transfer id). ``add`` returns True once every chunk is
    present; ``assemble`` concatenates in sequence order.
    """

    __slots__ = ("total", "chunks")

    def __init__(self, total: int):
        if total < 1:
            raise WireDecodeError(f"transfer total must be >= 1, got {total}")
        self.total = total
        self.chunks: dict = {}

    def add(self, seq: int, payload: np.ndarray) -> bool:
        if not 0 <= seq < self.total:
            raise WireDecodeError(
                f"chunk seq {seq} outside transfer of {self.total}")
        if not isinstance(payload, np.ndarray) or payload.ndim != 1:
            raise WireDecodeError("chunk payload must be a flat ndarray")
        self.chunks[seq] = payload
        return self.complete

    @property
    def complete(self) -> bool:
        return len(self.chunks) == self.total

    def assemble(self) -> np.ndarray:
        if not self.complete:
            missing = sorted(set(range(self.total)) - set(self.chunks))
            raise WireDecodeError(f"transfer missing chunks {missing[:8]}")
        return np.concatenate([self.chunks[s] for s in range(self.total)])


async def read_frame(reader) -> Optional[bytes]:
    """Read one length-prefixed frame from an asyncio StreamReader.

    Returns None on clean EOF at a frame boundary; raises
    WireDecodeError on oversize lengths (stream corruption) and
    ``asyncio.IncompleteReadError`` on mid-frame EOF.
    """
    try:
        header = await reader.readexactly(4)
    except asyncio.IncompleteReadError as e:
        if not e.partial:
            return None  # clean EOF between frames
        raise
    (length,) = struct.unpack(">I", header)
    if length > MAX_FRAME:
        raise WireDecodeError(f"frame length {length} exceeds MAX_FRAME")
    return await reader.readexactly(length)
