"""The PyTorch port's wire codec and fault interceptors vs the JAX package's.

The port's brokers and learners must interoperate with the reference's,
so its codec is held to the reference byte for byte: every value the
codec takes encodes to the same bytes in both packages, and what one
package encodes the other decodes to the same tree. The chunk plane's
helpers and the transport-fault interceptors must make the same
decisions from the same seeds.
"""
import asyncio
import signal

import numpy as np
import pytest

from repro.net import faults as ref_faults
from repro.net import wire as ref_wire
from repro_torch.net import faults, wire

DEADLINE_S = 90


@pytest.fixture(autouse=True)
def _hard_deadline():
    def _expired(signum, frame):
        raise TimeoutError(f"wire test exceeded {DEADLINE_S}s")

    old = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(DEADLINE_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _same_tree(a, b):
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    elif isinstance(b, dict):
        assert isinstance(a, dict) and list(a) == list(b)
        for k in b:
            _same_tree(a[k], b[k])
    elif isinstance(b, list):
        assert isinstance(a, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    else:
        assert type(a) is type(b) and a == b


_rng = np.random.RandomState(7)

#: one array of every dtype the codec takes (ARRAY_DTYPES), at sizes on
#: both sides of the zero-copy segment threshold, and a few ranks
ARRAYS = {
    "u4": _rng.randint(0, 2**32, 300, dtype=np.uint64).astype(np.uint32),
    "f4": _rng.standard_normal(37).astype(np.float32),
    "f8": _rng.standard_normal((4, 70)),
    "i4": _rng.randint(-2**31, 2**31, (3, 5), dtype=np.int64).astype(np.int32),
    "i8": _rng.randint(-2**62, 2**62, 129, dtype=np.int64),
    "u1": _rng.randint(0, 256, 2048).astype(np.uint8),
    "f4-scalar": np.array(1.5, np.float32),
    "f4-empty": np.zeros(0, np.float32),
    "f4-big-endian": np.arange(6, dtype=">f4"),
}

VALUES = {
    "scalars": {"none": None, "t": True, "f": False, "int": -(2**62),
                "np_int": np.int64(2**40), "float": -0.1, "np_float": np.float32(3.25),
                "str": "sÄfe", "bytes": b"\x00\x01" * 700, "empty": ""},
    "nested": {"groups": {"0": [1, 2, 3], "1": [4, [5, [6, None]]]},
               "alive": [True, False, True], "meta": {"deep": {"er": [{}]}}},
    "arrays": ARRAYS,
    "list-of-arrays": [ARRAYS["f4"], [ARRAYS["u4"], ARRAYS["u1"]], "tail"],
}


@pytest.mark.parametrize("name", sorted(VALUES))
def test_value_trees_same_bytes_both_ways(name):
    v = VALUES[name]
    body = wire.encode_value(v)
    assert body == ref_wire.encode_value(v)
    assert b"".join(wire.encode_value_parts(v)) == body
    _same_tree(wire.decode_value(body), ref_wire.decode_value(body))
    # requests and responses, framed, decode with the other package
    req = wire.encode_request("post_aggregate", {"payload": v, "node": 3})
    assert req == ref_wire.encode_request("post_aggregate", {"payload": v, "node": 3})
    op, kw = ref_wire.decode_request(req)
    op2, kw2 = wire.decode_request(ref_wire.encode_request("get_chunk", {"x": v}))
    assert (op, op2) == ("post_aggregate", "get_chunk")
    _same_tree(kw["payload"], wire.decode_request(req)[1]["payload"])
    _same_tree(kw2["x"], ref_wire.decode_request(
        ref_wire.encode_request("get_chunk", {"x": v}))[1]["x"])
    resp = ref_wire.encode_response(v)
    assert wire.encode_response(v) == resp
    assert wire.encode_frame(resp) == ref_wire.encode_frame(resp)
    assert (b"".join(wire.encode_frame_parts(wire.encode_response_parts(v)))
            == ref_wire.encode_frame(resp))
    _same_tree(wire.decode_response(resp), ref_wire.decode_response(resp))


@pytest.mark.parametrize("dtype", sorted(ARRAYS))
def test_each_array_dtype_round_trips_across_packages(dtype):
    a = ARRAYS[dtype]
    for enc, dec in ((wire, ref_wire), (ref_wire, wire)):
        got = dec.decode_value(enc.encode_value(a))
        assert got.dtype == a.dtype.newbyteorder("<")
        np.testing.assert_array_equal(got, a)


def test_protocol_tables_and_errors_match():
    for name in ("WIRE_VERSION", "MAX_FRAME", "OPS", "OPCODE", "VALUE_TAGS",
                 "DEFAULT_CHUNK_WORDS", "DEFAULT_PREFETCH_DEPTH",
                 "MIN_STREAM_WORDS"):
        assert getattr(wire, name) == getattr(ref_wire, name), name
    assert wire.ARRAY_DTYPES == ref_wire.ARRAY_DTYPES
    err = ref_wire.encode_error("unknown session 9")
    assert wire.encode_error("unknown session 9") == err
    with pytest.raises(wire.WireError, match="unknown session 9"):
        wire.decode_response(err)
    for bad in (np.zeros(3, np.float16), object()):
        with pytest.raises(wire.WireError):
            wire.encode_value(bad)
        with pytest.raises(ref_wire.WireError):
            ref_wire.encode_value(bad)
    truncated = ref_wire.encode_request("get_key", {"node": 1})[:-1]
    with pytest.raises(wire.WireDecodeError):
        wire.decode_request(truncated)


def _chunk_frames(mod, flat, chunk_words, xfer):
    total = mod.num_chunks(flat.size, chunk_words)
    return [mod.encode_request("post_chunk", {
        "session": 2, "node": 5, "xfer": xfer, "seq": s, "total": total,
        "chunk_words": chunk_words, "kind": "aggregate",
        "payload": mod.chunk_slice(flat, s, chunk_words)}) for s in range(total)]


@pytest.mark.parametrize("words,chunk_words", [(1000, 256), (1024, 256),
                                               (5, 1024), (0, 64)])
def test_chunk_frames_same_bytes_and_reassemble(words, chunk_words):
    flat = np.random.RandomState(words).randint(
        0, 2**32, words, dtype=np.uint64).astype(np.uint32)
    frames = _chunk_frames(wire, flat, chunk_words, xfer=11)
    assert frames == _chunk_frames(ref_wire, flat, chunk_words, xfer=11)
    assert len(frames) == wire.num_chunks(words, chunk_words) == max(
        1, -(-words // chunk_words))
    # out of order with duplicates, decoded by the other package
    order = list(range(len(frames)))[::-1] + [0, len(frames) - 1]
    asm, ref_asm = wire.ChunkAssembler(len(frames)), ref_wire.ChunkAssembler(len(frames))
    for s in order:
        _, kw = ref_wire.decode_request(frames[s])
        done = asm.add(kw["seq"], kw["payload"])
        assert done == ref_asm.add(kw["seq"], kw["payload"])
    assert asm.complete and ref_asm.complete
    np.testing.assert_array_equal(asm.assemble(), flat)
    np.testing.assert_array_equal(ref_asm.assemble(), flat)


def test_chunk_assembler_refuses_what_the_reference_refuses():
    asm = wire.ChunkAssembler(3)
    assert not asm.add(2, np.arange(2, dtype=np.uint32))
    assert not asm.add(2, np.arange(2, dtype=np.uint32))  # duplicate: overwrite
    with pytest.raises(wire.WireDecodeError, match="missing chunks \\[0, 1\\]"):
        asm.assemble()
    for bad in ((3, np.zeros(1, np.uint32)), (-1, np.zeros(1, np.uint32)),
                (0, np.zeros((1, 1), np.uint32))):
        with pytest.raises(wire.WireDecodeError):
            asm.add(*bad)
    with pytest.raises(wire.WireDecodeError):
        wire.ChunkAssembler(0)
    with pytest.raises(wire.WireError):
        wire.chunk_slice(np.zeros((2, 2)), 0, 1)


def test_frames_read_across_packages():
    async def go():
        bodies = [ref_wire.encode_request("post_average", {"average": ARRAYS["f4"]}),
                  wire.encode_response({"ok": True})]
        reader = asyncio.StreamReader()
        reader.feed_data(b"".join(ref_wire.encode_frame(b) for b in bodies))
        reader.feed_eof()
        got = [await wire.read_frame(reader) for _ in bodies]
        assert await wire.read_frame(reader) is None
        return bodies, got

    bodies, got = asyncio.run(go())
    assert got == bodies


def _drops(mod, icpt, nodes=(1, 2, 5), per_node=40):
    async def go():
        out = []
        for node in nodes:
            for i in range(per_node):
                try:
                    await icpt.on_request(node, "post_aggregate", 64)
                    out.append(0)
                except mod.DropPacket:
                    out.append(1)
        return out

    return asyncio.run(go())


def _crashes(mod, icpt, ops=12):
    async def go():
        out = []
        for i in range(ops):
            for node in (1, 5, 7):
                try:
                    await icpt.on_request(node, "check_aggregate", 8)
                except mod.LearnerCrashed as e:
                    out.append((node, e.after_ops, i))
        return out, sorted(icpt.crashed)

    return asyncio.run(go())


def _latency_parts(icpt):
    return icpt.parts if hasattr(icpt, "parts") else (icpt,)


@pytest.mark.parametrize("seed", [0, 3, 99])
def test_fault_decisions_match_reference(seed):
    assert _drops(faults, faults.DropInterceptor(p=0.3, seed=seed)) == _drops(
        ref_faults, ref_faults.DropInterceptor(p=0.3, seed=seed))
    sched = {1: 3, 5: 0, 7: 9}
    assert _crashes(faults, faults.ChurnInterceptor(sched)) == _crashes(
        ref_faults, ref_faults.ChurnInterceptor(sched))
    for make, ref_make in (
            (lambda: faults.LatencyInterceptor(mean=0.02, floor=0.001, seed=seed),
             lambda: ref_faults.LatencyInterceptor(mean=0.02, floor=0.001, seed=seed)),
            (lambda: faults.HeavyTailLatencyInterceptor(median=0.05, sigma=0.8, seed=seed),
             lambda: ref_faults.HeavyTailLatencyInterceptor(median=0.05, sigma=0.8,
                                                            seed=seed))):
        a, b = make(), ref_make()
        assert ([a._draw(n) for n in (1, 2, 5) for _ in range(32)]
                == [b._draw(n) for n in (1, 2, 5) for _ in range(32)])
    assert faults.WAN_PROFILES == ref_faults.WAN_PROFILES
    for profile in sorted(faults.WAN_PROFILES):
        got = _latency_parts(faults.make_wan_interceptor(profile, seed=seed))
        ref = _latency_parts(ref_faults.make_wan_interceptor(profile, seed=seed))
        assert [type(p).__name__ for p in got] == [type(p).__name__ for p in ref]
        for p, q in zip(got, ref):
            if hasattr(q, "_draw"):
                assert [p._draw(3) for _ in range(16)] == [q._draw(3) for _ in range(16)]
            else:
                assert _drops(faults, p) == _drops(ref_faults, q)
    got = faults.deep_edge_faults(seed=seed, crash_after={2: 4}).parts
    ref = ref_faults.deep_edge_faults(seed=seed, crash_after={2: 4}).parts
    assert [type(p).__name__ for p in got] == [type(p).__name__ for p in ref]
    assert [got[0]._draw(4) for _ in range(8)] == [ref[0]._draw(4) for _ in range(8)]
    assert _drops(faults, got[1]) == _drops(ref_faults, ref[1])
