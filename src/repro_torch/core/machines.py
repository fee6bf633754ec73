"""SAFE learner state machines — runtime-agnostic protocol coroutines.

The paper's learners (§5.1.1 initiator / §5.1.2 non-initiator, with the
§5.3–5.4 failover paths) as Python generators. They do *real* masking
arithmetic on numpy arrays but never touch a clock, a socket, or the
broker directly: every externally-visible action is a yield,

  ("compute", seconds)                       local work
  ("call",  op, kwargs, nbytes)              non-blocking controller op
  ("wait",  kind, kwargs, nbytes, timeout)   long-poll; resumes with the
                                             result or {"status":"timeout"}

plus the streaming-combine form of the §5.1.2 hot path,

  ("stream", kwargs, nbytes, timeout)        fused receive+combine+post:
                                             a runtime that can stream
                                             chunks performs the per-
                                             chunk combine (kwargs
                                             carries the closure) and
                                             resumes with
                                             {"status": "streamed", ...};
                                             any other runtime treats it
                                             as a plain get_aggregate
                                             wait and the machine falls
                                             back to whole-vector
                                             decrypt/add/encrypt/post —
                                             same bits, same §5 counts,

and the streaming form of the §5.1.1 initiator unmask,

  ("unmask", kwargs, nbytes, timeout)        fused receive+unmask+publish:
                                             a chunk-capable runtime
                                             decrypt-subtract-decodes
                                             chunk k (kwargs carries the
                                             closure) and publishes the
                                             average slice while chunk
                                             k+1 is still on its last
                                             hop, resuming with
                                             {"status": "unmasked", ...};
                                             any other runtime treats it
                                             as a plain get_aggregate
                                             wait — same bits, same
                                             counts (exactly one
                                             post_average either way),

and the final result is returned via StopIteration. Two runtimes drive
the identical coroutines:

  * the discrete-event kernel (``core/protocol.py``) — virtual time,
    closed-form message-count validation;
  * the wire runtime (``net/client.py``) — real asyncio transport to the
    ``net/broker.py`` server, wall-clock timeouts, injected faults.

That both planes share these generators (and the same ``Controller``) is
what makes the wire plane's published average bit-identical to the sim's
for the same seeds and topology.

``timeout`` in a ``wait`` yield is ``None`` (wait forever), a float in
*virtual seconds* (the sim uses it directly; the wire runtime scales it
to wall seconds), or the string ``"aggregation"`` (the broker's
aggregation timeout, §5.4).

The PyTorch port's copy of the JAX package's ``core/machines.py``, with the same
semantics.
"""
from __future__ import annotations

from typing import Any, Dict, Generator, Iterable, Optional

import numpy as np

from repro_torch.core.costs import CostModel, EDGE
from repro_torch.crypto.np_impl import (
    NpFixedPoint,
    derive_key_np,
    derive_pair_key_np,
    keystream_pair_lanes_np,
    keystream_slice_np,
)
from repro_torch.topology import RingTopology

_TAG_HOP_PAD = 0x50
_TAG_INITIATOR_MASK = 0x52

LearnerGen = Generator[tuple, Any, None]


def key_derivations() -> int:
    """Total Threefry key derivations performed by LearnerCrypto objects
    so far (constructions + pair-key cache misses). Persistent-session
    acceptance hinges on this staying flat after Round 0 — the broker
    tests and ``benchmarks/streaming.py`` snapshot it around rounds."""
    return LearnerCrypto._derivations


# ---------------------------------------------------------------------------
# Crypto helpers (real arithmetic; costs accounted separately)
# ---------------------------------------------------------------------------


class LearnerCrypto:
    """Hop encryption for one learner: Threefry one-time pads over Z/2^32Z.

    ``symmetric_only`` models §5.8 pre-negotiation (deep-edge profile);
    otherwise each hop additionally pays the RSA wrap/unwrap (§5.7 hybrid).
    """

    #: class-wide Threefry derivation tally (see :func:`key_derivations`)
    _derivations = 0

    def __init__(self, node: int, provisioning_seed: int, learner_master: int,
                 scale_bits: int = 16, encrypt: bool = True,
                 symmetric_only: bool = False):
        self.node = node
        self.codec = NpFixedPoint(scale_bits)
        self.encrypt_enabled = encrypt
        self.symmetric_only = symmetric_only
        prov = np.array([provisioning_seed & 0xFFFFFFFF,
                         (provisioning_seed >> 32) & 0xFFFFFFFF], np.uint32)
        self._pad_seed = derive_key_np(prov, _TAG_HOP_PAD)
        master = np.array([learner_master & 0xFFFFFFFF,
                           (learner_master >> 32) & 0xFFFFFFFF], np.uint32)
        self._own = derive_key_np(derive_key_np(master, node), _TAG_INITIATOR_MASK)
        # pair keys are derived once per (src, dst) and cached: a
        # persistent multi-round session (and the chunk-granular combine,
        # which touches the pad many times per vector) must not re-derive
        # per use — the Round-0 amortization the paper counts on
        self._pair_keys: Dict[tuple, np.ndarray] = {}
        LearnerCrypto._derivations += 4  # prov tag + master, node, R tags

    def _pair_key(self, src: int, dst: int) -> np.ndarray:
        k = self._pair_keys.get((src, dst))
        if k is None:
            k = derive_pair_key_np(self._pad_seed, src, dst)
            self._pair_keys[(src, dst)] = k
            LearnerCrypto._derivations += 1
        return k

    def pad(self, src: int, dst: int, n: int, counter: int) -> np.ndarray:
        return keystream_pair_lanes_np(self._pair_key(src, dst), n, counter)

    def pad_slice(self, src: int, dst: int, start: int, n: int,
                  counter: int) -> np.ndarray:
        """Words [start, start+n) of the (src→dst, counter) hop pad —
        bit-identical to ``pad(src, dst, total, counter)[start:start+n]``
        (the seekability the chunk-granular combine runs on)."""
        return keystream_slice_np(self._pair_key(src, dst), n, start, counter)

    def mask_r(self, n: int, counter: int) -> np.ndarray:
        return keystream_pair_lanes_np(self._own, n, counter)

    def mask_r_slice(self, start: int, n: int, counter: int) -> np.ndarray:
        """Words [start, start+n) of the initiator mask R — bit-identical
        to ``mask_r(total, counter)[start:start+n]`` (the same keystream
        seekability the chunk-granular combine runs on), so the
        streaming unmask can subtract R chunk by chunk."""
        return keystream_slice_np(self._own, n, start, counter)

    def hop_encrypt(self, plain_ring: np.ndarray, dst: int, counter: int) -> np.ndarray:
        if not self.encrypt_enabled:
            return plain_ring
        return NpFixedPoint.add(plain_ring, self.pad(self.node, dst, plain_ring.size, counter))

    def hop_decrypt(self, cipher: np.ndarray, src: int, counter: int) -> np.ndarray:
        if not self.encrypt_enabled:
            return cipher
        return NpFixedPoint.sub(cipher, self.pad(src, self.node, cipher.size, counter))

    def hop_encrypt_slice(self, plain_chunk: np.ndarray, dst: int,
                          counter: int, start: int) -> np.ndarray:
        if not self.encrypt_enabled:
            return plain_chunk
        return NpFixedPoint.add(plain_chunk, self.pad_slice(
            self.node, dst, start, plain_chunk.size, counter))

    def hop_decrypt_slice(self, cipher_chunk: np.ndarray, src: int,
                          counter: int, start: int) -> np.ndarray:
        if not self.encrypt_enabled:
            return cipher_chunk
        return NpFixedPoint.sub(cipher_chunk, self.pad_slice(
            src, self.node, start, cipher_chunk.size, counter))


# ---------------------------------------------------------------------------
# Learner state machines (paper §5.1.1 / §5.1.2, with §5.3–5.4 failover)
# ---------------------------------------------------------------------------


def safe_learner(
    node: int,
    topology: RingTopology,
    value: np.ndarray,
    crypto: LearnerCrypto,
    cost: CostModel,
    group: int = 0,
    is_initiator: bool = False,
    weight: Optional[float] = None,
    counter: int = 0,
    fail_mode: Optional[str] = None,
    subgroups: int = 1,
    node_base: int = 1,
) -> LearnerGen:
    """One SAFE learner for one aggregation round.

    Successor targeting comes from the shared ``topology`` object (the
    same one the device plane's ppermute schedule is built from);
    ``node_base`` maps 0-based topology ranks onto the sim's node ids.

    fail_mode: None | 'dead' (crashed before round — never spawned by the
    runner, listed here for completeness) | 'after_post' (initiator crash
    of Fig. 5: posts its first aggregate then stops responding).
    """
    codec = crypto.codec
    nxt = topology.successor(node - node_base) + node_base
    payload_f = value if weight is None else np.concatenate(
        [value * weight, np.array([weight], value.dtype)])
    V = payload_f.size
    # base64-wrapped binary ciphertext: ~6 bytes/element on the wire —
    # the "encryption helps with compression" effect of §6.2 (INSEC posts
    # clear-text JSON floats at ~14 bytes/element)
    nbytes = 6 * V

    def enc_cost():
        return cost.encrypt(nbytes, crypto.symmetric_only)

    def _election():
        """§5.4 path after any aggregation timeout: probe the average,
        else ask to become initiator. Returns 'done'|'initiator'|'rejoin'."""
        res = yield ("wait", "get_average", dict(), nbytes, 0.01)
        if res.get("status") != "timeout":
            return "done"
        won = yield ("call", "should_initiate", dict(node=node, group=group), 64)
        if won:
            return "initiator"
        res = yield ("wait", "get_average", dict(), nbytes, 0.01)
        if res.get("status") != "timeout":
            return "done"
        return "rejoin"

    def _post_and_confirm(agg, posted=False):
        """post_aggregate + check_aggregate loop, handling §5.3 reposts and
        round resets. Returns the terminal status dict (status is
        'consumed'|'reset'|'timeout'|'self' — 'self' means every repost
        target was dead and the poster's own aggregate is final).
        ``posted=True`` means the streaming-combine path already shipped
        the encrypted aggregate chunk-by-chunk — skip straight to the
        confirmation loop (repost retargets still re-encrypt ``agg``
        whole, exactly as in the buffered path)."""
        if not posted:
            yield ("compute", enc_cost())
            cipher = crypto.hop_encrypt(agg, nxt, counter)
            yield ("call", "post_aggregate",
                   dict(from_node=node, to_node=nxt, payload=cipher,
                        group=group), nbytes)
        while True:
            st = yield ("wait", "check_aggregate", dict(node=node, group=group),
                        64, "aggregation")
            status = st.get("status")
            if status in ("consumed", "reset", "timeout", "self"):
                return st
            assert status == "repost"
            target = st["to_node"]
            yield ("compute", enc_cost())
            cipher = crypto.hop_encrypt(agg, target, counter)
            yield ("call", "post_aggregate",
                   dict(from_node=node, to_node=target, payload=cipher, group=group),
                   nbytes)

    initiator_now = is_initiator
    while True:  # restarts on initiator failover (§5.4)
        if initiator_now:
            # -- §5.1.1 steps 1-2: mask with R, encrypt for next, post.
            yield ("compute", cost.t_rng_word * V + cost.t_add_elem * V)
            R = crypto.mask_r(V, counter)
            agg = NpFixedPoint.add(codec.encode(payload_f), R)
            if fail_mode == "after_post":
                # Fig. 5 step 3: initiator posts once, then crashes.
                yield ("compute", enc_cost())
                cipher = crypto.hop_encrypt(agg, nxt, counter)
                yield ("call", "post_aggregate",
                       dict(from_node=node, to_node=nxt, payload=cipher, group=group),
                       nbytes)
                return

            st = yield from _post_and_confirm(agg)
            if st["status"] in ("reset", "timeout"):
                verdict = yield from _election()
                if verdict == "done":
                    return
                initiator_now = verdict == "initiator"
                continue

            dec = None
            published = False
            if st["status"] == "self":
                # Lone survivor (§5.3 degenerate case): every repost
                # target was dead, the aggregate never left this node —
                # unmask the local copy, no decrypt hop.
                total = agg
                posted = st["posted"]
            else:
                # -- §5.1.1 steps 3-4: receive final aggregate, unmask.
                # Yielded as "unmask" so a chunk-capable runtime can
                # decrypt-subtract-decode chunk k (the pad and R are
                # both seekable) and publish the average slice while
                # chunk k+1 is still on its last hop — §8's "publication
                # overlaps the final relay". Elementwise over Z/2^32Z,
                # so any chunking produces the same bits as the whole-
                # vector path below, which every other runtime takes by
                # resolving the yield as a plain get_aggregate wait.
                def _unmask_chunk(start: int, cipher_chunk: np.ndarray,
                                  src: int) -> np.ndarray:
                    plain = crypto.hop_decrypt_slice(cipher_chunk, src,
                                                     counter, start)
                    return codec.decode(NpFixedPoint.sub(
                        plain, crypto.mask_r_slice(
                            start, cipher_chunk.size, counter)))

                res = yield ("unmask",
                             dict(node=node, group=group,
                                  unmask=_unmask_chunk, payload_words=V,
                                  weighted=weight is not None),
                             nbytes, "aggregation")
                if res.get("status") == "timeout":
                    verdict = yield from _election()
                    if verdict == "done":
                        return
                    initiator_now = verdict == "initiator"
                    continue
                if res.get("status") == "unmasked":
                    # chunk-granular unmask done on the fly; `decoded`
                    # is the assembled plaintext sum, `published` says
                    # whether the streamed post_average landed (a
                    # superseded upload falls back to a whole post).
                    dec = res["decoded"]
                    posted = res["posted"]
                    published = res.get("published", False)
                else:
                    yield ("compute", cost.decrypt(nbytes, crypto.symmetric_only))
                    total = crypto.hop_decrypt(res["aggregate"], res["from_node"], counter)
                    posted = res["posted"]  # §5.3: contributor count from controller
            if dec is None:
                yield ("compute", cost.t_add_elem * V * 2)
                total = NpFixedPoint.sub(total, R)
                dec = codec.decode(total)
            if weight is not None:
                avg = dec[:-1] / max(dec[-1], 1e-12)
                wavg = dec[-1] / posted
            else:
                avg = dec / posted
                wavg = None
            if not published:
                yield ("call", "post_average",
                       dict(node=node, average=avg, group=group,
                            weight_avg=wavg), nbytes)
            if subgroups > 1:
                # §5.5: group initiators must fetch the cross-group average.
                yield ("wait", "get_average", dict(), nbytes, None)
            return
        else:
            # -- §5.1.2 non-initiator. The receive+combine+forward hop is
            # the chain's hot path; yield it as a "stream" so a chunk-
            # capable runtime can decrypt/add/re-encrypt chunk k (the pad
            # is seekable, `_combine_chunk`) and ship it downstream while
            # chunk k+1 is still in flight — the §8 pipelined schedule
            # inside one hop. Runtimes without streaming resolve the
            # yield as a plain get_aggregate wait and the classic whole-
            # vector path below runs, bit-identical.
            enc_payload_box: list = []

            def _enc_payload() -> np.ndarray:
                if not enc_payload_box:
                    enc_payload_box.append(codec.encode(payload_f))
                return enc_payload_box[0]

            def _combine_chunk(start: int, cipher_chunk: np.ndarray,
                               src: int):
                """Chunk-granular §5.1.2 combine on words
                [start, start+len): returns (outgoing ciphertext for
                ``nxt``, combined plaintext kept for repost/unmask).
                Elementwise over Z/2^32Z, so any chunking of the vector
                produces the same bits as the whole-vector path."""
                plain = crypto.hop_decrypt_slice(cipher_chunk, src,
                                                 counter, start)
                comb = NpFixedPoint.add(
                    plain, _enc_payload()[start:start + cipher_chunk.size])
                out = crypto.hop_encrypt_slice(comb, nxt, counter, start)
                return out, comb

            if fail_mode is None:
                res = yield ("stream",
                             dict(node=node, group=group, to_node=nxt,
                                  combine=_combine_chunk,
                                  payload_words=V),
                             nbytes, "aggregation")
            else:
                res = yield ("wait", "get_aggregate",
                             dict(node=node, group=group), nbytes,
                             "aggregation")
            if res.get("status") == "timeout":
                verdict = yield from _election()
                if verdict == "done":
                    return
                initiator_now = verdict == "initiator"
                continue
            if fail_mode == "dead":
                return
            if res.get("status") == "streamed":
                # chunk-combined on the fly; `combined` is the assembled
                # plaintext partial (for repost retargets), `uploaded`
                # says whether the streamed post landed (a superseded
                # upload falls back to a whole-vector post here).
                agg = res["combined"]
                st = yield from _post_and_confirm(agg,
                                                  posted=res["uploaded"])
            else:
                yield ("compute", cost.decrypt(nbytes, crypto.symmetric_only))
                agg = crypto.hop_decrypt(res["aggregate"], res["from_node"],
                                         counter)
                yield ("compute", cost.t_add_elem * V)
                agg = NpFixedPoint.add(agg, codec.encode(payload_f))
                st = yield from _post_and_confirm(agg)
            if st["status"] == "reset":
                continue  # round restarted — rejoin the new chain
            if st["status"] == "timeout":
                # §5.4: the posting was never consumed within the
                # aggregation timeout (its target died with the chain
                # otherwise complete). Enter the election path right
                # away — same as the initiator's handling above. Waiting
                # on get_average here instead loses the race against the
                # round reset: the new chain would run (and publish)
                # without this survivor's contribution.
                verdict = yield from _election()
                if verdict == "done":
                    return
                initiator_now = verdict == "initiator"
                continue
            # 'self' falls through to get_average: the poster's own
            # aggregate was declared final, the (re-elected) round will
            # publish without further input from this node.

            res = yield ("wait", "get_average", dict(), nbytes, "aggregation")
            if res.get("status") == "timeout":
                verdict = yield from _election()
                if verdict == "done":
                    return
                initiator_now = verdict == "initiator"
                continue
            return


def insec_learner(node: int, value: np.ndarray, cost: CostModel,
                  group: int = 0, post_to: int = -1) -> LearnerGen:
    """INSEC baseline: post raw parameters, read back the average."""
    nbytes = 14 * value.size  # clear-text JSON floats
    yield ("call", "post_aggregate",
           dict(from_node=node, to_node=post_to, payload=value, group=group), nbytes)
    yield ("wait", "get_average", dict(), nbytes, None)
    return


# ---------------------------------------------------------------------------
# Round construction shared by both runtimes
# ---------------------------------------------------------------------------


def build_round_machines(
    values: np.ndarray,
    topo: RingTopology,
    groups: Dict[int, list],
    initiators: set,
    *,
    mode: str = "safe",
    weights: Optional[np.ndarray] = None,
    cost: CostModel = EDGE,
    symmetric_only: bool = False,
    scale_bits: int = 16,
    provisioning_seed: int = 0xC0FFEE,
    learner_master: int = 0x5EED,
    counter: int = 0,
    subgroups: int = 1,
    failed: Iterable[int] = (),
    initiator_fails: bool = False,
    crypto_cache: Optional[Dict[int, LearnerCrypto]] = None,
) -> Dict[int, LearnerGen]:
    """Build one generator per live learner for one aggregation round.

    This is the single place that wires values/keys/topology into the
    state machines — ``run_safe_round`` (discrete-event) and
    ``net.client.run_safe_round_net`` (wire) both call it, so "same
    seeds, same topology" means *the same coroutines* in both planes.
    Returns ``{node_id: generator}`` for nodes not in ``failed``.

    ``crypto_cache`` (node → LearnerCrypto, filled on first use) lets a
    persistent multi-round session reuse each learner's derived key
    material across rounds — no key re-derivation after Round 0, the
    paper's amortization. Callers own counter bookkeeping: the cache is
    only sound while ``counter`` advances past every previous round's
    pad words (``core.session.RoundCursor``).
    """
    failed = set(failed)
    machines: Dict[int, LearnerGen] = {}
    for g, chain in groups.items():
        for node in chain:
            if node in failed:
                continue  # crashed before the aggregation started
            val = values[node - 1]
            w = None if weights is None else float(weights[node - 1])
            if mode == "insec":
                machines[node] = insec_learner(
                    node, val if w is None else val * w, cost, group=g)
                continue
            crypto = None if crypto_cache is None else crypto_cache.get(node)
            if crypto is None:
                crypto = LearnerCrypto(
                    node, provisioning_seed, learner_master, scale_bits,
                    encrypt=(mode == "safe"), symmetric_only=symmetric_only)
                if crypto_cache is not None:
                    crypto_cache[node] = crypto
            is_init = node in initiators
            fail_mode = ("after_post"
                         if (initiator_fails and g == 0 and is_init) else None)
            machines[node] = safe_learner(
                node, topo, val, crypto, cost, group=g,
                is_initiator=is_init, weight=w, counter=counter,
                fail_mode=fail_mode, subgroups=subgroups)
    return machines
