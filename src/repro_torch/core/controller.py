"""The SAFE controller — a message broker with progress monitoring.

Faithful Python port of the paper's Flask controller (Appendix A): it
stores opaque ciphertext messages until consumed, tracks per-group
progress, orchestrates reposts after timeouts, re-elects initiators, and
distributes the final average. It never decrypts, never aggregates
(except averaging the already-anonymized subgroup averages, §5.5), and
never holds key material — the paper's "mere message broker".

Used by the discrete-event protocol simulation (``core/protocol.py``) and
by the paper-figure benchmarks. Every client-visible operation increments
the message counters that validate §5's closed-form counts.

The PyTorch port's copy of the JAX package's ``core/controller.py``, with the same
semantics.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

#: Shared op registry — the single source of truth for what a client can
#: ask the broker. ``CALL_OPS`` are fire-and-forget requests (the state
#: machines' ``("call", …)`` yields); ``WAIT_KINDS`` are long-polls
#: (``("wait", …)`` yields) with a non-counting ``try_*`` probe and a
#: counting consumer. Both the discrete-event kernel
#: (``core/protocol.py``) and the wire broker (``net/broker.py``)
#: dispatch through this table, so the two planes cannot drift — and
#: docs/PROTOCOL.md §7 documents it, with ``tests/test_docs.py``
#: asserting the book's table matches these sets (and ``MessageStats``'
#: fields) exactly, so the spec cannot drift either.
CALL_OPS = frozenset({
    "post_aggregate", "post_average", "should_initiate",
    "register_key", "get_key",
})
#: call ops that take the broker clock (``now=``); key-exchange ops do not.
TIMED_OPS = frozenset({"post_aggregate", "post_average", "should_initiate"})
WAIT_KINDS = frozenset({"get_aggregate", "check_aggregate", "get_average"})

#: §5.10 hierarchical (parent-broker) ops: a child org posts its
#: already-anonymized group average upward and fetches the cross-org
#: global back down. Counted in :class:`HierStats` (the parent level's
#: own closed form — 2·(c−f) for c child orgs, f crashed), never in
#: :class:`MessageStats`, so the per-chain §5 forms are unperturbed.
#: ``post_org_average`` takes the parent broker's clock (elision timing).
HIER_OPS = frozenset({"post_org_average", "get_org_average"})
HIER_TIMED_OPS = frozenset({"post_org_average"})


@dataclasses.dataclass
class MessageStats:
    """Client->controller request counters, by operation."""

    post_aggregate: int = 0
    check_aggregate: int = 0
    get_aggregate: int = 0
    post_average: int = 0
    get_average: int = 0
    should_initiate: int = 0
    register_key: int = 0
    get_key: int = 0

    @property
    def aggregation_total(self) -> int:
        """Messages in the aggregation itself (paper's 4n count excludes
        the one-time Round-0 key exchange, §5.2)."""
        return (
            self.post_aggregate
            + self.check_aggregate
            + self.get_aggregate
            + self.post_average
            + self.get_average
            + self.should_initiate
        )

    @property
    def key_exchange_total(self) -> int:
        return self.register_key + self.get_key


@dataclasses.dataclass
class HierStats:
    """Parent-level request counters (§5.10), by operation.

    Deliberately separate from :class:`MessageStats`: the parent hop is
    its own level with its own closed form — c surviving child orgs
    each post one group average up and fetch one global back down, so
    ``hierarchy_total == 2 * (c - f)`` with f whole-org crashes."""

    post_org_average: int = 0
    get_org_average: int = 0

    @property
    def hierarchy_total(self) -> int:
        return self.post_org_average + self.get_org_average


@dataclasses.dataclass
class _Posting:
    """A stored ciphertext message (opaque to the controller)."""

    payload: Any
    from_node: int
    time: float


class Controller:
    """In-process broker implementing the paper's six operations.

    All state is per-group (paper §5.5); group 0 is the default. The
    controller knows chain order only as an opaque node-id list per group
    (it must, to pick repost targets — exactly as in the paper where it
    "requests the sending node to re-encrypt and resend to a new target").
    """

    def __init__(self, groups: Dict[int, list[int]], aggregation_timeout: float = 30.0):
        self.groups = {g: list(nodes) for g, nodes in groups.items()}
        self.aggregation_timeout = aggregation_timeout
        self.stats = MessageStats()
        # group -> node -> _Posting
        self._aggregates: Dict[int, Dict[int, _Posting]] = {g: {} for g in groups}
        # group -> node -> {"status": ...} (repost/consumed signal per §A)
        self._repost: Dict[int, Dict[int, dict]] = {g: {} for g in groups}
        # group -> {"average": vec, "weight_avg": float, "posted": int}
        self._average: Dict[int, Optional[dict]] = {g: None for g in groups}
        # group -> count of learners that successfully posted (for §5.3's
        # "initiator is informed how many nodes posted")
        self._posted: Dict[int, int] = {g: 0 for g in groups}
        self._skipped: Dict[int, set] = {g: set() for g in groups}
        # group -> nodes that consumed a posting this round. A learner
        # consumes exactly once per chain pass, so a consumed node can
        # never be a viable repost target (§5.3 × §5.4 interaction): it
        # will not issue another get_aggregate until the round resets.
        self._consumed: Dict[int, set] = {g: set() for g in groups}
        # group -> to_node keys of postings the monitor declared stalled
        # (no viable repost target): left in place for the §5.4 election
        # to sweep up, and skipped by stuck_posting so the monitor does
        # not spin on them.
        self._stalled: Dict[int, set] = {g: set() for g in groups}
        self._initiator: Dict[int, Optional[int]] = {g: None for g in groups}
        self._round_start: Dict[int, float] = {g: 0.0 for g in groups}
        self._keys: Dict[int, Any] = {}
        # Registered public/symmetric keys: node -> key blob (opaque).
        self._global_average: Optional[dict] = None
        # Monotone round index: bumped by advance_round() (cross-round
        # pipelining, PROTOCOL.md §11). reset_round() restarts the SAME
        # logical round and leaves it untouched.
        self.round_index: int = 0

    # ------------------------------------------------------------------
    # Uniform op dispatch (shared by the sim kernel and the wire broker)
    # ------------------------------------------------------------------
    def call(self, op: str, **kwargs) -> Any:
        """Invoke a fire-and-forget client op by name (see ``CALL_OPS``)."""
        if op not in CALL_OPS:
            raise ValueError(f"unknown call op {op!r}")
        return getattr(self, op)(**kwargs)

    def probe(self, kind: str, **kwargs) -> Optional[Any]:
        """Non-counting availability probe for a long-poll kind."""
        if kind not in WAIT_KINDS:
            raise ValueError(f"unknown wait kind {kind!r}")
        return getattr(self, f"try_{kind}")(**kwargs)

    def consume(self, kind: str, **kwargs) -> Any:
        """Counting resolution of a long-poll kind; the caller must have
        seen a non-None ``probe`` first."""
        if kind not in WAIT_KINDS:
            raise ValueError(f"unknown wait kind {kind!r}")
        return getattr(self, kind)(**kwargs)

    # ------------------------------------------------------------------
    # Round 0: key exchange (2 messages per node: register + retrieve)
    # ------------------------------------------------------------------
    def register_key(self, node: int, key_blob: Any) -> None:
        self.stats.register_key += 1
        self._keys[node] = key_blob

    def get_key(self, node: int) -> Any:
        self.stats.get_key += 1
        return self._keys.get(node)

    # ------------------------------------------------------------------
    # Round 1: chain aggregation
    # ------------------------------------------------------------------
    def post_aggregate(self, from_node: int, to_node: int, payload: Any,
                       group: int = 0, now: float = 0.0) -> None:
        self.stats.post_aggregate += 1
        if self._initiator[group] is None:
            self._initiator[group] = from_node
            self._round_start[group] = now
        self._aggregates[group][to_node] = _Posting(payload, from_node, now)
        self._stalled[group].discard(to_node)  # fresh posting supersedes a stall
        self._posted[group] += 1
        # Poster will long-poll check_aggregate; target will long-poll
        # get_aggregate — mark the poster's check as pending.
        self._repost[group][from_node] = {"status": "pending"}

    def try_get_aggregate(self, node: int, group: int = 0) -> Optional[dict]:
        """Non-counting availability probe used by the event kernel; the
        actual client call is get_aggregate()."""
        posting = self._aggregates[group].get(node)
        if posting is None:
            return None
        # _posted counts successful post_aggregate calls net of removed
        # postings (order_repost decrements), i.e. the n-f contributors
        # the initiator divides by (§5.3).
        return {
            "aggregate": posting.payload,
            "from_node": posting.from_node,
            "posted": self._posted[group],
            "time": posting.time,
        }

    def get_aggregate(self, node: int, group: int = 0) -> dict:
        """Consume the message addressed to ``node`` (long-poll resolved)."""
        self.stats.get_aggregate += 1
        result = self.try_get_aggregate(node, group)
        assert result is not None, "kernel resolved a wait without data"
        posting = self._aggregates[group].pop(node)
        self._consumed[group].add(node)
        # Poster's check_aggregate resolves to consumed.
        self._repost[group][posting.from_node] = {"status": "consumed"}
        return result

    def try_check_aggregate(self, node: int, group: int = 0) -> Optional[dict]:
        st = self._repost[group].get(node)
        if st is None or st.get("status") == "pending":
            return None
        return st

    def check_aggregate(self, node: int, group: int = 0) -> dict:
        self.stats.check_aggregate += 1
        st = self.try_check_aggregate(node, group)
        assert st is not None
        if st.get("status") != "consumed":
            # one-shot repost instruction
            self._repost[group][node] = {"status": "pending"}
        return st

    # ------------------------------------------------------------------
    # Progress failover (§5.3) — called by the external progress monitor.
    # ------------------------------------------------------------------
    def stuck_posting(self, group: int, now: float, timeout: float):
        """Return (poster, failed_target) if a posting has been waiting
        longer than ``timeout``, else None."""
        for to_node, posting in self._aggregates[group].items():
            if to_node in self._stalled[group]:
                continue  # already declared unrecoverable until the round resets
            if now - posting.time > timeout:
                return posting.from_node, to_node
        return None

    def order_repost(self, group: int, poster: int,
                     failed: int) -> Optional[int]:
        """Instruct ``poster`` (via its pending check_aggregate) to
        re-encrypt for the next *viable* node after ``failed`` on the
        chain.

        Viable means not already skipped and not already consumed this
        round: a learner that performed its get_aggregate has moved past
        its receive slot and will never issue another one this round, so
        retargeting it strands the posting forever (the §5.3 × §5.4
        silently-wrong-average bug — the monitor used to walk a stuck
        posting around live-but-finished nodes until the wrap produced a
        spurious "self" verdict that dropped the survivor's contribution).

        Returns the new target, ``poster`` for the degenerate
        all-others-dead "self" verdict, or ``None`` when no viable target
        exists (chain finished but its consumer died): the posting is
        left in place, marked stalled, and the §5.4 aggregation-timeout
        election recovers the round.
        """
        chain = self.groups[group]
        idx = chain.index(failed)
        new_target = None
        for step in range(1, len(chain)):
            cand = chain[(idx + step) % len(chain)]
            if cand == poster:
                break
            if cand in self._skipped[group] or cand in self._consumed[group]:
                continue
            new_target = cand
            break
        if new_target is None:
            others = [x for x in chain if x != poster]
            if all(x == failed or x in self._skipped[group] for x in others):
                # Every other group member is dead (§5.3 degenerate
                # case). The poster's own aggregate IS the final one —
                # signal that instead of bouncing the posting through
                # dead nodes forever.
                self._skipped[group].add(failed)
                self._aggregates[group].pop(failed, None)
                # net _posted unchanged: the poster remains a contributor
                self._repost[group][poster] = {"status": "self",
                                               "posted": self._posted[group]}
                return poster
            # Remaining members are alive but already consumed: the chain
            # is complete except for its dead consumer. Stall — leave the
            # posting (and _posted/_skipped) untouched so the poster's
            # check_aggregate times out and the §5.4 election restarts
            # the round with nothing stranded.
            self._stalled[group].add(failed)
            return None
        self._skipped[group].add(failed)
        # Remove the unconsumed posting and flag the poster.
        self._aggregates[group].pop(failed, None)
        self._posted[group] -= 1
        self._repost[group][poster] = {"status": "repost", "to_node": new_target}
        return new_target

    # ------------------------------------------------------------------
    # Round 2: average distribution
    # ------------------------------------------------------------------
    def post_average(self, node: int, average: np.ndarray, group: int = 0,
                     weight_avg: Optional[float] = None, now: float = 0.0) -> None:
        self.stats.post_average += 1
        self._average[group] = {
            "average": average,
            "weight_avg": weight_avg,
            "initiator": node,
            "time": now,
        }
        self._maybe_publish_global()

    def _maybe_publish_global(self) -> None:
        """§5.5: once every group initiator posted, publish the average of
        the group averages (the only arithmetic the controller ever does,
        on already-anonymized values)."""
        if any(self._average[g] is None for g in self.groups):
            return
        avgs = [self._average[g]["average"] for g in self.groups]
        wavgs = [self._average[g]["weight_avg"] for g in self.groups]
        glob = np.mean(np.stack(avgs), axis=0)
        gw = None
        if all(w is not None for w in wavgs):
            gw = float(np.mean(wavgs))
        self._global_average = {
            "average": glob,
            "weight_avg": gw,
            "time": max(self._average[g].get("time", 0.0) for g in self.groups),
        }

    def try_get_average(self) -> Optional[dict]:
        return self._global_average

    def get_average(self) -> dict:
        self.stats.get_average += 1
        assert self._global_average is not None
        return self._global_average

    # ------------------------------------------------------------------
    # Initiator failover (§5.4)
    # ------------------------------------------------------------------
    def should_initiate(self, node: int, group: int = 0, now: float = 0.0) -> bool:
        """First asker after an aggregation timeout becomes initiator."""
        self.stats.should_initiate += 1
        if self._average[group] is not None:
            return False
        if now - self._round_start[group] <= self.aggregation_timeout:
            return False
        # reset group round state; first asker wins. Nodes still parked on
        # a stale check_aggregate learn the round restarted ("reset") so
        # they rejoin the new chain instead of hanging to their deadline.
        self._aggregates[group].clear()
        self._repost[group] = {
            other: {"status": "reset"} for other in self.groups[group] if other != node
        }
        self._posted[group] = 0
        self._skipped[group] = set()
        self._consumed[group] = set()
        self._stalled[group] = set()
        self._initiator[group] = node
        self._round_start[group] = now
        return True

    def reset_round(self) -> None:
        """Start a fresh aggregation round (new FL iteration)."""
        for g in self.groups:
            self._aggregates[g].clear()
            self._repost[g].clear()
            self._average[g] = None
            self._posted[g] = 0
            self._skipped[g] = set()
            self._consumed[g] = set()
            self._stalled[g] = set()
            self._initiator[g] = None
        self._global_average = None

    def advance_round(self) -> Optional[dict]:
        """Complete the current round and open the next (§11 pipelining).

        Same controller-state effect as :meth:`reset_round`, but bumps
        ``round_index`` and returns the outgoing round's published
        global average — the caller (the broker's ``advance_round``
        handler) uses the index to deliver transfer buffers that were
        parked for the new round. Non-destructive at the transport
        layer: the broker keeps round r+1 buffers across the boundary,
        whereas ``reset_round`` drops every transfer.
        """
        published = self._global_average
        self.reset_round()
        self.round_index += 1
        return published


def combine_org_averages(avgs: list, wavgs: Optional[list] = None) -> dict:
    """The §5.10 parent verdict: average the already-anonymized group
    averages (the only arithmetic a parent ever does — same fold as the
    §5.5 cross-group publish, so sim and wire hierarchies are
    bit-identical by construction). Shared by
    :class:`HierarchicalController` (sim) and :class:`ParentController`
    (wire parent broker)."""
    out = {"average": np.mean(np.stack(avgs), axis=0)}
    gw = None
    if wavgs and all(w is not None for w in wavgs):
        gw = float(np.mean(wavgs))
    out["weight_avg"] = gw
    return out


class HierarchicalController:
    """§5.10: child controllers post anonymized group averages upward.

    The parent is itself a plain averaging point — no encryption needed
    (the posted values are already averages over >= 3 learners).
    """

    def __init__(self, children: list[Controller]):
        self.children = children
        self.up_messages = 0
        self.elided: tuple = ()

    def collect(self, elide_incomplete: bool = False) -> dict:
        """Average the children's published averages.

        ``elide_incomplete=True`` is the §5.10 whole-org-crash verdict:
        a child whose aggregation never published is dropped from the
        parent average exactly like a dead learner is dropped from a
        chain — the surviving orgs' fold is unchanged. The elided child
        indices land in ``self.elided`` (and the result dict)."""
        avgs, wavgs, elided = [], [], []
        for idx, child in enumerate(self.children):
            res = child.try_get_average()
            if res is None:
                if elide_incomplete:
                    elided.append(idx)
                    continue
                raise AssertionError("child aggregation incomplete")
            self.up_messages += 1  # child -> parent post
            avgs.append(res["average"])
            wavgs.append(res.get("weight_avg"))
        assert avgs, "every child org crashed — nothing to publish"
        self.elided = tuple(elided)
        out = combine_org_averages(avgs, wavgs)
        out["elided"] = self.elided
        return out


class ParentController:
    """§5.10 parent-broker state: the wire-plane twin of
    :class:`HierarchicalController`.

    Tracks which child orgs posted their group average this round and
    publishes the cross-org global once all expected orgs posted — or,
    after the parent's aggregation timeout, with the missing orgs
    *elided* exactly like dead learners (the whole-org-crash failover).
    Never sees an individual contribution: the upward posts are already
    averages over >= 3 learners (RingTopology.validate_privacy), which
    is the paper's anonymization argument for the org boundary.

    Pure synchronous state like :class:`Controller` — the wire broker
    wraps it in its own locking/long-poll machinery. The fold is
    :func:`combine_org_averages`, shared with the sim, so parent
    averages are bit-identical across planes by construction.
    """

    def __init__(self, orgs: list[int], aggregation_timeout: float = 30.0):
        assert orgs, "a parent session needs at least one child org"
        self.orgs = list(orgs)
        self.aggregation_timeout = aggregation_timeout
        self.stats = HierStats()
        self._averages: Dict[int, dict] = {}  # org -> posted payload
        self._published: Optional[dict] = None
        self._round_start = 0.0
        self._started = False
        self.crashed_orgs: tuple = ()

    def post_org_average(self, org: int, average: np.ndarray,
                         weight_avg: Optional[float] = None,
                         now: float = 0.0) -> None:
        if org not in self.orgs:
            raise ValueError(f"unknown org {org!r}")
        self.stats.post_org_average += 1
        if not self._started:
            self._started = True
            self._round_start = now
        self._averages[org] = {
            "average": average, "weight_avg": weight_avg, "time": now,
        }
        if all(o in self._averages for o in self.orgs):
            self._publish(())

    def _publish(self, crashed: tuple) -> None:
        # org-id order, present orgs only — the same fold order the sim
        # twin uses over its surviving children
        present = [o for o in self.orgs if o in self._averages]
        out = combine_org_averages(
            [self._averages[o]["average"] for o in present],
            [self._averages[o]["weight_avg"] for o in present])
        out["time"] = max(self._averages[o]["time"] for o in present)
        out["orgs"] = present
        out["crashed_orgs"] = list(crashed)
        self.crashed_orgs = crashed
        self._published = out

    def maybe_elide(self, now: float) -> bool:
        """Progress-monitor hook (the parent-level §5.3/§5.4 analogue):
        once the aggregation timeout passes with at least one org
        posted, publish without the stragglers. Returns True when a
        publish happened (the caller wakes parked waiters)."""
        if self._published is not None or not self._averages:
            return False
        if now - self._round_start <= self.aggregation_timeout:
            return False
        crashed = tuple(o for o in self.orgs if o not in self._averages)
        self._publish(crashed)
        return True

    def try_get_org_average(self) -> Optional[dict]:
        return self._published

    def get_org_average(self) -> dict:
        self.stats.get_org_average += 1
        assert self._published is not None
        return self._published

    def peek_org(self, org: int) -> Optional[dict]:
        """Uncounted (admin-class) view of one org's posted average."""
        return self._averages.get(org)

    def reset_round(self) -> None:
        self._averages.clear()
        self._published = None
        self._started = False
        self._round_start = 0.0
        self.crashed_orgs = ()
