"""The general drivers, one per kind of traffic (a traffic file's
``kind``). A driver's ``Driver(config, traffic, seed, device)`` builds the
inputs and the system under test; ``warmup()`` runs every shape the
window will (set-up); ``window(seconds, spans, run, marks)`` runs the
closed loop and writes its readings into ``run``; ``release()`` frees the
program's state; ``check(limits)`` returns the numbers compared with the
reference, each with its limit from ``limits/<cell>.json``
(``harness.Check``), and sets ``failed``."""
from __future__ import annotations

from typing import Dict

import torch

from perfbench.inputs import Reservoir, alive_bitmap, gaussian_pool

#: The kernels that make SAFE's pads, by what the protocol has them do:
#: the initiator's pads, and the hops that each strip one pad and add the
#: next (one launch a hop for one round, or for every round of a batch).
MASK_KERNELS = ("mask_add",)
HOP_KERNELS = ("chain_combine", "chain_combine_batched")


def launch_counts() -> Dict[str, int]:
    """The program's kernel launches so far, by kernel (its
    ``kernels.build.launches``)."""
    from repro_torch.kernels.build import launches
    return dict(launches)


def short_of_protocol(before: Dict[str, int], after: Dict[str, int], n: int, rounds: int,
                      batched: bool) -> bool:
    """Whether the launches between two readings fall short of what SAFE's
    protocol makes for ``rounds`` rounds of an n-learner chain: each
    round's initiator makes three pads (its mask R, its outgoing pad and
    the incoming pad it strips), and the chain makes n - 1 hops, one
    launch each, or with ``batched`` one launch a hop for all the rounds.
    A round that publishes its mean without the ring falls short."""
    masks = sum(after[k] - before[k] for k in MASK_KERNELS)
    hops = sum(after[k] - before[k] for k in HOP_KERNELS)
    return masks < 3 * rounds or hops < (n - 1) * (1 if batched else rounds)


class Aggregation:
    """What the aggregation drivers share: the pool of [n, V] value
    matrices drawn from the seed, the alive patterns (``dead_cycle``), a
    sample of the window's published means a pattern (drawn from the
    seed), and their check against the plain fixed-point mean."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, tag: str):
        if config["pipelined"] or config["subgroups"] != 1 or config["weighted"]:
            raise ValueError("the aggregation drivers check the unweighted mean of one "
                             "sequential chain; this configuration needs its own reference")
        self.n, self.sb = int(config["num_learners"]), int(config["scale_bits"])
        self.V = int(traffic["payload_words"])
        self.seed, self.device = seed, torch.device(device)
        self.pool = gaussian_pool(int(traffic["pool"]), self.n, self.V,
                                  float(traffic["value_std"]), seed, self.device)
        self.dead = [sorted(int(r) for r in d) for d in traffic["dead_cycle"]]
        self.alive = [alive_bitmap(self.n, d) for d in self.dead]
        self.samples = [Reservoir(traffic["check_per_pattern"], seed, tag, p)
                        for p in range(len(self.dead))]
        self.attempted = self.failed = 0
        self.short = 0  # the window's session-rounds that fell short of the protocol

    def check(self, limits: dict) -> list:
        """``mismatched_words``: the most words of a sampled mean whose bits
        differ from the reference's (exact: 0); ``patterns_unchecked``:
        alive patterns without a sample (0); ``short_rounds``: the window's
        session-rounds whose pad-making launches fell short of the
        protocol's (0: no learner's vector left unmasked)."""
        from perfbench.harness import Check
        from perfbench.reference.fixedpoint import fixed_point_mean, mismatched_words
        worst = 0
        for pat, sample in enumerate(self.samples):
            rows = [r for r in range(self.n) if r not in self.dead[pat]]
            for out, idx in sample.items:
                bad = mismatched_words(out, fixed_point_mean(self.pool[idx], rows, self.sb))
                worst = max(worst, bad)
                self.failed += bad > 0
        missing = sum(not s.items for s in self.samples)
        self.failed += self.short
        got = {"mismatched_words": worst, "patterns_unchecked": missing,
               "short_rounds": self.short}
        return [Check(k, got[k], limits[k]) for k in got]
