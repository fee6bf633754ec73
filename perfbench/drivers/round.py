"""One tenant's SAFE rounds in a closed loop, through
``SecureAggregator.aggregate``.

Each round is timed from its call to its published mean on the device
(synchronised). Round r takes the alive set ``dead_cycle[r % c]`` and the
values ``pool[(r // c) % P]`` (c patterns, P matrices), so consecutive
rounds differ in both. Its counters come from ``reserve_round``; when that
refuses (the key pair's 2^32 counters are spent), the keys rotate: a new
aggregator with provisioning and learner seeds derived from the run's
seed and the rotation's number, as a long-lived deployment re-runs Round 0.
The initiator rotates by the round's first counter mod 2n + 1, as the
train step rotates it. Each round's kernel launches are held against the
protocol's (``drivers.short_of_protocol``).
"""
from __future__ import annotations

import time

from perfbench import work
from perfbench.drivers import Aggregation, launch_counts, short_of_protocol
from perfbench.harness import sync
from perfbench.inputs import derive


class Driver(Aggregation):
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        super().__init__(config, traffic, seed, device, "round")
        self.mode = config["mode"]
        self.epoch, self.r = -1, 0
        self.agg = None
        self._rotate_keys()

    def _rotate_keys(self) -> None:
        from repro_torch.core.aggregators import make_aggregator
        self.epoch += 1
        self.agg = make_aggregator(self.mode, self.n, scale_bits=self.sb,
                                   provisioning_seed=derive(self.seed, "prov", self.epoch),
                                   learner_master=derive(self.seed, "master", self.epoch),
                                   device=str(self.device))

    def _round(self):
        try:
            base = self.agg.reserve_round(self.V)
        except OverflowError:  # the key pair's counters are spent: Round 0 again
            self._rotate_keys()
            base = self.agg.reserve_round(self.V)
        r, c = self.r, len(self.dead)
        self.r += 1
        pat, idx = r % c, (r // c) % len(self.pool)
        out = self.agg.aggregate(self.pool[idx], base, alive=self.alive[pat],
                                 rotate=base % (2 * self.n + 1))
        return out, pat, idx

    def warmup(self) -> None:
        for _ in range(len(self.dead) * len(self.pool)):
            self._round()
        sync(self.device)

    def window(self, seconds: float, spans, run, marks: bool = False) -> None:
        lat, least = [], 0.0
        last = launch_counts()
        start = time.perf_counter()
        deadline = start + seconds
        while True:
            t = time.perf_counter()
            with spans("round"):
                out, pat, idx = self._round()
                sync(self.device)
            done = time.perf_counter()
            lat.append(done - t)
            now = launch_counts()
            self.short += short_of_protocol(last, now, self.n, 1, batched=False)
            last = now
            least += work.round_least_seconds(self.n, self.n - len(self.dead[pat]), self.V)
            self.samples[pat].offer((out, idx))
            if done >= deadline:
                break
        run.window_s, run.latencies_s = done - start, lat
        run.units, run.least_s = len(lat), least
        self.attempted = len(lat)

    def release(self) -> None:
        self.agg = None
