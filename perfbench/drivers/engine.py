"""Many tenants' SAFE rounds batched on one card, through
``AggregationEngine.step``.

``slots`` tenants in a closed loop: each submits its next session (one
round) when its last one is published, since a federation waits for its
aggregate; so every step carries every tenant's round. Session k has its
own provisioning and learner seeds (derived from the run's seed and k),
the alive set ``dead_cycle[k % c]``, the initiator rotation k mod 2n + 1,
and the values of a pool matrix drawn from the seed. A session-round's
latency runs from its ``submit`` to its published mean on the device.
Each step's kernel launches are held against the protocol's for its
sessions (``drivers.short_of_protocol``); a step that falls short counts
all of its sessions.
"""
from __future__ import annotations

import time

import numpy as np

from perfbench import work
from perfbench.drivers import Aggregation, launch_counts, short_of_protocol
from perfbench.harness import sync
from perfbench.inputs import derive


class Driver(Aggregation):
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from repro_torch.core.types import ChainConfig
        from repro_torch.serve.agg_engine import AggregationEngine
        super().__init__(config, traffic, seed, device, "engine")
        self.S = int(traffic["slots"])
        self.pick = np.random.default_rng(derive(seed, "pick"))
        cfg = ChainConfig(num_learners=self.n, scale_bits=self.sb, mode=config["mode"])
        self.engine = AggregationEngine(cfg, slots=self.S, payload_words=self.V,
                                        device=str(self.device))
        self.k = 0

    def _submit(self):
        """Every tenant's next session: [(session, submit time, pattern, pool index)]."""
        out = []
        for _ in range(self.S):
            k, self.k = self.k, self.k + 1
            pat, idx = k % len(self.dead), int(self.pick.integers(len(self.pool)))
            t = time.perf_counter()
            s = self.engine.submit(self.pool[idx], rounds=1,
                                   provisioning_seed=derive(self.seed, "prov", k),
                                   learner_master=derive(self.seed, "master", k),
                                   alive=self.alive[pat], rotate0=k % (2 * self.n + 1))
            out.append((s, t, pat, idx))
        return out

    def warmup(self) -> None:
        for _ in range(2):
            self._submit()
            self.engine.step()
        sync(self.device)

    def window(self, seconds: float, spans, run, marks: bool = False) -> None:
        lat, least = [], 0.0
        start = time.perf_counter()
        deadline = start + seconds
        while True:
            sessions = self._submit()
            last = launch_counts()
            with spans("engine.step"):
                self.engine.step()
            sync(self.device)
            done = time.perf_counter()
            if short_of_protocol(last, launch_counts(), self.n, len(sessions), batched=True):
                self.short += len(sessions)
            for s, t, pat, idx in sessions:
                lat.append(done - t)
                least += work.round_least_seconds(self.n, self.n - len(self.dead[pat]), self.V)
                self.samples[pat].offer((s.results[0], idx))
            if done >= deadline:
                break
        run.window_s, run.latencies_s = done - start, lat
        run.units, run.least_s = len(lat), least
        self.attempted = len(lat)

    def release(self) -> None:
        self.engine = None
