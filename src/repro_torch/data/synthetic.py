"""Synthetic federated data: deterministic, non-IID, learnable.

A copy of the JAX package's ``data/synthetic.py`` (numpy only): the same
seed gives the same token batches in both packages.

Cross-organizational FL means each learner's data comes from a different
distribution. We model ``n_domains`` Markov token generators (distinct
bigram structure per domain) and give each learner a Dirichlet mixture
over domains — ``alpha`` controls the non-IID-ness (paper §1's
cross-organizational setting; alpha→inf recovers IID).

Everything is counter-based (no stored datasets): batch ``i`` of learner
``l`` is a pure function of (seed, l, i), so the pipeline is infinitely
long, perfectly resumable from a checkpoint step, and identical across
hosts — the properties a production loader must have.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticMixture:
    vocab: int
    n_domains: int = 8
    seed: int = 0
    order: int = 1  # markov order (bigram)

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        # per-domain sparse-ish bigram logits over a reduced "active" vocab
        self.active = min(self.vocab, 4096)
        self._trans = []
        for d in range(self.n_domains):
            # low-rank bigram structure: P(j|i) ∝ exp(u_i · w_j / sqrt(r))
            r = 16
            u = rng.randn(self.active, r).astype(np.float32)
            w = rng.randn(self.active, r).astype(np.float32)
            # per-domain vocabulary bias: each domain prefers its own slice
            # of the vocab (distinct marginals — the cross-org non-IID-ness)
            bias = np.zeros(self.active, np.float32)
            sl = self.active // self.n_domains
            bias[d * sl:(d + 1) * sl] = 2.0
            self._trans.append((u, w, bias))

    def sample(self, domain: int, length: int, rng: np.random.RandomState) -> np.ndarray:
        u, w, bias = self._trans[domain % self.n_domains]
        toks = np.empty(length, np.int64)
        cur = rng.randint(self.active)
        # vectorized-ish: sample in chunks using gumbel trick on logits rows
        for t in range(length):
            logits = u[cur] @ w.T / 4.0 + bias
            g = rng.gumbel(size=self.active).astype(np.float32)
            cur = int(np.argmax(logits + g))
            toks[t] = cur
        return toks % self.vocab


@dataclasses.dataclass
class FederatedTokenStream:
    """Per-learner non-IID batch generator."""

    vocab: int
    num_learners: int
    batch_per_learner: int
    seq_len: int
    alpha: float = 0.5  # dirichlet concentration (non-IID-ness)
    seed: int = 0
    n_domains: int = 8
    num_codebooks: int = 1

    def __post_init__(self):
        self.mixture = SyntheticMixture(self.vocab, self.n_domains, self.seed)
        rng = np.random.RandomState(self.seed + 1)
        self.learner_mix = rng.dirichlet(
            [self.alpha] * self.n_domains, size=self.num_learners)

    def learner_batch(self, learner: int, step: int) -> dict:
        """tokens int32[batch_per_learner, seq_len(, num_codebooks)]."""
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + learner * 7919 + step) % (2**31 - 1))
        shape = (self.batch_per_learner, self.seq_len, self.num_codebooks) \
            if self.num_codebooks > 1 else (self.batch_per_learner, self.seq_len)
        toks = np.empty(shape, np.int32)
        for b in range(self.batch_per_learner):
            domain = rng.choice(self.n_domains, p=self.learner_mix[learner])
            seq = self.mixture.sample(domain, self.seq_len, rng)
            if self.num_codebooks > 1:
                for c in range(self.num_codebooks):
                    toks[b, :, c] = np.roll(seq, c) % self.vocab  # delay pattern
            else:
                toks[b] = seq
        # weight = "sample count" for §5.6 weighted averaging; vary by
        # learner to exercise the weighted path
        weight = float(1000 + 500 * (learner % 4))
        return {"tokens": toks, "weight": weight}

    def global_batch(self, step: int) -> dict:
        """Stacked [num_learners, batch_per_learner, ...] batch (the layout
        the train step shards over the learner axis)."""
        parts = [self.learner_batch(l, step) for l in range(self.num_learners)]
        return {
            "tokens": np.stack([p["tokens"] for p in parts]),
            "weights": np.asarray([p["weight"] for p in parts], np.float32),
        }


def make_federated_batches(cfg, num_learners: int, batch_per_learner: int,
                           seq_len: int, seed: int = 0) -> FederatedTokenStream:
    return FederatedTokenStream(
        vocab=cfg.vocab,
        num_learners=num_learners,
        batch_per_learner=batch_per_learner,
        seq_len=seq_len,
        seed=seed,
        num_codebooks=cfg.num_codebooks,
    )
