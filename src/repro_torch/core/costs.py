"""Virtual-time cost models for the control-plane protocol simulation.

The paper evaluates two platforms (§6, §7):

  * *edge*      — Python learners on a desktop-class box (RSA+AES hybrid).
  * *deep-edge* — busybox/openssl on TP-Link Wi-Fi routers, symmetric keys
                  pre-negotiated because RSA private-key ops are too slow.

The constants below are calibrated to the same order of magnitude as the
paper's measurements (e.g. edge: ~0.1 s for 3-node/1-feature SAFE,
deep-edge: ~1 s for 3 nodes) so the benchmark curves are directly
comparable in *shape* and *ratio*; absolute values are documented as
model parameters, not measurements.

The PyTorch port's copy of the JAX package's ``core/costs.py``, with the same
semantics.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Tuple


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Per-operation virtual-time costs, in seconds."""

    name: str = "edge"
    # Network: one controller round trip (request+response, LAN).
    t_msg: float = 0.002
    # Per-byte serialization + transfer cost (JSON over HTTPS).
    t_byte: float = 1.5e-7
    # RSA-2048: wrap/unwrap one AES session key (desktop-class CPU).
    t_rsa_encrypt: float = 0.0003
    t_rsa_decrypt: float = 0.0015
    # AES-256: per byte (stream).
    t_aes_byte: float = 2.0e-9
    # PRF keystream generation, per 4-byte word (BON pad expansion and the
    # SAFE initiator mask both pay this).
    t_prf_word: float = 6.0e-9
    # Vector add / fixed-point codec, per element.
    t_add_elem: float = 3.0e-9
    # Secure random generation, per word (initiator mask R, BON b_u).
    t_rng_word: float = 2.0e-8
    # Shamir share create/reconstruct, per share (BON only).
    t_share: float = 3.0e-5
    # Pairwise key agreement (BON Round 0: RSA keypair generation +
    # agreement per peer, re-run every aggregation cycle for failover —
    # §2 point 1; RSA-2048 keygen is ~100 ms, which is what makes BON
    # "deteriorate already at 8-10 nodes", Fig. 6).
    t_keyagree: float = 0.1
    # Controller bookkeeping per request (requests serialize on it).
    t_ctrl: float = 0.001
    # Controller per-byte handling: INSEC must PARSE the JSON float
    # payload (it averages it); SAFE's broker relays an opaque blob —
    # the paper's "mere message broker" advantage (§6.2 compression).
    t_parse_byte: float = 3.0e-8
    t_relay_byte: float = 2.0e-9
    # INSEC controller averaging: the server re-averages the n posted
    # arrays when serving results — O(n·V) per request, the quadratic-ish
    # server burden SAFE avoids by making the initiator compute the mean.
    t_avg_elem: float = 2.0e-8

    def encrypt(self, nbytes: int, symmetric_only: bool) -> float:
        """Hybrid (RSA-wrapped AES) or pre-negotiated symmetric encrypt."""
        c = self.t_aes_byte * nbytes
        if not symmetric_only:
            c += self.t_rsa_encrypt
        return c

    def decrypt(self, nbytes: int, symmetric_only: bool) -> float:
        c = self.t_aes_byte * nbytes
        if not symmetric_only:
            c += self.t_rsa_decrypt
        return c

    def message(self, nbytes: int = 256) -> float:
        return self.t_msg + self.t_byte * nbytes

    @classmethod
    def fit(cls, samples: Iterable[Tuple[Dict[str, float], float]],
            base: "CostModel" = None, name: str = "fitted"
            ) -> Tuple["CostModel", Dict[str, float]]:
        """Calibrate cost constants from measured timings.

        ``samples`` is an iterable of ``(features, seconds)`` pairs where
        ``features`` maps constant names (``t_msg``, ``t_byte``, ...) to
        their multiplier in that measurement — e.g. an RPC echo of a
        1 KiB payload under a model ``t = t_msg + nbytes*t_byte`` is
        ``({"t_msg": 1, "t_byte": 1024}, measured_seconds)``. Solves the
        nonnegative least-squares system over the union of feature names
        (plain lstsq, negatives clipped to 0 — adequate for the
        well-separated micro-benchmarks this calibrates), returning a
        new model with fitted fields replacing ``base``'s (default
        :data:`EDGE`) and a residual report::

            {"rms": ..., "max": ..., "r2": ..., "n_samples": ...}

        so benchmark output can state how well the linear model explains
        the measurements instead of asserting it.
        """
        import numpy as np

        base = base if base is not None else EDGE
        samples = list(samples)
        if not samples:
            raise ValueError("need at least one sample to fit")
        names = sorted({k for feats, _ in samples for k in feats})
        valid = {f.name for f in dataclasses.fields(cls)} - {"name"}
        unknown = set(names) - valid
        if unknown:
            raise ValueError(f"unknown cost constants: {sorted(unknown)}")
        A = np.array([[feats.get(k, 0.0) for k in names]
                      for feats, _ in samples], dtype=np.float64)
        y = np.array([t for _, t in samples], dtype=np.float64)
        coef, *_ = np.linalg.lstsq(A, y, rcond=None)
        coef = np.maximum(coef, 0.0)
        pred = A @ coef
        resid = y - pred
        ss_tot = float(np.sum((y - y.mean()) ** 2))
        report = {
            "rms": float(np.sqrt(np.mean(resid ** 2))),
            "max": float(np.max(np.abs(resid))),
            "r2": (1.0 - float(np.sum(resid ** 2)) / ss_tot
                   if ss_tot > 0 else 1.0),
            "n_samples": len(samples),
        }
        fitted = dataclasses.replace(
            base, name=name,
            **{k: float(v) for k, v in zip(names, coef)})
        return fitted, report


EDGE = CostModel(name="edge")

# Archer C7 (QCA9558 @ 720 MHz): busybox+curl per-request overhead
# dominates (~150-200 ms TLS handshake + process startup), crypto 30-100x
# slower than desktop.
DEEP_EDGE = CostModel(
    name="deep_edge",
    t_msg=0.17,
    t_byte=2.0e-7,
    t_rsa_encrypt=0.02,
    t_rsa_decrypt=0.35,  # why the paper pre-negotiates symmetric keys (§7)
    t_aes_byte=6.0e-8,
    t_prf_word=2.0e-7,
    t_add_elem=1.0e-7,
    t_rng_word=2.0e-6,  # "generating random numbers is quite slow" (§7)
    t_share=1.0e-3,
    t_keyagree=2.0,
    t_ctrl=0.001,
)

COST_MODELS = {"edge": EDGE, "deep_edge": DEEP_EDGE}
