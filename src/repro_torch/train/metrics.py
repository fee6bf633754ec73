"""JSONL metrics writer + simple console progress (a copy of the JAX
package's ``train/metrics.py``: the same records, line for line)."""
from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, print_every: int = 10):
        self.path = path
        self.print_every = print_every
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, step: int, **metrics) -> None:
        rec = {"step": step, "time": round(time.time() - self._t0, 3)}
        rec.update({k: float(v) for k, v in metrics.items()})
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
        if step % self.print_every == 0:
            kv = " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                          for k, v in rec.items() if k != "time")
            print(f"[{rec['time']:8.1f}s] {kv}", flush=True)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
