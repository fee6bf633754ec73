"""Batched serving: continuous prefill+decode over fixed batch slots.

Run: PYTHONPATH=src python -m repro_torch.examples.serving [--device cpu]
(SAFE_SMOKE=1 shrinks the run)
"""
import time

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.examples import device_arg, smoke
from repro_torch.models import Model
from repro_torch.serve import Request, ServeEngine


def main(argv=None):
    device = device_arg(__doc__.splitlines()[0], argv)
    cfg = get_smoke_config("qwen3-14b")
    model = Model(cfg, device=device)
    eng = ServeEngine(model, model.tree(), batch_slots=4, max_seq=256,
                      temperature=0.8, seed=0)
    rng = np.random.RandomState(0)
    n_req, max_new = (3, 8) if smoke() else (10, 24)
    t0 = time.time()
    for i in range(n_req):
        prompt = rng.randint(0, cfg.vocab, rng.randint(4, 24)).astype(np.int32)
        eng.submit(Request(rid=i, prompt=prompt, max_new=max_new))
    eng.run_until_done()
    dt = time.time() - t0
    print(f"served {n_req} requests in {dt:.1f}s "
          f"({n_req*max_new/dt:.1f} tok/s, {eng.steps} batched decode steps)")


if __name__ == "__main__":
    main()
