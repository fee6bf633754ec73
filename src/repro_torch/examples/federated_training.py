"""Cross-organizational federated training over the SAFE wire plane.

The paper's actual use case, end to end in one process: an asyncio
broker (the controller "reduced to a mere message broker"), four
organizations with non-IID data and *different dataset sizes* each
running real local FedAvg steps on the model's device, and their model
deltas travelling the encrypted SAFE chain over real TCP, chunk-streamed
because a delta is bigger than one wire frame (docs/PROTOCOL.md §6).
Averaging is the paper's §5.6 weighted mean, so no org reveals its
dataset size. Midway, one organization goes dark — the §5.3 failover path
keeps training going on the survivors.

The published delta here is bit-identical to the in-process
``train/federated.py`` round for the same seeds
(tests/test_torch_federated.py).

Run: PYTHONPATH=src python -m repro_torch.examples.federated_training [--device cpu]
(SAFE_SMOKE=1 shrinks the run.)
"""
import asyncio

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.data import make_federated_batches
from repro_torch.examples import device_arg, smoke
from repro_torch.models import Model
from repro_torch.net import SafeBroker, run_federated_round_net
from repro_torch.train import make_wire_federated

N_ORGS = 4
LOCAL_STEPS = 2
CHUNK_WORDS = 1 << 18  # stream deltas in 256k-word chunks


def main(argv=None):
    device = device_arg(__doc__.splitlines()[0], argv)
    rounds = 3 if smoke() else 10
    fail_at = 2 if smoke() else 5  # org #3 goes dark after this round
    cfg = get_smoke_config("internlm2-1.8b")
    model = Model(cfg, device=device)
    stream = make_federated_batches(cfg, N_ORGS, 2, 128)

    # per-org dataset sizes (the §5.6 weights — never revealed)
    weights = np.array([4000.0, 1000.0, 2500.0, 500.0], np.float32)
    # each org's fixed private shard: LOCAL_STEPS microbatches per round
    org_tokens = {
        l + 1: np.stack([stream.learner_batch(l, k)["tokens"]
                         for k in range(LOCAL_STEPS)])
        for l in range(N_ORGS)}
    wf = make_wire_federated(model, org_tokens, local_steps=LOCAL_STEPS, local_lr=2e-3)
    print(f"model delta: {wf.payload_words} words "
          f"({wf.payload_words * 4 / 1e6:.1f} MB/hop, "
          f"{-(-wf.payload_words // CHUNK_WORDS)} chunks)")

    async def train(params):
        broker = SafeBroker(progress_timeout=0.5, monitor_interval=0.1,
                            aggregation_timeout=60.0)
        addr = await broker.start()
        try:
            for r in range(rounds):
                failed = (3,) if r >= fail_at else ()
                params, res = await run_federated_round_net(
                    params, wf.local_fns, wf.apply_fn, addr,
                    weights=weights, counter=r * (wf.payload_words + 1),
                    failed_nodes=failed, chunk_words=CHUNK_WORDS)
                losses = [wf.last_losses[n] for n in sorted(wf.last_losses)
                          if n not in failed]
                tag = " (org 3 DOWN, failover active)" if failed else ""
                print(f"round {r:2d}: local_loss={np.mean(losses):.4f} "
                      f"delta={np.linalg.norm(res.average):.3f} "
                      f"msgs={res.stats['aggregation_total']} "
                      f"chunks={res.stats['chunk_frames_in']}"
                      f"/{res.stats['chunk_frames_out']}{tag}")
        finally:
            await broker.stop()
        return params

    asyncio.run(train(model.tree()))


if __name__ == "__main__":
    main()
