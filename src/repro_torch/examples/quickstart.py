"""Quickstart: SAFE-secured data-parallel training in ~40 lines.

Four learners (organisations) train the smoke internlm2-1.8b; every
step's gradient is averaged by the SAFE chain instead of an all-reduce,
then FlatAdamW updates the f32 master vector. The reference's (4, 2)
('data', 'model') mesh becomes the port's one-card layout: the four
learners are dim 0 of learner-major tensors on one device, and no
tensor-parallel ranks are spawned (one learner a rank, with model shards,
is ``python -m torch.distributed.run ... -m repro_torch.launch.train
--model-shards 2``).

Run: PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
(SAFE_SMOKE=1 shrinks the run.)
"""
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import make_aggregator
from repro_torch.data import make_federated_batches
from repro_torch.examples import device_arg, smoke
from repro_torch.models import Model
from repro_torch.train import MetricsLogger, make_train_step


def main(argv=None):
    device = device_arg(__doc__.splitlines()[0], argv)
    cfg = get_smoke_config("internlm2-1.8b")
    model = Model(cfg, device=device)

    # the paper's technique: gradients flow through the SAFE chain instead
    # of an all-reduce — swap "safe" for "insec"/"saf"/"bon" to ablate
    aggregator = make_aggregator("safe", num_learners=4, device=device)

    bundle = make_train_step(model, aggregator, lr=3e-3)
    state = bundle.init_state_fn(model.tree())
    stream = make_federated_batches(cfg, num_learners=4, batch_per_learner=2, seq_len=128)
    # each org's local dataset: 4 batches, trained over multiple epochs
    dataset = [torch.as_tensor(stream.global_batch(i)["tokens"], device=device)
               for i in range(4)]
    log = MetricsLogger(print_every=5)
    steps = 6 if smoke() else 30
    for step in range(steps):
        # fresh Threefry counters every step: no pad is ever reused
        state, metrics = bundle.step_fn(
            state, dataset[step % len(dataset)],
            counter=aggregator.reserve_round(bundle.padded_size + 2))
        log.log(step, loss=metrics["loss"], grad=metrics["grad_scale"])
    print("final loss:", float(metrics["loss"]))


if __name__ == "__main__":
    main()
