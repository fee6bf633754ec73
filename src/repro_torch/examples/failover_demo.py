"""Control-plane walkthrough: the SAFE protocol message flow, §5.3 progress
failover, and §5.4 initiator failover — on the discrete-event simulation
with real masked payloads — and then the same rounds on the device data
plane, whose published means are the simulation's bit for bit.

Run: PYTHONPATH=src python -m repro_torch.examples.failover_demo [--device cpu]
"""
import numpy as np

from repro_torch.core import make_aggregator
from repro_torch.core.bon_protocol import run_bon_round
from repro_torch.core.protocol import run_safe_round
from repro_torch.examples import device_arg


def show(title, res, expected):
    err = float(np.max(np.abs(res.average - expected)))
    s = res.stats
    print(f"\n=== {title} ===")
    print(f"  average error vs ground truth : {err:.2e}")
    print(f"  messages: post={s.post_aggregate} check={s.check_aggregate} "
          f"get={s.get_aggregate} post_avg={s.post_average} "
          f"get_avg={s.get_average} should_init={s.should_initiate} "
          f"(total {s.aggregation_total})")
    print(f"  virtual time: {res.virtual_time:.3f}s   "
          f"reposts: {res.monitor_reposts}   "
          f"elections: {res.initiator_elections}")


def main(argv=None):
    device = device_arg(__doc__.splitlines()[0], argv)
    n, V = 8, 16
    vals = np.random.RandomState(0).uniform(-1, 1, (n, V)).astype(np.float32)
    sims = {}

    res = sims["basic"] = run_safe_round(vals)
    show(f"basic round, n={n} (expect 4n = {4*n} messages)", res, vals.mean(0))

    res = sims["failover"] = run_safe_round(vals, failed_nodes=[4, 5])
    mask = np.ones(n, bool)
    mask[[3, 4]] = False
    show("progress failover: learners 4,5 dead (controller re-targets the "
         "chain)", res, vals[mask].mean(0))

    res = run_safe_round(vals, initiator_fails=True, aggregation_timeout=2.0)
    show("initiator failover: learner 1 crashes after posting (round "
         "restarts with a new initiator)", res, vals[1:].mean(0))

    res = sims["subgrouped"] = run_safe_round(vals, subgroups=2)
    exp = (vals[:4].mean(0) + vals[4:].mean(0)) / 2
    show("subgrouped: two parallel chains, average of group averages", res, exp)

    w = np.array([100, 200, 1000, 50, 75, 300, 400, 20], np.float32)
    res = sims["weighted"] = run_safe_round(vals, weights=w)
    show("weighted averaging (§5.6): dataset sizes stay private", res,
         np.average(vals, 0, weights=w))

    bon = run_bon_round(vals, failed_nodes=[4])
    mask = np.ones(n, bool)
    mask[3] = False
    print("\n=== BON baseline with one dropout ===")
    print(f"  average error: "
          f"{float(np.max(np.abs(bon.average - vals[mask].mean(0)))):.2e}")
    print(f"  messages: {bon.messages} (vs SAFE's "
          f"{4*(n-1)+2})  shares reconstructed: {bon.shares_reconstructed}")

    # the same rounds through the device data plane: the masking kernels on
    # the card (their plain versions on the CPU), the learners dim 0
    alive = np.ones(n, np.float32)
    alive[[3, 4]] = 0.0
    rounds = {"basic": (make_aggregator("safe", n, device=device), {}),
              "failover": (make_aggregator("safe", n, device=device), dict(alive=alive)),
              "subgrouped": (make_aggregator("safe", n, subgroups=2, device=device), {}),
              "weighted": (make_aggregator("safe", n, weighted=True, device=device),
                           dict(weights=w))}
    print(f"\n=== the same rounds on the device data plane ({device}) ===")
    for name, (agg, kw) in rounds.items():
        mean = agg.aggregate(vals, 0, **kw).cpu().numpy()
        print(f"  {name}: published mean bit for bit the simulation's: "
              f"{np.array_equal(mean, sims[name].average)}")


if __name__ == "__main__":
    main()
