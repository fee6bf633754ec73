#!/usr/bin/env python3
"""The readings a cell's limits are set from, outside the benchmark's runs.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 [--program]

For each seed, at the cell's own sizes and on its own inputs: the control
(the reference put in the program's place, computed in the nearest
precision below the configuration's: bfloat16 words for float32
aggregation, fp8 (e4m3) products for a bfloat16 model) compared with the
reference by the cell's numbers. With ``--program`` also the program's own
readings (a train cell's set-up steps, without a measured window). One
JSON line a seed and kind. See PERF.md for the readings and limits.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def aggregation_control(config: dict, traffic: dict, seed: int, device) -> dict:
    """Mismatched words of the bf16 control against the f32 reference, for
    each alive pattern of the traffic, on the cell's first pool matrix."""
    from perfbench.inputs import gaussian_pool
    from perfbench.reference.fixedpoint import fixed_point_mean, mismatched_words
    n, sb = int(config["num_learners"]), int(config["scale_bits"])
    values = gaussian_pool(1, n, int(traffic["payload_words"]), float(traffic["value_std"]),
                           seed, device)[0]
    out = {}
    for dead in traffic["dead_cycle"]:
        rows = [r for r in range(n) if r not in dead]
        ref = fixed_point_mean(values, rows, sb)
        ctl = fixed_point_mean(values, rows, sb, dtype=torch.bfloat16)
        out[f"dead{list(dead)}"] = {"mismatched_words": mismatched_words(ctl, ref)}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--program", action="store_true")
    p.add_argument("--variants", default="fp8,half_batch,altered",
                   help="a train cell's: the control (fp8) and the faults planted in the "
                        "reference, comma-separated, or 'none'")
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    from perfbench import harness
    spec = harness.load_spec()
    cell = harness.find_cell(spec, args.workload)
    config = harness.load_config(spec, cell["config"])
    traffic = harness.load_traffic(cell["traffic"])
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        if traffic["kind"] in ("round", "engine"):
            res = {"control": aggregation_control(config, traffic, seed, args.device)}
        else:
            from perfbench.drivers.train import train_readings
            variants = () if args.variants == "none" else tuple(args.variants.split(","))
            res = train_readings(config, traffic, seed, args.device, program=args.program,
                                 variants=variants)
        print(json.dumps({"workload": args.workload, "seed": seed, **res,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    sys.exit(main())
