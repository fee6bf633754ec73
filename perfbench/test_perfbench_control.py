"""Each cell's control comes out not correct: the reference put in the
program's place, in the precision below the configuration's (bfloat16
words for the float32 rounds; fp8 products for the bfloat16 model).

At a size a test run holds here on the CPU, and, marked ``cuda``, at the
aggregation cells' own sizes on the card. (The train cell's control at
its own size runs through ``perfbench/control.py``; PERF.md has its
readings.)
"""
import pytest

from perfbench import control, harness
from perfbench.drivers import train as train_driver

SPEC = harness.load_spec()


def _agg(cell, **over):
    c = harness.find_cell(SPEC, cell)
    return (harness.load_config(SPEC, c["config"]),
            dict(harness.load_traffic(c["traffic"]), **over))


@pytest.mark.parametrize("cell", ["agg-n36-round", "agg-n36-engine"])
@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
def test_aggregation_control_fails(cell, seed):
    config, traffic = _agg(cell, payload_words=4099)
    got = control.aggregation_control(config, traffic, seed, "cpu")
    assert all(v["mismatched_words"] > 0 for v in got.values())  # the limit is 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["agg-n36-round", "agg-n36-engine"])
def test_aggregation_control_fails_at_the_cells_size(cuda_device, cell):
    config, traffic = _agg(cell)
    got = control.aggregation_control(config, traffic, 2**31 + 11, cuda_device)
    assert all(v["mismatched_words"] > traffic["payload_words"] // 2 for v in got.values())


TINY = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
        "d_ff": 96, "vocab": 128}


@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
def test_train_control_fails_where_the_program_passes(seed):
    c = harness.find_cell(SPEC, "train-internlm2-1.8b-safe")
    config = dict(harness.load_config(SPEC, c["config"]), **TINY)
    traffic = dict(harness.load_traffic(c["traffic"]), seq=16)
    got = train_driver.train_readings(config, traffic, seed, "cpu", variants=("fp8",))
    limits = {k: v for k, v in harness.load_limits(c["name"]).items() if k in got["fp8"]}
    assert all(got["program"][k] <= limits[k] for k in limits), got["program"]
    assert any(got["fp8"][k] > limits[k] for k in limits), got["fp8"]
