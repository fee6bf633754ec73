"""BENCHMARK.json against the benchmark's contract, and every name in it
found in a file of its own."""
import re

import pytest
import torch

from perfbench import harness, work
from perfbench.reference import decoder

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "perfbench/run.py"]
    assert SPEC["paths"] == ["perfbench"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    names = set()
    for entry in SPEC["configs"]:
        assert set(entry) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(entry["name"]) and all(NAME.match(k) for k in entry["reduced"])
        assert entry["file"].startswith("perfbench/")
    for cell in SPEC["workloads"]:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        assert cell["chips"] in (1, 4) and len(cell["why"]) <= 200
        assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    for section, keys in (("end_to_end", {"name", "unit", "better", "bound", "source"}),
                          ("per_layer", {"name", "unit", "better", "source", "layer", "moves"})):
        for m in SPEC[section]:
            assert set(m) - {"workloads"} == keys, m["name"]
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
            assert m["name"] not in names
            names.add(m["name"])
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("cell", [c["name"] for c in SPEC["workloads"]])
def test_cell_finds_its_files_and_reports_enough(cell):
    c = harness.find_cell(SPEC, cell)
    config = harness.load_config(SPEC, c["config"])
    traffic = harness.load_traffic(c["traffic"])
    assert config["name"] == c["config"]
    assert harness.load_driver(traffic["kind"]).Driver
    e2e = [m["name"] for m in harness.metrics_of(SPEC, cell, "end_to_end")]
    layer = harness.metrics_of(SPEC, cell, "per_layer")
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in layer:
        assert m["moves"] in e2e, (m["name"], m["moves"])


@pytest.mark.parametrize("cell", [c["name"] for c in SPEC["workloads"]])
def test_every_cell_has_its_limits(cell):
    limits = harness.load_limits(cell)
    assert limits and all(isinstance(v, (int, float)) and v >= 0 for v in limits.values())


def test_layouts_are_the_programs_parameters():
    """The reference's layout names every leaf of the program's model, at
    its shape, for the configuration as it is run (meta tensors)."""
    from perfbench.drivers.train import leaf_spans, program_config, reference_of
    from repro_torch.models import Model
    for entry in SPEC["configs"]:
        cfg = harness.load_config(SPEC, entry["name"])
        if "reference" not in cfg:
            continue
        tree = Model(program_config(cfg), device="meta").tree()
        layout = reference_of(cfg).layout(cfg)
        assert set(layout) == set(leaf_spans(tree))
        sizes = {p: shape for p, (shape, _, _) in layout.items()}
        for path, (_, size) in leaf_spans(tree).items():
            assert torch.Size(sizes[path]).numel() == size, path


def test_reduced_lists_what_differs_from_the_published_model():
    for entry in SPEC["configs"]:
        cfg = harness.load_config(SPEC, entry["name"])
        assert sorted(cfg.get("published", {})) == sorted(entry["reduced"])
        assert sorted(cfg["reduced"]) == sorted(entry["reduced"])


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(harness.load_reader(metric))


def test_every_config_is_used_and_pairs_are_unique():
    used = {c["config"] for c in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    pairs = [(c["config"], c["traffic"]) for c in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_run_seconds_fit_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_work_arithmetic():
    # a hop at 2^26 words is bound by bytes: 12 B a word at 3.35 TB/s
    assert work.kernel_least_seconds("chain_combine", 1 << 26) == pytest.approx(
        12 * (1 << 26) / 3.35e12)
    # a round of 36 at 2^26 is bound by its 73 pads' Threefry operations
    b, ops = work.round_work(36, 36, 1 << 26)
    assert ops / work.ISSUE_OPS_PER_S > b / work.HBM_BYTES_PER_S
    assert work.round_least_seconds(36, 36, 1 << 26) == pytest.approx(5.64e-3, rel=0.01)
    cfg = harness.load_config(SPEC, "internlm2-1.8b")
    # 12 layers' projections and the untied head: 6 x 1.134e9 x 32,768 tokens, and attention
    assert decoder.train_flops(cfg, 4, 2, 4096) == pytest.approx(
        6 * (12 * 62_914_560 + 92_544 * 2048) * 32_768 + 6 * 4096 ** 2 * 2048 * 12 * 8)


def test_model_flops_match_a_flop_counter_on_the_programs_forward():
    """The parts of ``decoder.train_flops`` (projections, head, S x S
    products) against ``FlopCounterMode`` on the program's forward at the
    published widths, on meta tensors (two layers, one learner's batch)."""
    from torch.utils.flop_counter import FlopCounterMode

    from perfbench.drivers.train import program_config
    from repro_torch.models import Model
    cfg = dict(harness.load_config(SPEC, "internlm2-1.8b"), n_layers=2)
    model = Model(program_config(cfg), device="meta")
    tokens = torch.zeros((2, 4096), dtype=torch.long, device="meta")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model.apply(model.tree(), tokens)
    assert counter.get_total_flops() == decoder.forward_flops_dense(cfg, 2, 4096)
