"""The plain references agree with the program's CPU path at small sizes,
and load nothing of the program or of JAX."""
import ast
import os
import subprocess
import sys

import pytest
import torch

from perfbench import harness
from perfbench.drivers import train as train_driver
from perfbench.inputs import alive_bitmap, gaussian_pool
from perfbench.reference import decoder, fixedpoint
from perfbench.reference.train import gaps

REFERENCE = harness.HERE / "reference"


def _tiny_decoder(dtype="float32", **over):
    cfg = dict(harness.load_config(harness.load_spec(), "internlm2-1.8b"), n_layers=2,
               d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96, vocab=128,
               dtype=dtype, **over)
    return cfg


@pytest.mark.parametrize("dead", [[], [3, 4, 5], [0, 35]])
def test_fixed_point_mean_is_the_published_round(dead):
    from repro_torch.core.aggregators import make_aggregator
    n, V = 36, 1001
    values = gaussian_pool(1, n, V, 0.1, 2**31 + 5, "cpu")[0]
    agg = make_aggregator("safe", n, provisioning_seed=11, learner_master=12, device="cpu")
    base = agg.reserve_round(V)
    out = agg.aggregate(values, base, alive=alive_bitmap(n, dead), rotate=base % 73 + 2)
    ref = fixedpoint.fixed_point_mean(values, [r for r in range(n) if r not in dead])
    assert fixedpoint.mismatched_words(out, ref) == 0
    ctl = fixedpoint.fixed_point_mean(values, [r for r in range(n) if r not in dead],
                                      dtype=torch.bfloat16)
    assert fixedpoint.mismatched_words(ctl, ref) > V // 2


def test_fixed_point_mean_is_every_engine_session():
    from repro_torch.core.types import ChainConfig
    from repro_torch.serve.agg_engine import AggregationEngine
    n, V = 36, 257
    pool = gaussian_pool(3, n, V, 0.1, 77, "cpu")
    eng = AggregationEngine(ChainConfig(num_learners=n, mode="safe"), slots=3,
                            payload_words=V, device="cpu")
    deads = [[], [3, 4, 5], [7]]
    sess = [eng.submit(pool[i], provisioning_seed=100 + i, learner_master=200 + i,
                       alive=alive_bitmap(n, deads[i]), rotate0=i) for i in range(3)]
    eng.step()
    for s, v, d in zip(sess, pool, deads):
        ref = fixedpoint.fixed_point_mean(v, [r for r in range(n) if r not in d])
        assert fixedpoint.mismatched_words(s.results[0], ref) == 0


@pytest.mark.parametrize("tied", [False, True])
def test_decoder_loss_is_the_programs_f32_loss(tied):
    from repro_torch.models import Model
    from repro_torch.train.loss import next_token_loss
    cfg = _tiny_decoder(tie_embeddings=tied)
    weights = train_driver.make_weights(cfg, 3, "cpu")
    model = Model(train_driver.program_config(cfg), device="cpu")
    tree = model.tree()
    with torch.no_grad():
        for path in train_driver.leaf_spans(tree):
            train_driver._leaf(tree, path).copy_(weights[path])
    tokens = torch.randint(0, cfg["vocab"], (2, 24), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        logits, _ = model.apply(tree, tokens)
        want = next_token_loss(logits, tokens)
        got = [decoder.sequence_loss(weights, tokens[b], cfg) for b in range(2)]
    assert float(sum(got) / 2) == pytest.approx(float(want), rel=2e-6)


def test_train_reference_follows_the_programs_f32_step():
    cfg = _tiny_decoder()
    traffic = dict(harness.load_traffic("train-4x2x4096"), seq=16)
    drv = train_driver.Driver(cfg, traffic, 2**31 + 9, "cpu")
    drv.warmup()
    got = gaps(drv.readings, drv.reference())
    assert got["loss_gap"] < 1e-6 and got["grad_gap"] < 1e-5 and got["change_gap"] < 1e-4


def test_references_import_nothing_of_the_program():
    for path in REFERENCE.glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] in ("torch", "numpy", "math", "contextlib",
                                             "typing", "perfbench", "__future__"), (path, mod)
                if mod.startswith("perfbench"):
                    assert mod.startswith("perfbench.reference"), (path, mod)


def test_references_run_with_the_program_and_jax_blocked():
    code = (
        "import sys, importlib.abc\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in ('repro_torch', 'repro', 'jax', 'jaxlib', 'flax'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import torch\n"
        "from perfbench.reference import decoder, fixedpoint, precision, train\n"
        "x = torch.randn(4, 9)\n"
        "print(fixedpoint.fixed_point_mean(x, [0, 2]).shape)\n")
    env = dict(os.environ, PYTHONPATH=str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "torch.Size([9])" in out.stdout
