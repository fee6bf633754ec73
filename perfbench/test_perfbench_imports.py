"""The run's check of its own imports, and the command without a card."""
import os
import subprocess
import sys
import types

import pytest
import torch

from perfbench import harness


@pytest.mark.parametrize("name,caught", [("jax", True), ("jax.numpy", True), ("jaxlib", True),
                                         ("flax.linen", True), ("repro", True),
                                         ("repro.core.chain", True), ("repro_torch", False),
                                         ("repro_torch.core", False), ("reprox", False)])
def test_forbidden_modules_compare_whole_top_level_names(monkeypatch, name, caught):
    for k in [m for m in sys.modules if m.split(".")[0] in harness.FORBIDDEN_MODULES]:
        monkeypatch.delitem(sys.modules, k)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (name.split(".")[0] in harness.forbidden_modules()) == caught


def test_command_without_a_card_exits_2_with_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the command would run the cell")
    out = subprocess.run([sys.executable, str(harness.HERE / "run.py"), "--workload",
                          "agg-n36-round", "--seed", str(2**31 + 3), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=120,
                         env=dict(os.environ), cwd=harness.ROOT)
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA" in out.stderr
