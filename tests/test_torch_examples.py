"""The port's examples smoke: every module under ``repro_torch.examples``
must run, as ``python -m repro_torch.examples.<name> --device cpu`` with
``SAFE_SMOKE=1``, the way the README tells a user to run it.

The five subprocesses and the reference's two deterministic scripts
(``examples/failover_demo.py`` and ``examples/kernels_demo.py``; the
reference's ``federated_training.py`` can hang under a loaded machine, and
its ``quickstart.py`` fails on this jax) run side by side. In the port's,
``jax`` and ``repro`` cannot be imported. The port's failover and kernel
demos must print the reference's lines word for word: the average errors,
message counts, virtual times and the chain mean's error; the failover demo
then adds the same rounds on the device data plane, each bit for bit the
simulation's.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.examples import device_arg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_EXAMPLES = os.path.join(REPO, "src", "repro_torch", "examples")

#: every example must be enumerated here, as in tests/test_examples.py
EXPECTED = {"failover_demo", "federated_training", "kernels_demo", "quickstart", "serving"}
#: the examples whose lines must equal the reference script's
SAME_LINES = ("failover_demo", "kernels_demo")
TIMEOUT_S = 600
BLOCKED = ("jax", "repro")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: (returncode, stdout, stderr)} of the port's examples, and
    {name: stdout} of the reference's deterministic ones, all run at once."""
    blocker = tmp_path_factory.mktemp("blocked")
    for name in BLOCKED:
        (blocker / name).mkdir()
        (blocker / name / "__init__.py").write_text(
            f"raise ImportError('the port imports no {name}')\n")
    base = dict(os.environ, SAFE_SMOKE="1", OMP_NUM_THREADS="2")
    port_env = dict(base, PYTHONPATH=os.pathsep.join([str(blocker),
                                                      os.path.join(REPO, "src")]))
    ref_env = dict(base, PYTHONPATH=os.path.join(REPO, "src"),
                   XLA_FLAGS="--xla_force_host_platform_device_count=8")
    procs = {("port", name): subprocess.Popen(
        [sys.executable, "-m", f"repro_torch.examples.{name}", "--device", "cpu"],
        env=port_env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in sorted(EXPECTED)}
    procs.update({("ref", name): subprocess.Popen(
        [sys.executable, os.path.join(REPO, "examples", f"{name}.py")],
        env=ref_env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in SAME_LINES})
    out = {}
    try:
        for key, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=TIMEOUT_S)
            out[key] = (proc.returncode, stdout, stderr)
    finally:
        for proc in procs.values():
            proc.kill()
    return out


def test_every_example_is_ported():
    names = {f[:-3] for f in os.listdir(PORT_EXAMPLES)
             if f.endswith(".py") and f != "__init__.py"}
    reference = {f[:-3] for f in os.listdir(os.path.join(REPO, "examples")) if f.endswith(".py")}
    assert names == EXPECTED >= reference


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_example_runs(runs, name):
    rc, stdout, stderr = runs["port", name]
    assert rc == 0, f"{name} failed (rc={rc}):\n{stdout[-3000:]}\n{stderr[-3000:]}"
    assert stdout.strip()


@pytest.mark.parametrize("name", SAME_LINES)
def test_lines_equal_reference(runs, name):
    rc, ref, stderr = runs["ref", name]
    assert rc == 0, stderr[-3000:]
    port = runs["port", name][1].splitlines()
    ref = ref.splitlines()
    assert port[:len(ref)] == ref
    extra = [line for line in port[len(ref):] if line.strip()]
    if name == "failover_demo":
        assert extra[0] == "=== the same rounds on the device data plane (cpu) ==="
        assert len(extra) == 5 and all(line.endswith(": True") for line in extra[1:]), extra
    else:
        assert not extra, extra


def test_training_examples_learn(runs):
    """The quickstart's loss falls; every FedAvg round publishes a finite
    delta, the last with org 3 down. The rounds with every org up carry at
    least a failure-free round's 4n messages: the broker's 0.5 s progress
    timeout adds reposts on a loaded host, so the counts are not fixed."""
    lines = runs["port", "quickstart"][1].splitlines()
    first = float(lines[0].split("loss=")[1].split()[0])
    final = float(lines[-1].split("final loss:")[1])
    assert final < first, (first, final)
    rounds = [line for line in runs["port", "federated_training"][1].splitlines()
              if line.startswith("round")]
    assert len(rounds) == 3 and ["org 3 DOWN" in line for line in rounds] == [False, False, True]
    deltas = [float(line.split("delta=")[1].split()[0]) for line in rounds]
    assert all(np.isfinite(d) and d > 0 for d in deltas), deltas
    msgs = [int(line.split("msgs=")[1].split()[0]) for line in rounds]
    assert min(msgs[:2]) >= 4 * 4, msgs


def test_example_without_card_stops():
    """An example asked for the card, on a host without one, stops; it
    does not go on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(SystemExit, match="no CUDA device"):
        device_arg("an example", [])
    assert device_arg("an example", ["--device", "cpu"]).type == "cpu"
