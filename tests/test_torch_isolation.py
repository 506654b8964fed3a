"""The port stands alone: importing every module of testground_tpu_torch
(and chip_smoke.py) loads neither jax nor anything of testground_tpu,
its entry points refuse to run without CUDA unless the caller asks for
the CPU, and chip_smoke.py fails without a card or without the port
beside it."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from testground_tpu_torch.device import resolve_device
from testground_tpu_torch.plans import dht, gossipsub
from testground_tpu_torch.sim import BuildContext, GroupSpec, compile_program
from testground_tpu_torch.sim.state_io import state_from_numpy

REPO = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import testground_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
import chip_smoke  # noqa: F401
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k == "jaxlib"
             or k.startswith("jaxlib.") or k == "testground_tpu"
             or k.startswith("testground_tpu."))
print(json.dumps({"modules": mods, "bad": bad}))
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, str(REPO)],
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for mod in (
        "testground_tpu_torch.sim.core",
        "testground_tpu_torch.sim.ring_merge",
        "testground_tpu_torch.kernels.deliver_front",
        "testground_tpu_torch.kernels.ring_merge",
        "testground_tpu_torch.plans.gossipsub",
        "testground_tpu_torch.tools.microbench_append",
        "testground_tpu_torch.sim.replay",
        "testground_tpu_torch.sim.drain",
        "testground_tpu_torch.plans.election",
        "testground_tpu_torch.sim.runner",
        "testground_tpu_torch.sim.live",
        "testground_tpu_torch.sim.profile",
        "testground_tpu_torch.sim.checkpoint",
        "testground_tpu_torch.runner.sim_torch",
        "testground_tpu_torch.runner.outputs",
        "testground_tpu_torch.api.composition",
        "testground_tpu_torch.api.contracts",
        "testground_tpu_torch.api.manifest",
        "testground_tpu_torch.config.coalescing",
        "testground_tpu_torch.utils.timing",
        "testground_tpu_torch.healthcheck.checks",
        "testground_tpu_torch.cli",
        "testground_tpu_torch.__main__",
    ):
        assert mod in out["modules"]
    assert out["bad"] == []


def _ctx(n=200):
    return BuildContext([GroupSpec("single", 0, n, {})], test_case="t")


def test_entry_points_need_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        compile_program(dht.find_providers, _ctx())
    with pytest.raises(RuntimeError, match="cuda"):
        compile_program(gossipsub.mesh_propagation, _ctx())
    with pytest.raises(RuntimeError, match="cuda"):
        state_from_numpy({"tick": np.int32(0)})
    with pytest.raises(ValueError):
        resolve_device("mps")
    # the CPU runs when, and only when, the caller asks for it
    from testground_tpu_torch.sim import SimConfig

    ex = compile_program(dht.find_providers, _ctx(),
                         SimConfig(pallas_front=True), device="cpu")
    assert ex.device.type == "cpu"
    st = state_from_numpy({"tick": np.int32(3)}, device="cpu")
    assert int(st["tick"]) == 3


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card_or_the_port(tmp_path, alone):
    """Without CUDA (this machine) the script exits non-zero and prints no
    result; copied alone into an empty directory it fails the same way."""
    script = REPO / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    proc = subprocess.run(
        [sys.executable, str(script)], capture_output=True, text=True,
        timeout=300, cwd=script.parent,
    )
    if torch.cuda.is_available() and not alone:
        pytest.skip("a card is present: chip_smoke.py runs for real")
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
