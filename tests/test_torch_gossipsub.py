"""The port's gossipsub mesh-propagation (testground_tpu_torch/plans/
gossipsub.py) against the JAX plan (plans/gossipsub/sim.py), whole, on
the default lowering (default deliver front, unbounded append, event
skip), both on the CPU: degree 6 at n = 300, with the bench's 50 ms / 0%
links and with 20 ms / 10% loss. Every state leaf (ticks_executed
included), ticks, statuses and metric records must be equal, floats by
their bits."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest

from testground_tpu.parallel import instance_mesh
from testground_tpu.sim import BuildContext as JCtx
from testground_tpu.sim import SimConfig as JConfig
from testground_tpu.sim import compile_program as j_compile
from testground_tpu.sim.context import GroupSpec as JGroup
from testground_tpu_torch.plans import gossipsub as tgs
from testground_tpu_torch.sim import BuildContext as TCtx
from testground_tpu_torch.sim import GroupSpec as TGroup
from testground_tpu_torch.sim import SimConfig as TConfig
from testground_tpu_torch.sim import compile_program as t_compile
from testground_tpu_torch.sim.state_io import flatten, state_to_numpy

REPO = Path(__file__).resolve().parent.parent
CFG = dict(quantum_ms=10.0, max_ticks=20_000, metrics_capacity=8)


def _jax_plan():
    spec = importlib.util.spec_from_file_location(
        "plan_gossipsub_reference", REPO / "plans" / "gossipsub" / "sim.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.testcases["mesh-propagation"]


def _groups(cls, n, params):
    return [cls("single", 0, n, {k: str(v) for k, v in params.items()})]


def assert_leaves_equal(jax_state, torch_state):
    a = flatten(jax.device_get(jax_state))
    b = flatten(state_to_numpy(torch_state))
    assert set(a) == set(b), set(a) ^ set(b)
    for k in sorted(a):
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (k, x.dtype,
                                                           y.dtype)
        if x.dtype.kind == "f":
            x, y = x.view(np.int32), y.view(np.int32)
        np.testing.assert_array_equal(y, x, err_msg=k)


@pytest.mark.parametrize("latency_ms,loss_pct", [(50, 0), (20, 10)])
def test_gossipsub_bit_equal(latency_ms, loss_pct):
    n = 300
    params = {"degree": 6, "link_latency_ms": latency_ms,
              "link_loss_pct": loss_pct}
    jex = j_compile(
        _jax_plan(),
        JCtx(_groups(JGroup, n, params), test_case="mesh-propagation",
             test_run="t"),
        JConfig(chunk_ticks=100_000, **CFG),
        mesh=instance_mesh(jax.devices()[:1]),
    )
    tex = t_compile(
        tgs.mesh_propagation,
        TCtx(_groups(TGroup, n, params), test_case="mesh-propagation",
             test_run="t"),
        TConfig(chunk_ticks=16, **CFG), device="cpu",
    )
    assert jex.event_skip and tex.event_skip
    assert tex.program.net_spec.send_slots is None  # the unbounded append
    jres, tres = jex.run(), tex.run()
    assert not jres.timed_out()
    assert tres.ticks == jres.ticks
    assert tres.ticks_executed == jres.ticks_executed
    assert tres.skip_ratio == jres.skip_ratio
    np.testing.assert_array_equal(tres.statuses(), jres.statuses())
    assert tres.metrics_records() == jres.metrics_records()
    assert_leaves_equal(jres.state, tres.state)
    # full coverage and the bench's honesty counters
    assert (tres.statuses() == 1).sum() == n
    assert tres.net_dropped() == 0
    assert tres.metrics_dropped() == 0
