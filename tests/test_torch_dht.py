"""The port's whole slice against the JAX package: dht find-providers
with the bench's parameters (20 ms links, 5% loss, 5% churn over
100-5,000 ms, 500 ms query timeout, 3 retries) and the fused deliver
front, both on the CPU. Every state leaf must be bit-equal by name, and
so must ticks, statuses and metric records; a state carried from a JAX
run mid-way must tick identically in the port."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from testground_tpu.parallel import instance_mesh
from testground_tpu.sim import BuildContext as JCtx
from testground_tpu.sim import SimConfig as JConfig
from testground_tpu.sim import compile_program as j_compile
from testground_tpu.sim.context import GroupSpec as JGroup
from testground_tpu_torch.plans import dht as tdht
from testground_tpu_torch.sim import BuildContext as TCtx
from testground_tpu_torch.sim import GroupSpec as TGroup
from testground_tpu_torch.sim import SimConfig as TConfig
from testground_tpu_torch.sim import compile_program as t_compile
from testground_tpu_torch.sim.state_io import (
    flatten,
    state_from_numpy,
    state_to_numpy,
)

REPO = Path(__file__).resolve().parent.parent
PARAMS = {"link_latency_ms": 20, "link_loss_pct": 5,
          "query_timeout_ms": 500, "max_retries": 3}
CFG = dict(quantum_ms=10.0, max_ticks=60_000, metrics_capacity=8,
           churn_fraction=0.05, churn_start_ms=100.0, churn_end_ms=5_000.0,
           pallas_front=True)


def _jax_plan():
    spec = importlib.util.spec_from_file_location(
        "plan_dht_reference", REPO / "plans" / "dht" / "sim.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.testcases["find-providers"]


def _groups(cls, n):
    return [cls("single", 0, n, {k: str(v) for k, v in PARAMS.items()})]


def jax_exec(n):
    ctx = JCtx(_groups(JGroup, n), test_case="find-providers", test_run="t")
    return j_compile(_jax_plan(), ctx, JConfig(chunk_ticks=100_000, **CFG),
                     mesh=instance_mesh(jax.devices()[:1]))


def torch_exec(n):
    ctx = TCtx(_groups(TGroup, n), test_case="find-providers", test_run="t")
    return t_compile(tdht.find_providers, ctx,
                     TConfig(chunk_ticks=16, **CFG), device="cpu")


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


@pytest.mark.parametrize("n", [200, 300])
def test_dht_slice_bit_equal(n):
    jres = jax_exec(n).run()
    tres = torch_exec(n).run()
    assert not jres.timed_out()
    assert tres.ticks == jres.ticks
    np.testing.assert_array_equal(tres.statuses(), jres.statuses())
    assert tres.metrics_records() == jres.metrics_records()
    assert_leaves_equal(jres.state, tres.state)
    # the bench's honesty counters, read through the port's accessors
    assert tres.net_egress_overflow() == 0
    assert tres.net_dropped() == 0
    assert tres.metrics_dropped() == 0
    assert (tres.statuses() == 1).sum() > 0
    assert (tres.statuses() == 3).sum() > 0  # churn struck


def test_dht_carried_state_ticks_alike():
    """Run JAX k ticks, carry its state into the port, tick once in each:
    every leaf must agree (state_from_numpy is the weights-carried-across
    of a system without a model)."""
    n = 200
    jex, tex = jax_exec(n), torch_exec(n)
    run_chunk = jex._compile_chunk()
    j_tick = jax.jit(jex.tick_fn())
    t_tick = tex.tick_fn()
    st = jex._init_jitted()()
    for k in (1, 4, 37, 120):
        st = run_chunk(st, jnp.int32(k))
        assert int(st["tick"]) == k
        carried = state_from_numpy(jax.device_get(st), "cpu")
        assert_leaves_equal(j_tick(st), t_tick(carried))


def test_dht_small_n_is_ineligible_in_both():
    """dht sets send_slots = max(128, n // 8); at n <= 128 that is not
    below n, so the fused front is ineligible and both packages raise."""
    n = 64
    with pytest.raises(ValueError, match="pallas_front"):
        jax_exec(n)
    with pytest.raises(ValueError, match="pallas_front"):
        torch_exec(n)
