"""Shared helpers of the benchmarks-plan parity tests
(tests/test_torch_storm*.py, tests/test_torch_benchmarks*.py): the JAX
plan's cases, the JAX and port executables of a case, storm with
``__graft_entry__``'s compressed params, and the leaf-by-leaf
comparison."""

import importlib.util
from pathlib import Path

import jax
import numpy as np
import torch

from testground_tpu.parallel import instance_mesh
from testground_tpu.sim import BuildContext as JCtx
from testground_tpu.sim import SimConfig as JConfig
from testground_tpu.sim import compile_program as j_compile
from testground_tpu.sim.context import GroupSpec as JGroup
from testground_tpu_torch import graft
from testground_tpu_torch.plans import benchmarks as tbench
from testground_tpu_torch.sim import BuildContext as TCtx
from testground_tpu_torch.sim import GroupSpec as TGroup
from testground_tpu_torch.sim import SimConfig as TConfig
from testground_tpu_torch.sim import compile_program as t_compile
from testground_tpu_torch.sim.state_io import flatten, state_to_numpy

REPO = Path(__file__).resolve().parent.parent


def jax_plan(case="storm"):
    """The JAX benchmarks plan's ``case`` (plans/benchmarks/sim.py)."""
    spec = importlib.util.spec_from_file_location(
        "plan_benchmarks_reference", REPO / "plans" / "benchmarks" / "sim.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.testcases[case]


def leg_params(shaped):
    """The compressed params; shaped adds latency, loss, SYN retries and
    churn-tolerant rendezvous (``__graft_entry__._storm_executable``
    with shaped=True, tolerant=True)."""
    p = dict(graft.STORM_PARAMS)
    if shaped:
        p.update(graft.SHAPED_PARAMS, churn_tolerant=1)
    return {k: str(v) for k, v in p.items()}


def leg_config(shaped, **kw):
    cfg = dict(quantum_ms=10.0, max_ticks=100_000, phase_gating=True)
    if shaped:
        cfg.update(churn_fraction=0.05, churn_start_ms=500.0,
                   churn_end_ms=1_500.0)
    cfg.update(kw)
    return cfg


def jax_run(plan, groups, cfg, case="storm"):
    ctx = JCtx([JGroup(*g) for g in groups], test_case=case, test_run="t")
    ex = j_compile(plan, ctx, JConfig(chunk_ticks=100_000, **cfg),
                   mesh=instance_mesh(jax.devices()[:1]))
    return ex.run()


def torch_run(plan, groups, cfg, chunk_ticks=64, case="storm"):
    ctx = TCtx([TGroup(*g) for g in groups], test_case=case, test_run="t")
    ex = t_compile(plan, ctx, TConfig(chunk_ticks=chunk_ticks, **cfg),
                   device="cpu")
    return ex.run()


def storm_pair(n, shaped, **cfg_kw):
    groups = [("single", 0, n, leg_params(shaped))]
    cfg = leg_config(shaped, **cfg_kw)
    return (jax_run(jax_plan(), groups, cfg),
            torch_run(tbench.storm, groups, cfg))


def case_pair(case, n, params=None, chunk_ticks=64, **cfg):
    """The benchmarks plan's ``case`` at ``n`` instances (one group with
    ``params``) run to the end in both packages: (JAX result, port
    result)."""
    groups = [("single", 0, n,
               {k: str(v) for k, v in (params or {}).items()})]
    return (jax_run(jax_plan(case), groups, cfg, case=case),
            torch_run(tbench.testcases[case], groups, cfg, chunk_ticks,
                      case=case))


def _is_torch(state):
    return any(isinstance(v, torch.Tensor) for v in flatten(state).values())


def assert_leaves_equal(jax_state, torch_state, skip=()):
    """Every leaf bit-equal by path (floats by their bits), but the
    leaves whose last path component is in ``skip``; returns the number
    of leaves compared. Either state may be the JAX package's or the
    port's."""
    a, b = (flatten(state_to_numpy(s) if _is_torch(s)
                    else jax.device_get(s)) for s in (jax_state, torch_state))
    a = {k: v for k, v in a.items() if k.split("/")[-1] not in skip}
    b = {k: v for k, v in b.items() if k.split("/")[-1] not in skip}
    assert set(a) == set(b), set(a) ^ set(b)
    for k in sorted(a):
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (k, x.dtype,
                                                           y.dtype)
        if x.dtype.kind == "f":
            x, y = x.view(np.int32), y.view(np.int32)
        np.testing.assert_array_equal(y, x, err_msg=k)
    return len(a)
