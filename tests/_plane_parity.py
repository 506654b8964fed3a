"""Shared helpers of the fault, trace, telemetry, replay and drain parity
tests (tests/test_torch_faults.py, test_torch_trace.py,
test_torch_telemetry.py, test_torch_plans_faults.py, test_torch_replay.py,
test_torch_drain.py, test_torch_plans_election.py): one program built in
both packages with the same ``[faults]``/``[trace]``/``[telemetry]``/
``[replay]`` tables (dicts, parsed by each package's own table classes),
the comparison of everything the planes give (every state leaf, the
demuxed trace events, the Chrome trace JSON text, the telemetry records,
the consumed arrivals), and the op log of one tick."""

import json

import jax
import numpy as np
import torch
from _storm_parity import assert_leaves_equal

from testground_tpu.api import Faults as JFaults
from testground_tpu.api import Replay as JReplay
from testground_tpu.api import Telemetry as JTelemetry
from testground_tpu.api import Trace as JTrace
from testground_tpu.parallel import instance_mesh
from testground_tpu.sim import BuildContext as JCtx
from testground_tpu.sim import SimConfig as JConfig
from testground_tpu.sim import compile_program as j_compile
from testground_tpu.sim import trace as jtrace
from testground_tpu.sim.context import GroupSpec as JGroup
from testground_tpu_torch.bench import OpLog
from testground_tpu_torch.sim import BuildContext as TCtx
from testground_tpu_torch.sim import GroupSpec as TGroup
from testground_tpu_torch.sim import SimConfig as TConfig
from testground_tpu_torch.sim import compile_program as t_compile
from testground_tpu_torch.sim import tables
from testground_tpu_torch.sim import trace as ttrace


def j_tables(faults=None, trace=None, telemetry=None, replay=None):
    """The JAX package's table objects of the dict tables."""
    return dict(
        faults=None if faults is None else JFaults.from_dict(faults),
        trace=None if trace is None else JTrace.from_dict(trace),
        telemetry=(None if telemetry is None
                   else JTelemetry.from_dict(telemetry)),
        replay=None if replay is None else JReplay.from_dict(replay),
    )


def t_tables(faults=None, trace=None, telemetry=None, replay=None):
    """The port's table objects of the dict tables."""
    return dict(
        faults=None if faults is None else tables.Faults.from_dict(faults),
        trace=None if trace is None else tables.Trace.from_dict(trace),
        telemetry=(None if telemetry is None
                   else tables.Telemetry.from_dict(telemetry)),
        replay=None if replay is None else tables.Replay.from_dict(replay),
    )


def j_build(plan, groups, case="t", **cfg_and_tables):
    """The JAX executable of ``plan`` on one CPU device."""
    tabs, cfg = _split(cfg_and_tables)
    ctx = JCtx([JGroup(*g) for g in groups], test_case=case, test_run="r")
    cfg.setdefault("chunk_ticks", 100_000)
    return j_compile(plan, ctx, JConfig(**cfg),
                     mesh=instance_mesh(jax.devices()[:1]),
                     **j_tables(**tabs))


def t_build(plan, groups, case="t", chunk_ticks=64, **cfg_and_tables):
    """The port's executable of ``plan`` on the CPU."""
    tabs, cfg = _split(cfg_and_tables)
    ctx = TCtx([TGroup(*g) for g in groups], test_case=case, test_run="r")
    return t_compile(plan, ctx, TConfig(chunk_ticks=chunk_ticks, **cfg),
                     device="cpu", **t_tables(**tabs))


def _split(kw):
    tabs = {k: kw.pop(k) for k in ("faults", "trace", "telemetry", "replay")
            if k in kw}
    return tabs, kw


def run_pair(jplan, tplan, groups, case="t", **kw):
    """Both packages' executables of a program and their runs:
    ((jax executable, jax result), (port executable, port result))."""
    jex = j_build(jplan, groups, case, **dict(kw))
    tex = t_build(tplan, groups, case, **dict(kw))
    return (jex, jex.run()), (tex, tex.run())


def assert_planes_equal(jpair, tpair):
    """Everything the two runs give equal: ticks, every state leaf (bits),
    the trace events, the Chrome trace JSON text and the telemetry
    records. Returns the number of leaves compared."""
    (jex, jr), (tex, tr) = jpair, tpair
    assert tr.ticks == jr.ticks
    assert tr.ticks_executed == jr.ticks_executed
    leaves = assert_leaves_equal(jr.state, tr.state)
    if "trace" in jr.state:
        np.testing.assert_array_equal(ttrace.trace_events(tr.state),
                                      jtrace.trace_events(jr.state))
        want = json.dumps(jtrace.chrome_trace(
            jr.state, jex.ctx, jex.config.quantum_ms,
            fault_plan=jex.faults))
        assert json.dumps(tr.chrome_trace()) == want
    assert tr.telemetry_records() == jr.telemetry_records()
    assert tr.restarts_total() == jr.restarts_total()
    assert tr.replay_consumed() == jr.replay_consumed()
    return leaves


def tick_op_log(ex, ticks=2):
    """The ops of ``ticks`` loop iterations of a port executable from its
    initial state, and the state's leaf names."""
    from testground_tpu_torch.sim.state_io import flatten

    st = ex.init_state()
    ex.tick_fn()  # the build-time probe runs outside the log
    with torch.no_grad(), OpLog() as log:
        for _ in range(ticks):
            st = ex.guarded_tick(st)
    return log.ops, sorted(flatten(st))
