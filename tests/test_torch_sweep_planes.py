"""Sweeps under the fault, trace, telemetry, replay and drain planes, the
port (testground_tpu_torch/sim/sweep.py) against the JAX package on the
CPU: a ``$param`` fault-severity grid over seed-keyed kills, traced and
sampled (faultsdemo's chaos case at 6, dense and event-skipped); a replay
``$scale`` grid with an explicit capacity and recorded churn; and a
drained sweep whose per-scenario ``trace.jsonl``, ``results.out`` and
``trace.json`` are byte-equal to the JAX drain's. Scenario s of the port
sweep equals the JAX sweep's scenario s and the port's serial run on
every state leaf, bit for bit."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import copy

import jax.numpy as jnp
import pytest
import torch
from test_torch_replay import _basic_rows, _echo, _write_trace
from test_torch_sweep import assert_scenario, j_sweep, t_serial, t_sweep
from test_torch_trace import CHAOS_GROUPS, CHAOS_TIMELINE, faultsdemo

from testground_tpu.sim.drain import ObserverDrain as JDrain
from testground_tpu_torch.sim.drain import EVENTS_FILE, RESULTS_FILE
from testground_tpu_torch.sim.drain import ObserverDrain as TDrain


def chaos_grid():
    """CHAOS_TIMELINE with the degrade window's loss a ``$loss`` param."""
    tl = copy.deepcopy(CHAOS_TIMELINE)
    for ev in tl["events"]:
        if ev["kind"] == "degrade":
            ev["loss_pct"] = "$loss"
    return tl


def grid_scenarios(seeds, losses):
    return [{"seed": s, "params": {"loss": str(v)}}
            for v in losses for s in seeds]


CHAOS_CFG = dict(quantum_ms=1.0, max_ticks=400, metrics_capacity=16)


def _chaos_tabs(trace=True, telemetry=True, drain=False):
    tabs = {"faults": chaos_grid()}
    if trace:
        tabs["trace"] = {"capacity": 16, "drain": drain}
    if telemetry:
        tabs["telemetry"] = {"interval": 10, "drain": drain}
    return tabs


@pytest.mark.parametrize("event_skip", [False, True])
def test_fault_grid_traced_and_sampled_matches_serial_and_jax(event_skip):
    jplan, tplan = faultsdemo()
    scen = grid_scenarios([0, 7], [10, 90])
    tabs = _chaos_tabs()
    cfg = dict(CHAOS_CFG, event_skip=event_skip)
    jres = j_sweep(jplan, CHAOS_GROUPS, scen, "chaos", tabs=tabs, **cfg).run()
    tex = t_sweep(tplan, CHAOS_GROUPS, scen, "chaos", tabs=tabs, **cfg)
    tres = tex.run()
    # the grid rides the fault tensors: the window's loss per scenario
    losses = [float(tres.scenario(s).state["faults"]["win_loss"].max())
              for s in range(4)]
    assert losses[0] == losses[1] != losses[2] == losses[3]
    for s in range(4):
        serial = t_serial(tplan, CHAOS_GROUPS, scen[s], "chaos", tabs=tabs,
                          **cfg)
        assert assert_scenario(jres, tres, s, serial) > 40
        r = tres.scenario(s)
        assert r.trace_events_total() > 0 and r.telemetry_samples() > 0
        assert r.restarts_total() == 1
    # the seeds pick their own victims (a rejoin clears the state's
    # kill_tick, so read the plans)
    kills = {tex._fault_plans[s].kill_tick.tobytes() for s in range(4)}
    assert len(kills) > 1


def test_replay_scale_grid_matches_serial_and_jax(tmp_path):
    tf = _write_trace(tmp_path, _basic_rows())
    tabs = {"replay": {"trace": tf, "scale": "$load", "capacity": 8}}
    groups = [("g", 0, 2, {})]
    scen = [{"seed": s, "params": {"load": str(v)}}
            for v in (1, 2) for s in (0, 3)]
    cfg = dict(quantum_ms=1.0, max_ticks=2_000, metrics_capacity=8,
               chunk_ticks=100)
    jres = j_sweep(_echo(jnp), groups, scen, tabs=tabs, **cfg).run()
    tex = t_sweep(_echo(torch), groups, scen, tabs=tabs, **cfg)
    assert tex._fault_plans is not None  # the recorded churn merged in
    tres = tex.run()
    for s in range(4):
        serial = t_serial(_echo(torch), groups, scen[s], tabs=tabs, **cfg)
        assert_scenario(jres, tres, s, serial)
    got = [int(tres.scenario(s).state["mem"]["got"].sum()) for s in range(4)]
    assert got[2] == 2 * got[0] > 0


def test_drained_scenario_dirs_byte_equal_to_jax(tmp_path):
    jplan, tplan = faultsdemo()
    scen = grid_scenarios([0, 7], [10, 90])
    tabs = _chaos_tabs(drain=True)
    cfg = dict(CHAOS_CFG, chunk_ticks=40)
    out = {}
    for pkg, build, plan, Drain in (("jax", j_sweep, jplan, JDrain),
                                    ("port", t_sweep, tplan, TDrain)):
        ex = build(plan, CHAOS_GROUPS, scen, "chaos", chunk=3, tabs=tabs,
                   **cfg)
        d = Drain(ex, trace_drain=True, telem_drain=True,
                  scenario_dir=lambda s, pkg=pkg: tmp_path / pkg / str(s),
                  skip_scenarios=(1,))
        res = ex.run(drain=d)
        for s in range(4):
            if s in d.skip_scenarios:
                continue
            d.finalize_scenario(s, res.scenario(s).state,
                                fault_plan=ex._fault_plans[s])
        out[pkg] = (d, res)
    (jd, jres), (td, tres) = out["jax"], out["port"]
    assert td.batches == jd.batches > 2
    assert td.stats() == jd.stats()
    for s in range(4):
        assert td.scenario_stats(s) == jd.scenario_stats(s)
        for f in (EVENTS_FILE, RESULTS_FILE, "trace.json"):
            j = tmp_path / "jax" / str(s) / f
            t = tmp_path / "port" / str(s) / f
            assert j.exists() == t.exists() == (s != 1), (s, f)
            if j.exists():
                assert t.read_bytes() == j.read_bytes(), (s, f)
        assert_scenario(jres, tres, s)
    assert td.snapshot() == jd.snapshot()

