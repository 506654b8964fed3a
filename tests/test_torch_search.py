"""The search plane of the port (testground_tpu_torch/sim/search.py)
against the JAX package's (testground_tpu/sim/search.py) on the CPU: each
driver (bisect, halving, coverage) gives JAX's rounds, probes, frontier
and verdict on the same outcomes; objective_value and the [search] table
match JAX's; a bisect of the benchmarks plan's cliff at a small N gives
JAX's verdict and rounds with one build of the batched tick; and a
fault-severity search rebinds the same sweep executable round after
round, each round's scenarios bit-equal to the JAX search's."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import math

import pytest
from _storm_parity import jax_plan, torch_plan
from test_torch_sweep import assert_leaves_equal, j_sweep, t_sweep
from test_torch_sweep_planes import CHAOS_CFG, _chaos_tabs
from test_torch_trace import CHAOS_GROUPS, faultsdemo

from testground_tpu.api import composition as jcomp
from testground_tpu.sim import search as jsearch
from testground_tpu.sim import sweep as jsweep
from testground_tpu.sim.context import GroupSpec as JGroup
from testground_tpu_torch.bench import search_leg
from testground_tpu_torch.sim import GroupSpec as TGroup
from testground_tpu_torch.sim import search as tsearch
from testground_tpu_torch.sim import sweep as tsweep
from testground_tpu_torch.sim import tables


def outcome_of(p):
    """A synthetic, seed-dependent severity response: fails above a
    seed-shifted edge, objective rising with the value."""
    v = float(p.value)
    p.failed = v > 0.37 + 0.01 * (p.seed % 3)
    p.outcome = "failure" if p.failed else "success"
    p.objective = v * (1 + p.seed % 5) / 3.0 + (0.5 if p.failed else 0.0)


def drive(mod, spec):
    driver = mod.make_driver(dict(spec))

    def evaluate(r, batch):
        assert len(batch) == driver.width
        for p in batch:
            if not p.pad:
                outcome_of(p)

    verdict = mod.run_search_loop(driver, evaluate)
    return (verdict, driver.rounds, driver.frontier(),
            driver.scenarios_probed, driver.stopped)


SPECS = [
    {"param": "x", "lo": 0.0, "hi": 1.0, "step": 0.01, "width": 4},
    {"param": "x", "lo": 0.0, "hi": 1.0, "step": 0.01, "width": 1},
    {"param": "x", "lo": 0.0, "hi": 1.0, "step": 0.01, "width": 6,
     "seeds": 3, "tolerance": 0.05},
    {"param": "x", "values": [0.9, 0.1, 0.5, 0.3, 0.45], "width": 2},
    {"param": "x", "lo": 0, "hi": 40, "step": 1, "width": 8,
     "max_rounds": 2},
    {"param": "x", "lo": 0.0, "hi": 1.0, "step": 0.1, "width": 4,
     "strategy": "halving"},
    {"param": "x", "lo": 0.0, "hi": 1.0, "step": 0.05, "width": 5,
     "strategy": "halving", "goal": "max", "seeds": 2, "seed_base": 3},
    {"param": "x", "lo": 0.0, "hi": 1.0, "step": 0.05, "width": 3,
     "strategy": "coverage", "seed_base": 11},
    {"param": "x", "lo": 0.0, "hi": 1.0, "step": 0.05, "width": 4,
     "strategy": "coverage", "budget": 7, "seeds": 2},
]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.get("strategy",
                                                            "bisect"))
def test_drivers_match_jax(spec):
    assert drive(tsearch, spec) == drive(jsearch, spec)


def test_non_monotone_bisect_matches_jax():
    spec = {"param": "x", "lo": 0, "hi": 20, "step": 1, "width": 3}

    def run(mod):
        driver = mod.make_driver(dict(spec))

        def evaluate(r, batch):
            for p in batch:
                p.failed = p.value in (4, 10, 19)
                p.objective = float(p.failed)

        return mod.run_search_loop(driver, evaluate), driver.rounds

    assert run(tsearch) == run(jsearch)


def test_probes_and_objectives_match_jax():
    probes = [tsearch.Probe(value=v, seed=s, index=i)
              for i, (v, s) in enumerate([(1, 0), (0.5, 2), ("3", 1)])]
    jprobes = [jsearch.Probe(value=p.value, seed=p.seed, index=p.index)
               for p in probes]
    assert (tsearch.probe_scenarios(probes, "x")
            == jsearch.probe_scenarios(jprobes, "x"))
    assert [p.record() for p in probes] == [p.record() for p in jprobes]
    row = {"outcome": "failure", "ticks": 7, "net_dropped": True,
           "skip_ratio": "n/a", "crashed_count": None}
    recs = [{"name": "telemetry.net_drops", "value": v}
            for v in (3, 1, 4, 1, 5, 9, 2, 6)]
    for name in ("outcome", "ticks", "net_dropped", "skip_ratio",
                 "crashed_count", "restarted_count"):
        assert (tsearch.objective_value(name, row)
                == jsearch.objective_value(name, row))
    for stat in jcomp.SEARCH_TELEMETRY_STATS:
        for name in (f"telemetry:net_drops:{stat}",
                     f"telemetry:live_lanes:{stat}"):
            assert (tsearch.objective_value(name, row, recs)
                    == jsearch.objective_value(name, row, recs))


@pytest.mark.parametrize("d", [
    {"param": "x", "lo": 0.0, "hi": 1.0, "step": 0.25},
    {"param": "x", "lo": 0, "hi": 10, "step": 2, "strategy": "halving",
     "objective": "ticks", "goal": "max", "width": 3},
    {"param": "x", "values": [3, 1.5, 3.0, 2], "strategy": "coverage"},
    {"param": "x", "lo": 0.0, "hi": 1.0, "tolerance": 0.3},
    {"param": ""},
    {"param": "x", "strategy": "bisekt", "lo": 0, "hi": 1, "step": 0.5},
    {"param": "x", "objective": "tiks", "lo": 0, "hi": 1, "step": 0.5},
    {"param": "x", "objective": "telemetry:net_drop:max", "lo": 0,
     "hi": 1, "step": 0.5},
    {"param": "x", "objective": "telemetry:net_drops:p42", "lo": 0,
     "hi": 1, "step": 0.5},
    {"param": "x", "objective": "telemetry:net_drops", "lo": 0, "hi": 1,
     "step": 0.5},
    {"param": "x", "goal": "up", "lo": 0, "hi": 1, "step": 0.5},
    {"param": "x", "width": 0, "lo": 0, "hi": 1, "step": 0.5},
    {"param": "x", "width": 5000, "lo": 0, "hi": 1, "step": 0.5},
    {"param": "x", "seeds": 9, "width": 8, "lo": 0, "hi": 1, "step": 0.5},
    {"param": "x", "lo": 1, "hi": 0, "step": 0.5},
    {"param": "x", "lo": 0, "hi": 1},
    {"param": "x", "values": [1, "a"]},
    {"param": "x", "values": [1]},
    {"param": "x", "lo": 0, "hi": 1, "step": 1e-6},
    {"param": "x", "lo": 0, "hi": 1, "step": 0.5, "budget": -1},
    {"param": "x", "lo": 0, "hi": 1, "step": 0.5, "wdith": 3},
])
def test_search_table_matches_jax(d):
    def run(mod):
        s = mod.Search.from_dict(d)
        s.validate()
        return s.grid_values(), s.to_dict()

    try:
        want = run(jcomp)
    except jcomp.CompositionError as e:
        with pytest.raises(tables.CompositionError) as te:
            run(tables)
        assert str(te.value) == str(e)
        return
    assert run(tables) == want
    assert tables.SEARCH_STRATEGIES == jcomp.SEARCH_STRATEGIES
    assert tables.SEARCH_COUNTERS == jcomp.SEARCH_COUNTERS


def cliff_search(pkg, n=8, grid_n=64, width=8, cliff_at=0.663):
    """search_main's bisect of cliff's edge at ``n`` through one package;
    returns (verdict, rounds, batched-tick builds)."""
    if pkg == "jax":
        mod, sw, plan, Group = jsearch, jsweep, jax_plan("cliff"), JGroup
        from testground_tpu.sim import SimConfig
        kw = {"mesh_shape": [1, 1]}
    else:
        mod, sw, plan, Group = tsearch, tsweep, torch_plan("cliff"), TGroup
        from testground_tpu_torch.sim import SimConfig
        kw = {"device": "cpu"}
    groups = [Group("single", 0, n, {"x_fail": str(cliff_at)})]
    cfg = SimConfig(quantum_ms=10.0, max_ticks=10_000, chunk_ticks=64,
                    metrics_capacity=8)
    driver = mod.make_driver({"param": "x", "lo": 0.0, "hi": 1.0,
                              "step": 1.0 / grid_n, "width": width})
    builds0 = sw.chunk_compiles()
    batch0 = driver.next_batch()
    ex = sw.compile_sweep(plan, groups, cfg,
                          mod.probe_scenarios(batch0, "x"),
                          test_case="cliff", test_run="s", **kw)
    rb = mod.SearchRebinder(ex, None, plan, groups, ex.config,
                            test_case="cliff")

    def evaluate(r, batch):
        if r > 0:
            rb.rebind(mod.probe_scenarios(batch, "x"))
        res = ex.run()
        for p in batch:
            if p.pad:
                continue
            oc = res.scenario(p.scenario).outcomes()
            ok = all(o[0] == o[1] for o in oc.values())
            p.outcome = "success" if ok else "failure"
            p.failed = not ok
            p.objective = 0.0 if ok else 1.0

    verdict = mod.run_search_loop(driver, evaluate, first_batch=batch0)
    return verdict, driver.rounds, sw.chunk_compiles() - builds0


def test_cliff_bisect_matches_jax_with_one_build():
    t, j = cliff_search("port"), cliff_search("jax")
    assert t == j
    verdict, rounds, builds = t
    assert builds == 1
    assert len(rounds) <= math.ceil(math.log2(65)) + 1
    assert verdict["first_failing"] == 0.671875
    assert verdict["last_passing"] == 0.65625


def test_bench_search_leg_on_the_cpu():
    line = search_leg(n=8, device="cpu", grid_n=64)
    assert line["batched_tick_builds"] == 1 and line["captures"] == 0
    assert line["breaking_point"] == 0.671875
    assert line["rounds"] <= line["round_bound"]


def test_fault_severity_search_rebinds_one_executable():
    """A coverage search over the degrade window's ``$loss`` on
    faultsdemo's chaos case (width 2, 2 rounds): every round rebinds the
    same sweep executable with that round's fault plans, and each
    round's scenarios equal the JAX search's on every leaf."""
    jplan, tplan = faultsdemo()
    tabs = _chaos_tabs()
    spec = {"param": "loss", "values": [10, 50, 90, 70], "width": 2,
            "strategy": "coverage", "max_rounds": 2}
    states = {}
    for pkg, mod, build, plan, sw, Group in (
            ("jax", jsearch, j_sweep, jplan, jsweep, JGroup),
            ("port", tsearch, t_sweep, tplan, tsweep, TGroup)):
        driver = mod.make_driver(spec)
        batch0 = driver.next_batch()
        ex = build(plan, CHAOS_GROUPS, mod.probe_scenarios(batch0, "loss"),
                   "chaos", tabs=tabs, **CHAOS_CFG)
        builds0 = sw.chunk_compiles()
        groups = [Group(*g) for g in CHAOS_GROUPS]
        rb = mod.SearchRebinder(ex, tabs["faults"], plan, groups,
                                ex.config, test_case="chaos")
        got = []

        def evaluate(r, batch, mod=mod, ex=ex, rb=rb, got=got):
            if r > 0:
                rb.rebind(mod.probe_scenarios(batch, "loss"))
            res = ex.run()
            got.append([res.scenario(p.scenario).state for p in batch])
            for p in batch:
                p.failed = False

        mod.run_search_loop(driver, evaluate, first_batch=batch0)
        assert sw.chunk_compiles() - builds0 == 1
        states[pkg] = got
    assert len(states["port"]) == len(states["jax"]) == 2
    for jr, tr in zip(states["jax"], states["port"]):
        for js, ts in zip(jr, tr):
            assert_leaves_equal(js, ts)
