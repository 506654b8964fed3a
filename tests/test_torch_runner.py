"""The port's runner (testground_tpu_torch/sim/runner.py) against the JAX
package's ``run_composition``, on the CPU: the placebo plan's cases at 3
instances (the per-instance results layout) and its metrics case at
1,025 (the combined layout), storm at 64 with ``__graft_entry__``'s
compressed params and bench.py's SimConfig, a terminated run, and the
executor pool (hit, miss, an edited plan, prewarm, eviction to fit a
memory budget), and the registered SimTorchRunner. Each pair writes the
same summary keys, run.out, results.out files and progress rows
(tests/_runner_parity.py)."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import shutil

import pytest
from _runner_parity import (
    REPO,
    assert_runs_equal,
    output_files,
    rinputs,
    run_jax,
    run_pair,
    run_port,
    summary,
)

from testground_tpu.sim import core as jcore
from testground_tpu.sim import program as jprogram
from testground_tpu.sim import runner as jrunner
from testground_tpu_torch import graft
from testground_tpu_torch.api.contracts import RunGroup, RunInput
from testground_tpu_torch.plans import placebo as tplacebo
from testground_tpu_torch.runner.outputs import BUDGET_KEYS
from testground_tpu_torch.sim import core as tcore
from testground_tpu_torch.sim import runner as trunner
from testground_tpu_torch.sim import tables

STORM_RUN_CONFIG = dict(quantum_ms=10.0, max_ticks=100_000,
                        metrics_capacity=16, phase_gating=True)


@pytest.mark.parametrize("case,run_config", [
    ("ok", None), ("panic", None), ("stall", {"max_ticks": 200}),
    ("metrics", None),
])
def test_placebo_3_matches_jax(tmp_path, case, run_config):
    (jo, jd), (to, td) = run_pair("placebo", case, [("single", 3, {})],
                                  tmp_path, run_config=run_config)
    s = assert_runs_equal(jd, td)
    assert to.result.outcome == jo.result.outcome
    assert s["outcome"] == ("success" if case in ("ok", "metrics")
                            else "failure")
    assert s["mesh"] == {"instance": 1}
    # the per-instance layout: one results.out a group member
    files = output_files(td)
    assert sorted(files) == [f"single/{i}/results.out" for i in range(3)]
    if case == "stall":
        assert s["timed_out"] and s["stalled_count"] == 3


def test_placebo_metrics_1025_combined_layout(tmp_path):
    (_, jd), (_, td) = run_pair("placebo", "metrics",
                                [("single", 1_025, {})], tmp_path)
    s = assert_runs_equal(jd, td)
    assert s["outcome"] == "success"
    assert list(output_files(td)) == ["results.out"]
    assert not (td / "single").exists()


def test_storm_64_matches_jax(tmp_path):
    params = {k: str(v) for k, v in graft.STORM_PARAMS.items()}
    (_, jd), (_, td) = run_pair("benchmarks", "storm",
                                [("single", 64, params)], tmp_path,
                                run_config=STORM_RUN_CONFIG)
    s = assert_runs_equal(jd, td)
    assert s["outcome"] == "success" and s["ticks"] > 0
    # the chunk is the JAX runner's watchdog tier at 64 instances
    assert s["hbm_preflight"]["state_model_bytes_per_device"] > 0
    assert "fail_if: dial failed\n" in (td / "run.out").read_text()


def test_terminated_run_matches_jax(tmp_path):
    ri_j, ri_t = rinputs("placebo", "stall", [("single", 3, {})],
                         tmp_path / "jax", tmp_path / "port",
                         run_id="killed",
                         run_config={"max_ticks": 5_000, "chunk_ticks": 100,
                                     "event_skip": False})
    jrunner.request_terminate("killed")
    run_jax(ri_j)
    trunner.request_terminate("killed")
    out = run_port(ri_t)
    s = assert_runs_equal(tmp_path / "jax", tmp_path / "port")
    assert out.result.outcome == s["outcome"] == "terminated"
    assert s["terminated"] is True and s["ticks"] == 100


def test_executor_pieces_match_jax():
    for n in (1, 64, 100_000, 100_001, 300_001, 3_000_001, 10_000_000):
        for scale in (1.0, 3.6, 8.0):
            assert (tcore.watchdog_chunk_ticks(n, scale)
                    == jcore.watchdog_chunk_ticks(n, scale))
    # the plan's static strings in build order: log and fail_if
    from testground_tpu.sim import BuildContext as JCtx
    from testground_tpu.sim.context import GroupSpec as JGroup
    from testground_tpu_torch.sim import BuildContext as TCtx
    from testground_tpu_torch.sim import GroupSpec as TGroup
    from testground_tpu_torch.sim.program import ProgramBuilder

    params = {k: str(v) for k, v in graft.STORM_PARAMS.items()}
    jb = jprogram.ProgramBuilder(JCtx([JGroup("single", 0, 4, params)]))
    tb = ProgramBuilder(TCtx([TGroup("single", 0, 4, params)]))
    from _storm_parity import jax_plan, torch_plan

    jax_plan()(jb)
    torch_plan()(tb)
    assert tb.build().messages == jb.build().messages != []


def _port_rinput(run_dir, run_id="pool", **kw):
    return RunInput(
        run_id=run_id, env_config=None, run_dir=str(run_dir),
        test_plan="placebo", test_case="metrics", total_instances=3,
        groups=[RunGroup(id="single", instances=3,
                         artifact_path=str(REPO / "plans" / "placebo"))],
        **kw)


def test_pool_hit_matches_jax(tmp_path):
    """A repeat run reuses the pooled executor: memory_hit, compiles 0,
    the cached pre-flight report, and the same outputs; the JAX runner's
    repeat run journals the same."""
    first = rinputs("placebo", "metrics", [("single", 3, {})],
                    tmp_path / "j1", tmp_path / "t1")
    second = rinputs("placebo", "metrics", [("single", 3, {})],
                     tmp_path / "j2", tmp_path / "t2")
    run_jax(first[0])
    run_jax(second[0], clear=False)
    run_port(first[1])
    (pooled, _), = trunner._EX_CACHE.values()
    run_port(second[1], clear=False)
    s = assert_runs_equal(tmp_path / "j2", tmp_path / "t2")
    assert s["hbm_preflight"]["executor_cache"] == "memory_hit"
    assert s["compiles"] == 0 and s["compile_breakdown"] is None
    assert "metrics_capacity" in s["hbm_preflight"]
    assert output_files(tmp_path / "t2") == output_files(tmp_path / "t1")
    # the same executor came back to the pool
    assert [ex for ex, _ in trunner._EX_CACHE.values()] == [pooled]


def test_pool_misses_on_config_change_and_plan_edit(tmp_path, monkeypatch):
    trunner.clear_executor_pool()
    runs = iter(range(100))

    def run(**kw):
        out = trunner.run_composition(
            _port_rinput(tmp_path / str(next(runs)), **kw), device="cpu")
        return out.result.journal["hbm_preflight"]["executor_cache"]

    assert run() == "miss"
    assert run() == "memory_hit"
    # a runtime field (max_ticks) is patched into the pooled executor
    assert run(run_config={"max_ticks": 500}) == "memory_hit"
    # a config field that shapes the program misses
    assert run(run_config={"metrics_capacity": 13}) == "miss"
    assert run() == "memory_hit"
    # an edited plan misses: the key hashes the plan module's source
    edited = tmp_path / "placebo_edited.py"
    shutil.copy(tplacebo.__file__, edited)
    edited.write_text(edited.read_text() + "\nEDIT_MARKER = 1\n")
    monkeypatch.setattr(tplacebo, "__file__", str(edited))
    assert run() == "miss"
    assert len(trunner._EX_CACHE) == 3


def test_prewarm_then_run_is_a_memory_hit(tmp_path):
    trunner.clear_executor_pool()
    pre = trunner.prewarm_composition(_port_rinput(tmp_path / "pre"),
                                      device="cpu")
    assert pre.result.journal["executor_cache"] == "miss"
    assert pre.result.journal["compiles"] == 1
    assert not (tmp_path / "pre").exists()  # nothing dispatched
    again = trunner.prewarm_composition(_port_rinput(tmp_path / "pre"),
                                        device="cpu")
    assert again.result.journal["executor_cache"] == "memory_hit"
    out = trunner.run_composition(_port_rinput(tmp_path / "run"),
                                  device="cpu")
    j = out.result.journal
    assert j["hbm_preflight"]["executor_cache"] == "memory_hit"
    assert j["compiles"] == 0 and out.result.outcome == "success"
    trunner.clear_executor_pool()
    cold = trunner.run_composition(_port_rinput(tmp_path / "cold"),
                                   device="cpu")
    assert cold.result.journal["compiles"] == 1
    assert output_files(tmp_path / "run") == output_files(tmp_path / "cold")


def test_pool_evicts_what_does_not_fit_beside_a_new_program(tmp_path,
                                                          monkeypatch):
    """A pooled executor holds its state and capture on the card. Under a
    budget that the pool and a new program's executor do not fit
    together, the new program's run evicts the pool before it builds;
    its pre-flight sizes it against the whole budget, so it runs at the
    tiers, and writes the outputs, it has with the pool empty."""
    other = {"run_config": {"metrics_capacity": 13}}
    trunner.clear_executor_pool()
    cold = trunner.run_composition(
        _port_rinput(tmp_path / "cold", **other), device="cpu")
    trunner.clear_executor_pool()
    first = trunner.run_composition(_port_rinput(tmp_path / "first"),
                                    device="cpu")
    held = [trunner._held_bytes(o.result.journal["hbm_preflight"])
            for o in (first, cold)]
    monkeypatch.setenv("TESTGROUND_HBM_BYTES", str(sum(held) - 1))
    out = trunner.run_composition(
        _port_rinput(tmp_path / "evicting", **other), device="cpu")
    rep = out.result.journal["hbm_preflight"]
    assert rep["executor_cache"] == "evicted"
    assert rep["hbm_budget_bytes"] == sum(held) - 1

    def tiers(r):
        return {k: v for k, v in r.items()
                if k not in BUDGET_KEYS + ("executor_cache",)}

    assert tiers(rep) == tiers(cold.result.journal["hbm_preflight"])
    assert output_files(tmp_path / "evicting") == output_files(
        tmp_path / "cold")
    assert len(trunner._EX_CACHE) == 1  # the new program alone
    # where both fit, the first program pools beside it again
    monkeypatch.setenv("TESTGROUND_HBM_BYTES", str(sum(held)))
    again = trunner.run_composition(_port_rinput(tmp_path / "again"),
                                    device="cpu")
    assert again.result.journal["hbm_preflight"]["executor_cache"] == "miss"
    assert len(trunner._EX_CACHE) == 2
    # a prewarm makes room as a run does: a third program, a little
    # larger than the second, fits beside neither
    monkeypatch.setenv("TESTGROUND_HBM_BYTES", str(sum(held) - 1))
    trunner.prewarm_composition(
        _port_rinput(tmp_path / "pre", run_config={"metrics_capacity": 14}),
        device="cpu")
    assert len(trunner._EX_CACHE) == 1
    trunner.clear_executor_pool()


def test_sim_torch_runner_runs_prewarms_terminates_and_collects(tmp_path):
    """The runner the repo's compositions name (``sim:jax``) from the
    registry: prewarm fills the pool and run hits it, terminate_run stops
    a run at its first boundary, collect_outputs tars the run's tree."""
    import io
    import tarfile

    from testground_tpu_torch.runner import SimTorchRunner, get_runner

    r = get_runner("sim:jax")
    assert isinstance(r, SimTorchRunner)
    with pytest.raises(ValueError, match="unknown runner: local:exec"):
        get_runner("local:exec")
    trunner.clear_executor_pool()
    pre = r.prewarm(_port_rinput(tmp_path / "pre"), device="cpu")
    assert pre.result.journal["executor_cache"] == "miss"
    out = r.run(_port_rinput(tmp_path / "run"), device="cpu")
    assert out.result.outcome == "success"
    assert out.result.journal["hbm_preflight"]["executor_cache"] == (
        "memory_hit")
    stall = _port_rinput(tmp_path / "stopped", run_id="stopped",
                         run_config={"max_ticks": 5_000, "chunk_ticks": 100,
                                     "event_skip": False})
    stall.test_case = "stall"
    r.terminate_run("stopped")
    stopped = r.run(stall, device="cpu")
    assert stopped.result.outcome == "terminated"
    assert summary(tmp_path / "stopped")["ticks"] == 100
    buf = io.BytesIO()
    r.collect_outputs(str(tmp_path / "run"), buf)
    with tarfile.open(fileobj=io.BytesIO(buf.getvalue()), mode="r:gz") as tf:
        names = tf.getnames()
    assert {"run/sim_summary.json", "run/run.out",
            "run/single/0/results.out"} <= set(names)
    trunner.clear_executor_pool()


def test_plan_the_port_lacks_raises(tmp_path):
    plan_dir = tmp_path / "myplan"
    plan_dir.mkdir()
    (plan_dir / "manifest.toml").write_text('name = "myplan"\n')
    (plan_dir / "sim.py").write_text("import testground_tpu\n")
    ri = RunInput(run_id="x", env_config=None, run_dir=str(tmp_path / "r"),
                  test_plan="myplan", test_case="ok", total_instances=1,
                  groups=[RunGroup(id="g", instances=1,
                                   artifact_path=str(plan_dir))])
    with pytest.raises(ValueError, match="'myplan' has no port"):
        trunner.run_composition(ri, device="cpu")
    ri = _port_rinput(tmp_path / "r2")
    ri.test_case = "nosuch"
    with pytest.raises(KeyError, match="no test case 'nosuch'"):
        trunner.run_composition(ri, device="cpu")


def test_sweep_and_search_compositions_are_not_ported_yet(tmp_path):
    """Once refused as not ported, a [sweep] and a [search] composition
    now take their batched paths (tests/test_torch_runner_sweep.py and
    tests/test_torch_runner_search.py hold them against the JAX
    runner): a sweep demuxes its scenarios, a search over a param the
    plan does not expose is refused as compile_sweep refuses it."""
    sweep = _port_rinput(tmp_path / "s", sweep=tables.Sweep(seeds=2))
    out = trunner.run_composition(sweep, device="cpu")
    s = summary(tmp_path / "s")
    assert out.result.outcome == s["outcome"] == "success"
    assert [r["seed"] for r in s["scenarios"]] == [0, 1]
    assert (tmp_path / "s" / "scenario" / "1" / "results.out").exists()
    search = _port_rinput(tmp_path / "q", search={
        "param": "x", "lo": 0, "hi": 4, "step": 1, "objective": "outcome"})
    with pytest.raises(ValueError, match=r"grid over \['x'\] is impossible"):
        trunner.run_composition(search, device="cpu")
    # a disabled [search] runs the plain path and journals the mark
    off = _port_rinput(tmp_path / "o", search={
        "enabled": False, "param": "x", "lo": 0, "hi": 4, "step": 1,
        "objective": "outcome"})
    out = trunner.run_composition(off, device="cpu")
    assert out.result.journal["search"] == "disabled"
    assert summary(tmp_path / "o")["search"] == "disabled"


def test_the_card_is_the_default(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        trunner.run_composition(_port_rinput(tmp_path / "r"))


def test_metrics_lines_are_the_records_json_dumps(tmp_path):
    """``SimResult.metrics_lines`` (the runner's results.out writer) is
    ``json.dumps`` of each of ``metrics_records``, the floats JSON
    cannot spell as Python does (NaN, infinities) and an id past the
    metric names included."""
    import json

    import torch

    from testground_tpu_torch.sim import BuildContext, GroupSpec
    from testground_tpu_torch.sim.core import SimConfig, compile_program

    ctx = BuildContext([GroupSpec("single", 0, 3, {})], test_case="metrics")
    res = compile_program(tplacebo.testcases["metrics"], ctx,
                          SimConfig(max_ticks=200), device="cpu").run()
    assert res.metrics_records()
    buf, cnt = res.state["metrics_buf"], res.state["metrics_cnt"]
    buf[0, 0, 2] = float("nan")
    buf[1, 0, 2] = float("inf")
    buf[2, 0, 2] = -float("inf")
    buf[2, 0, 0] = 99  # no such metric: named by its id
    buf[1, 0, 1] = 12_345.0
    assert torch.all(cnt > 0)
    recs = res.metrics_records()
    assert res.metrics_lines() == [json.dumps(r) + "\n" for r in recs]
    assert any(r["name"] == "99" for r in recs)
