"""[sweep] compositions through the port's runner against the JAX
package's, on the CPU: storm at 32 over 4 seeds in scenario chunks of 2
(its demuxed scenario directories, their rows and the roll-up, scenario
0 equal to a plain run of its seed), the memory pre-flight's chunk
ladder under a forced budget (the same with another executor pooled;
the card's free memory counted as if the pool were empty), the
metrics-ring shrink with the trace and telemetry tiers it picks
(faultsdemo at 4, traced and sampled), a drained sweep, a sweep preempted inside its second chunk and resumed
(equal to the uninterrupted run, leg by leg to the JAX runner's), and a
sweep prewarm followed by a pool hit with no build. Each pair writes the
same summary keys, run.out, scenario files and progress rows
(tests/_runner_parity.py)."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import json
import math
import tomllib
from pathlib import Path

import pytest
from _runner_parity import (
    REPO,
    NO_HEARTBEAT,
    PreemptAt,
    _env,
    assert_runs_equal,
    deterministic,
    output_files,
    rinputs,
    run_jax,
    run_out_lines,
    run_port,
    summary,
)

from testground_tpu.api import composition as jcomp
from testground_tpu.sim import runner as jrunner
from testground_tpu_torch import graft
from testground_tpu_torch.sim import runner as trunner
from testground_tpu_torch.sim import sweep as tsweep
from testground_tpu_torch.sim import tables as ttables

STORM_N = 32
STORM_RUN_CONFIG = dict(quantum_ms=10.0, max_ticks=100_000,
                        metrics_capacity=16, phase_gating=True)
SWEEP = dict(seeds=4, chunk=2, mesh=[1, 1])
KINDS = {"sweep": (jcomp.Sweep, ttables.Sweep),
         "faults": (jcomp.Faults, ttables.Faults),
         "trace": (jcomp.Trace, ttables.Trace),
         "telemetry": (jcomp.Telemetry, ttables.Telemetry)}
# the journal keys a resumed run adds or changes
RESUME_KEYS = ("checkpoint", "resume", "resumed_from_chunk",
               "resumed_from_tick", "compiles", "live")


def _tables(**dicts):
    """Each table dict as (JAX table, port table)."""
    return {k: (KINDS[k][0].from_dict(v), KINDS[k][1].from_dict(v))
            for k, v in dicts.items()}


def storm_params():
    """``__graft_entry__``'s compressed storm, its dial window and data
    cut further (600 ms, 8 KiB) so that a CPU run is short."""
    params = {k: str(v) for k, v in graft.STORM_PARAMS.items()}
    params.update(conn_delay_ms="600", data_size_kb="8")
    return params


def storm(tmp, name, run_id="sweep", sweep=SWEEP, run_config=None, **kw):
    return rinputs("benchmarks", "storm", [("single", STORM_N,
                                            storm_params())],
                   tmp / "jax" / name, tmp / "port" / name, run_id=run_id,
                   run_config=dict(STORM_RUN_CONFIG, **(run_config or {})),
                   **_tables(sweep=sweep), **kw)


def faultsdemo(tmp, name, seeds=2, drain=False, run_config=None):
    with open(REPO / "plans" / "faultsdemo" / "composition.toml", "rb") as f:
        comp = tomllib.load(f)
    p = {k: str(v) for k, v in comp["global"]["run"]["test_params"].items()}
    p["min_pings"] = "0"
    return rinputs(
        "faultsdemo", "chaos",
        [(g["id"], g["instances"]["count"], p) for g in comp["groups"]],
        tmp / "jax" / name, tmp / "port" / name,
        run_config=dict({"max_ticks": 2_000}, **(run_config or {})),
        **_tables(sweep={"seeds": seeds, "mesh": [1, 1]},
                  faults=comp["faults"],
                  trace=dict(comp["trace"], drain=drain),
                  telemetry=dict(comp["telemetry"], drain=drain)))


def scenario_rows(run_dir) -> list:
    """Every scenario's own sim_summary.json, by scenario."""
    root = Path(run_dir) / "scenario"
    return [json.loads((root / str(s) / "sim_summary.json").read_text())
            for s in sorted(int(p.name) for p in root.iterdir())]


def assert_sweeps_equal(jd, td) -> dict:
    """Both runners' sweep outputs equal: the roll-up, run.out, every
    scenario's files and rows, and the progress rows; every scenario's
    row equal to its own sim_summary.json."""
    s = assert_runs_equal(jd, td)
    rows = scenario_rows(td)
    assert rows == scenario_rows(jd) == s["scenarios"]
    return s


# ----------------------------------------------------------- the sweep


def test_storm_sweep_matches_jax_and_its_plain_runs(tmp_path):
    ri_j, ri_t = storm(tmp_path, "sweep")
    run_jax(ri_j)
    out = run_port(ri_t)
    s = assert_sweeps_equal(ri_j.run_dir, ri_t.run_dir)
    assert out.result.outcome == s["outcome"] == "success"
    assert s["scenario_chunk"] == 2 and len(s["scenarios"]) == 4
    assert s["mesh"] == {"scenario": 1, "instance": 1}
    assert s["sweep"]["seeds"] == 4 and s["compiles"] == 1
    assert [r["seed"] for r in s["scenarios"]] == [0, 1, 2, 3]
    assert sorted(out.result.outcomes) == [f"single[s{i}]" for i in range(4)]
    assert sorted(output_files(ri_t.run_dir)) == [
        f"scenario/{i}/results.out" for i in range(4)]
    # scenario 0 is the plain run of seed 0: its records and its row
    _, plain = rinputs("benchmarks", "storm",
                       [("single", STORM_N, storm_params())],
                       tmp_path / "unused", tmp_path / "plain",
                       run_config=STORM_RUN_CONFIG)
    run_port(plain)
    p = summary(plain.run_dir)
    row = s["scenarios"][0]
    assert (row["ticks"], row["outcomes"]) == (p["ticks"], p["outcomes"])
    # the plain run files its records per instance (up to 1,024)
    plain_lines = sorted(
        line for name, data in output_files(plain.run_dir).items()
        for line in data.decode().splitlines())
    scen = Path(ri_t.run_dir) / "scenario" / "0" / "results.out"
    assert sorted(scen.read_text().splitlines()) == plain_lines != []


def _one_scenario_bytes(ri_t, **table_kw):
    """The port's state model of one scenario of ``ri_t``'s sweep."""
    _, build_fn = trunner._load_build_fn(ri_t)
    ctx = trunner.build_context_from_input(ri_t)
    sweep = trunner._sweep_of(ri_t)
    _, rep = trunner._sweep_preflight(
        ri_t, build_fn, ctx, trunner._config(ri_t), sweep.expand(), "cpu",
        lambda m: None, explicit_chunk=1)
    return rep["state_model_bytes_per_device"]


def _budgets(admissible):
    """The TESTGROUND_HBM_BYTES each runner turns into ``admissible``
    bytes for a sweep's state."""
    return (str(math.ceil(admissible / jrunner._HBM_FRACTION)),
            str(math.ceil(admissible / tsweep.SWEEP_MEMORY_FRACTION)))


def _run_both(ri_j, ri_t, budgets):
    with _env(TESTGROUND_HBM_BYTES=budgets[0]):
        run_jax(ri_j)
    with _env(TESTGROUND_HBM_BYTES=budgets[1]):
        return run_port(ri_t)


def test_forced_budget_chunk_ladder_matches_jax(tmp_path):
    """A budget that holds 2 of the 4 scenarios: both pre-flights walk
    the ladder 4, 2 and run 2 chunks of 2."""
    ri_j, ri_t = storm(tmp_path, "ladder", sweep={"seeds": 4,
                                                  "mesh": [1, 1]})
    one = _one_scenario_bytes(ri_t)
    _run_both(ri_j, ri_t, _budgets(int(2.5 * one)))
    s = assert_sweeps_equal(ri_j.run_dir, ri_t.run_dir)
    hp = s["hbm_preflight"]
    assert s["scenario_chunk"] == hp["scenario_chunk"] == 2
    assert hp["state_model_bytes_per_device"] == 2 * one
    assert hp["metrics_capacity"] == 16 and s["outcome"] == "success"
    # a budget under one scenario, with the metrics capacity pinned:
    # both refuse
    tiny = _budgets(one // 2)
    with _env(TESTGROUND_HBM_BYTES=tiny[0]), pytest.raises(
            RuntimeError, match="cannot fit"):
        run_jax(ri_j)
    with _env(TESTGROUND_HBM_BYTES=tiny[1]), pytest.raises(
            RuntimeError, match="cannot fit"):
        run_port(ri_t)


def test_forced_budget_chunk_ignores_the_pool(tmp_path):
    """A sweep's pre-flight sizes its chunk as if the executor pool were
    empty: under the ladder's forced budget, with another sweep's
    executor pooled, it picks the chunk it picks with an empty pool."""
    _, ri_t = storm(tmp_path, "empty", sweep={"seeds": 4, "mesh": [1, 1]})
    _, ri_p = storm(tmp_path, "pooled", sweep={"seeds": 4, "mesh": [1, 1]})
    _, other = storm(tmp_path, "other", "other")
    budget = _budgets(int(2.5 * _one_scenario_bytes(ri_t)))[1]
    with _env(TESTGROUND_HBM_BYTES=budget):
        run_port(ri_t)
        trunner.clear_executor_pool()
        trunner.prewarm_composition(other, device="cpu")
        assert len(trunner._EX_CACHE) == 1
        run_port(ri_p, clear=False)
    a, b = summary(ri_t.run_dir), summary(ri_p.run_dir)
    assert a["scenario_chunk"] == b["scenario_chunk"] == 2
    assert (a["hbm_preflight"]["state_model_bytes_per_device"]
            == b["hbm_preflight"]["state_model_bytes_per_device"])
    assert run_out_lines(ri_p.run_dir) == run_out_lines(ri_t.run_dir)


def test_free_memory_counts_the_pool_back(monkeypatch):
    """On the card the sweep's budget is the free memory after the
    allocator's idle blocks are released, plus what the pool's
    executors hold (modeled), at most the card's total."""
    gib = 1 << 30
    freed = []
    monkeypatch.delenv("TESTGROUND_HBM_BYTES", raising=False)
    monkeypatch.setattr(trunner.torch.cuda, "empty_cache",
                        lambda: freed.append(True))
    monkeypatch.setattr(trunner.torch.cuda, "mem_get_info",
                        lambda dev: (30 * gib, 80 * gib))
    trunner.clear_executor_pool()
    try:
        assert trunner.device_hbm_bytes("cuda", free=True) == 30 * gib
        assert trunner.device_hbm_bytes("cuda") == 80 * gib
        held = int(6 * gib * trunner._HBM_FRACTION)  # models 6 GiB held
        trunner._executor_checkin(
            "a", None, {"state_model_bytes_per_device": held})
        assert trunner.device_hbm_bytes("cuda", free=True) == (
            30 * gib + trunner._held_bytes(
                {"state_model_bytes_per_device": held}))
        trunner._executor_checkin(
            "b", None, {"state_model_bytes_per_device": 80 * gib})
        assert trunner.device_hbm_bytes("cuda", free=True) == 80 * gib
        assert len(freed) == 3
        assert trunner.device_hbm_bytes("cpu", free=True) == 1 << 62
    finally:
        trunner.clear_executor_pool()


def test_metrics_shrink_and_observer_tiers_match_jax(tmp_path):
    """Even one scenario does not fit at the requested tiers: both
    pre-flights shrink the metrics ring, the trace ring and the
    telemetry interval to the same rungs and the same chunk, and the
    runs match."""
    ri_j, ri_t = faultsdemo(tmp_path, "shrink")
    full = _one_scenario_bytes(ri_t)
    _run_both(ri_j, ri_t, _budgets(full - 1_000))
    s = assert_sweeps_equal(ri_j.run_dir, ri_t.run_dir)
    hp = s["hbm_preflight"]
    # the shrink pass walks the chunk ladder again from the whole batch
    assert hp["state_model_bytes_per_device"] < full
    shrunk = [(hp[f"{k}_requested"], hp[k])
              for k in ("metrics_capacity", "trace_capacity",
                        "telemetry_interval")]
    assert any(a != b for a, b in shrunk), shrunk
    assert s["trace_events"] > 0 and s["telemetry_samples"] > 0
    assert sorted(output_files(ri_t.run_dir)) == [
        f"scenario/{i}/{f}" for i in range(2)
        for f in ("results.out", "trace.json")]


def test_drained_sweep_matches_jax(tmp_path):
    ri_j, ri_t = faultsdemo(tmp_path, "drained", drain=True,
                            run_config={"chunk_ticks": 50})
    run_jax(ri_j)
    run_port(ri_t)
    s = assert_sweeps_equal(ri_j.run_dir, ri_t.run_dir)
    assert s["drain"]["batches"] > 1 and s["trace_dropped"] == 0
    assert all(r["restarted_count"] == 1 for r in s["scenarios"])
    for i in range(2):
        assert (Path(ri_t.run_dir) / "scenario" / str(i) / "trace.jsonl"
                ).stat().st_size > 0


# ------------------------------------------------ preempt and resume

STOP_AT = 7  # inside the second scenario chunk (32-tick chunks)


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    """Both runners' three legs: uninterrupted, preempted at boundary
    ``STOP_AT`` (in scenario chunk 1), and its resume into the same
    directory."""
    tmp = tmp_path_factory.mktemp("sweep_resume")
    ck = {"checkpoint": ({"interval": 0.0}, {"interval": 0.0})}
    rc = {"chunk_ticks": 32}
    full = storm(tmp, "full", "full", run_config=rc, **ck)
    pre = storm(tmp, "pre", "pre", run_config=rc, **ck)
    res = storm(tmp, "pre", "pre", run_config=rc, resume=True, **ck)
    out = {}
    for side, run, runner in ((0, run_jax, jrunner), (1, run_port, trunner)):
        run(full[side])
        with PreemptAt(runner, STOP_AT):
            b = run(pre[side], clear=False)
        mid = {"summary": summary(pre[side].run_dir),
               "outcome": b.result.outcome,
               "files": sorted(p.name for p in (
                   Path(pre[side].run_dir) / "checkpoint").iterdir())}
        c = run(res[side], clear=False)
        out[side] = {"full": full[side].run_dir, "pre": mid,
                     "resumed": res[side].run_dir,
                     "outcome": c.result.outcome}
    return out


def test_preempted_sweep_matches_jax(legs):
    j, t = legs[0]["pre"], legs[1]["pre"]
    assert t["outcome"] == j["outcome"] == "preempted"
    s = t["summary"]
    assert s["preempted"] and s["resume_token"] == "pre"
    # stopped inside chunk 1: chunk 0 demuxed, its final saved
    assert s["scenarios_demuxed"] == 4
    assert "chunkfinal-0.pkl" in t["files"]
    assert (deterministic(s, legs[1]["resumed"])
            == deterministic(j["summary"], legs[0]["resumed"]))


def test_resumed_sweep_matches_jax(legs):
    assert legs[1]["outcome"] == legs[0]["outcome"] == "success"
    s = assert_sweeps_equal(legs[0]["resumed"], legs[1]["resumed"])
    assert s["resumed_from_chunk"] == 1 and s["compiles"] == 0


def test_resumed_sweep_equals_the_uninterrupted_one(legs):
    full, resumed = legs[1]["full"], legs[1]["resumed"]
    a, b = deterministic(summary(full), full), deterministic(
        summary(resumed), resumed)
    for d in (a, b):
        for k in RESUME_KEYS:
            d.pop(k, None)
        d["hbm_preflight"].pop("executor_cache")
    assert b == a
    assert run_out_lines(resumed) == run_out_lines(full)
    assert scenario_rows(resumed) == scenario_rows(full)
    files = output_files(full)
    assert len(files) == 4 and output_files(resumed) == files


# ------------------------------------------------------- the pool


def test_sweep_prewarm_then_pool_hit(tmp_path):
    """A sweep's prewarm builds its executor into the pool; the run that
    follows builds nothing (memory_hit, compiles 0, no new build of the
    batched tick) and writes what a fresh run writes."""
    ri_j, ri_t = storm(tmp_path, "fresh")
    run_jax(ri_j)
    _, warm = storm(tmp_path, "warm", "warm")
    trunner.clear_executor_pool()
    pre = trunner.prewarm_composition(warm, device="cpu")
    assert pre.result.journal["executor_cache"] == "miss"
    assert pre.result.journal["hbm_preflight"]["scenario_chunk"] == 2
    builds = tsweep.chunk_compiles()
    with _env(**NO_HEARTBEAT):
        trunner.run_composition(warm, device="cpu")
    assert tsweep.chunk_compiles() == builds
    s = summary(warm.run_dir)
    assert s["hbm_preflight"]["executor_cache"] == "memory_hit"
    assert s["compiles"] == 0
    a = deterministic(s, warm.run_dir)
    b = deterministic(summary(ri_j.run_dir), ri_j.run_dir)
    for d in (a, b):
        d.pop("compiles")
        d["hbm_preflight"].pop("executor_cache")
    assert a == b
    assert output_files(warm.run_dir) == output_files(ri_j.run_dir)
    # a second prewarm finds it pooled
    again = trunner.prewarm_composition(warm, device="cpu")
    assert again.result.journal["executor_cache"] == "memory_hit"
