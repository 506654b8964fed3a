"""[search] compositions through the port's runner against the JAX
package's, on the CPU: cliff's edge by bisection, faultsdemo at 4 with
its composition's own [search] table enabled (the telemetry objective),
a disabled [search] that runs the plain path, and a search preempted
after its first round and resumed from its checkpointed driver (equal to
the uninterrupted search, leg by leg to the JAX runner's), then resumed
once more after it resolved (a fresh replay). Each pair writes the same
roll-up, run.out, per-round probe files and progress rows
(tests/_runner_parity.py). The JAX sweep plane sees one device, as the
port runs on one card."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import json
import tomllib
from pathlib import Path

import pytest
from _runner_parity import (
    REPO,
    assert_runs_equal,
    deterministic,
    jax_sees_one_device,
    output_files,
    rinputs,
    run_jax,
    run_out_lines,
    run_port,
    summary,
)

from testground_tpu.api import composition as jcomp
from testground_tpu.sim import runner as jrunner
from testground_tpu_torch.sim import runner as trunner
from testground_tpu_torch.sim import tables as ttables

KINDS = {"search": (jcomp.Search, ttables.Search),
         "faults": (jcomp.Faults, ttables.Faults),
         "trace": (jcomp.Trace, ttables.Trace),
         "telemetry": (jcomp.Telemetry, ttables.Telemetry)}
CLIFF_AT = "0.663"
CLIFF_SEARCH = {"param": "x", "lo": 0.0, "hi": 1.0, "step": 1.0 / 16,
                "width": 4}
# the journal keys a resumed search adds or changes
RESUME_KEYS = ("checkpoint", "resume", "resumed_from_round", "compiles",
               "live")


def _tables(**dicts):
    return {k: (KINDS[k][0].from_dict(v), KINDS[k][1].from_dict(v))
            for k, v in dicts.items()}


def jax_run(ri, clear=True):
    with jax_sees_one_device():
        return run_jax(ri, clear=clear)


def cliff(tmp, name, search=CLIFF_SEARCH, run_id="search"):
    return rinputs("benchmarks", "cliff", [("single", 16,
                                            {"x_fail": CLIFF_AT})],
                   tmp / "jax" / name, tmp / "port" / name, run_id=run_id,
                   run_config={"quantum_ms": 10.0, "max_ticks": 10_000,
                               "metrics_capacity": 8},
                   **_tables(search=search))


def faultsdemo(tmp, name, run_id="search", enabled=True, chunk_ticks=None,
               **kw):
    """faultsdemo's composition at its 4 instances with its [faults],
    [trace], [telemetry] and [search] tables, the search enabled."""
    with open(REPO / "plans" / "faultsdemo" / "composition.toml", "rb") as f:
        comp = tomllib.load(f)
    p = {k: str(v) for k, v in comp["global"]["run"]["test_params"].items()}
    p["min_pings"] = "0"
    return rinputs(
        "faultsdemo", "chaos",
        [(g["id"], g["instances"]["count"], p) for g in comp["groups"]],
        tmp / "jax" / name, tmp / "port" / name, run_id=run_id,
        run_config=dict({"max_ticks": 2_000},
                        **({"chunk_ticks": chunk_ticks} if chunk_ticks
                           else {})),
        **_tables(faults=comp["faults"], trace=comp["trace"],
                  telemetry=comp["telemetry"],
                  search=dict(comp["search"], enabled=enabled)), **kw)


def probe_files(run_dir) -> list:
    return sorted(str(p.relative_to(run_dir))
                  for p in Path(run_dir).rglob("*") if p.is_file()
                  and p.parts[len(Path(run_dir).parts)] == "round")


def assert_searches_equal(jd, td) -> dict:
    """The roll-up, run.out, progress rows and every probe's files and
    row equal."""
    s = assert_runs_equal(jd, td)
    files = probe_files(td)
    assert files == probe_files(jd) != []
    for f in files:
        if f.endswith("sim_summary.json"):
            assert (json.loads((Path(td) / f).read_text())
                    == json.loads((Path(jd) / f).read_text())), f
    return s


def test_cliff_bisect_matches_jax(tmp_path):
    ri_j, ri_t = cliff(tmp_path, "cliff")
    jax_run(ri_j)
    out = run_port(ri_t)
    s = assert_searches_equal(ri_j.run_dir, ri_t.run_dir)
    assert out.result.outcome == s["outcome"] == "success"
    bp = s["breaking_point"]
    assert bp["resolved"] and bp["first_failing"] == 0.6875
    assert bp["last_passing"] == 0.625
    assert s["compiles"] == 1 and s["rounds"] == len(s["search_rounds"])
    assert s["scenarios_probed"] < s["exhaustive_scenarios"] == 17
    assert s["mesh"] == {"scenario": 1, "instance": 1}


def test_faultsdemo_search_matches_jax(tmp_path):
    ri_j, ri_t = faultsdemo(tmp_path, "demo")
    jax_run(ri_j)
    run_port(ri_t)
    s = assert_searches_equal(ri_j.run_dir, ri_t.run_dir)
    assert s["outcome"] == "success" and s["compiles"] == 1
    assert s["breaking_point"]["resolved"]
    assert s["search"]["objective"] == "telemetry:net_drops_loss:mean"
    assert s["fault_events"] > 0 and s["rounds"] > 1
    # every probe writes its records and its trace
    names = {Path(f).name for f in probe_files(ri_t.run_dir)}
    assert names == {"results.out", "trace.json", "sim_summary.json"}


def test_disabled_search_runs_plainly(tmp_path):
    ri_j, ri_t = faultsdemo(tmp_path, "off", enabled=False)
    run_jax(ri_j)
    run_port(ri_t)
    s = assert_runs_equal(ri_j.run_dir, ri_t.run_dir)
    assert s["search"] == "disabled" and "breaking_point" not in s
    assert s["outcome"] == "success"
    assert not (Path(ri_t.run_dir) / "round").exists()


class _PreemptAfterRound:
    """A runner's should_stop hook that preempts its search at the first
    boundary after the driver's first checkpoint (round 0 digested)."""

    def __init__(self, runner):
        self.runner, self.real = runner, runner._make_should_stop

    def __enter__(self):
        runner = self.runner

        def make(rinput):
            rid = rinput.run_id
            ev = runner._term_event(rid)
            driver = Path(rinput.run_dir) / "checkpoint" / "driver.pkl"

            def should_stop():
                if driver.exists():
                    runner.request_preempt(rid)
                return ev.is_set()

            return should_stop

        runner._make_should_stop = make

    def __exit__(self, *exc):
        self.runner._make_should_stop = self.real


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    """Both runners' legs: the uninterrupted search, the search
    preempted in round 1, its resume, and a resume of the finished
    search."""
    tmp = tmp_path_factory.mktemp("search_resume")
    # several boundaries a round: a stop lands inside round 1
    ck = {"checkpoint": ({"interval": 0.0}, {"interval": 0.0}),
          "chunk_ticks": 50}
    full = faultsdemo(tmp, "full", "full", **ck)
    pre = faultsdemo(tmp, "pre", "pre", **ck)
    res = faultsdemo(tmp, "pre", "pre", resume=True, **ck)
    again = faultsdemo(tmp, "full", "full", resume=True, **ck)
    out = {}
    for side, run, runner in ((0, jax_run, jrunner), (1, run_port, trunner)):
        run(full[side])
        full_s = summary(full[side].run_dir)
        full_out = run_out_lines(full[side].run_dir)
        full_files = output_files(full[side].run_dir)
        with _PreemptAfterRound(runner):
            b = run(pre[side], clear=False)
        mid = {"summary": summary(pre[side].run_dir),
               "outcome": b.result.outcome}
        c = run(res[side], clear=False)
        d = run(again[side], clear=False)
        out[side] = {"full": full[side].run_dir, "full_summary": full_s,
                     "full_run_out": full_out, "full_files": full_files,
                     "pre": mid, "resumed": res[side].run_dir,
                     "outcome": c.result.outcome,
                     "again": d.result.journal}
    return out


def test_preempted_search_matches_jax(legs):
    j, t = legs[0]["pre"], legs[1]["pre"]
    assert t["outcome"] == j["outcome"] == "preempted"
    s = t["summary"]
    assert s["preempted"] and s["breaking_point"]["stopped"] == "terminated"
    assert len(s["search_rounds"]) == 1
    assert (deterministic(s, legs[1]["resumed"])
            == deterministic(j["summary"], legs[0]["resumed"]))


def test_resumed_search_matches_jax(legs):
    assert legs[1]["outcome"] == legs[0]["outcome"] == "success"
    s = assert_searches_equal(legs[0]["resumed"], legs[1]["resumed"])
    assert s["resumed_from_round"] == 1 and s["compiles"] == 0
    assert s["resume"]["from_round"] == 1


def _without_compiles(lines):
    """run.out without the last line's build count."""
    return lines[:-1] + [lines[-1].split(" compiles=")[0]]


def test_resumed_search_equals_the_uninterrupted_one(legs):
    full, resumed = legs[1]["full"], legs[1]["resumed"]
    a = deterministic(legs[1]["full_summary"], full)
    b = deterministic(summary(resumed), resumed)
    for d in (a, b):
        for k in RESUME_KEYS:
            d.pop(k, None)
        d["hbm_preflight"].pop("executor_cache")
    assert b == a
    # the resumed leg reused the pooled build: compiles=0 against 1
    assert (_without_compiles(run_out_lines(resumed))
            == _without_compiles(legs[1]["full_run_out"]))
    files = legs[1]["full_files"]
    assert files and output_files(resumed) == files


def test_resume_of_a_resolved_search_replays_it(legs):
    """The finished search's checkpoint holds a resolved driver: the
    resume replays the search fresh, to the same verdict."""
    for side in (0, 1):
        j = legs[side]["again"]
        assert "resumed_from_round" not in j
        assert j["breaking_point"] == legs[side]["full_summary"][
            "breaking_point"]
        assert j["search_rounds"] == legs[side]["full_summary"][
            "search_rounds"]
