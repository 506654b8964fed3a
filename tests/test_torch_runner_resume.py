"""The durability plane (testground_tpu_torch/sim/checkpoint.py) through
the port's runner, on the CPU: faultsdemo at 4, drained, checkpointed at
every boundary, preempted at its third boundary and resumed, equal to
the uninterrupted run and, leg by leg, to the JAX runner's same
sequence; a resume refused after an edit; a resume with nothing to
resume. Then the unit cases of tests/test_checkpoint.py,
tests/test_live.py and tests/test_profiles.py on the port's Checkpointer,
DispatchWatchdog, LiveSink, StageClock and ChunkProfiler."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import json
import pickle
import tomllib

import pytest
from _runner_parity import (
    REPO,
    PreemptAt,
    assert_runs_equal,
    deterministic,
    output_files,
    progress_rows,
    rinputs,
    run_jax,
    run_out_lines,
    run_port,
    summary,
)

from testground_tpu.api import composition as jcomp
from testground_tpu.sim import runner as jrunner
from testground_tpu_torch.sim import checkpoint as C
from testground_tpu_torch.sim import runner as trunner
from testground_tpu_torch.sim import tables as ttables
from testground_tpu_torch.sim.live import LiveSink
from testground_tpu_torch.sim.profile import ChunkProfiler
from testground_tpu_torch.utils.timing import StageClock

STOP_AT = 3  # the boundary the preempted leg stops at


def _faultsdemo(tmp, name, run_id, resume=False, params=None):
    with open(REPO / "plans" / "faultsdemo" / "composition.toml", "rb") as f:
        comp = tomllib.load(f)
    p = {k: str(v) for k, v in comp["global"]["run"]["test_params"].items()}
    p["min_pings"] = "0"
    p.update(params or {})
    tables = {"faults": comp["faults"],
              "trace": dict(comp["trace"], drain=True),
              "telemetry": dict(comp["telemetry"], drain=True)}
    kinds = {"faults": (jcomp.Faults, ttables.Faults),
             "trace": (jcomp.Trace, ttables.Trace),
             "telemetry": (jcomp.Telemetry, ttables.Telemetry)}
    return rinputs(
        "faultsdemo", "chaos",
        [(g["id"], g["instances"]["count"], p) for g in comp["groups"]],
        tmp / "jax" / name, tmp / "port" / name, run_id=run_id,
        run_config={"max_ticks": 2_000, "chunk_ticks": 25},
        checkpoint=({"interval": 0.0}, {"interval": 0.0}), resume=resume,
        **{k: (kinds[k][0].from_dict(v), kinds[k][1].from_dict(v))
           for k, v in tables.items()})


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    """Both runners' three legs: uninterrupted (full), preempted at
    boundary ``STOP_AT`` (pre), and its resume into the same directory."""
    tmp = tmp_path_factory.mktemp("resume")
    full = _faultsdemo(tmp, "full", "full")
    pre = _faultsdemo(tmp, "pre", "pre")
    res = _faultsdemo(tmp, "pre", "pre", resume=True)
    out = {}
    for side, run, runner in ((0, run_jax, jrunner), (1, run_port, trunner)):
        run(full[side])
        with PreemptAt(runner, STOP_AT):
            b = run(pre[side], clear=False)
        mid = {"summary": summary(pre[side].run_dir),
               "progress": progress_rows(pre[side].run_dir),
               "outcome": b.result.outcome}
        c = run(res[side], clear=False)
        out[side] = {"full": full[side].run_dir, "pre": mid,
                     "resumed": res[side].run_dir,
                     "outcome": c.result.outcome}
    return out


def test_preempted_leg_matches_jax(legs):
    j, t = legs[0]["pre"], legs[1]["pre"]
    assert t["outcome"] == j["outcome"] == "preempted"
    s = t["summary"]
    assert s["preempted"] and s["terminated"] and s["resume_token"] == "pre"
    assert s["checkpoint"]["snapshots"] == STOP_AT
    assert s["ticks"] == 25 * STOP_AT
    assert (deterministic(s, legs[1]["resumed"])
            == deterministic(j["summary"], legs[0]["resumed"]))
    assert t["progress"] == j["progress"]


def test_resumed_leg_matches_jax(legs):
    assert legs[1]["outcome"] == legs[0]["outcome"] == "success"
    s = assert_runs_equal(legs[0]["resumed"], legs[1]["resumed"])
    assert s["resumed_from_tick"] == 25 * STOP_AT
    assert s["resume"]["checkpoint_seq"] == STOP_AT - 1
    assert s["compiles"] == 0  # the pooled executor


# the journal keys a resumed run adds or changes: where it resumed, its
# snapshots, its progress rows, and that it reused the pooled executor
RESUME_KEYS = ("checkpoint", "resume", "resumed_from_chunk",
               "resumed_from_tick", "compiles", "live")


def test_resumed_run_equals_the_uninterrupted_one(legs):
    full, resumed = legs[1]["full"], legs[1]["resumed"]
    a, b = deterministic(summary(full), full), deterministic(
        summary(resumed), resumed)
    for s in (a, b):
        for k in RESUME_KEYS:
            s.pop(k, None)
        s["hbm_preflight"].pop("executor_cache")
    assert b == a
    assert run_out_lines(resumed) == run_out_lines(full)
    files = output_files(full)
    assert sorted(files) == ["results.out", "trace.json", "trace.jsonl"]
    assert output_files(resumed) == files


def test_resume_refused_after_an_edit(legs, tmp_path):
    """The checkpoint belongs to its program: a resume whose params
    differ is refused (both runners), before anything is built."""
    import shutil

    for side, run in ((0, run_jax), (1, run_port)):
        edited = _faultsdemo(tmp_path, f"e{side}", "pre", resume=True,
                             params={"chaos_loss": "30"})[side]
        shutil.copytree(legs[side]["resumed"], edited.run_dir)
        with pytest.raises(Exception, match="resume refused"):
            run(edited)


def test_resume_without_a_checkpoint_runs_fresh(tmp_path):
    ri_j, ri_t = rinputs("placebo", "metrics", [("single", 3, {})],
                         tmp_path / "jax", tmp_path / "port", resume=True)
    run_jax(ri_j)
    run_port(ri_t)
    s = assert_runs_equal(tmp_path / "jax", tmp_path / "port")
    assert s["resume"] == "no_checkpoint" and s["outcome"] == "success"


# ------------------------------------------------------ unit: checkpoint


def _state(tick):
    """A boundary state as the run loop hands it over: tensors."""
    import torch

    return {"tick": torch.tensor(tick, dtype=torch.int32),
            "x": torch.arange(4)}


def test_checkpointer_rotates_keeping_last_two(tmp_path):
    ck = C.Checkpointer(tmp_path, key_hash="k", interval_s=0.0)
    for t in (10, 20, 30):
        assert ck.boundary(_state(t))
    assert sorted(p.name for p in ck.dir.glob("state-*.pkl")) == [
        "state-1.pkl", "state-2.pkl"]
    rp = C.load_checkpoint(tmp_path)
    assert rp.seq == 2 and rp.tick == 30 and int(rp.state["tick"]) == 30


def test_checkpointer_interval_rate_limits_but_force_lands(tmp_path):
    now = [0.0]
    ck = C.Checkpointer(tmp_path, key_hash="k", interval_s=10.0,
                        clock=lambda: now[0])
    now[0] = 1.0
    assert not ck.boundary(_state(1))
    assert ck.boundary(_state(2), force=True)
    now[0] = 12.0
    assert ck.boundary(_state(3))
    assert ck.snapshots == 2


def test_checkpoint_verify_refuses_another_program(tmp_path):
    ck = C.Checkpointer(tmp_path, key_hash="k1", comp_hash="c1",
                        interval_s=0.0)
    ck.boundary(_state(5))
    rp = C.load_checkpoint(tmp_path)
    rp.verify("k1", "c1")
    rp.verify("k1", "")
    with pytest.raises(C.CheckpointError, match="different program"):
        rp.verify("k2", "c1")
    with pytest.raises(C.CheckpointError, match="composition changed"):
        rp.verify("k1", "c2")


def test_checkpoint_torn_newest_falls_back_and_fresh_run_clears(tmp_path):
    ck = C.Checkpointer(tmp_path, key_hash="k", interval_s=0.0)
    for t in (10, 20):
        ck.boundary(_state(t))
    newest = ck.dir / "state-1.pkl"
    newest.write_bytes(newest.read_bytes()[:10])
    rp = C.load_checkpoint(tmp_path)
    assert rp.seq == 0 and rp.tick == 10
    C.Checkpointer(tmp_path, key_hash="new", interval_s=0.0)
    assert C.load_checkpoint(tmp_path) is None


def test_checkpoint_first_save_hook_fires_once_and_meta_is_json(tmp_path):
    calls = []
    ck = C.Checkpointer(tmp_path, key_hash="k", interval_s=0.0,
                        on_first_save=lambda: calls.append(1))
    ck.boundary(_state(1))
    ck.boundary(_state(2))
    assert calls == [1]
    meta = json.loads((ck.dir / "meta.json").read_text())
    assert meta["seq"] == 1 and meta["tick"] == 2
    assert pickle.loads((ck.dir / "state-1.pkl").read_bytes())["tick"] == 2


def test_watchdog_budget_raise_and_env(monkeypatch):
    wd = C.DispatchWatchdog(floor_s=10.0, factor=4.0)
    assert wd.budget_s() == 10.0
    for _ in range(20):
        wd.observe(5.0)
    assert wd.budget_s() == pytest.approx(20.0)
    wd = C.DispatchWatchdog(floor_s=0.1, factor=2.0)
    wd.observe(0.05)
    with pytest.raises(C.WedgedDispatchError, match="watchdog budget"):
        wd.observe(0.5)
    assert wd.fired
    monkeypatch.setenv("TG_DISPATCH_TIMEOUT_S", "0")
    assert C.DispatchWatchdog.from_env() is None
    monkeypatch.setenv("TG_DISPATCH_TIMEOUT_S", "off")
    assert C.DispatchWatchdog.from_env() is None
    monkeypatch.setenv("TG_DISPATCH_TIMEOUT_S", "33")
    assert C.DispatchWatchdog.from_env().floor_s == 33.0
    monkeypatch.delenv("TG_DISPATCH_TIMEOUT_S")
    assert C.DispatchWatchdog.from_env().floor_s == 120.0


def test_watchdog_heartbeat_beats_only_while_armed():
    import time

    rows = []
    wd = C.DispatchWatchdog(floor_s=60.0)
    wd.attach_heartbeat(rows.append, interval_s=0.1)
    try:
        time.sleep(0.3)
        assert rows == []  # nothing armed
        wd.begin()
        time.sleep(0.5)
        wd.end()
        n = len(rows)
        assert n >= 1 and rows[0]["kind"] == "dispatching"
        assert rows[0]["budget_s"] == 60.0
        time.sleep(0.3)
        assert len(rows) == n
    finally:
        wd.detach_heartbeat()


# ------------------------------------------------------------ unit: live


def _rows(path):
    return [json.loads(x) for x in (path / "progress.jsonl").read_text()
            .splitlines()]


def test_live_sink_appends_rate_limits_and_mirrors(tmp_path):
    sink = LiveSink(tmp_path, kind="run")
    assert sink.emit({"phase": "dispatch", "tick": 1})
    assert sink.emit({"phase": "done"}, force=True)
    assert [r["seq"] for r in _rows(tmp_path)] == [0, 1]
    now = [0.0]
    seen = []
    sink = LiveSink(tmp_path, interval_s=10.0, clock=lambda: now[0],
                    mirror=seen.append)
    assert _rows(tmp_path) == []  # a new sink truncates
    assert sink.emit({"phase": "dispatch"})
    now[0] = 1.0
    assert not sink.emit({"phase": "dispatch"})
    assert sink.emit({"phase": "round"}, force=True)
    now[0] = 20.0
    assert sink.emit({"phase": "dispatch"})
    assert len(_rows(tmp_path)) == 3
    assert [r["phase"] for r in seen] == ["dispatch", "round", "dispatch"]


def test_live_sink_mirror_floor_and_failures(tmp_path):
    now, seen = [0.0], []
    sink = LiveSink(tmp_path, mirror=seen.append, clock=lambda: now[0])
    for i in range(5):
        now[0] = i * 0.01
        assert sink.emit({"phase": "dispatch", "tick": i})
    assert len(_rows(tmp_path)) == 5 and len(seen) == 1
    now[0] = 1.0
    sink.emit({"phase": "dispatch"})
    assert len(seen) == 2

    def bad(row):
        raise RuntimeError("storage hiccup")

    assert LiveSink(tmp_path, mirror=bad).emit({"phase": "dispatch"})


def test_live_sink_resume_truncates_post_checkpoint_lines(tmp_path):
    first = LiveSink(tmp_path)
    first.emit({"phase": "dispatch", "tick": 10})
    seq, nbytes = first.seq, first.path.stat().st_size
    first.emit({"phase": "dispatch", "tick": 20})
    resumed = LiveSink(tmp_path, resume_seq=seq, resume_bytes=nbytes)
    resumed.emit({"phase": "dispatch", "tick": 20})
    rows = _rows(tmp_path)
    assert [r["seq"] for r in rows] == [0, 1] and rows[1]["tick"] == 20


def test_stage_clock_spans_and_rollup():
    c = StageClock("t")
    with c.span("a"):
        pass
    with c.span("a"):
        pass
    c.reset_lap()
    c.lap("dispatch")
    r = c.rollup()
    assert [x["name"] for x in r] == ["a", "dispatch"]
    assert r[0]["count"] == 2 and r[1]["count"] == 1


# -------------------------------------------------------- unit: profiler


def test_chunk_profiler_aggregates_and_one_chunk_window(tmp_path,
                                                        monkeypatch):
    import torch

    monkeypatch.setenv("TG_PROFILE_DIR", str(tmp_path / "prof"))
    monkeypatch.setenv("TG_PROFILE_CHUNK", "1")
    p = ChunkProfiler.from_env(device="cpu")
    for lap in (0.5, 0.25, 0.25):
        p.on_boundary(lap)
        torch.ones(8).sum()  # some work inside the window
    p.close()
    j = p.journal()
    assert j["chunks"] == 3 and j["dispatch_seconds"] == 1.0
    assert j["dispatch_max_s"] == 0.5 and j["trace_captured"]
    assert "hbm_high_water_bytes" not in j  # the CPU reports none
    trace = json.loads((tmp_path / "prof" / "chunk1" / "trace.json")
                       .read_text())
    assert trace["traceEvents"]
    assert ChunkProfiler().journal() is None


def test_runner_profiles_and_device_profile(tmp_path):
    """A group asking for ``profiles`` gets a torch.profiler trace of the
    run under ``<run_dir>/profiles``; every run journals its
    ``device_profile``."""
    from testground_tpu_torch.api.contracts import RunGroup, RunInput

    ri = RunInput(
        run_id="prof", env_config=None, run_dir=str(tmp_path / "r"),
        test_plan="placebo", test_case="ok", total_instances=2,
        groups=[RunGroup(id="single", instances=2,
                         artifact_path=str(REPO / "plans" / "placebo"),
                         profiles={"cpu": "on"})])
    out = trunner.run_composition(ri, device="cpu")
    assert out.result.outcome == "success"
    assert (tmp_path / "r" / "profiles" / "trace.json").exists()
    assert out.result.journal["device_profile"]["chunks"] >= 1
