"""The drain plane of the port (testground_tpu_torch/sim/drain.py and the
chunk boundary of ``SimExecutable.run``) against the JAX package, on the
CPU: the mirrors of tests/test_drain.py's bit-identity and sizing cases.
Each drained run goes through both packages' ObserverDrain, and the three
streamed files (``trace.jsonl``, ``results.out``, the assembled
``trace.json``) are byte-equal to the JAX drain's; within the port a
small drained run's concatenated stream equals a big undrained run's
end-of-run demux. Also: ``should_stop`` keeping the drained prefix, the
order drain -> on_chunk -> stop at a boundary, the in-place cursor reset,
the drain's resume position, and a drain knob that changes no state
leaf and no tick op."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _plane_parity import j_build, t_build, tick_op_log
from test_torch_trace import CHAOS_GROUPS, CHAOS_TIMELINE, faultsdemo

from testground_tpu.sim import PhaseCtrl as JPhaseCtrl
from testground_tpu.sim import telemetry as jtel
from testground_tpu.sim.drain import ObserverDrain as JDrain
from testground_tpu.sim.drain import drain_flags as j_drain_flags
from testground_tpu_torch.sim import PhaseCtrl as TPhaseCtrl
from testground_tpu_torch.sim import tables
from testground_tpu_torch.sim import telemetry as ttel
from testground_tpu_torch.sim.drain import EVENTS_FILE, RESULTS_FILE
from testground_tpu_torch.sim.drain import ObserverDrain as TDrain
from testground_tpu_torch.sim.drain import drain_flags

FILES = (EVENTS_FILE, RESULTS_FILE, "trace.json")


def _chaos_kw(trace=None, telemetry=None, chunk_ticks=400, event_skip=True):
    return dict(faults=CHAOS_TIMELINE, trace=trace, telemetry=telemetry,
                chunk_ticks=chunk_ticks, event_skip=event_skip,
                quantum_ms=1.0, max_ticks=400, metrics_capacity=16)


def _strip(kw):
    return {k: v for k, v in kw.items() if v is not None}


def _chaos(pkg, **kw):
    jplan, tplan = faultsdemo()
    if pkg == "jax":
        return j_build(jplan, CHAOS_GROUPS, "chaos", **_strip(_chaos_kw(**kw)))
    return t_build(tplan, CHAOS_GROUPS, "chaos", **_strip(_chaos_kw(**kw)))


def _read_jsonl(path):
    return [json.loads(ln) for ln in Path(path).read_text().splitlines()]


def _nonmeta(events):
    return [e for e in events if e.get("ph") != "M"]


def _tkey(r):
    return (r["virtual_time_s"], r["name"], str(r["instance"]))


def _drained_pair(tmp_path, trace_drain=True, telem_drain=True,
                  should_stop=None, **kw):
    """The same drained run through both packages' drains, into
    ``tmp_path/jax`` and ``tmp_path/port``; returns both (executable,
    drain, result) triples."""
    out = {}
    for pkg, Drain in (("jax", JDrain), ("port", TDrain)):
        ex = _chaos(pkg, **kw)
        d = Drain(ex, trace_drain=trace_drain, telem_drain=telem_drain,
                  run_dir=tmp_path / pkg)
        stop = should_stop() if should_stop else None
        res = ex.run(drain=d, should_stop=stop)
        d.finalize(res.state, fault_plan=ex.faults)
        out[pkg] = (ex, d, res)
    return out["jax"], out["port"]


def _assert_files_equal(tmp_path, files=FILES):
    for f in files:
        j, t = tmp_path / "jax" / f, tmp_path / "port" / f
        assert j.exists() == t.exists(), f
        if j.exists():
            assert t.read_bytes() == j.read_bytes(), f


# ------------------------------------------------ bit-identity contracts


@pytest.mark.parametrize("event_skip", [False, True])
def test_chaos_timeline_drained_matches_undrained(tmp_path, event_skip):
    """A small-capacity drained run of the faultsdemo chaos timeline
    (faults, telemetry, with and without event skip) streams what a
    big-capacity undrained run demuxes at its end, with no loss, and its
    files are byte-equal to the JAX drain's."""
    big = _chaos("port", trace={"capacity": 512},
                 telemetry={"interval": 20}, event_skip=event_skip)
    res_big = big.run()
    assert res_big.trace_dropped_total() == 0
    assert res_big.trace_events_total() > 0
    (jex, jd, jres), (tex, td, tres) = _drained_pair(
        tmp_path, trace={"capacity": 256, "drain": True},
        telemetry={"interval": 20, "drain": True, "samples": 8},
        chunk_ticks=60, event_skip=event_skip)
    _assert_files_equal(tmp_path)
    stats = td.stats()
    assert stats == jd.stats()
    assert stats["trace_dropped"] == 0 and stats["telemetry_clipped"] == 0
    assert stats["drain_batches"] > 1
    assert stats["trace_events"] == res_big.trace_events_total()
    assert stats["telemetry_samples"] == res_big.telemetry_samples()
    d = tmp_path / "port"
    got = _nonmeta(_read_jsonl(d / EVENTS_FILE))
    ref_doc = res_big.chrome_trace()
    ref = _nonmeta(ref_doc["traceEvents"])
    assert got == ref
    # the fault windows' track rides the stream too
    fault_track = [e for e in got if e.get("pid") == 1 and e.get("ph") == "X"]
    assert {e["name"].split(" ")[0] for e in fault_track} == {
        "partition", "degrade"}
    tj = json.loads((d / "trace.json").read_text())
    assert _nonmeta(tj["traceEvents"]) == ref

    def meta(evs):
        return {e["tid"] for e in evs if e.get("name") == "thread_name"}

    assert meta(tj["traceEvents"]) == meta(ref_doc["traceEvents"])
    lane, glob = res_big.telemetry_records()
    got_t = _read_jsonl(d / RESULTS_FILE)
    assert sorted(got_t, key=_tkey) == sorted(lane + glob, key=_tkey)


def test_skip_and_dense_drained_streams_match(tmp_path):
    streams = {}
    for skip in (False, True):
        ex = _chaos("port", trace={"capacity": 256, "drain": True},
                    chunk_ticks=60, event_skip=skip)
        d = TDrain(ex, trace_drain=True, run_dir=tmp_path / str(skip))
        res = ex.run(drain=d)
        d.finalize(res.state, fault_plan=ex.faults)
        streams[skip] = _nonmeta(_read_jsonl(tmp_path / str(skip)
                                             / EVENTS_FILE))
    assert streams[False] == streams[True] and streams[True]


def test_trace_only_and_telemetry_only_drains(tmp_path):
    for which in ("trace", "telem"):
        sub = tmp_path / which
        _drained_pair(sub, trace_drain=which == "trace",
                      telem_drain=which == "telem",
                      trace={"capacity": 64, "drain": True},
                      telemetry={"interval": 10, "drain": True,
                                 "samples": 4},
                      chunk_ticks=30, event_skip=False)
        _assert_files_equal(sub)
        written = {f for f in FILES if (sub / "port" / f).exists()}
        assert written == ({EVENTS_FILE, "trace.json"} if which == "trace"
                           else {RESULTS_FILE})


def _hist_plan(np_mod):
    """Every lane observes a value into two histograms, counts and sets
    its gauge each tick for 90 ticks (the user probes and histograms the
    finalize step demuxes)."""
    tor = np_mod is torch
    PC = TPhaseCtrl if tor else JPhaseCtrl

    def build(b):
        def fn(env, mem):
            v = (env.tick * (env.instance + 3)).to(torch.float32) if tor \
                else (env.tick * (env.instance + 3)).astype(jnp.float32)
            done = env.tick >= 90
            return mem, PC(
                advance=done.to(torch.int32) if tor else jnp.int32(done),
                observe_hist=np_mod.remainder(env.tick, 2),
                observe_value=v, count_add=1, gauge_set=1,
                gauge_value=v * 0.5,
            )

        b.phase(fn, "obs")
        b.end_ok()

    return build


def test_histograms_demux_once_at_finalize(tmp_path):
    telem = {"interval": 7, "drain": True, "samples": 3,
             "histograms": [{"name": "a", "buckets": 12},
                            {"name": "b", "buckets": 6}]}
    kw = dict(quantum_ms=1.0, max_ticks=300, chunk_ticks=20,
              event_skip=False, telemetry=telem)
    for pkg, build, Drain in (("jax", j_build, JDrain),
                              ("port", t_build, TDrain)):
        ex = build(_hist_plan(jnp if pkg == "jax" else torch),
                   [("g", 0, 3, {})], **dict(kw))
        d = Drain(ex, telem_drain=True, run_dir=tmp_path / pkg)
        res = ex.run(drain=d)
        d.finalize(res.state)
        assert d.stats()["telemetry_clipped"] == 0
    _assert_files_equal(tmp_path)
    recs = _read_jsonl(tmp_path / "port" / RESULTS_FILE)
    assert {r["name"] for r in recs if r.get("type") == "histogram"} == {
        "telemetry.hist.a", "telemetry.hist.b"}


# ----------------------------------------------------- the chunk boundary


def _stop_after(k):
    """A should_stop that says stop at the k-th boundary."""
    def make():
        calls = []

        def stop():
            calls.append(1)
            return len(calls) >= k

        return stop

    return make


@pytest.mark.parametrize("event_skip", [False, True])
def test_should_stop_keeps_the_drained_prefix(tmp_path, event_skip):
    (jex, jd, jres), (tex, td, tres) = _drained_pair(
        tmp_path, should_stop=_stop_after(2),
        trace={"capacity": 128, "drain": True},
        telemetry={"interval": 5, "drain": True, "samples": 4},
        chunk_ticks=15, event_skip=event_skip)
    assert tres.terminated and jres.terminated
    assert tres.ticks == jres.ticks < 400
    assert td.batches == jd.batches == 2
    _assert_files_equal(tmp_path)
    events = _nonmeta(_read_jsonl(tmp_path / "port" / EVENTS_FILE))
    assert td.stats()["trace_events"] == len(
        [e for e in events if e.get("pid") == 0]) > 0


def test_boundary_order_drain_then_on_chunk_then_stop(tmp_path):
    ex = _chaos("port", trace={"capacity": 256, "drain": True},
                chunk_ticks=60)
    d = TDrain(ex, trace_drain=True, run_dir=tmp_path)
    seen = []

    def on_chunk(tick, running, info):
        # the drain ran first: its watermarks and zeroed cursors
        assert int(info["state"]["trace"]["trace_cnt"].sum()) == 0
        seen.append((tick, running, info["observer"]["trace_events"],
                     info["observer"]["drain_batches"]))

    res = ex.run(drain=d, on_chunk=on_chunk)
    assert not res.terminated
    assert [s[3] for s in seen] == list(range(1, len(seen) + 1))
    ev = [s[2] for s in seen]
    assert ev == sorted(ev) and ev[-1] == d.stats()["trace_events"] > 0
    assert seen[-1][0] == res.ticks and seen[-1][1] == 0


@pytest.mark.parametrize("event_skip", [False, True])
def test_should_stop_is_polled_at_every_boundary_as_in_jax(event_skip):
    """A should_stop that never stops is called once a boundary, the
    last included, after on_chunk, as often as in the JAX package."""
    logs = {}
    for pkg in ("jax", "port"):
        ex = _chaos(pkg, trace={"capacity": 256}, chunk_ticks=60,
                    event_skip=event_skip)
        log = logs[pkg] = []
        res = ex.run(
            on_chunk=lambda tick, running, info, log=log: log.append(
                ("chunk", tick)),
            should_stop=lambda log=log: log.append(("stop",)) or False)
        assert not res.terminated
    assert logs["port"] == logs["jax"]
    assert logs["port"][-1] == ("stop",)
    assert logs["port"][::2] == [e for e in logs["port"] if e[0] == "chunk"]


def test_undrained_on_chunk_reads_cumulative_counts():
    ex = _chaos("port", trace={"capacity": 512}, telemetry={"interval": 20},
                chunk_ticks=60)
    seen = []
    res = ex.run(on_chunk=lambda tick, running, info: seen.append(
        (int(info["state"]["trace"]["trace_cnt"].sum()),
         int(info["state"]["telem"]["cnt"]), sorted(info))))
    assert len(seen) > 1 and {tuple(s[2]) for s in seen} == {("state",)}
    seen = [s[:2] for s in seen]
    assert [s[0] for s in seen] == sorted(s[0] for s in seen)
    assert seen[-1] == (res.trace_events_total(), res.telemetry_samples())


def test_reset_is_in_place(tmp_path):
    """The drain zeroes the cursors inside the state's own tensors (a
    captured stepper replays into them) and returns the same dict;
    nothing else resets."""
    ex = _chaos("port", trace={"capacity": 2, "drain": True},
                telemetry={"interval": 5, "drain": True, "samples": 2})
    st = ex.init_state()
    for _ in range(60):
        st = ex.guarded_tick(st)
    cnt, tcnt = st["trace"]["trace_cnt"], st["telem"]["cnt"]
    dropped = st["trace"]["trace_dropped"].clone()
    clipped = st["telem"]["clipped"].clone()
    assert int(cnt.sum()) > 0 and int(tcnt) > 0 and int(dropped.sum()) > 0
    d = TDrain(ex, trace_drain=True, telem_drain=True, run_dir=tmp_path)
    out = d.drain(st)
    assert out is st
    assert out["trace"]["trace_cnt"] is cnt and out["telem"]["cnt"] is tcnt
    assert int(cnt.sum()) == 0 and int(tcnt) == 0
    assert torch.equal(st["trace"]["trace_dropped"], dropped)
    assert torch.equal(st["telem"]["clipped"], clipped)


def test_drain_knob_changes_no_leaf_and_no_op():
    on = _chaos("port", trace={"capacity": 64, "drain": True},
                telemetry={"interval": 50, "drain": True})
    off = _chaos("port", trace={"capacity": 64},
                 telemetry={"interval": 50})
    assert tick_op_log(on, ticks=3) == tick_op_log(off, ticks=3)


def test_snapshot_matches_jax_and_restore_truncates(tmp_path):
    snaps = {}
    for pkg, Drain in (("jax", JDrain), ("port", TDrain)):
        ex = _chaos(pkg, trace={"capacity": 128, "drain": True},
                    telemetry={"interval": 5, "drain": True, "samples": 4},
                    chunk_ticks=15, event_skip=False)
        d = Drain(ex, trace_drain=True, telem_drain=True,
                  run_dir=tmp_path / pkg)
        taken = []
        ex.run(drain=d, on_chunk=lambda t, r, i, d=d, taken=taken: (
            taken.append(d.snapshot()) if len(taken) < 3 else None))
        snaps[pkg] = (d, taken[2])
    (jd, jsnap), (td, tsnap) = snaps["jax"], snaps["port"]
    assert tsnap == jsnap
    full = (tmp_path / "port" / EVENTS_FILE).stat().st_size
    td.restore(tsnap)
    rec = tsnap["streams"]["root"]
    assert (tmp_path / "port" / EVENTS_FILE).stat().st_size == \
        rec["trace_bytes"] < full
    assert (tmp_path / "port" / RESULTS_FILE).stat().st_size == \
        rec["results_bytes"]
    assert td.batches == 3 and td.stats()["trace_events"] == \
        rec["trace_events"]


# --------------------------------------------------- sizing and the table


def test_samples_without_drain_is_a_build_error():
    with pytest.raises(jtel.TelemetryError) as je:
        _chaos("jax", telemetry={"interval": 20, "samples": 4}).init_state()
    with pytest.raises(ttel.TelemetryError) as te:
        _chaos("port", telemetry={"interval": 20, "samples": 4})
    assert str(te.value) == str(je.value)
    assert "drain" in str(te.value)


def test_samples_with_drain_bounds_the_buffer():
    ex = _chaos("port", telemetry={"interval": 20, "drain": True,
                                   "samples": 4})
    assert ex.telemetry.s_cap == 4
    assert ex.init_state()["telem"]["lane_buf"].shape[1] == 4


def test_long_run_fixed_depth_only_with_drain():
    def build(b):
        b.sleep_ms(5)
        b.end_ok()

    kw = dict(quantum_ms=1.0, max_ticks=100_000)
    with pytest.raises(ttel.TelemetryError, match="drain"):
        t_build(build, [("single", 0, 2, {})], telemetry={"interval": 1},
                **kw)
    ex = t_build(build, [("single", 0, 2, {})],
                 telemetry={"interval": 1, "drain": True, "samples": 64},
                 **kw)
    assert ex.telemetry.s_cap == 64


def test_clipped_chunk_keeps_later_timestamps_aligned(tmp_path):
    """A chunk whose boundaries overflow the drained buffer loses its tail
    (counted in telemetry_clipped) but shifts no later batch: every
    record streamed carries its undrained twin's time, and the file is
    byte-equal to the JAX drain's."""
    big = _chaos("port", telemetry={"interval": 5}, chunk_ticks=60)
    lane, glob = big.run().telemetry_records()
    ref = {json.dumps(r, sort_keys=True) for r in lane + glob}
    (_, jd, _), (_, td, _) = _drained_pair(
        tmp_path, trace_drain=False,
        telemetry={"interval": 5, "drain": True, "samples": 6},
        chunk_ticks=60)
    assert td.stats() == jd.stats()
    assert td.stats()["telemetry_clipped"] > 0
    _assert_files_equal(tmp_path)
    got = _read_jsonl(tmp_path / "port" / RESULTS_FILE)
    assert got
    missing = [r for r in got if json.dumps(r, sort_keys=True) not in ref]
    assert not missing, missing[:3]


def test_drain_flags_match_jax():
    cases = [
        (None, None),
        (tables.Trace(drain=True), tables.Telemetry()),
        (tables.Trace(drain=True, enabled=False),
         tables.Telemetry(drain=True)),
        ({"drain": True}, {"drain": True, "enabled": False}),
    ]

    class RInput:
        def __init__(self, trace, telemetry):
            self.trace, self.telemetry = trace, telemetry

    for trace, telem in cases:
        ri = RInput(trace, telem)
        assert drain_flags(ri) == j_drain_flags(ri)
    assert drain_flags(RInput(tables.Trace(drain=True),
                              tables.Telemetry(drain=True))) == (True, True)


def test_run_hooks_watchdog_checkpoint_and_resume(tmp_path):
    ex = _chaos("port", trace={"capacity": 16, "drain": True},
                chunk_ticks=20, event_skip=False)
    # the per-scenario streams are ported (the sweep plane): only one
    # of run_dir/scenario_dir may be given, as in JAX
    assert TDrain(ex, trace_drain=True,
                  scenario_dir=lambda s: tmp_path).batched
    with pytest.raises(ValueError, match="exactly one"):
        TDrain(ex, trace_drain=True, run_dir=tmp_path,
               scenario_dir=lambda s: tmp_path)
    # the durability hooks (sim/checkpoint.py): the watchdog judges each
    # chunk but the last, the checkpointer snapshots each boundary but
    # the last, and a run resumed from a snapshot ends in the
    # uninterrupted run's state, leaf for leaf
    from testground_tpu_torch.sim.checkpoint import (
        Checkpointer, DispatchWatchdog, load_checkpoint)
    from testground_tpu_torch.sim.state_io import (
        compare_leaves, flatten, state_to_numpy)

    def assert_leaves_equal(a, b):
        compare_leaves(flatten(state_to_numpy(a)), flatten(state_to_numpy(b)))

    full = ex.run()
    chunks = full.ticks // 20 + 1
    wd = DispatchWatchdog(floor_s=600.0)
    ck = Checkpointer(tmp_path / "ck", key_hash="k", interval_s=0.0)
    res = ex.run(watchdog=wd, checkpoint=ck)
    assert wd.boundaries == ck.snapshots == chunks - 1 > 1
    assert_leaves_equal(res.state, full.state)
    rp = load_checkpoint(tmp_path / "ck")
    assert rp.tick == 20 * (chunks - 1)
    # resume from the one before the last (the last two are kept)
    import pickle

    older = pickle.loads((rp.dir / f"state-{rp.seq - 1}.pkl").read_bytes())
    assert int(older["tick"]) == 20 * (chunks - 2)
    resumed = ex.run(resume_state=older)
    assert_leaves_equal(resumed.state, full.state)
    assert resumed.ticks == full.ticks
    with pytest.raises(ValueError, match="run_dir"):
        TDrain(ex, trace_drain=True)
    # a drain of no plane is a no-op
    idle = TDrain(ex, run_dir=tmp_path)
    st = ex.init_state()
    assert not idle.active and idle.drain(st) is st and idle.batches == 0
    np.testing.assert_array_equal(idle.journal()["batches"], 0)


def test_bench_drain_leg_on_the_cpu():
    """``bench --drain``'s legs at n = 32 and 20 timer rounds on the CPU
    (one plain and one drained run): the flag keeps the leaves and ops,
    the busiest lane's
    events overflow the drained ring at least 8x, and the drained stream
    equals the undrained 1,024-slot reference's demux, with nothing
    dropped or clipped."""
    from testground_tpu_torch import bench

    line = bench.drain_leg(32, "cpu", runs=1, rounds=20)
    assert line["overflow_factor"] >= 8
    assert line["drain_batches"] > 10
    assert line["events_compared"] == line["drained_events"] > 0
    assert line["trace_dropped"] == line["telemetry_clipped"] == 0
    json.dumps(line)
