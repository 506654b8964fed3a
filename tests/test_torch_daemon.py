"""The port's daemon (testground_tpu_torch/daemon/) against the JAX
package's, on the CPU, in one process: each boots on ``localhost:0`` over
its own engine (in-memory task store, two scheduler workers; the port's
runs on ``device="cpu"``), and the same compositions go through each
one's client. For placebo's ``ok`` and ``stall``, benchmarks storm at 8,
a 2-seed ``[sweep]`` of it and an enabled ``[search]`` over cliff: the
task states, ``/status`` but its walls, every member of the outputs
tarball (their names, and their bytes but the walls of
runner/outputs.py), ``/progress``'s snapshots but their walls, and the
``/tasks`` listing; ``/cache`` after a prewarm and the pool hit it gives;
the families and label sets of ``/metrics``; the error text of an unknown
runner, a disabled runner, a missing task and a missing token (401);
``kill`` of a queued task, ``delete``, a ``kill`` that terminates a run
at its chunk boundary, ``terminate``, and ``resume`` after
``preempt_all``; the federation routes of a daemon with no peers, and a
coordinator's enroll making it a worker; the
HTML pages and data routes. Every wait is on a task's state, never on a
sleep."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import io
import json
import time

import pytest
from _runner_parity import (
    REPO,
    ROW_WALL_KEYS,
    assert_outputs_equal,
    composition,
    engines,
    jax_on_one_device,
    output_files,
    run_out_lines,
    task_view,
)

from testground_tpu.client import Client as JClient
from testground_tpu.daemon import Daemon as JDaemon
from testground_tpu.rpc import RPCError as JRPCError
from testground_tpu_torch import graft
from testground_tpu_torch import obs as tobs
from testground_tpu_torch.client import Client as TClient
from testground_tpu_torch.daemon import Daemon as TDaemon
from testground_tpu_torch.rpc import RPCError as TRPCError

STORM = dict({k: str(v) for k, v in graft.STORM_PARAMS.items()},
             conn_delay_ms="600", data_size_kb="8")
STORM_CFG = {"quantum_ms": 10.0, "max_ticks": 100_000,
             "metrics_capacity": 16, "phase_gating": True}
CLIFF_SEARCH = {"param": "x", "lo": 0.0, "hi": 1.0, "step": 1.0 / 16,
                "width": 4}
CASES = {
    "ok": composition("placebo", "ok", 3),
    "stall": composition("placebo", "stall", 3,
                         run_config={"max_ticks": 200}),
    "storm": composition("benchmarks", "storm", 8, STORM, STORM_CFG),
    "sweep": composition("benchmarks", "storm", 8, STORM, STORM_CFG,
                         sweep={"seeds": 2, "mesh": [1, 1]}),
    "search": composition("benchmarks", "cliff", 16, {"x_fail": "0.663"},
                          {"quantum_ms": 10.0, "max_ticks": 10_000,
                           "metrics_capacity": 8},
                          search=CLIFF_SEARCH),
}
# a run that is still running when it is killed or preempted: placebo's
# stall without event skip, 25 ticks a chunk, a snapshot each boundary
LONG_CFG = {"max_ticks": 3_000, "chunk_ticks": 25, "event_skip": False}
LONG = composition("placebo", "stall", 2, run_config=LONG_CFG,
                   live={"enabled": True, "interval": 0.0},
                   checkpoint={"enabled": True, "interval": 0.0})


class Pair:
    """A JAX daemon and the port's, with a client each."""

    def __init__(self, tmp, workers):
        self.tmp = tmp
        self.jeng, self.teng = engines(tmp, workers=workers)
        self.jd = JDaemon(engine=self.jeng,
                          listen="localhost:0").start_background()
        self.td = TDaemon(engine=self.teng,
                          listen="localhost:0").start_background()
        self.jc = JClient(self.jd.endpoint)
        self.tc = TClient(self.td.endpoint)
        self.homes = (self.jeng.env.home, self.teng.env.home)

    def submit(self, comp, tid, kind="run"):
        plan_dir = str((REPO / "plans") / comp["global"]["plan"])
        for c in (self.jc, self.tc):
            got = getattr(c, kind)(comp, plan_dir=plan_dir,
                                   extra={"task_id": tid})
            assert got == tid

    def wait(self, tid, states=("complete", "canceled"), timeout=300):
        """Each side's task once it reaches one of ``states``."""
        out = []
        for c in (self.jc, self.tc):
            deadline = time.monotonic() + timeout
            while True:
                st = c.status(tid)
                if st["state"] in states:
                    out.append(st)
                    break
                assert time.monotonic() < deadline, (tid, st["state"])
                time.sleep(0.05)
        return out

    def run_dirs(self, tid):
        return [h / "data" / "outputs" / self.jc.status(tid)["plan"] / tid
                for h in self.homes]

    def views(self, tid):
        return [task_view(c.status(tid), h)
                for c, h in zip((self.jc, self.tc), self.homes)]

    def close(self):
        self.jd.close()
        self.td.close()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    with jax_on_one_device():
        p = Pair(tmp_path_factory.mktemp("daemons"), workers=2)
        try:
            yield p
        finally:
            p.close()


@pytest.fixture(scope="module")
def solo(tmp_path_factory):
    """A pair with one scheduler worker each (so a second task queues)."""
    with jax_on_one_device():
        p = Pair(tmp_path_factory.mktemp("solo"), workers=1)
        try:
            yield p
        finally:
            p.close()


def progress_rows(client, tid):
    rows = []
    client.progress(tid, on_snapshot=rows.append)
    return [{k: v for k, v in r.items() if k not in ROW_WALL_KEYS}
            for r in rows]


def tarball(client, tid):
    buf = io.BytesIO()
    client.collect_outputs(tid, buf)
    return buf.getvalue()


@pytest.mark.parametrize("name", list(CASES))
def test_daemon_runs_match_jax(pair, name, tmp_path):
    with jax_on_one_device():
        pair.submit(CASES[name], name)
        # both clients follow the log to completion
        outcomes = [c.wait(name) for c in (pair.jc, pair.tc)]
        jst, tst = pair.wait(name)
    assert outcomes[0] == outcomes[1]
    jv, tv = pair.views(name)
    assert tv == jv
    assert [s["state"] for s in tst["states"]] == [
        "scheduled", "processing", "complete"]
    s = assert_outputs_equal(tarball(pair.jc, name), tarball(pair.tc, name),
                             tmp_path, *pair.run_dirs(name))
    assert progress_rows(pair.tc, name) == progress_rows(pair.jc, name)
    if name == "ok":
        assert s["outcome"] == "success"
    if name == "stall":
        assert s["timed_out"]
    if name == "sweep":
        assert [r["seed"] for r in s["scenarios"]] == [0, 1]
    if name == "search":
        assert s["compiles"] == 1


def test_tasks_listing_matches_jax(pair):
    with jax_on_one_device():
        pair.submit(CASES["ok"], "listed")
        pair.wait("listed")
    rows = [[task_view(d, h) for d in c.tasks()]
            for c, h in zip((pair.jc, pair.tc), pair.homes)]
    assert rows[1] == rows[0]
    assert pair.tc.tasks(states=["complete"], limit=2) == pair.tc.tasks(
        states=["complete"], limit=2)[:2]
    assert len(pair.tc.tasks(limit=1)) == 1


def _memory(info):
    m = dict(info.get("memory") or {})
    m.pop("pool_depth", None)  # the JAX pool holds 2 executors a key
    return m


def test_cache_after_prewarm_and_the_pool_hit(pair):
    """The port's prewarm builds and captures into the in-memory pool, so
    the next run hits it; the JAX prewarm persists to its disk tier only
    (off here) and journals its own compile. After that first run, a
    repeat run hits each pool alike, and ``/cache`` reads alike."""
    with jax_on_one_device():
        pair.submit(CASES["storm"], "prewarm1", kind="prewarm")
        jp, tp = pair.wait("prewarm1")
        pair.submit(CASES["storm"], "warm1")
        pair.wait("warm1")
        before = [c.cache() for c in (pair.jc, pair.tc)]
        pair.submit(CASES["storm"], "warm2")
        jw, tw = pair.wait("warm2")
    assert jp["outcome"] == tp["outcome"] == "success"
    jv, tv = pair.views("prewarm1")
    jv["result"].pop("journal"), tv["result"].pop("journal")
    assert tv == jv
    assert tp["result"]["journal"]["prewarm"] is True
    t1 = pair.tc.status("warm1")["result"]["journal"]
    assert t1["hbm_preflight"]["executor_cache"] == "memory_hit"
    assert t1["compiles"] == 0
    after = [c.cache() for c in (pair.jc, pair.tc)]
    for k in ("dir", "enabled", "entries"):
        assert after[1][k] == after[0][k], k
    # the disk tier's counters are process-wide in the JAX package
    # (other tests of this process may have stored): what this test did
    # to them, and the port's, which has no disk tier
    disk = [{k: a["disk"][k] - b["disk"][k] for k in a["disk"]}
            for a, b in zip(after, before)]
    assert disk[1] == disk[0] == dict.fromkeys(after[0]["disk"], 0)
    assert after[1]["disk"] == disk[1]
    assert after[1]["enabled"] is False and after[1]["entries"] == []
    assert set(after[1]) == set(after[0])
    assert set(_memory(after[1])) == set(_memory(after[0]))
    deltas = [{k: _memory(a)[k] - _memory(b)[k]
               for k in ("memory_hits", "misses", "checkins")}
              for a, b in zip(after, before)]
    assert deltas[1] == deltas[0] == {"memory_hits": 1, "misses": 0,
                                      "checkins": 1}
    for st in (jw, tw):
        j = st["result"]["journal"]
        assert j["hbm_preflight"]["executor_cache"] == "memory_hit"
        assert j["compiles"] == 0
    assert after[1]["leases"] == after[0]["leases"] == {}
    jv, tv = pair.views("warm2")
    assert tv == jv


def _families(text):
    """{family: (type, {sample key: value})}, a sample's key being its
    suffixed name and its label set."""
    fams = tobs.parse_exposition(text)
    return {name: (f["type"], {(sname, frozenset(labels.items())): value
                               for sname, labels, value in f["samples"]})
            for name, f in fams.items()}


def _moved(before, after):
    """{family: the label sets of its samples that are new in ``after`` or
    changed value}: the series that the calls between the two reads
    produced (each package's registry is process-wide, so earlier tests
    of this process may have made others)."""
    out = {}
    for name, (_, samples) in after.items():
        old = before.get(name, (None, {}))[1]
        out[name] = {key[1] for key, v in samples.items()
                     if old.get(key) != v}
    return out


def test_metrics_families_and_labels_match_jax(pair):
    import urllib.request

    def read():
        got = []
        for d in (pair.jd, pair.td):
            with urllib.request.urlopen(d.endpoint + "/metrics") as r:
                assert r.headers["Content-Type"] == tobs.CONTENT_TYPE
                got.append(_families(r.read().decode()))
        return got

    before = read()
    # a run, and its repeat: a pool miss and a hit on each side
    with jax_on_one_device():
        for tid in ("metrics1", "metrics2"):
            pair.submit(CASES["ok"], tid)
            pair.wait(tid)
    jfam, tfam = read()
    jmoved, tmoved = (_moved(b, a) for b, a in zip(before, (jfam, tfam)))
    want = {"tg_task_transitions_total", "tg_excache_ops_total",
            "tg_lease_bytes_admitted_total", "tg_lease_wait_seconds_total",
            "tg_lease_overcommitted_total", "tg_lease_active_runs",
            "tg_run_chunk_seconds", "tg_watchdog_fires_total",
            "tg_task_retries_total", "tg_task_retries_exhausted_total",
            "tg_task_backoff_seconds_total", "tg_task_resumes_total",
            "tg_tasks_queue_depth", "tg_tasks_oldest_age_seconds"}
    assert want <= set(tfam) and want <= set(jfam)
    # only the families this test asks for or its own runs moved: a
    # family that another test of this process declared in the port's
    # registry shows up (HELP/TYPE) without being the daemon's
    for name in want | {n for n, s in tmoved.items() if s}:
        assert name in jfam, name
        assert tfam[name][0] == jfam[name][0], name
        # every series the port's runs produced is one the JAX daemon
        # shows (which may hold more)
        jlabels = {key[1] for key in jfam[name][1]}
        assert tmoved[name] <= jlabels, (name, tmoved[name] - jlabels)
    mem = {op: frozenset({("tier", "memory"), ("op", op)})
           for op in ("hit", "miss", "checkin")}
    assert set(mem.values()) <= {key[1] for key in
                                 tfam["tg_excache_ops_total"][1]}
    states = {frozenset({("state", s)})
              for s in ("processing", "complete")}
    for moved in (jmoved, tmoved):
        # the repeat is a pool hit, and each run checks its executor in
        # (the first may hit too: this file's daemons ran it before)
        assert {mem["hit"], mem["checkin"]} <= moved["tg_excache_ops_total"]
        assert states <= moved["tg_task_transitions_total"]


def _error(client, errcls, fn, *a, **kw):
    with pytest.raises(errcls) as e:
        fn(client, *a, **kw)
    return str(e.value)


def both_errors(pair, fn, *a, **kw):
    return (_error(pair.jc, JRPCError, fn, *a, **kw),
            _error(pair.tc, TRPCError, fn, *a, **kw))


def test_error_texts_match_jax(pair):
    plan = str((REPO / "plans") / "placebo")
    bad = composition("placebo", "ok", 2, runner="local:nosuch")
    j, t = both_errors(pair, lambda c: c.run(bad, plan_dir=plan))
    assert t == j == "unknown runner: local:nosuch"
    for d in (pair.jd, pair.td):
        d.env.runners["sim:jax"] = {"disabled": True}
    try:
        j, t = both_errors(pair, lambda c: c.run(CASES["ok"],
                                                  plan_dir=plan))
    finally:
        for d in (pair.jd, pair.td):
            d.env.runners.pop("sim:jax")
    assert t == j == "runner is disabled in configuration: sim:jax"
    j, t = both_errors(pair, lambda c: c.status("nosuch"))
    assert t == j == "no such task: nosuch"
    j, t = both_errors(pair, lambda c: c.kill("nosuch"))
    assert t == j
    j, t = both_errors(pair, lambda c: c.resume("nosuch"))
    assert t == j == "no such task: nosuch"
    for d in (pair.jd, pair.td):
        d.env.daemon.tokens = ["s3cret"]
    try:
        j, t = both_errors(pair, lambda c: c.tasks())
        assert t == j == "HTTP 401: unauthorized"
        assert (TClient(pair.td.endpoint, token="s3cret").tasks()
                is not None)
    finally:
        for d in (pair.jd, pair.td):
            d.env.daemon.tokens = []
    # a builder the manifest does not list fails the task alike
    nob = dict(CASES["ok"], **{"global": dict(CASES["ok"]["global"],
                                              builder="exec:nosuch")})
    with jax_on_one_device():
        pair.submit(nob, "nobuilder")
        jst, tst = pair.wait("nobuilder")
    assert tst["error"] == jst["error"]
    assert "plan does not support builder 'exec:nosuch'" in tst["error"]


def test_federation_routes_of_a_daemon_without_peers(pair):
    for c, d in ((pair.jc, pair.jd), (pair.tc, pair.td)):
        assert c.federation() == {"role": "standalone",
                                  "endpoint": d.endpoint}
    j, t = both_errors(pair, lambda c: c._call(
        "POST", "/federation/heartbeat", body=b"{}"))
    assert t == j == "not a federation coordinator (no [daemon] peers)"
    j, t = both_errors(pair, lambda c: c._call(
        "POST", "/federation/enroll", body=b"{}"))
    assert t == j == "enroll carries no coordinator endpoint"
    import urllib.request

    for d in (pair.jd, pair.td):
        with urllib.request.urlopen(d.endpoint + "/fleet") as r:
            assert "standalone" in r.read().decode()
    # a well-formed enroll makes either daemon a worker of that
    # coordinator (here a dead one: no heartbeat is delivered)
    body = (b'{"coordinator": "http://localhost:1", "worker": "w", '
            b'"interval": 60}')
    got = [c._call("POST", "/federation/enroll", body=body)
           for c in (pair.jc, pair.tc)]
    assert got[1] == got[0] == {"enrolled": "w",
                                "coordinator": "http://localhost:1"}
    try:
        infos = [c.federation() for c in (pair.jc, pair.tc)]
        for info, d in zip(infos, (pair.jd, pair.td)):
            assert info["role"] == "worker" and info["endpoint"] == d.endpoint
        assert infos[1]["enrolled"] == infos[0]["enrolled"] == {
            "coordinator": "http://localhost:1", "name": "w",
            "heartbeats_sent": 0, "interval_s": 60.0}
    finally:
        # back to standalone for the module's other tests
        for d in (pair.jd, pair.td):
            d._heartbeat.stop()
            d._heartbeat = None


def _running(pair, tid):
    """Wait until each side's run has streamed a snapshot (it is in its
    loop, past its build)."""
    deadline = time.monotonic() + 120
    for c in (pair.jc, pair.tc):
        while not progress_rows(c, tid):
            assert time.monotonic() < deadline, tid
            time.sleep(0.05)


def test_kill_delete_terminate_and_resume_match_jax(solo):
    pair = solo
    with jax_on_one_device():
        pair.submit(LONG, "long")
        pair.wait("long", states=("processing",))
        _running(pair, "long")
        # one worker is busy: this one queues, and kill cancels it
        pair.submit(CASES["ok"], "queued")
        for c in (pair.jc, pair.tc):
            assert c.kill("queued") == {"killed": "queued"}
        jq, tq = pair.wait("queued")
        assert jq["state"] == tq["state"] == "canceled"
        j, t = both_errors(pair, lambda c: c.delete("long"))
        assert t == j == "task is processing; kill it first"
        for c in (pair.jc, pair.tc):
            assert c.delete("queued") == {"deleted": "queued"}
            assert c.terminate("sim:jax") == 0
        j, t = both_errors(pair, lambda c: c.status("queued"))
        assert t == j
        # a kill of a running task terminates its run at a chunk
        # boundary
        for c in (pair.jc, pair.tc):
            assert c.kill("long") == {"killed": "long"}
        jl, tl = pair.wait("long")
    for st in (jl, tl):
        assert st["state"] == "canceled"
        assert st["result"]["outcome"] == "terminated"
        assert st["result"]["journal"]["ticks"] % 25 == 0

    # preempt_all, then resume: the resumed run ends as an
    # uninterrupted one
    with jax_on_one_device():
        pair.submit(LONG, "whole")
        pair.wait("whole")
        pair.submit(LONG, "preempted")
        pair.wait("preempted", states=("processing",))
        _running(pair, "preempted")
        assert pair.jeng.preempt_all() == 1 and pair.teng.preempt_all() == 1
        jp, tp = pair.wait("preempted")
        for st in (jp, tp):
            assert st["result"]["outcome"] == "preempted"
            assert st["input"]["resume"] is True
        for c in (pair.jc, pair.tc):
            assert c.resume("preempted") == {"resumed": "preempted"}
        jr, tr = pair.wait("preempted", timeout=300)
    for st in (jr, tr):
        assert [s["state"] for s in st["states"]] == [
            "scheduled", "processing", "complete", "scheduled",
            "processing", "complete"]
        assert st["result"]["journal"]["resumed_from_tick"] > 0
    assert jr["outcome"] == tr["outcome"]
    homes = dict(zip(("jax", "port"), pair.homes))
    dirs = {k: h / "data" / "outputs" / "placebo" for k, h in homes.items()}
    for k in dirs:
        assert output_files(dirs[k] / "preempted") == output_files(
            dirs[k] / "whole")
    assert output_files(dirs["port"] / "preempted") == output_files(
        dirs["jax"] / "preempted")
    assert run_out_lines(dirs["port"] / "preempted") == run_out_lines(
        dirs["jax"] / "preempted")


def test_pages_and_data_routes_answer_as_jax_does(pair):
    """The HTML pages (/dashboard, /live, /fleet, /measurements, /search)
    and the data routes (/journal, /data, /events) answer with the JAX
    daemon's status and content type; the dashboard lists the tasks."""
    import urllib.error
    import urllib.request

    with jax_on_one_device():
        pair.submit(CASES["ok"], "pages")
        pair.wait("pages")
    routes = ("/dashboard", "/live", "/fleet", "/measurements", "/search",
              "/journal?task_id=pages", "/journal?task_id=nosuch",
              "/data?series=results.placebo.nosuch", "/data",
              "/events?task_id=pages", "/nosuch")
    got = {}
    for side, d in (("jax", pair.jd), ("port", pair.td)):
        for r in routes:
            try:
                with urllib.request.urlopen(d.endpoint + r) as resp:
                    got[side, r] = (resp.status,
                                    resp.headers["Content-Type"],
                                    resp.read().decode())
            except urllib.error.HTTPError as e:
                got[side, r] = (e.code, e.headers["Content-Type"],
                                e.read().decode())
    for r in routes:
        j, t = got["jax", r], got["port", r]
        assert t[:2] == j[:2], r
    assert "pages" in got["port", "/dashboard"][2]
    assert "testground-tpu-torch" in got["port", "/dashboard"][2]
    assert got["port", "/journal?task_id=nosuch"][2] == got[
        "jax", "/journal?task_id=nosuch"][2]
    assert got["port", "/data"][2] == got["jax", "/data"][2]
    assert got["port", "/nosuch"][2] == got["jax", "/nosuch"][2]
    jj = json.loads(got["jax", "/journal?task_id=pages"][2])
    tj = json.loads(got["port", "/journal?task_id=pages"][2])
    assert set(tj) == set(jj) and tj["ticks"] == jj["ticks"]
