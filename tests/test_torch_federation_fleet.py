"""A fleet of the port's daemons on the CPU: a coordinator and two workers
(``python -m testground_tpu_torch daemon --device cpu``, the coordinator
with a ``--peer`` for each), each a process of its own, as
``bench.Fleet`` starts them; the placebo, example and benchmarks plans at
small N go through the coordinator's client. It shows what JAX's
``tests/test_federation.py`` asserts of a fleet: a submission that
already carries ``routed_to`` runs where it lands; a run routes to a
worker, and ``/status``, ``/logs``, ``/outputs`` and ``/tasks`` proxy or
merge, ``/metrics`` merges every worker's families under ``worker=``;
the ``/federation`` surface has JAX's keys on both roles; ``kill``
proxies to the owning worker and the task ends ``canceled``; with no
live worker the coordinator runs the submission itself (``routed_to:
""``); ``logs --since``; ``tasks --json`` printed by JAX's command line
and the port's from the same coordinator; compile-on-upload (a routed
prewarm, then the run that routes to its worker by affinity and journals
``memory_hit``, ``compiles: 0`` and ``routed_to``, its results.out byte
for byte an in-process run's); ``bench --feder`` at 16 instances; and a
worker killed mid-run, whose run the coordinator requeues on the
survivor, where it completes with an in-process run's files. Every wait
is on a state, never a sleep."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import contextlib
import io
import json
import tarfile
import time
import urllib.request
from pathlib import Path

import pytest

from testground_tpu_torch import bench
from testground_tpu_torch import obs as tobs
from testground_tpu_torch.client import Client
from testground_tpu_torch.runner.outputs import output_files, run_out_lines

REPO = Path(__file__).resolve().parents[1]
# the daemons' dispatch heartbeat off (its progress rows count wall
# time), one torch thread each
ENV = {"TG_DISPATCH_HEARTBEAT_S": "86400", "OMP_NUM_THREADS": "1"}


def composition(plan, case, n, params=None, run_config=None) -> dict:
    g = {"plan": plan, "case": case, "runner": "sim:jax",
         "builder": "sim:module", "total_instances": n,
         "run_config": dict(run_config or {})}
    grp = {"id": "single", "instances": {"count": n},
           "run": {"test_params": {k: str(v)
                                   for k, v in (params or {}).items()}}}
    return {"metadata": {}, "global": g, "groups": [grp]}


def plan_dir(comp) -> str:
    return str(REPO / "plans" / comp["global"]["plan"])


OK = composition("placebo", "ok", 3)
SYNC = composition("example", "sync", 5)


def long_run(rounds=10) -> dict:
    """The sparsetimer at 4, dense, 50-tick chunks: ~100 ticks a round,
    seconds of CPU, a chunk boundary every 50 ticks."""
    comp = bench.feder_composition(4, 100, rounds, chunk_ticks=50)
    comp["global"]["run_config"]["event_skip"] = False
    return comp


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    f = bench.Fleet(tmp_path_factory.mktemp("fleet"), 2, "cpu", ENV)
    try:
        f.wait_alive()
        yield f
    finally:
        f.close()


def _tar_contents(buf: io.BytesIO) -> dict:
    out = {}
    with tarfile.open(fileobj=io.BytesIO(buf.getvalue())) as tf:
        for m in tf.getmembers():
            if m.isfile():
                out[m.name] = tf.extractfile(m).read()
    return out


def _scrape(endpoint) -> dict:
    with urllib.request.urlopen(endpoint + "/metrics", timeout=30) as r:
        assert r.headers["Content-Type"] == tobs.CONTENT_TYPE
        return tobs.parse_exposition(r.read().decode())


def test_an_already_routed_submission_runs_where_it_lands(fleet):
    cli = fleet.client()
    tid = cli.run(OK, plan_dir=plan_dir(OK),
                  extra={"task_id": "routed-1", "routed_to": "http://origin"})
    assert tid == "routed-1"
    st = bench.wait_task(cli, tid)
    assert st["outcome"] == "success" and st["routed_to"] == "http://origin"
    # it ran on the coordinator, which routed nothing
    assert Path(fleet.coordinator.run_dir("placebo", tid)).is_dir()
    assert not any(Path(w.run_dir("placebo", tid)).exists()
                   for w in fleet.workers)
    assert tid not in {r["task_id"] for r in cli.federation()["routes"]}


def test_route_proxy_and_metrics_merge(fleet):
    cli = fleet.client()
    workers = {w.endpoint() for w in fleet.workers}
    for comp in (OK, SYNC):
        tid = cli.run(comp, plan_dir=plan_dir(comp))
        lines = []
        assert cli.logs(tid, follow=True,
                        on_line=lines.append)["outcome"] == "success"
        assert any("sim:torch done: outcome=success" in ln for ln in lines)
        st = cli.status(tid)
        assert st["state"] == "complete" and st["routed_to"] in workers
        assert st["result"]["journal"]["routed_to"] == st["routed_to"]
        owner = fleet.by_endpoint(st["routed_to"])
        assert Path(owner.run_dir(comp["global"]["plan"], tid)).is_dir()
        assert not Path(fleet.coordinator.run_dir(
            comp["global"]["plan"], tid)).exists()
        mine = [d for d in cli.tasks() if d["id"] == tid]
        assert mine and mine[0]["routed_to"] == st["routed_to"]
        via_coord, via_worker = io.BytesIO(), io.BytesIO()
        cli.collect_outputs(tid, via_coord)
        Client(st["routed_to"]).collect_outputs(tid, via_worker)
        assert _tar_contents(via_coord) == _tar_contents(via_worker)
        assert any(m.endswith("results.out")
                   for m in _tar_contents(via_coord))
    fams = _scrape(fleet.coordinator.endpoint())
    routes = fams["tg_fed_routes_total"]["samples"]
    assert fams["tg_fed_routes_total"]["type"] == "counter"
    assert routes and all(lab.get("worker") in workers
                          for _, lab, _ in routes)
    assert sum(v for _, _, v in routes) >= 2
    sources = {lab.get("worker")
               for _, lab, _ in fams["tg_tasks_queue_depth"]["samples"]}
    assert sources == {None} | workers
    assert any(lab.get("state") == "complete" and lab.get("worker")
               for _, lab, _ in
               fams["tg_task_transitions_total"]["samples"])
    html = urllib.request.urlopen(fleet.coordinator.endpoint()
                                  + "/fleet").read().decode()
    assert "workers" in html and all(w.split("//")[1] in html
                                     for w in workers)


def _keys(d):
    return set(d)


def test_federation_surface_keys_equal_jax(fleet, tmp_path):
    """The coordinator's and a worker's ``/federation`` against the JAX
    package's on the same state: a plane whose registry holds one JAX
    heartbeat and one route, and a JAX daemon enrolled as a worker."""
    from testground_tpu.config import EnvConfig as JEnvConfig
    from testground_tpu.daemon import Daemon as JDaemon
    from testground_tpu.engine import Engine as JEngine
    from testground_tpu.federation import heartbeat_payload
    from testground_tpu.federation.coordinator import FederationPlane
    from testground_tpu.task import MemoryTaskStorage

    cfg = JEnvConfig.load(str(tmp_path / "jax"))
    cfg.dirs.ensure()
    jd = JDaemon(engine=JEngine(env_config=cfg, storage=MemoryTaskStorage(),
                                workers=1),
                 listen="localhost:0").start_background()
    try:
        plane = FederationPlane(jd.engine, ["localhost:1"], jd.endpoint)
        plane.registry.update("w", heartbeat_payload(jd.engine, "w",
                                                     "http://w"))
        plane._routes["t"] = {"task_id": "t", "kind": "run", "worker": "w",
                              "attempts": 0, "state": "processing"}
        jinfo = {**plane.info(), "endpoint": jd.endpoint}
        jd.ensure_heartbeat("http://localhost:1", "w", 60.0)
        jworker = jd.federation_info()
    finally:
        jd.close()
    cli = fleet.client()
    bench.wait_task(cli, cli.run(OK, plan_dir=plan_dir(OK)))
    info = cli.federation()
    assert _keys(info) == _keys(jinfo)
    assert info["role"] == jinfo["role"] == "coordinator"
    assert info["peers"] == [w.endpoint() for w in fleet.workers]
    w = info["workers"][0]
    assert _keys(w) == _keys(jinfo["workers"][0])
    assert w["alive"] and w["heartbeat_age_s"] < 4.0
    assert _keys(w["lease"]) <= {"free_bytes", "budget_bytes",
                                 "active_leases"}
    assert w["fingerprint"] == {}  # a CPU worker never initialises CUDA
    assert info["routes"] and all(_keys(r) == _keys(jinfo["routes"][0])
                                  for r in info["routes"])
    winfo = Client(fleet.workers[0].endpoint()).federation()
    assert _keys(winfo) == _keys(jworker)
    assert winfo["role"] == jworker["role"] == "worker"
    assert _keys(winfo["enrolled"]) == _keys(jworker["enrolled"])
    assert winfo["enrolled"]["coordinator"] == fleet.coordinator.endpoint()
    assert winfo["enrolled"]["heartbeats_sent"] >= 1


def test_kill_proxies_to_the_owning_worker(fleet):
    cli = fleet.client()
    comp = long_run()
    tid = cli.run(comp, plan_dir=plan_dir(comp))
    bench.wait_task(cli, tid, states=("processing",))
    assert cli.kill(tid) == {"killed": tid}
    st = bench.wait_task(cli, tid)
    assert st["state"] == "canceled"
    assert st["result"]["outcome"] == "terminated"
    owner = Client(st["routed_to"]).status(tid)
    assert owner["state"] == "canceled"


def test_no_live_worker_queues_locally(tmp_path):
    d = bench.DaemonProcess(tmp_path / "lonely", "cpu", ["127.0.0.1:1"], ENV)
    try:
        cli = d.client()
        tid = cli.run(OK, plan_dir=plan_dir(OK))
        st = bench.wait_task(cli, tid)
        assert st["outcome"] == "success" and st["routed_to"] == ""
        assert Path(d.run_dir("placebo", tid)).is_dir()
        assert cli.federation()["routes"] == []
    finally:
        assert d.stop() == 0


def test_logs_since_skips_a_prefix(fleet):
    cli = fleet.client()
    tid = cli.run(OK, plan_dir=plan_dir(OK))
    st = bench.wait_task(cli, tid)
    every, tail = [], []
    cli.logs(tid, on_line=every.append)
    res = Client(st["routed_to"])._call(
        "GET", "/logs", query={"task_id": tid, "since": "2"},
        on_progress=tail.append)
    assert tail == every[2:] and res["lines"] == len(every)
    # the same through the coordinator's proxy
    tail2 = []
    cli._call("GET", "/logs", query={"task_id": tid, "since": "2"},
              on_progress=tail2.append)
    assert tail2 == tail


def test_tasks_json_and_fleet_ls_lines_equal_jax(fleet, monkeypatch,
                                                 tmp_path):
    from testground_tpu.cmd.root import main as jmain
    from testground_tpu_torch.cli import main as tmain

    monkeypatch.setenv("TESTGROUND_HOME", str(tmp_path))
    cli = fleet.client()
    tid = cli.run(OK, plan_dir=plan_dir(OK))
    bench.wait_task(cli, tid)
    # the coordinator's route record takes the worker's row at its next
    # tick; until then /tasks shows the record's own fields
    deadline = time.monotonic() + 60
    while {r["task_id"]: r["state"] for r in cli.federation()["routes"]
           }.get(tid) != "complete":
        assert time.monotonic() < deadline
        time.sleep(0.05)

    def both(*argv):
        out = []
        for main in (jmain, tmain):
            o, e = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(o), contextlib.redirect_stderr(e):
                rc = main(["--endpoint", fleet.coordinator.endpoint(),
                           *argv])
            out.append((rc, o.getvalue(), e.getvalue()))
        return out

    j, t = both("tasks", "--json")
    assert t == j and t[0] == 0
    rows = json.loads(t[1])
    assert any(d.get("routed_to") for d in rows)
    assert all("attempts" in d and "backoff_until" in d for d in rows)
    j, t = both("fleet", "ls")
    assert t[0] == j[0] == 0
    # the rows' heartbeat ages move between the two reads: the role line
    # and the shape of the table
    assert t[1].splitlines()[0] == j[1].splitlines()[0] == (
        f"role: coordinator  endpoint: {fleet.coordinator.endpoint()}")
    assert len(t[1].splitlines()) == len(j[1].splitlines())
    assert all(w.endpoint().split("//")[1] in t[1] for w in fleet.workers)


def test_compile_on_upload(fleet, tmp_path):
    """A prewarm routed to a worker (a miss), then the run, which routes
    there by the digest the worker's heartbeat names: memory_hit,
    compiles 0, routed_to; results.out and run.out byte for byte an
    in-process run's."""
    comp = bench.feder_composition(8, 50, 4)
    a = bench.compile_on_upload(fleet, comp, tmp_path)
    j = a["run"]["result"]["journal"]
    assert j["routed_to"] == a["prewarm"]["routed_to"]
    assert a["prewarm"]["result"]["journal"]["persisted_local"] is False
    ref = tmp_path / "in-process"
    bench.in_process_run(comp, ref, "cpu")
    files = output_files(ref)
    assert files and output_files(a["dir"]) == files
    assert run_out_lines(a["dir"]) == run_out_lines(ref)


def test_bench_feder_leg():
    """``bench --feder`` at 16 instances (4 beats): leg (a) on its own
    fleet, leg (b) on a two-worker and a one-worker fleet, every daemon
    stopped with exit 0."""
    line = bench.feder_leg(n=16, device="cpu", rounds=4)
    assert line["prewarmed_first_run_executor_cache"] == "memory_hit"
    assert line["prewarmed_first_run_compiles"] == 0
    assert line["fleet_measured"] and line["workers_used_2w"] == 2
    assert line["wall_2workers_s"] > 0 and line["wall_1worker_s"] > 0


def test_a_killed_workers_run_is_requeued_on_the_survivor(fleet, tmp_path):
    """Last in this file: it SIGKILLs a worker of the module's fleet."""
    cli = fleet.client()
    comp = long_run()
    tid = cli.run(comp, plan_dir=plan_dir(comp))
    deadline = time.monotonic() + 120
    owner = None
    while owner is None:
        r = {x["task_id"]: x for x in cli.federation()["routes"]}.get(tid, {})
        if r.get("state") == "processing":
            owner = r["worker"]
        assert time.monotonic() < deadline, r
        time.sleep(0.05)
    fleet.by_endpoint(owner).kill()
    st = bench.wait_task(cli, tid, timeout=300)
    assert st["outcome"] == "success", (st["outcome"], st.get("error"))
    assert st["routed_to"] not in ("", owner)
    assert st["attempts"] >= 1
    assert st["result"]["journal"]["attempt"] >= 1
    alive = {w["worker"]: w["alive"] for w in cli.federation()["workers"]}
    assert alive[owner] is False and alive[st["routed_to"]] is True
    fams = _scrape(fleet.coordinator.endpoint())
    assert sum(v for _, _, v in
               fams["tg_fed_requeues_total"]["samples"]) >= 1
    got = Path(fleet.by_endpoint(st["routed_to"]).run_dir("benchmarks", tid))
    ref = tmp_path / "in-process"
    bench.in_process_run(comp, ref, "cpu")
    files = output_files(ref)
    assert files and output_files(got) == files
