"""The port's federation plane (testground_tpu_torch/federation/) against
the JAX package's (testground_tpu/federation/), on the CPU, in one
process, on the pieces that are deterministic: the affinity digest of
every composition file under plans/, of one composition per test case of
every manifest, and of each with the program-shaping and host-only
tables added or the runtime tick knobs varied; the routing decision on
200 heartbeat-row sets made from a numpy seed; the heartbeat payload's
keys; the route table's records for the same submissions and its
survival across a coordinator restart; the requeue policy (JAX's
``TestRoutePersistence`` cases fed to both planes, the records compared
field for field but their deadlines); the prewarm validation's errors;
``fleet ls`` and ``fleet ls --json`` printed from one ``/federation``
JSON by both command lines; the ``[daemon]`` keys the port now takes
and the ones it still refuses; and the runner's affinity notes, which
name only executors its pool holds. The fleets of daemon processes are
tests/test_torch_federation_fleet.py."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import contextlib
import io
import json
import time
import tomllib
import types
from pathlib import Path

import numpy as np
import pytest

from testground_tpu.api import Composition as JComposition
from testground_tpu.cmd import root as jroot
from testground_tpu.federation import WorkerRegistry as JRegistry
from testground_tpu.federation import affinity_key as jaffinity
from testground_tpu.federation import heartbeat_payload as jpayload
from testground_tpu.federation.coordinator import FederationPlane as JPlane
from testground_tpu_torch import cli as tcli
from testground_tpu_torch.api import Composition as TComposition
from testground_tpu_torch.config import EnvConfig as TEnvConfig
from testground_tpu_torch.federation import WorkerRegistry as TRegistry
from testground_tpu_torch.federation import affinity_key as taffinity
from testground_tpu_torch.federation import heartbeat_payload as tpayload
from testground_tpu_torch.federation import notes
from testground_tpu_torch.federation.coordinator import (
    FederationPlane as TPlane,
)
from testground_tpu_torch.sim import runner as trunner

REPO = Path(__file__).resolve().parents[1]
COMPOSITION_FILES = sorted(REPO.glob("plans/*/composition.toml")) + sorted(
    REPO.glob("plans/_integrations/_compositions/*.toml"))
MANIFESTS = sorted(REPO.glob("plans/*/manifest.toml"))

# ------------------------------------------------------ the affinity digest


def _manifest_compositions():
    """One composition dict per test case of every manifest: the case's
    default instance count, its parameters' defaults as test params."""
    out = []
    for path in MANIFESTS:
        m = tomllib.loads(path.read_text())
        for tc in m.get("testcases", []):
            n = int((tc.get("instances") or {}).get("default", 1) or 1)
            params = {k: str(v.get("default", ""))
                      for k, v in (tc.get("params") or {}).items()
                      if isinstance(v, dict)}
            out.append((f"{m['name']}/{tc['name']}", {
                "metadata": {},
                "global": {"plan": m["name"], "case": tc["name"],
                           "runner": "sim:jax", "builder": "sim:module",
                           "total_instances": n,
                           "run_config": {"quantum_ms": 1.0}},
                "groups": [{"id": "single", "instances": {"count": n},
                            "run": {"test_params": params}}],
            }))
    return out


MANIFEST_COMPS = _manifest_compositions()
FILE_COMPS = [(p.relative_to(REPO).as_posix(),
               JComposition.load(p).to_dict()) for p in COMPOSITION_FILES]
# the tables a composition may carry: the program-shaping ones key the
# digest, [live] and [checkpoint] (host-only) do not
TABLES = {
    "sweep": {"seeds": 4},
    "faults": {"events": [{"kind": "partition", "at_ms": 100,
                           "a": "single", "b": "single"},
                          {"kind": "heal", "at_ms": 200, "a": "single",
                           "b": "single"}]},
    "trace": {"capacity": 64},
    "telemetry": {"interval": 10},
    "search": {"param": "x", "lo": 0.0, "hi": 1.0, "step": 0.25,
               "width": 4},
    "live": {"enabled": True, "interval": 0.0},
    "checkpoint": {"enabled": True, "interval": 0.0},
}


def _digests(d: dict) -> tuple:
    """(JAX's digest of the dict as the JAX daemon normalizes it, the
    port's as the port's daemon does)."""
    return (jaffinity(JComposition.from_dict(d).to_dict()),
            taffinity(TComposition.from_dict(d).to_dict()))


@pytest.mark.parametrize("name,comp", FILE_COMPS + MANIFEST_COMPS,
                         ids=[n for n, _ in FILE_COMPS + MANIFEST_COMPS])
def test_affinity_digest_equals_jax(name, comp):
    j, t = _digests(comp)
    assert t == j and len(t) == 32
    # the raw dict too: the digest is one function of the dict
    assert taffinity(comp) == jaffinity(comp)


@pytest.mark.parametrize("table", sorted(TABLES))
def test_affinity_digest_with_each_table_equals_jax(table):
    keyed = table not in ("live", "checkpoint")
    for name, comp in FILE_COMPS + MANIFEST_COMPS:
        base = _digests(comp)[1]
        with_table = {**comp, table: TABLES[table]}
        j, t = _digests(with_table)
        assert t == j, (name, table)
        assert (t != base) == keyed or table in comp, (name, table)


def test_affinity_digest_ignores_the_runtime_tick_knobs_as_jax():
    for name, comp in FILE_COMPS + MANIFEST_COMPS:
        base = _digests(comp)
        for knobs in ({"chunk_ticks": 50}, {"max_ticks": 123},
                      {"chunk_ticks": 7, "max_ticks": 99_999}):
            g = dict(comp["global"])
            g["run_config"] = {**(g.get("run_config") or {}), **knobs}
            assert _digests({**comp, "global": g}) == base, (name, knobs)


# ------------------------------------------------------------- routing


def _rowsets(seed=0, count=200):
    """Heartbeat-row sets: up to 5 workers, alive or stale, their cache
    keys, free bytes (None included, ties included), depths; the
    submission's affinity, ``exclude`` and ``extra_load``."""
    rng = np.random.default_rng(seed)
    keys = ["a", "b", "c"]
    for _ in range(count):
        k = int(rng.integers(0, 6))
        names = [f"w{j}" for j in rng.permutation(k)]
        rows = []
        for name in names:
            free = [None, 0, 10**6, 10**9, 10**9][int(rng.integers(0, 5))]
            rows.append((name, float(rng.uniform(0.0, 10.0)), {
                "endpoint": f"http://{name}",
                "cache_keys": [x for x in keys if rng.random() < 0.4],
                "lease": {"free_bytes": free},
                "queue_depth": int(rng.integers(0, 4)),
            }))
        affinity = ["", "a", "b", "c", "z"][int(rng.integers(0, 5))]
        exclude = {n for n in names if rng.random() < 0.2}
        extra = {n: int(rng.integers(0, 3)) for n in names
                 if rng.random() < 0.5}
        yield rows, affinity, exclude, extra


def _registry(cls, rows, now=100.0, stale_s=5.0):
    clock = [0.0]
    reg = cls(stale_s=stale_s, clock=lambda: clock[0])
    for name, age, payload in rows:
        clock[0] = now - age
        reg.update(name, payload)
    clock[0] = now
    return reg


def test_routing_equals_jax_on_seeded_rowsets():
    decided = set()
    for rows, affinity, exclude, extra in _rowsets():
        j = _registry(JRegistry, rows)
        t = _registry(TRegistry, rows)
        assert t.rows() == j.rows()
        assert t.lost() == j.lost()
        got = t.route(affinity, exclude=exclude, extra_load=extra)
        assert got == j.route(affinity, exclude=exclude, extra_load=extra)
        assert t.route(affinity) == j.route(affinity)
        decided.add(got is None)
    assert decided == {True, False}  # both outcomes were exercised


def test_staleness_threshold_reads_the_same_variable(monkeypatch):
    from testground_tpu.federation import stale_threshold_s as jstale
    from testground_tpu_torch.federation import stale_threshold_s as tstale

    for raw in ("", "2.5", "nope"):
        monkeypatch.setenv("TG_FED_STALE_S", raw)
        assert tstale() == jstale()


# ---------------------------------------------------- payloads and files


@pytest.fixture
def engines(tmp_path):
    from _runner_parity import engines as make

    j, t = make(tmp_path, workers=1)
    yield j, t
    j.close()
    t.close()


def test_heartbeat_payload_keys_equal_jax(engines):
    je, te = engines
    j = jpayload(je, "w", "http://h:1")
    t = tpayload(te, "w", "http://h:1")
    assert list(t) == list(j)
    for k in ("worker", "endpoint", "queue_depth", "tasks_processing"):
        assert t[k] == j[k], k
    assert set(t["lease"]) <= {"free_bytes", "budget_bytes",
                               "active_leases"}
    # this process never initialised CUDA: no fingerprint
    assert t["fingerprint"] == {}
    assert isinstance(t["cache_keys"], list)


def _stub_engine(path: Path):
    path.mkdir(parents=True, exist_ok=True)
    return types.SimpleNamespace(
        env=types.SimpleNamespace(dirs=types.SimpleNamespace(daemon=path)))


def _planes(tmp_path, clock=None, stale_s=5.0):
    """(JAX plane, port plane), each over its own daemon dir, their
    registries on one ``clock``."""
    out = []
    for cls, reg, side in ((JPlane, JRegistry, "jax"),
                           (TPlane, TRegistry, "port")):
        plane = cls(_stub_engine(tmp_path / side), ["localhost:1"],
                    "http://localhost:2")
        plane.registry = reg(stale_s=stale_s,
                             clock=clock or time.monotonic)
        out.append(plane)
    return out


SUBMISSIONS = [
    ("run", {"composition": {"global": {"plan": "placebo", "case": "ok"},
                             "groups": []},
             "priority": 2, "created_by": {"user": "u"}}, b"zip-bytes"),
    ("prewarm", {"composition": {"global": {"plan": "benchmarks",
                                            "case": "storm"}}}, None),
]


def _record_view(rec: dict) -> dict:
    """A route record but its id, its times and its zip's path."""
    return {k: (v is not None) if k == "zip" else v
            for k, v in rec.items()
            if k not in ("task_id", "created", "backoff_until")}


def test_route_records_equal_jax_for_the_same_submissions(tmp_path):
    jp, tp = _planes(tmp_path)
    for p in (jp, tp):
        p.registry.update("w1", {"endpoint": "http://w1"})
        p._dispatch = lambda route, worker, resume: None
    for kind, payload, zp in SUBMISSIONS:
        jt = jp.submit(kind, payload, zp)
        tt = tp.submit(kind, payload, zp)
        assert jt[1] == tt[1] == "w1"
        assert (_record_view(tp.route_record(tt[0]))
                == _record_view(jp.route_record(jt[0])))
    files = [json.loads((tmp_path / side / "federation_routes.json")
                        .read_text()) for side in ("jax", "port")]
    assert list(files[1]) == list(files[0]) == ["routes"]
    views = [sorted((_record_view(r) for r in f["routes"].values()),
                    key=lambda r: r["kind"]) for f in files]
    assert views[1] == views[0]
    assert all(set(r) == set(next(iter(files[0]["routes"].values())))
               for r in files[1]["routes"].values())
    # a no-live-worker submission falls back locally on both (None)
    for p in (jp, tp):
        p.registry.forget("w1")
    assert tp.submit(*SUBMISSIONS[0]) is jp.submit(*SUBMISSIONS[0]) is None


def test_route_table_survives_a_coordinator_restart(tmp_path):
    jp, tp = _planes(tmp_path)
    rec = {"task_id": "t-1", "kind": "run", "affinity": "a", "plan": "p",
           "case": "c", "payload": {"composition": {}}, "zip": None,
           "attempts": 1, "backoff_until": 0.0, "state": "scheduled",
           "outcome": "unknown", "error": "", "created": 5.0,
           "worker": "w1", "task": {"id": "t-1"}}
    for p in (jp, tp):
        with p._lock:
            p._routes["t-1"] = dict(rec)
        p._save_routes()
    again = [cls(_stub_engine(tmp_path / side), ["localhost:1"],
                 "http://localhost:2")
             for cls, side in ((JPlane, "jax"), (TPlane, "port"))]
    got = [p.route_record("t-1") for p in again]
    assert got[1] == got[0] and "task" not in got[1]
    assert got[1]["worker"] == "w1" and got[1]["attempts"] == 1
    assert [p.worker_endpoint("t-1") for p in again] == ["http://w1"] * 2


# ------------------------------------------------------ the requeue policy

BASE = {"task_id": "t-1", "kind": "run", "affinity": "", "plan": "p",
        "case": "c", "payload": {"composition": {}}, "zip": None,
        "attempts": 0, "backoff_until": 0.0, "state": "processing",
        "outcome": "unknown", "error": "", "created": 5.0}


def _two_phase(plane, clock, tmp, side):
    plane.registry.update("w-dead", {"endpoint": "http://dead"})
    plane._routes["t-1"] = {**BASE, "worker": "w-dead"}
    clock[0] += 10.0
    plane._requeue_lost()
    first = plane.route_record("t-1")
    assert first["backoff_until"] > time.time()
    plane._requeue_lost()  # before the deadline, and no survivor
    return [first, plane.route_record("t-1")]


def _exhausted(plane, clock, tmp, side):
    plane.registry.update("w-dead", {"endpoint": "http://dead"})
    plane._routes["t-1"] = {**BASE, "worker": "w-dead"}
    clock[0] += 10.0
    plane._requeue_lost()
    rec = plane.route_record("t-1")
    return [rec, plane.synthesized_task(rec)]


def _kill_requested(plane, clock, tmp, side):
    plane.registry.update("w-dead", {"endpoint": "http://dead"})
    plane._routes["t-1"] = {**BASE, "worker": "w-dead"}
    plane.mark_kill_requested("t-1")
    clock[0] += 10.0
    plane._requeue_lost()
    return [plane.route_record("t-1")]


def _failed_redispatch(plane, clock, tmp, side):
    plane.registry.update("w-ok", {"endpoint": "http://w-ok"})

    def boom(route, worker, resume):
        raise OSError("rejected")

    plane._dispatch = boom
    plane._routes["t-1"] = {**BASE, "attempts": 1,
                            "backoff_until": time.time() - 1.0,
                            "state": "requeued", "worker": "w-gone",
                            "from_worker": "w-gone"}
    plane._requeue_lost()
    return [plane.route_record("t-1")]


def _orphaned(plane, clock, tmp, side):
    plane._routes["t-1"] = {**BASE, "worker": "w-gone"}
    plane._requeue_lost()  # inside the post-boot grace
    first = plane.route_record("t-1")
    plane._started -= 10.0  # the grace has elapsed; w-gone never enrolled
    plane._requeue_lost()
    return [first, plane.route_record("t-1")]


def _one_worker_redispatch(plane, clock, tmp, side):
    plane.registry.update("w1", {"endpoint": "http://w1"})
    sent = []
    plane._dispatch = lambda r, w, resume: sent.append((w, resume))
    plane._routes["t-1"] = {**BASE, "attempts": 1,
                            "backoff_until": time.time() - 1.0,
                            "state": "requeued", "worker": "w1",
                            "from_worker": "w1"}
    plane._requeue_lost()
    return [plane.route_record("t-1"), sent]


def _fenced_once(plane, clock, tmp, side):
    plane.registry.update("w-back", {"endpoint": "http://w-back"})
    killed = []

    class Cli:
        def kill(self, tid):
            killed.append(tid)

    plane._client = lambda endpoint, timeout=5.0: Cli()
    plane._routes["t-1"] = {**BASE, "attempts": 1, "state": "scheduled",
                            "worker": "w-new", "from_worker": "w-back"}
    plane._fence_recovered()
    plane._fence_recovered()  # idempotent: fenced routes are skipped
    return [plane.route_record("t-1"), killed]


def _pruned(plane, clock, tmp, side):
    zips = []
    for i in range(3):
        zp = tmp / side / f"t-{i}.zip"
        zp.write_bytes(b"z")
        zips.append(zp)
        plane._routes[f"t-{i}"] = {**BASE, "task_id": f"t-{i}",
                                   "zip": str(zp), "state": "complete",
                                   "outcome": "success", "created": float(i),
                                   "worker": "w1"}
    plane._prune_terminal(keep=1)
    return [[plane.route_record(f"t-{i}") is None for i in range(3)],
            [z.exists() for z in zips]]


REQUEUE_CASES = {
    "two_phase_backoff": (_two_phase, {"TG_TASK_RETRY_BACKOFF_S": "30"}),
    "attempts_exhausted": (_exhausted, {"TG_TASK_MAX_ATTEMPTS": "1"}),
    "kill_requested_cancels": (_kill_requested, {}),
    "failed_redispatch_consumes_attempts": (_failed_redispatch,
                                            {"TG_TASK_MAX_ATTEMPTS": "2"}),
    "orphaned_route_after_restart": (_orphaned, {}),
    "one_worker_fleet_redispatch": (_one_worker_redispatch, {}),
    "recovered_owner_fenced_once": (_fenced_once, {}),
    "terminal_routes_pruned_with_zips": (_pruned, {}),
}


def _scrub(obj):
    """Records but their deadlines (a wall time each plane takes)."""
    if isinstance(obj, dict):
        return {k: _scrub(v) for k, v in obj.items()
                if k != "backoff_until"}
    if isinstance(obj, list):
        return [_scrub(v) for v in obj]
    return obj


@pytest.mark.parametrize("case", sorted(REQUEUE_CASES))
def test_requeue_policy_equals_jax(case, tmp_path, monkeypatch):
    fn, env = REQUEUE_CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    clock = [100.0]
    stale = 60.0 if case in ("failed_redispatch_consumes_attempts",
                             "one_worker_fleet_redispatch",
                             "recovered_owner_fenced_once") else 1.0
    if case == "orphaned_route_after_restart":
        stale = 5.0
    jp, tp = _planes(tmp_path, clock=lambda: clock[0], stale_s=stale)
    out = []
    for plane, side in ((jp, "jax"), (tp, "port")):
        clock[0] = 100.0
        out.append(_scrub(fn(plane, clock, tmp_path, side)))
    assert out[1] == out[0]
    # and the outcome JAX's own tests assert
    first = out[1][0]
    want = {
        "two_phase_backoff": lambda: (first["state"], first["attempts"],
                                      out[1][1]["state"])
        == ("requeued", 1, "requeued"),
        "attempts_exhausted": lambda: (first["state"], first["outcome"],
                                       out[1][1]["attempts"])
        == ("complete", "failure", 1) and "exhausted" in first["error"],
        "kill_requested_cancels": lambda: (first["state"], first["outcome"])
        == ("canceled", "canceled") and "killed" in first["error"],
        "failed_redispatch_consumes_attempts": lambda: (
            first["attempts"], first["state"], first["outcome"])
        == (2, "complete", "failure") and "re-dispatch" in first["error"],
        "orphaned_route_after_restart": lambda: (
            first["state"], out[1][1]["state"], out[1][1]["attempts"])
        == ("processing", "requeued", 1),
        "one_worker_fleet_redispatch": lambda: out[1][1] == [("w1", True)]
        and (first["state"], first["worker"]) == ("scheduled", "w1"),
        "recovered_owner_fenced_once": lambda: out[1][1] == ["t-1"]
        and first["fenced"] is True,
        "terminal_routes_pruned_with_zips": lambda: out[1]
        == [[True, True, False], [False, False, True]],
    }[case]
    assert want(), out[1]


# ----------------------------------------------------- prewarm validation


def test_prewarm_validation_errors_equal_jax(engines):
    from testground_tpu.engine import EngineError as JEngineError
    from testground_tpu_torch.engine import EngineError as TEngineError

    je, te = engines

    class NoPrewarm:
        pass

    for e in (je, te):
        e.runners["test:noprewarm"] = NoPrewarm()
    for runner in ("test:noprewarm", "local:nosuch"):
        d = {"global": {"plan": "placebo", "case": "ok", "runner": runner,
                        "builder": "sim:module", "total_instances": 1},
             "groups": [{"id": "single", "instances": {"count": 1}}]}
        with pytest.raises(JEngineError) as jerr:
            je.queue_prewarm(JComposition.from_dict(d))
        with pytest.raises(TEngineError) as terr:
            te.queue_prewarm(TComposition.from_dict(d))
        assert str(terr.value) == str(jerr.value)
    assert "does not support prewarm" in str(
        pytest.raises(TEngineError, te.queue_prewarm, TComposition.from_dict(
            {**d, "global": {**d["global"],
                             "runner": "test:noprewarm"}})).value)


# ------------------------------------------------------------- fleet ls

FLEET_INFO = {
    "role": "coordinator", "advertise": "http://c:8042",
    "peers": ["http://a:1", "http://b:2"], "heartbeat_interval_s": 0.25,
    "stale_after_s": 4.0, "endpoint": "http://c:8042",
    "workers": [
        {"worker": "http://a:1", "endpoint": "http://a:1",
         "heartbeat_age_s": 0.12, "alive": True, "queue_depth": 1,
         "lease": {"free_bytes": 67_371_380_326, "active_leases": 1},
         "cache_keys": ["k1", "k2"], "fingerprint": {}, "routed_tasks": 1},
        {"worker": "http://b:2", "endpoint": "http://b:2",
         "heartbeat_age_s": 6.4, "alive": False, "queue_depth": 0,
         "lease": {"free_bytes": None}, "cache_keys": [],
         "fingerprint": {}, "routed_tasks": 0},
    ],
    "routes": [
        {"task_id": "t1", "kind": "run", "worker": "http://a:1",
         "plan": "dht", "case": "find-providers", "state": "processing",
         "outcome": "unknown", "attempts": 0},
        {"task_id": "t2", "kind": "prewarm", "worker": "http://a:1",
         "plan": "benchmarks", "case": "storm", "state": "requeued",
         "outcome": "unknown", "attempts": 2},
        {"task_id": "t3", "kind": "run", "worker": "http://b:2",
         "plan": "placebo", "case": "ok", "state": "complete",
         "outcome": "success", "attempts": 0},
    ],
}
FLEET_VIEWS = {
    "coordinator": FLEET_INFO,
    "coordinator-empty": {**FLEET_INFO, "workers": [], "routes": []},
    "worker": {"role": "worker", "endpoint": "http://a:1",
               "enrolled": {"coordinator": "http://c:8042", "name": "a",
                            "heartbeats_sent": 12, "interval_s": 0.25}},
    "standalone": {"role": "standalone", "endpoint": "http://s:1"},
}


class _StubClient:
    def __init__(self, info, rows=()):
        self.info, self.rows = info, list(rows)

    def federation(self):
        return self.info

    def tasks(self, limit=0, state=None):
        return self.rows[:limit] if limit else self.rows


def _both(monkeypatch, argv, client=None):
    """(JAX command's (rc, stdout, stderr), the port's) for ``argv``,
    each with its ``_client`` answering from ``client``."""
    out = []
    for mod, main in ((jroot, jroot.main), (tcli, tcli.main)):
        if client is not None:
            monkeypatch.setattr(mod, "_client", lambda args, **kw: client)
        o, e = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(o), contextlib.redirect_stderr(e):
            rc = main(list(argv))
        out.append((rc, o.getvalue(), e.getvalue()))
    return out


@pytest.mark.parametrize("view", sorted(FLEET_VIEWS))
@pytest.mark.parametrize("json_flag", [False, True], ids=["table", "json"])
def test_fleet_ls_lines_equal_jax(view, json_flag, monkeypatch, tmp_path):
    monkeypatch.setenv("TESTGROUND_HOME", str(tmp_path))
    argv = ["--endpoint", "http://c:8042", "fleet", "ls"]
    j, t = _both(monkeypatch, argv + (["--json"] if json_flag else []),
                 _StubClient(FLEET_VIEWS[view]))
    assert t == j and t[0] == 0 and t[1]


def test_tasks_json_lines_equal_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("TESTGROUND_HOME", str(tmp_path))
    rows = [{"id": "t1", "type": "run", "plan": "placebo", "case": "ok",
             "state": "complete", "outcome": "success", "created": 1.5,
             "routed_to": "http://a:1", "attempts": 1,
             "backoff_until": 0.0, "states": [], "result": None}]
    j, t = _both(monkeypatch, ["--endpoint", "http://c:8042", "tasks",
                               "--json"], _StubClient({}, rows))
    assert t == j and t[0] == 0 and json.loads(t[1]) == rows


def test_fleet_ls_without_endpoint_exits_as_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("TESTGROUND_HOME", str(tmp_path))
    j, t = _both(monkeypatch, ["fleet", "ls"])
    assert t == j and t[0] == 2 and "--endpoint" in t[2]


# ----------------------------------------------------- the [daemon] keys


def _env_toml(tmp_path, body):
    home = tmp_path / "home"
    home.mkdir(exist_ok=True)
    (home / ".env.toml").write_text(body)
    return str(home)


def test_peers_and_advertise_load_as_jax(tmp_path):
    from testground_tpu.config import EnvConfig as JEnvConfig

    home = _env_toml(tmp_path, '[daemon]\npeers = ["10.0.0.5:8042", '
                     '"10.0.0.6:8042"]\nadvertise = "10.0.0.1:8042"\n')
    t, j = TEnvConfig.load(home).daemon, JEnvConfig.load(home).daemon
    assert (t.peers, t.advertise) == (j.peers, j.advertise) == (
        ["10.0.0.5:8042", "10.0.0.6:8042"], "10.0.0.1:8042")


@pytest.mark.parametrize("body", [
    '[daemon]\nexecutor_cache_shared_dir = "/mnt/shared"\n',
    '[daemon]\nexecutor_cache_dir = "/var/cache/tg"\n',
    '[daemon]\nexecutor_pool = 2\n',
], ids=["shared_dir", "cache_dir", "pool"])
def test_disk_tier_keys_still_raise_naming_11_3(tmp_path, body):
    with pytest.raises(NotImplementedError, match=r"\(11\.3\)") as e:
        TEnvConfig.load(_env_toml(tmp_path, body))
    assert "11.5b" not in str(e.value)


def test_daemon_with_peers_is_a_coordinator(tmp_path):
    from testground_tpu_torch.daemon import Daemon
    from testground_tpu_torch.engine import Engine
    from testground_tpu_torch.task import MemoryTaskStorage

    cfg = TEnvConfig.load(_env_toml(
        tmp_path, '[daemon]\npeers = ["localhost:1"]\n'))
    cfg.dirs.ensure()
    for kw in ({}, {"peers": ["localhost:1"], "advertise": "localhost:9"}):
        d = Daemon(engine=Engine(env_config=cfg, storage=MemoryTaskStorage(),
                                 workers=1, device="cpu"),
                   listen="localhost:0", **kw).start_background()
        try:
            info = d.federation_info()
            assert info["role"] == "coordinator"
            assert info["peers"] == ["http://localhost:1"]
            assert info["advertise"] == (kw and "http://localhost:9"
                                         or d.endpoint)
        finally:
            d.close()


# -------------------------------------------------- the runner's notes


class _Ex:
    captures = 0


@pytest.fixture
def empty_pool():
    trunner.clear_executor_pool()
    yield
    trunner.clear_executor_pool()


def test_notes_follow_the_pool(empty_pool, monkeypatch):
    trunner._executor_checkin("k1", _Ex(), {}, "aff-1")
    trunner._executor_checkin("k2", _Ex(), {}, "")  # no digest: no note
    assert notes.affinity_keys() == ["aff-1"]
    # checked out by a run: the next identical run would build its own
    entry, status = trunner._executor_checkout("k1")
    assert status == "memory_hit" and notes.affinity_keys() == []
    trunner._executor_checkin("k1", entry[0], entry[1], "aff-1")
    assert notes.affinity_keys() == ["aff-1"]
    # the pool's depth bound evicts the least recently used
    for i in range(trunner._EXECUTOR_CACHE_N):
        trunner._executor_checkin(f"x{i}", _Ex(), {}, f"aff-x{i}")
    assert notes.affinity_keys() == [
        f"aff-x{i}" for i in range(trunner._EXECUTOR_CACHE_N)]
    # evicted to make room for a run
    monkeypatch.setenv("TESTGROUND_HBM_BYTES", "1000")
    report = {"state_model_bytes_per_device": 10**6}
    assert trunner._make_room(report, "cpu", lambda m: None)
    assert notes.affinity_keys() == []
    trunner._executor_checkin("k3", _Ex(), {}, "aff-3")
    trunner.clear_executor_pool()
    assert notes.affinity_keys() == []


def test_prewarm_notes_and_journals_as_jax(empty_pool, tmp_path):
    """A prewarm's journal carries JAX's keys (``persisted_local`` and
    ``persisted_shared`` false: no disk tier) and its digest, which the
    pool's note then names."""
    from _runner_parity import rinputs

    _, ri = rinputs("placebo", "ok", [("single", 2, {})],
                    tmp_path / "j", tmp_path / "t")
    ri.affinity = "aff-pw"
    j = trunner.prewarm_composition(ri, device="cpu").result.journal
    assert list(j) == ["prewarm", "executor_cache", "compiles",
                       "compile_seconds", "persisted_local",
                       "persisted_shared", "hbm_preflight", "affinity"]
    assert j["persisted_local"] is j["persisted_shared"] is False
    assert j["affinity"] == "aff-pw"
    assert notes.affinity_keys() == ["aff-pw"]
    again = trunner.prewarm_composition(ri, device="cpu").result.journal
    assert again["executor_cache"] == "memory_hit"
    assert notes.affinity_keys() == ["aff-pw"]
