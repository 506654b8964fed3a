"""Coordinator side of the federation plane: routing + fleet health (a
copy of ``testground_tpu/federation/coordinator.py``).

A daemon configured with ``[daemon] peers`` (or repeated ``--peer``
flags) runs one of these next to its engine. It:

- ENROLLS each peer (``POST /federation/enroll`` with a callback
  endpoint), after which the peer heartbeats back into the
  :class:`~testground_tpu_torch.federation.registry.WorkerRegistry`;
- ROUTES every submitted RUN/PREWARM task to the best worker
  (cache-affinity first, headroom second — registry.route), forwarding
  the original submission (composition + uploaded plan zip) with a
  coordinator-minted task id, so the id stays stable across requeues
  and the proxy endpoints know where to dial;
- TRACKS each routed task (the route table is persisted to
  ``<daemon dir>/federation_routes.json`` atomically, surviving
  coordinator restarts) and lazily refreshes its state from the owning
  worker;
- REQUEUES a lost worker's in-flight tasks on survivors with the
  durability plane's attempts/backoff policy (TG_TASK_MAX_ATTEMPTS /
  TG_TASK_RETRY_BACKOFF_S — the same knobs the wedged-dispatch retry
  uses), submitting with ``resume=true`` so a run whose run dir lives
  on shared storage continues from its checkpoint and any other run
  restarts fresh.

A routed task that fails on its worker fails: the coordinator never
reruns it itself. The coordinator stays a fully-functional daemon: with
no live worker (fleet booting, every peer down) submissions fall back to
its local queue, on its own device, so a one-node "fleet" degrades to
exactly the single-daemon behavior.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

from ..obs import REGISTRY as _OBS
from ..utils.ids import new_id
from .affinity import affinity_key
from .registry import WorkerRegistry

# route states that need no further attention
_TERMINAL = ("complete", "canceled")

# fleet metrics plane (docs/observability.md): the coordinator's own
# families. Worker-labeled staleness is a scrape-time collector (one
# gauge sample per registry row), registered per plane in start().
_M_ROUTES = _OBS.counter(
    "tg_fed_routes_total",
    "Tasks dispatched to a worker by the coordinator, by worker.",
)
_M_REQUEUES = _OBS.counter(
    "tg_fed_requeues_total",
    "Routes of lost workers marked for re-dispatch (two-phase requeue).",
)
_M_FENCES = _OBS.counter(
    "tg_fed_fences_total",
    "Superseded attempts killed on recovered workers.",
)
_M_HEARTBEATS = _OBS.counter(
    "tg_fed_heartbeats_total",
    "Worker heartbeats received, by worker.",
)
_M_STALENESS = _OBS.gauge(
    "tg_fed_heartbeat_staleness_seconds",
    "Seconds since each enrolled worker's last heartbeat.",
)


def heartbeat_interval_s() -> float:
    """Fleet heartbeat cadence (``TG_FED_HEARTBEAT_S``); also the
    monitor thread's tick."""
    raw = os.environ.get("TG_FED_HEARTBEAT_S", "")
    try:
        return max(0.05, float(raw)) if raw else 2.0
    except ValueError:
        return 2.0


def _normalize(peer: str) -> str:
    peer = peer.strip().rstrip("/")
    if not peer:
        return peer
    if not peer.startswith("http://") and not peer.startswith("https://"):
        peer = f"http://{peer}"
    return peer


class FederationPlane:
    def __init__(
        self,
        engine,
        peers: list[str],
        advertise: str,
        token: str = "",
    ) -> None:
        self.engine = engine
        self.peers = [_normalize(p) for p in peers if p.strip()]
        self.advertise = _normalize(advertise)
        self.token = token
        self.registry = WorkerRegistry()
        self._lock = threading.RLock()
        self._routes: dict[str, dict] = {}
        daemon_dir = Path(engine.env.dirs.daemon)
        self._routes_path = daemon_dir / "federation_routes.json"
        self._zip_dir = daemon_dir / "federation"
        self._enrolled_at: dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._started = time.monotonic()
        self._load_routes()

    # ------------------------------------------------------------ plumbing

    def _client(self, endpoint: str, timeout: float = 10.0):
        from ..client import Client

        return Client(endpoint, token=self.token, timeout=timeout)

    def _load_routes(self) -> None:
        try:
            data = json.loads(self._routes_path.read_text())
            self._routes = {
                tid: r for tid, r in (data.get("routes") or {}).items()
            }
        except (OSError, ValueError):
            self._routes = {}

    def _save_routes(self) -> None:
        """Atomic (write-temp-rename, the durability-plane pattern): a
        coordinator crash mid-save must never tear the route table —
        it IS the memory of which worker owns which task."""
        with self._lock:
            slim = {
                tid: {k: v for k, v in r.items() if k != "task"}
                for tid, r in self._routes.items()
            }
        try:
            self._routes_path.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(
                dir=self._routes_path.parent, prefix=".fedroutes-"
            )
            with os.fdopen(fd, "w") as f:
                json.dump({"routes": slim}, f)
            os.replace(tmp, self._routes_path)
        except OSError:
            pass  # best-effort: in-memory table still authoritative

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "FederationPlane":
        self._thread = threading.Thread(target=self._monitor, daemon=True)
        self._thread.start()
        _OBS.register_collector(self._collect_fleet_metrics)
        return self

    def close(self) -> None:
        _OBS.unregister_collector(self._collect_fleet_metrics)
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)

    def _collect_fleet_metrics(self) -> None:
        """Scrape-time per-worker heartbeat staleness for GET /metrics."""
        for row in self.registry.rows():
            _M_STALENESS.set(
                round(float(row.get("heartbeat_age_s", 0.0)), 3),
                worker=row["worker"],
            )

    # ------------------------------------------------------------ heartbeat

    def heartbeat(self, payload: dict) -> str:
        name = str(payload.get("worker") or payload.get("endpoint") or "")
        if not name:
            raise ValueError("heartbeat carries no worker name")
        self.registry.update(name, payload)
        _M_HEARTBEATS.inc(worker=name)
        return name

    def _enroll(self, peer: str) -> None:
        """Introduce ourselves to a peer so it starts heartbeating.
        Idempotent — the worker retargets its existing loop."""
        try:
            self._client(peer, timeout=3.0)._call(
                "POST",
                "/federation/enroll",
                body=json.dumps(
                    {
                        "coordinator": self.advertise,
                        "worker": peer,
                        "interval": heartbeat_interval_s(),
                    }
                ).encode(),
            )
        except Exception:  # noqa: BLE001 — peer down: retried next tick
            pass
        self._enrolled_at[peer] = time.monotonic()

    def _monitor(self) -> None:
        tick = heartbeat_interval_s()
        while not self._stop.is_set():
            try:
                self._tick()
            except Exception:  # noqa: BLE001 — the fleet loop must live
                pass
            self._stop.wait(tick)

    def _tick(self) -> None:
        now = time.monotonic()
        fresh = {r["worker"] for r in self.registry.alive()}
        for peer in self.peers:
            # (re-)enroll peers that aren't heartbeating — covers both
            # boot and a restarted worker that forgot its coordinator;
            # throttled so a dead peer isn't hammered
            if peer not in fresh and (
                now - self._enrolled_at.get(peer, -1e9)
                >= self.registry.stale_s
            ):
                self._enroll(peer)
        # requeue runs FIRST: it reads only heartbeat staleness (plus
        # last tick's refresh verdicts), so a slow worker dragging the
        # serial status sweep below can never starve the failure path
        self._requeue_lost()
        self._refresh_routes()
        self._fence_recovered()
        self._prune_terminal()

    # ------------------------------------------------------------ submit

    def submit(
        self, kind: str, payload: dict, plan_zip: Optional[bytes]
    ) -> Optional[tuple[str, str]]:
        """Route one /run or /prewarm submission. Returns (task id,
        worker name), or None when no live worker accepted it (the
        caller queues locally)."""
        comp = payload.get("composition") or {}
        aff = affinity_key(comp)
        tid = new_id()
        route = {
            "task_id": tid,
            "kind": kind,
            "affinity": aff,
            "plan": (comp.get("global") or {}).get("plan", ""),
            "case": (comp.get("global") or {}).get("case", ""),
            "payload": {
                "composition": comp,
                "priority": int(payload.get("priority", 0)),
                "created_by": payload.get("created_by") or {},
            },
            "zip": None,
            "attempts": 0,
            "backoff_until": 0.0,
            "state": "scheduled",
            "outcome": "unknown",
            "error": "",
            "created": time.time(),
        }
        if plan_zip:
            self._zip_dir.mkdir(parents=True, exist_ok=True)
            zp = self._zip_dir / f"{tid}.zip"
            zp.write_bytes(plan_zip)
            route["zip"] = str(zp)
        excluded: set = set()
        while True:
            worker = self.registry.route(
                aff, exclude=excluded, extra_load=self._inflight()
            )
            if worker is None:
                self._drop_zip(route)  # local fallback: zip is orphaned
                return None
            try:
                self._dispatch(route, worker, resume=False)
            except Exception:  # noqa: BLE001 — dead worker: try the next
                # the forward MAY have landed (e.g. a timeout after the
                # worker accepted): best-effort kill so an
                # accepted-but-unacked attempt never executes alongside
                # the next dispatch of the same task id
                try:
                    ep = self.registry.endpoint(worker) or worker
                    self._client(ep, timeout=5.0).kill(route["task_id"])
                except Exception:  # noqa: BLE001
                    pass
                excluded.add(worker)
                continue
            with self._lock:
                route["worker"] = worker
                self._routes[tid] = route
            self._save_routes()
            _M_ROUTES.inc(worker=worker)
            return tid, worker

    def _dispatch(self, route: dict, worker: str, resume: bool) -> None:
        """Forward the stored submission to ``worker`` under the
        coordinator-minted task id."""
        endpoint = self.registry.endpoint(worker) or worker
        zip_bytes = None
        if route.get("zip"):
            try:
                zip_bytes = Path(route["zip"]).read_bytes()
            except OSError:
                zip_bytes = None
        extra = {
            "task_id": route["task_id"],
            "routed_to": worker,
            "attempts": int(route.get("attempts", 0)),
            "resume": bool(resume),
        }
        cli = self._client(endpoint, timeout=30.0)
        cli._queue(
            route["kind"],
            route["payload"]["composition"],
            plan_zip=zip_bytes,
            priority=route["payload"].get("priority", 0),
            created_by=route["payload"].get("created_by") or {},
            extra=extra,
        )

    def _drop_zip(self, route: dict) -> None:
        """A terminal (or locally-queued) route no longer needs its
        forwarded plan zip."""
        zp = route.pop("zip", None) if route.get("zip") else None
        if zp:
            try:
                Path(zp).unlink()
            except OSError:
                pass

    def _prune_terminal(self, keep: int = 256) -> None:
        """Bound the route table: terminal routes beyond the ``keep``
        most recent are dropped (with their zips) — without this the
        table, its atomic rewrite, and /federation grow forever on a
        long-lived coordinator."""
        with self._lock:
            done = sorted(
                (
                    r
                    for r in self._routes.values()
                    if r.get("state") in _TERMINAL
                ),
                key=lambda r: r.get("created", 0.0),
            )
            victims = done[: max(0, len(done) - keep)]
            for r in victims:
                self._routes.pop(r["task_id"], None)
        for r in victims:
            self._drop_zip(r)
        if victims:
            self._save_routes()

    def _inflight(self) -> dict:
        """Non-terminal routed tasks per worker — the router's
        between-heartbeats load correction (registry.route
        ``extra_load``)."""
        with self._lock:
            out: dict = {}
            for r in self._routes.values():
                if r.get("state") not in _TERMINAL:
                    w = r.get("worker", "")
                    out[w] = out.get(w, 0) + 1
        return out

    # ------------------------------------------------------------ routes

    def worker_endpoint(self, task_id: str) -> Optional[str]:
        """Where a routed task lives — the proxy endpoints' lookup.
        None for unrouted (local) tasks."""
        with self._lock:
            r = self._routes.get(task_id)
        if r is None:
            return None
        return self.registry.endpoint(r.get("worker", "")) or _normalize(
            r.get("worker", "")
        )

    def route_record(self, task_id: str) -> Optional[dict]:
        with self._lock:
            r = self._routes.get(task_id)
        return dict(r) if r else None

    def mark_kill_requested(self, task_id: str) -> None:
        """A /kill arrived while the owning worker was unreachable:
        record the intent so the requeue path CANCELS the route
        instead of resurrecting a killed run on a survivor."""
        with self._lock:
            r = self._routes.get(task_id)
            if r is not None:
                r["kill_requested"] = True
        self._save_routes()

    def synthesized_task(self, route: dict) -> dict:
        """A task-dict view of a route record, for when the owning
        worker can't answer (dead, or never polled yet)."""
        task = route.get("task")
        if task:
            d = dict(task)
        else:
            d = {
                "id": route["task_id"],
                "type": "run" if route["kind"] == "run" else route["kind"],
                "plan": route.get("plan", ""),
                "case": route.get("case", ""),
                "state": route.get("state", "scheduled"),
                "outcome": route.get("outcome", "unknown"),
                "created": route.get("created", 0.0),
                "error": route.get("error", ""),
                "states": [],
                "result": None,
                "progress": None,
            }
        d["routed_to"] = route.get("worker", "")
        d["attempts"] = int(route.get("attempts", 0))
        return d

    def task_rows(self) -> list[dict]:
        """Every routed task as a task dict (merged into /tasks)."""
        with self._lock:
            routes = [dict(r) for r in self._routes.values()]
        return [self.synthesized_task(r) for r in routes]

    def _refresh_routes(self) -> None:
        """Pull each non-terminal routed task's state from its worker
        (also caches the full task dict for /tasks and dead-worker
        /status fallbacks)."""
        from ..rpc import RPCError

        alive = {r["worker"] for r in self.registry.alive()}
        with self._lock:
            pending = [
                dict(r)
                for r in self._routes.values()
                if r.get("state") not in _TERMINAL
                and r.get("worker") in alive
            ]
        changed = False
        for r in pending:
            endpoint = self.registry.endpoint(r["worker"]) or r["worker"]
            try:
                d = self._client(endpoint, timeout=5.0).status(r["task_id"])
            except RPCError:
                # the worker is alive but doesn't know the task (e.g.
                # memory storage lost it in a restart): candidate for
                # requeue, handled like a lost worker
                d = None
                state = "missing"
            except Exception:  # noqa: BLE001 — transient: retry next tick
                continue
            with self._lock:
                live = self._routes.get(r["task_id"])
                if live is None or live.get("worker") != r["worker"]:
                    continue
                if d is not None:
                    live["task"] = d
                    live["state"] = d.get("state", live["state"])
                    live["outcome"] = d.get("outcome", live["outcome"])
                    if live["state"] in _TERMINAL:
                        self._drop_zip(live)
                else:
                    live["state"] = state
                changed = True
        if changed:
            self._save_routes()

    def _requeue_lost(self) -> None:
        """The worker-death path: any route whose owner went stale (or
        reported the task missing) is re-dispatched to a survivor with
        the attempts/backoff policy. Two-phase — first mark with a
        backoff deadline, then dispatch once it elapses — so a blip
        shorter than the backoff lets the original worker's heartbeat
        recover the route untouched."""
        from ..engine import Engine

        lost = set(self.registry.lost())
        now = time.time()
        max_attempts = int(Engine._retry_env("TG_TASK_MAX_ATTEMPTS", 3))
        base = Engine._retry_env("TG_TASK_RETRY_BACKOFF_S", 2.0)
        cap = Engine._retry_env("TG_TASK_RETRY_BACKOFF_CAP_S", 60.0)
        # a route restored from federation_routes.json whose worker has
        # not heartbeated since THIS coordinator booted is stranded too
        # (registry.lost() only covers workers seen this process) — but
        # only after a full staleness window, so a live fleet has time
        # to re-enroll before its routes are declared orphaned
        known = {row["worker"] for row in self.registry.rows()}
        booted_past_stale = (
            time.monotonic() - self._started > self.registry.stale_s
        )
        changed = False
        with self._lock:
            candidates = [
                r
                for r in self._routes.values()
                if r.get("state") not in _TERMINAL
            ]
        for r in candidates:
            stranded = (
                r.get("worker") in lost
                or r.get("state") == "missing"
                or (booted_past_stale and r.get("worker") not in known)
            )
            if r.get("kill_requested") and (
                stranded or r.get("state") == "requeued"
            ):
                # the user killed it while its worker was dark:
                # cancel the route, never resurrect the run
                with self._lock:
                    r["state"] = "canceled"
                    r["outcome"] = "canceled"
                    r["error"] = (
                        "killed while its worker was unreachable"
                    )
                    self._drop_zip(r)
                changed = True
                continue
            if r.get("state") == "requeued":
                if now < r.get("backoff_until", 0.0):
                    continue
                survivor = self.registry.route(
                    r.get("affinity", ""),
                    exclude={r.get("from_worker", "")},
                    extra_load=self._inflight(),
                )
                if survivor is None:
                    # no OTHER live worker — a recovered from_worker (a
                    # restart that reported the task missing) is still a
                    # valid re-dispatch target; without this fallback a
                    # one-worker fleet wedges the route forever
                    survivor = self.registry.route(
                        r.get("affinity", ""), extra_load=self._inflight()
                    )
                if survivor is None:
                    continue  # no live worker yet: retry next tick
                try:
                    self._dispatch(r, survivor, resume=True)
                except Exception:  # noqa: BLE001 — failed re-dispatch
                    # consumes an attempt with backoff like any loss:
                    # a survivor that deterministically rejects (plan
                    # zip gone, runner disabled there) must exhaust
                    # attempts, not be hammered every tick forever
                    with self._lock:
                        r["attempts"] = int(r.get("attempts", 0)) + 1
                        if r["attempts"] >= max_attempts:
                            r["state"] = "complete"
                            r["outcome"] = "failure"
                            r["error"] = (
                                f"re-dispatch to {survivor} failed; "
                                f"{r['attempts']} attempts exhausted"
                            )
                            self._drop_zip(r)
                        else:
                            r["backoff_until"] = now + min(
                                cap, base * (2.0 ** (r["attempts"] - 1))
                            )
                    changed = True
                    continue
                with self._lock:
                    r["worker"] = survivor
                    r["state"] = "scheduled"
                    r.pop("task", None)
                _M_ROUTES.inc(worker=survivor)
                changed = True
            elif stranded:
                with self._lock:
                    r["attempts"] = int(r.get("attempts", 0)) + 1
                    r["from_worker"] = r.get("worker", "")
                    r.pop("fenced", None)  # new loss: re-arm the fence
                    if r["attempts"] >= max_attempts:
                        r["state"] = "complete"
                        r["outcome"] = "failure"
                        r["error"] = (
                            f"worker {r['from_worker']} lost; "
                            f"{r['attempts']} attempts exhausted"
                        )
                        self._drop_zip(r)
                    else:
                        backoff = min(cap, base * (2.0 ** (r["attempts"] - 1)))
                        r["state"] = "requeued"
                        r["backoff_until"] = now + backoff
                        _M_REQUEUES.inc()
                changed = True
        if changed:
            self._save_routes()

    def _fence_recovered(self) -> None:
        """A worker that went stale mid-run and came BACK after its
        task was re-dispatched elsewhere is still executing the
        superseded attempt — into the same run dir when storage is
        shared, racing the resumed attempt. Kill it there (best-effort,
        once): the old attempt stops at its next chunk boundary."""
        alive = {r["worker"] for r in self.registry.alive()}
        with self._lock:
            stale_owners = [
                (r["task_id"], r["from_worker"])
                for r in self._routes.values()
                if r.get("from_worker")
                and r["from_worker"] != r.get("worker", "")
                and r["from_worker"] in alive
                and not r.get("fenced")
            ]
        from ..rpc import RPCError

        for tid, owner in stale_owners:
            endpoint = self.registry.endpoint(owner) or owner
            try:
                self._client(endpoint, timeout=5.0).kill(tid)
            except RPCError:
                # the worker ANSWERED: the attempt is already dead
                # (finished, or lost in its restart) — fence achieved
                pass
            except Exception:  # noqa: BLE001 — transport: retry next tick
                continue
            with self._lock:
                live = self._routes.get(tid)
                if live is not None and live.get("from_worker") == owner:
                    live["fenced"] = True
                    _M_FENCES.inc()

    # ------------------------------------------------------------ surface

    def info(self) -> dict:
        """GET /federation's coordinator section (also the fleet page's
        data source and ``testground fleet ls``'s rows)."""
        with self._lock:
            routed: dict[str, int] = {}
            routes = []
            for r in self._routes.values():
                if r.get("state") not in _TERMINAL:
                    routed[r.get("worker", "")] = (
                        routed.get(r.get("worker", ""), 0) + 1
                    )
                routes.append(
                    {
                        "task_id": r["task_id"],
                        "kind": r.get("kind", "run"),
                        "worker": r.get("worker", ""),
                        "plan": r.get("plan", ""),
                        "case": r.get("case", ""),
                        "state": r.get("state", ""),
                        "outcome": r.get("outcome", ""),
                        "attempts": int(r.get("attempts", 0)),
                    }
                )
        workers = self.registry.rows()
        for w in workers:
            w["routed_tasks"] = routed.get(w["worker"], 0)
        routes.sort(key=lambda r: r["task_id"])
        return {
            "role": "coordinator",
            "advertise": self.advertise,
            "peers": list(self.peers),
            "heartbeat_interval_s": heartbeat_interval_s(),
            "stale_after_s": self.registry.stale_s,
            "workers": workers,
            "routes": routes,
        }
