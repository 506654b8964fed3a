"""HTTP daemon exposing the engine (a copy of
``testground_tpu/daemon/server.py``; reference
pkg/daemon/daemon.go:34-101).

The port's daemon answers every route of the JAX daemon, from the port's
engine: its runs run on the engine's device (the card unless the daemon
was started with ``--device cpu``). With peers (``--peer`` or ``[daemon]
peers``) it is a federation coordinator (federation/): it routes each
``/run`` and ``/prewarm`` to a worker daemon, proxies the task-scoped
routes to the owning worker and merges the fleet's ``/metrics``; with no
live worker it queues the submission on its own engine. Any daemon
becomes a worker when a coordinator enrolls it
(``/federation/enroll``), and heartbeats to it from then on.

Route surface mirrors the reference's mux table::

    POST /build        queue a build   (JSON or multipart w/ plan sources)
    POST /run          queue a run     (JSON or multipart w/ plan sources)
    POST /prewarm      queue a PREWARM (build + capture the executor into
                       the runner's pool, no run)
    GET  /tasks        list tasks      [?state=...&limit=N]
    GET  /status       one task        ?task_id=...
    GET  /logs         task log        ?task_id=...[&follow=1]
    GET  /outputs      tar.gz stream   ?task_id=...
    POST /kill         cancel a task   {"task_id": ...}
    DELETE /delete     drop a task     ?task_id=...
    POST /terminate    kill all of a runner's instances  {"runner": ...}
    GET  /healthcheck  run checks      [?fix=1]
    GET  /progress     live-plane snapshots  ?task_id=...[&follow=1][&since=N]
    GET  /events       drain-plane event stream (trace.jsonl)
                       ?task_id=...[&follow=1][&since=N][&scenario=S]
    POST /federation/heartbeat  worker -> coordinator liveness/capacity
    POST /federation/enroll     coordinator -> worker: start heartbeating
    GET  /federation   fleet state (role, workers, routes) as JSON
    GET  /metrics      Prometheus text exposition (coordinator merges
                       worker expositions under worker= labels)
    GET  /dashboard    HTML task dashboard
    GET  /fleet        HTML fleet page (workers, heartbeats, routes)
    GET  /live         HTML live run dashboard (progress bars, sparklines)
    GET  /measurements HTML measurements page  [?plan=...]
    GET  /search       HTML breaking-point search page  [?plan=...]

Every response except the HTML pages is a chunk stream
(testground_tpu_torch.rpc).
Bearer-token auth applies when the daemon config lists tokens
(reference daemon.go:49-70).
"""

from __future__ import annotations

import io
import json
import tempfile
import threading
import time
import zipfile
from email.parser import BytesParser
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional
from urllib.parse import parse_qs, urlparse

from ..api import Composition
from ..config import EnvConfig
from ..engine import Engine, EngineError
from ..federation.coordinator import _normalize
from ..rpc.chunks import BinaryChunkWriter, OutputWriter
from ..task import STATE_CANCELED, STATE_COMPLETE
from .dashboard import render_dashboard


class Daemon:
    def __init__(
        self,
        home: Optional[str] = None,
        listen: Optional[str] = None,
        engine: Optional[Engine] = None,
        peers: Optional[list[str]] = None,
        advertise: Optional[str] = None,
        device: str = "cuda",
    ) -> None:
        env = EnvConfig.load(home)
        self.engine = engine or Engine(env_config=env, device=device)
        self.env = self.engine.env
        addr = listen or self.env.daemon.listen
        host, _, port = addr.rpartition(":")
        handler = _make_handler(self)
        self._httpd = ThreadingHTTPServer((host or "localhost", int(port)), handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None
        # federation plane (docs/federation.md): peers (from --peer or
        # [daemon] peers) make this daemon the fleet COORDINATOR —
        # workers enroll + heartbeat, submitted runs route to the best
        # worker, task endpoints proxy through. A daemon can also BE a
        # worker (self._heartbeat, started by /federation/enroll).
        self.federation = None
        self._heartbeat = None
        # --advertise / [daemon] advertise: the endpoint OTHER fleet
        # members dial — both the coordinator's heartbeat callback and
        # this daemon's worker-side endpoint in heartbeats (the bind
        # address may be 0.0.0.0/localhost and undialable off-host);
        # scheme-less values ("10.0.0.5:8042") are normalized once here
        self._advertise = _normalize(
            advertise or self.env.daemon.advertise or "")
        peer_list = [p for p in (peers or self.env.daemon.peers) if p]
        if peer_list:
            from ..federation import FederationPlane

            self.federation = FederationPlane(
                self.engine,
                peer_list,
                self._advertise or self.endpoint,
                token=self.env.client.token,
            ).start()

    def ensure_heartbeat(
        self, coordinator: str, worker: str, interval_s: float
    ) -> str:
        """Start (or retarget) this daemon's worker-side heartbeat loop
        — the /federation/enroll handler's body."""
        from ..federation import HeartbeatLoop

        worker = worker or self._advertise or self.endpoint
        if self._heartbeat is None:
            self._heartbeat = HeartbeatLoop(
                self.engine,
                coordinator,
                worker,
                self._advertise or self.endpoint,
                interval_s=interval_s,
                token=self.env.client.token,
            ).start()
        else:
            self._heartbeat.retarget(coordinator, worker, interval_s)
        return worker

    def federation_info(self) -> dict:
        """GET /federation: this daemon's fleet role + state (both
        sides — a coordinator's registry/routes, a worker's enrolled
        coordinator)."""
        if self.federation is not None:
            info = {**self.federation.info(), "endpoint": self.endpoint}
        else:
            info = {"role": "standalone", "endpoint": self.endpoint}
        if self._heartbeat is not None:
            info["enrolled"] = {
                "coordinator": self._heartbeat.coordinator,
                "name": self._heartbeat.worker,
                "heartbeats_sent": self._heartbeat.sent,
                "interval_s": self._heartbeat.interval_s,
            }
            if info["role"] == "standalone":
                info["role"] = "worker"
        return info

    def metrics_text(self) -> str:
        """GET /metrics body (fleet metrics plane, docs/observability.md):
        this process's Prometheus exposition. A coordinator additionally
        scrapes each alive worker's /metrics and merges the fleet into
        one body — every worker sample relabeled ``worker="name"``, one
        HELP/TYPE pair per family — so one scrape target covers the
        whole fleet. Each render also appends a point to the obs history
        rings (the /fleet sparklines' data source)."""
        from .. import obs

        local = obs.render()
        obs.REGISTRY.sample_history()
        fed = self.federation
        if fed is None:
            return local
        import urllib.request

        per_worker = {}
        for row in fed.registry.alive():
            name = row["worker"]
            endpoint = (fed.registry.endpoint(name) or name).rstrip("/")
            try:
                req = urllib.request.Request(endpoint + "/metrics")
                token = self.env.client.token
                if token:
                    req.add_header("Authorization", f"Bearer {token}")
                with urllib.request.urlopen(req, timeout=3.0) as resp:
                    per_worker[name] = resp.read().decode(
                        "utf-8", "replace"
                    )
            except Exception:  # noqa: BLE001 — dark worker: skip it
                continue
        return obs.merge_expositions(per_worker, local=local)

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def endpoint(self) -> str:
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}"

    def serve_forever(self) -> int:
        # SIGTERM preempts in-flight sim runs (each stops at its next
        # chunk boundary with a forced final checkpoint + resume token;
        # POST /resume continues one, on this home, after a restart),
        # then shuts the server down once they drain (grace-capped) —
        # main-thread only, a no-op when serving from a worker thread
        self.engine.install_preemption_handler(
            on_idle=self._httpd.shutdown
        )
        try:
            # 0.1s shutdown poll (stdlib default 0.5s): daemon stops —
            # preemption drains, test teardowns, fleet respawns — wait
            # at most one poll for serve_forever to notice shutdown()
            self._httpd.serve_forever(poll_interval=0.1)
        except KeyboardInterrupt:
            pass
        finally:
            self.close()
        return 0

    def start_background(self) -> "Daemon":
        self._thread = threading.Thread(
            target=lambda: self._httpd.serve_forever(poll_interval=0.1),
            daemon=True,
        )
        self._thread.start()
        return self

    def close(self) -> None:
        if self.federation is not None:
            self.federation.close()
        if self._heartbeat is not None:
            self._heartbeat.stop()
        self._httpd.shutdown()
        self._httpd.server_close()
        self.engine.close()
        if self._thread:
            self._thread.join(timeout=2)


def _make_handler(daemon: Daemon):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet; engine logs to task files
            pass

        # ------------------------------------------------------------ auth
        def _authorized(self) -> bool:
            tokens = daemon.env.daemon.tokens
            if not tokens:
                return True
            hdr = self.headers.get("Authorization", "")
            return hdr.startswith("Bearer ") and hdr[7:] in tokens

        # --------------------------------------------------------- plumbing
        def _begin_chunks(self) -> OutputWriter:
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            self._body = _ChunkedBody(self.wfile)
            return OutputWriter(self._body)

        def _finish_chunks(self) -> None:
            body = getattr(self, "_body", None)
            if body is not None:
                try:
                    body.finish()
                except (BrokenPipeError, ConnectionError, OSError):
                    pass
                self._body = None

        def _deny(self, code: int, msg: str) -> None:
            # drain any unread request body first: replying while bytes sit
            # in rfile desyncs HTTP/1.1 keep-alive (the next request on the
            # connection would be parsed from the leftover body)
            try:
                remaining = int(self.headers.get("Content-Length") or 0)
                while remaining > 0:
                    chunk = self.rfile.read(min(remaining, 65536))
                    if not chunk:
                        break
                    remaining -= len(chunk)
            except (ValueError, OSError):
                self.close_connection = True
            body = msg.encode()
            self.send_response(code)
            self.send_header("Content-Type", "text/plain")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _query(self) -> dict:
            return {
                k: v[0] for k, v in parse_qs(urlparse(self.path).query).items()
            }

        def _route(self) -> str:
            return urlparse(self.path).path

        def _read_body(self) -> bytes:
            n = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(n) if n else b""

        def _parse_request_raw(self) -> tuple[dict, Optional[bytes]]:
            """Returns (payload dict, raw plan-zip bytes or None) —
            the zip stays bytes so a federation coordinator can forward
            the submission verbatim instead of unpacking it locally."""
            body = self._read_body()
            ctype = self.headers.get("Content-Type", "")
            if ctype.startswith("multipart/form-data"):
                parts = _parse_multipart(body, ctype)
                payload = json.loads(parts.get("composition", b"{}"))
                return payload, parts.get("plan")
            return (json.loads(body) if body else {}), None

        def _unpack_zip(self, zip_bytes: Optional[bytes]) -> Optional[str]:
            """Unpack uploaded plan sources into the daemon work dir
            (reference daemon/build.go:88+, api.UnpackedSources
            engine.go:22-38)."""
            if not zip_bytes:
                return None
            sources_root = daemon.env.dirs.work / "sources"
            sources_root.mkdir(parents=True, exist_ok=True)
            workdir = Path(tempfile.mkdtemp(dir=sources_root))
            with zipfile.ZipFile(io.BytesIO(zip_bytes)) as zf:
                _safe_extract(zf, workdir)
            return str(workdir)

        def _parse_request(self) -> tuple[dict, Optional[str]]:
            """Returns (payload dict, unpacked sources dir or None)."""
            payload, zip_bytes = self._parse_request_raw()
            return payload, self._unpack_zip(zip_bytes)

        # federation: task-scoped endpoints a coordinator proxies raw
        # to the owning worker (the route table knows which one) —
        # existing Client/command-line code works unchanged against the
        # coordinator
        _PROXY_GET = (
            "/status", "/logs", "/progress", "/events", "/outputs",
            "/journal",
        )

        # ----------------------------------------------------------- verbs
        def do_GET(self):  # noqa: N802 (http.server API)
            if not self._authorized():
                return self._deny(401, "unauthorized")
            route = self._route()
            q = self._query()
            try:
                fed = daemon.federation
                if fed is not None and route in self._PROXY_GET:
                    endpoint = fed.worker_endpoint(q.get("task_id", ""))
                    if endpoint is not None:
                        return self._h_proxy(endpoint, q.get("task_id", ""))
                if route == "/tasks":
                    self._h_tasks(q)
                elif route == "/status":
                    self._h_status(q)
                elif route == "/logs":
                    self._h_logs(q)
                elif route == "/progress":
                    self._h_progress(q)
                elif route == "/events":
                    self._h_events(q)
                elif route == "/cache":
                    self._h_cache(q)
                elif route == "/outputs":
                    self._h_outputs(q)
                elif route == "/healthcheck":
                    self._h_healthcheck(q)
                elif route == "/metrics":
                    self._h_metrics(q)
                elif route == "/federation":
                    self._h_federation(q)
                elif route == "/dashboard":
                    self._h_dashboard(q)
                elif route == "/fleet":
                    self._h_fleet(q)
                elif route == "/live":
                    self._h_live(q)
                elif route == "/measurements":
                    self._h_measurements(q)
                elif route == "/search":
                    self._h_search(q)
                elif route == "/data":
                    self._h_data(q)
                elif route == "/journal":
                    self._h_journal(q)
                else:
                    self._deny(404, f"no such route: {route}")
            except (BrokenPipeError, ConnectionError):
                pass
            finally:
                self._finish_chunks()

        def do_POST(self):  # noqa: N802
            if not self._authorized():
                return self._deny(401, "unauthorized")
            route = self._route()
            try:
                if route in ("/run", "/build", "/prewarm"):
                    self._h_queue(route[1:])
                elif route == "/federation/heartbeat":
                    self._h_fed_heartbeat()
                elif route == "/federation/enroll":
                    self._h_fed_enroll()
                elif route == "/build/purge":
                    self._h_build_purge()
                elif route == "/cache/purge":
                    self._h_cache_purge()
                elif route == "/kill":
                    self._h_kill()
                elif route == "/resume":
                    self._h_resume()
                elif route == "/terminate":
                    self._h_terminate()
                else:
                    self._deny(404, f"no such route: {route}")
            except (BrokenPipeError, ConnectionError):
                pass
            finally:
                self._finish_chunks()

        def do_DELETE(self):  # noqa: N802
            if not self._authorized():
                return self._deny(401, "unauthorized")
            if self._route() != "/delete":
                return self._deny(404, "no such route")
            q = self._query()
            try:
                ow = self._begin_chunks()
                tid = q.get("task_id", "")
                t = daemon.engine.get_task(tid)
                if t is None:
                    ow.error(f"no such task: {tid}")
                elif t.state not in (STATE_COMPLETE, STATE_CANCELED):
                    ow.error(f"task is {t.state}; kill it first")
                else:
                    daemon.engine.storage.delete(tid)
                    ow.result({"deleted": tid})
            except (BrokenPipeError, ConnectionError):
                pass
            finally:
                self._finish_chunks()

        # --------------------------------------------------------- handlers
        def _h_queue(self, kind: str) -> None:
            ow = self._begin_chunks()
            try:
                payload, zip_bytes = self._parse_request_raw()
                comp = Composition.from_dict(payload["composition"])
                created_by = payload.get("created_by") or {}
                priority = int(payload.get("priority", 0))
                fed = daemon.federation
                # a payload already carrying routed_to was forwarded BY
                # a coordinator — execute it here, never route it again
                # (symmetric --peer configs would otherwise forward in
                # a cycle forever, each hop a blocking nested POST)
                already_routed = bool(payload.get("routed_to"))
                if (
                    fed is not None
                    and not already_routed
                    and kind in ("run", "prewarm")
                ):
                    # federation coordinator: route to the best worker
                    # (cache-affinity first, headroom second) and
                    # forward the submission verbatim; with no live
                    # worker the coordinator serves it locally — a
                    # booting fleet degrades to single-daemon behavior
                    comp.validate_for_run()  # fail fast, pre-routing
                    # forward the NORMALIZED dict (from_dict→to_dict):
                    # the worker engine computes the affinity digest on
                    # exactly this form, so routing and the worker's
                    # cache-key heartbeats agree byte-for-byte
                    routed = fed.submit(
                        kind,
                        {**payload, "composition": comp.to_dict()},
                        zip_bytes,
                    )
                    if routed is not None:
                        tid, worker = routed
                        ow.info(f"task routed to worker {worker}: {tid}")
                        ow.result({"task_id": tid, "routed_to": worker})
                        return
                    ow.info("no live federation worker; queuing locally")
                sources_dir = self._unpack_zip(zip_bytes)
                common = dict(
                    sources_dir=sources_dir,
                    priority=priority,
                    created_by=created_by,
                )
                if kind == "build":
                    tid = daemon.engine.queue_build(comp, **common)
                elif kind == "prewarm":
                    tid = daemon.engine.queue_prewarm(
                        comp,
                        **common,
                        task_id=payload.get("task_id"),
                        routed_to=payload.get("routed_to", ""),
                    )
                else:
                    tid = daemon.engine.queue_run(
                        comp,
                        **common,
                        task_id=payload.get("task_id"),
                        routed_to=payload.get("routed_to", ""),
                        attempts=int(payload.get("attempts", 0)),
                        resume=bool(payload.get("resume")),
                    )
                ow.info(f"task queued: {tid}")
                ow.result({"task_id": tid})
            except (EngineError, KeyError, ValueError, TypeError,
                    json.JSONDecodeError, zipfile.BadZipFile) as e:
                ow.error(str(e))

        def _h_proxy(self, endpoint: str, tid: str,
                     body: Optional[bytes] = None) -> None:
            """Raw pass-through of this request to the worker owning
            ``tid`` — the response streams back byte-for-byte (chunk
            protocol, keepalives, binary tar frames), so the
            coordinator is transparent to Client/CLI. A dead worker
            answers /status from the coordinator's route record and
            errors cleanly elsewhere; a worker dying MID-stream
            truncates the stream, which the client's follow-retry
            (Client since=) resumes."""
            import http.client as _hc
            from urllib.parse import urlparse as _up

            u = _up(endpoint)
            try:
                conn = _hc.HTTPConnection(
                    # 8042: the same default port Client uses, so a
                    # port-less worker endpoint proxies where dispatch
                    # and status refresh already dial
                    u.hostname or "localhost", u.port or 8042, timeout=30
                )
                headers = {}
                token = daemon.env.client.token
                if token:
                    headers["Authorization"] = f"Bearer {token}"
                if body is not None:
                    headers["Content-Type"] = self.headers.get(
                        "Content-Type", "application/json"
                    )
                    headers["Content-Length"] = str(len(body))
                conn.request(
                    self.command, self.path, body=body, headers=headers
                )
                resp = conn.getresponse()
            except OSError:
                fed = daemon.federation
                rec = fed.route_record(tid) if fed is not None else None
                ow = self._begin_chunks()
                if self._route() == "/status" and rec is not None:
                    # last-known view: state/outcome kept fresh by the
                    # coordinator's monitor polls
                    ow.result(fed.synthesized_task(rec))
                elif self._route() == "/kill" and rec is not None:
                    # the owner is dark but the user's intent is
                    # recorded: the requeue path cancels the route
                    # instead of resurrecting a killed run elsewhere
                    fed.mark_kill_requested(tid)
                    ow.result({"killed": tid, "deferred": True})
                else:
                    ow.error(
                        f"routed worker unreachable for task {tid}"
                    )
                return
            try:
                self.send_response(resp.status)
                self.send_header(
                    "Content-Type",
                    resp.getheader(
                        "Content-Type", "application/x-ndjson"
                    ),
                )
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                out = _ChunkedBody(self.wfile)
                try:
                    while True:
                        data = resp.read(65536)
                        if not data:
                            break
                        out.write(data)
                        out.flush()
                except (OSError, ConnectionError, _hc.HTTPException):
                    pass  # worker died mid-stream: client retries
                try:
                    out.finish()
                except (OSError, ConnectionError):
                    pass
            finally:
                conn.close()

        def _h_fed_heartbeat(self) -> None:
            """POST /federation/heartbeat (worker → coordinator): one
            liveness + capacity report into the registry."""
            ow = self._begin_chunks()
            if daemon.federation is None:
                return ow.error(
                    "not a federation coordinator (no [daemon] peers)"
                )
            try:
                payload = json.loads(self._read_body() or b"{}")
                name = daemon.federation.heartbeat(payload)
            except (ValueError, json.JSONDecodeError) as e:
                return ow.error(str(e))
            ow.result({"ok": True, "worker": name})

        def _h_fed_enroll(self) -> None:
            """POST /federation/enroll (coordinator → worker): start or
            retarget this daemon's heartbeat loop toward the
            coordinator's callback endpoint."""
            ow = self._begin_chunks()
            try:
                payload = json.loads(self._read_body() or b"{}")
            except json.JSONDecodeError as e:
                return ow.error(str(e))
            coordinator = str(payload.get("coordinator", ""))
            if not coordinator:
                return ow.error("enroll carries no coordinator endpoint")
            try:
                interval = float(payload.get("interval", 2.0))
            except (TypeError, ValueError):
                interval = 2.0
            name = daemon.ensure_heartbeat(
                coordinator, str(payload.get("worker", "")), interval
            )
            ow.result({"enrolled": name, "coordinator": coordinator})

        def _h_federation(self, q: dict) -> None:
            """GET /federation: fleet state — role, workers (heartbeat
            age, lease headroom, warm cache keys, routed-task counts),
            routes — the JSON behind `testground fleet ls` and the
            /fleet dashboard page."""
            ow = self._begin_chunks()
            ow.result(daemon.federation_info())

        def _h_metrics(self, q: dict) -> None:
            """GET /metrics: Prometheus text exposition (fleet metrics
            plane). On a coordinator the body aggregates every alive
            worker's families under ``worker=`` labels."""
            from ..obs import CONTENT_TYPE

            self._send_plain(daemon.metrics_text().encode(), CONTENT_TYPE)

        def _h_fleet(self, q: dict) -> None:
            """HTML fleet page (per-worker heartbeat age, leases, cache
            keys, routed tasks — docs/federation.md)."""
            from .dashboard import render_fleet

            self._send_plain(
                render_fleet(daemon.federation_info()).encode(),
                "text/html; charset=utf-8",
            )

        def _h_tasks(self, q: dict) -> None:
            ow = self._begin_chunks()
            states = q["state"].split(",") if "state" in q else None
            try:
                limit = int(q.get("limit", 0))
            except ValueError:
                ow.error(f"invalid limit: {q.get('limit')!r}")
                return
            fed = daemon.federation
            tasks = daemon.engine.tasks(
                states=states, limit=0 if fed is not None else limit
            )
            rows = [t.to_dict() for t in tasks]
            if fed is not None:
                # merge the routed tasks (each marked routed_to) into
                # the listing so the coordinator shows the WHOLE fleet
                fed_rows = fed.task_rows()
                if states:
                    fed_rows = [
                        d for d in fed_rows if d.get("state") in states
                    ]
                rows += fed_rows
                rows.sort(
                    key=lambda d: d.get("created", 0.0), reverse=True
                )
                if limit:
                    rows = rows[:limit]
            ow.result(rows)

        def _h_status(self, q: dict) -> None:
            ow = self._begin_chunks()
            t = daemon.engine.get_task(q.get("task_id", ""))
            if t is None:
                ow.error(f"no such task: {q.get('task_id')}")
            else:
                ow.result(t.to_dict())

        def _h_logs(self, q: dict) -> None:
            """Streams the task log; with follow=1, tails until the task
            completes and finishes with its outcome (reference
            engine.go:461-592). ``since=N`` skips the first N lines —
            the client's mid-stream reconnect resumes where the dropped
            connection left off instead of re-printing the log."""
            tid = q.get("task_id", "")
            follow = q.get("follow") in ("1", "true")
            try:
                since = int(q.get("since", 0))
            except ValueError:
                return self._deny(400, f"invalid since: {q.get('since')!r}")
            ow = self._begin_chunks()
            t = daemon.engine.get_task(tid)
            if t is None:
                return ow.error(f"no such task: {tid}")
            path = daemon.engine.task_log_path(tid)
            pos = 0
            sent = 0
            last_sent = time.monotonic()

            def drain() -> None:
                nonlocal pos, sent, last_sent
                if path.exists():
                    with open(path, "r") as f:
                        f.seek(pos)
                        for line in f:
                            if sent >= since:
                                ow.info(line.rstrip("\n"))
                                last_sent = time.monotonic()
                            sent += 1
                        pos = f.tell()

            while True:
                # check completion BEFORE draining: anything written up to
                # the completion point is then guaranteed to be streamed
                t = daemon.engine.get_task(tid)
                done = t is None or t.state in (STATE_COMPLETE, STATE_CANCELED)
                drain()
                if done or not follow:
                    break
                if time.monotonic() - last_sent > 5.0:
                    # keepalive: empty binary chunk defeats idle timeouts
                    # without polluting the log stream
                    ow.binary(b"")
                    last_sent = time.monotonic()
                time.sleep(0.2)
            ow.result(
                {
                    "task_id": tid,
                    "outcome": t.outcome if t else "unknown",
                    "lines": sent,
                }
            )

        def _h_progress(self, q: dict) -> None:
            """Streams the run's live-plane snapshots (one JSON line per
            chunk boundary / search round — sim/live.py); with follow=1,
            long-poll tails ``progress.jsonl`` until the task completes,
            exactly like /logs tails the task log. ``since=N`` skips the
            first N snapshots (resume a dropped tail)."""
            from ..metrics import PROGRESS_FILE

            self._tail_jsonl(q, PROGRESS_FILE, count_key="snapshots")

        def _h_events(self, q: dict) -> None:
            """Streams the drain plane's event log (one Chrome
            trace-event JSON object per line — sim/drain.py appends a
            batch at every chunk boundary when ``[trace] drain`` is
            on); with follow=1, long-poll tails ``trace.jsonl`` until
            the task completes, so a long run's timeline is watchable
            while it executes. ``since=N`` skips the first N lines
            (resume a dropped tail); ``scenario=S`` tails one sweep
            scenario's stream (``scenario/<S>/trace.jsonl``)."""
            from ..metrics import EVENTS_FILE

            sub = q.get("scenario")
            fname = (
                f"scenario/{int(sub)}/{EVENTS_FILE}"
                if sub is not None and sub.isdigit()
                else EVENTS_FILE
            )
            self._tail_jsonl(q, fname, count_key="events")

        def _tail_jsonl(
            self, q: dict, fname: str, count_key: str
        ) -> None:
            """Shared torn-tail-safe long-poll over one of a run's
            streaming jsonl files (/progress, /events): completion is
            checked BEFORE each drain so every line written up to the
            completion point is guaranteed to be streamed; keepalive
            empty chunks defeat idle timeouts."""
            tid = q.get("task_id", "")
            follow = q.get("follow") in ("1", "true")
            try:
                since = int(q.get("since", 0))
            except ValueError:
                return self._deny(400, f"invalid since: {q.get('since')!r}")
            ow = self._begin_chunks()
            t = daemon.engine.get_task(tid)
            if t is None:
                return ow.error(f"no such task: {tid}")
            path = daemon.env.dirs.outputs / t.plan / tid / fname
            pos = 0
            sent = 0
            last_sent = time.monotonic()

            def drain() -> None:
                nonlocal pos, sent, last_sent
                if not path.exists():
                    return
                with open(path, "r") as f:
                    f.seek(pos)
                    while True:
                        line = f.readline()
                        if not line or not line.endswith("\n"):
                            # torn tail: the writer is mid-append; the
                            # next drain re-reads from this offset
                            break
                        pos = f.tell()
                        line = line.strip()
                        if not line:
                            continue
                        if sent >= since:
                            ow.info(line)
                            last_sent = time.monotonic()
                        sent += 1

            while True:
                # completion check BEFORE draining (the /logs contract):
                # every line written up to the completion point is
                # guaranteed to be streamed
                t = daemon.engine.get_task(tid)
                done = t is None or t.state in (
                    STATE_COMPLETE, STATE_CANCELED,
                )
                drain()
                if done or not follow:
                    break
                if time.monotonic() - last_sent > 5.0:
                    ow.binary(b"")  # keepalive
                    last_sent = time.monotonic()
                time.sleep(0.2)
            ow.result(
                {
                    "task_id": tid,
                    "outcome": t.outcome if t else "unknown",
                    count_key: sent,
                }
            )

        def _h_cache_purge(self) -> None:
            """Drop disk executor-tier entries on the DAEMON's host
            (all, or by entry-id prefix) — the remote form of
            ``cache purge``; none while the port has no disk tier."""
            ow = self._begin_chunks()
            try:
                body = json.loads(self._read_body() or b"{}")
            except json.JSONDecodeError as e:
                ow.error(str(e))
                return
            n = daemon.engine.executor_cache_purge(body.get("key"))
            ow.result({"purged": n})

        def _h_cache(self, q: dict) -> None:
            """The serving plane's executor-cache state: the disk tier
            (off), in-memory pool occupancy and counters and live device
            leases — the same JSON ``cache ls --endpoint`` renders and
            the dashboard's cache table reads."""
            ow = self._begin_chunks()
            ow.result(daemon.engine.executor_cache_info())

        def _h_outputs(self, q: dict) -> None:
            from ..runner.outputs import tar_outputs

            tid = q.get("task_id", "")
            ow = self._begin_chunks()
            t = daemon.engine.get_task(tid)
            if t is None:
                return ow.error(f"no such task: {tid}")
            run_dir = daemon.env.dirs.outputs / t.plan / tid
            if not run_dir.exists():
                return ow.error(f"no outputs for task: {tid}")
            w = BinaryChunkWriter(ow)
            tar_outputs(str(run_dir), w)
            w.flush()
            ow.result({"task_id": tid, "exists": True})

        def _h_build_purge(self) -> None:
            ow = self._begin_chunks()
            try:
                payload, _ = self._parse_request()
            except (ValueError, json.JSONDecodeError) as e:
                return ow.error(str(e))
            plan = payload.get("plan", "")
            if not plan:
                return ow.error("missing plan")
            ow.result({"purged": daemon.engine.build_purge(plan)})

        def _h_kill(self) -> None:
            body = self._read_body()
            try:
                payload = json.loads(body or b"{}")
            except json.JSONDecodeError as e:
                ow = self._begin_chunks()
                return ow.error(str(e))
            tid = payload.get("task_id", "")
            fed = daemon.federation
            if fed is not None:
                endpoint = fed.worker_endpoint(tid)
                if endpoint is not None:
                    return self._h_proxy(endpoint, tid, body=body)
            ow = self._begin_chunks()
            if daemon.engine.kill(tid):
                ow.result({"killed": tid})
            else:
                ow.error(f"task not killable (not found or complete): {tid}")

        def _h_resume(self) -> None:
            """POST /resume {task_id}: requeue an interrupted run task
            to continue from its last checkpoint (the durability
            plane, docs/robustness.md — the daemon analog of
            `testground run --resume`)."""
            from ..engine import EngineError

            body = self._read_body()
            try:
                payload = json.loads(body or b"{}")
            except json.JSONDecodeError as e:
                ow = self._begin_chunks()
                return ow.error(str(e))
            tid = payload.get("task_id", "")
            fed = daemon.federation
            if fed is not None:
                endpoint = fed.worker_endpoint(tid)
                if endpoint is not None:
                    return self._h_proxy(endpoint, tid, body=body)
            ow = self._begin_chunks()
            try:
                daemon.engine.resume_task(tid)
            except EngineError as e:
                return ow.error(str(e))
            ow.result({"resumed": tid})

        def _h_terminate(self) -> None:
            ow = self._begin_chunks()
            try:
                payload, _ = self._parse_request()
            except (ValueError, json.JSONDecodeError) as e:
                return ow.error(str(e))
            n = daemon.engine.terminate(payload.get("runner"))
            fed = daemon.federation
            # fanout=False marks a request forwarded BY a coordinator:
            # terminate locally only, or symmetric --peer configs would
            # bounce the fan-out between each other forever
            if fed is not None and payload.get("fanout", True):
                # fan out to every live worker: /terminate is
                # runner-scoped, not task-scoped, so the coordinator
                # sums the whole fleet's count
                from ..client import Client

                for w in fed.registry.alive():
                    try:
                        res = Client(
                            w["endpoint"] or w["worker"],
                            token=daemon.env.client.token,
                            timeout=10.0,
                        )._call(
                            "POST",
                            "/terminate",
                            body=json.dumps(
                                {
                                    "runner": payload.get("runner"),
                                    "fanout": False,
                                }
                            ).encode(),
                        )
                        n += int(res.get("terminated", 0))
                    except Exception:  # noqa: BLE001 — best-effort
                        pass
            ow.result({"terminated": n})

        def _h_healthcheck(self, q: dict) -> None:
            from ..healthcheck import run_checks
            from ..healthcheck.checks import default_checks

            ow = self._begin_chunks()
            fix = q.get("fix") in ("1", "true")
            runner_name = q.get("runner")
            if runner_name:
                from ..runner.registry import runner_healthcheck

                try:
                    report = runner_healthcheck(
                        runner_name,
                        fix,
                        daemon.engine.env.runners,
                        runners=daemon.engine.runners,
                    )
                except LookupError as e:
                    ow.error(str(e))
                    return
            else:
                report = run_checks(
                    default_checks(str(daemon.env.home)), fix=fix
                )
            ow.result(report.to_dict())

        def _h_dashboard(self, q: dict) -> None:
            self._send_plain(
                render_dashboard(daemon.engine, q).encode(),
                "text/html; charset=utf-8",
            )

        def _h_live(self, q: dict) -> None:
            """HTML live dashboard: per-task progress bars, skip-ratio /
            live-lane sparklines and search rounds, rendered from the
            task store's mirrored snapshots + each run's progress.jsonl
            (auto-refreshes — watch a sweep while it executes)."""
            from ..metrics import Viewer
            from .dashboard import render_live

            viewer = Viewer(daemon.env.dirs.outputs)
            self._send_plain(
                render_live(daemon.engine, viewer, q).encode(),
                "text/html; charset=utf-8",
            )

        def _h_measurements(self, q: dict) -> None:
            from ..metrics import Viewer
            from .dashboard import render_measurements

            viewer = Viewer(daemon.env.dirs.outputs)
            self._send_plain(
                render_measurements(viewer, q).encode(),
                "text/html; charset=utf-8",
            )

        def _h_search(self, q: dict) -> None:
            """HTML page of closed-loop breaking-point searches: rounds,
            probed frontiers, located breaking points (docs/search.md)."""
            from ..metrics import Viewer
            from .dashboard import render_search

            viewer = Viewer(daemon.env.dirs.outputs)
            self._send_plain(
                render_search(viewer, q).encode(),
                "text/html; charset=utf-8",
            )

        def _h_data(self, q: dict) -> None:
            """CSV of a series' per-run rows (reference daemon/data.go:
            header Time + tag variations, one line per run)."""
            from ..metrics import Viewer

            series = q.get("series", "")
            if not series:
                return self._deny(400, "query param `series` is missing")
            viewer = Viewer(daemon.env.dirs.outputs)
            try:
                rows = viewer.get_data(series)
            except ValueError as e:
                return self._deny(400, str(e))
            import csv as _csv
            import io as _io

            variations = sorted({v for r in rows for v in r.fields})
            buf = _io.StringIO()
            w = _csv.writer(buf)
            w.writerow(["Time", "Run"] + variations)
            for r in rows:
                w.writerow(
                    [f"{r.timestamp:.3f}", r.run]
                    + [
                        (f"{r.fields[v]:.9g}" if v in r.fields else "")
                        for v in variations
                    ]
                )
            self._send_plain(buf.getvalue().encode(), "text/csv")

        def _h_journal(self, q: dict) -> None:
            """Run journal from the task result (reference
            daemon/journal.go; ours carries the sim runner's journal
            instead of pod statuses)."""
            tid = q.get("task_id", "")
            if not tid:
                return self._deny(400, "url param `task_id` is missing")
            t = daemon.engine.get_task(tid)
            journal = (t.result or {}).get("journal") if t else None
            if not journal:
                return self._send_plain(
                    b"No events or statuses captured for this run.\n"
                )
            self._send_plain(
                json.dumps(journal, indent=2).encode() + b"\n",
                "application/json",
            )

        def _send_plain(
            self, body: bytes, ctype: str = "text/plain"
        ) -> None:
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return Handler


class _ChunkedBody:
    """Wraps the raw socket file with HTTP/1.1 chunked transfer encoding
    (http.server doesn't frame chunks for us)."""

    def __init__(self, wfile):
        self._wfile = wfile
        self._closed = False

    def write(self, data: bytes) -> int:
        if self._closed or not data:
            return 0
        self._wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
        return len(data)

    def flush(self) -> None:
        if not self._closed:
            self._wfile.flush()

    def finish(self) -> None:
        if not self._closed:
            self._closed = True
            self._wfile.write(b"0\r\n\r\n")
            self._wfile.flush()


def _parse_multipart(body: bytes, content_type: str) -> dict[str, bytes]:
    """multipart/form-data → {field name: raw bytes}, via the stdlib MIME
    parser (exact CRLF framing; binary-safe)."""
    msg = BytesParser().parsebytes(
        f"Content-Type: {content_type}\r\n\r\n".encode() + body
    )
    if not msg.is_multipart():
        raise ValueError("malformed multipart body")
    parts: dict[str, bytes] = {}
    for part in msg.get_payload():
        name = part.get_param("name", header="content-disposition")
        if name:
            parts[str(name)] = part.get_payload(decode=True) or b""
    return parts


def _safe_extract(zf: zipfile.ZipFile, dest: Path) -> None:
    """Extract refusing path traversal (uploaded archives are untrusted)."""
    dest = dest.resolve()
    for info in zf.infolist():
        target = (dest / info.filename).resolve()
        if not target.is_relative_to(dest):
            raise ValueError(f"zip entry escapes destination: {info.filename}")
    zf.extractall(dest)
