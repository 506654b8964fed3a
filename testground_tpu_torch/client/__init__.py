"""Typed HTTP client for the daemon (a copy of ``testground_tpu.client``;
reference pkg/client/client.go:62-515).

Mirrors the reference surface: Build, Run, Tasks, Status, Logs,
CollectOutputs, Terminate, Kill, Delete, Healthcheck — each consuming the
daemon's chunk-stream responses (``testground_tpu_torch.rpc``).
"""

from __future__ import annotations

import io
import json
import time
import zipfile
from http.client import HTTPConnection, HTTPException
from pathlib import Path
from typing import Any, Callable, Optional
from urllib.parse import urlencode, urlparse

from ..rpc.chunks import RPCError, read_response

__all__ = ["Client", "RPCError", "zip_dir"]


def zip_dir(path: str | Path) -> bytes:
    """Zips a directory tree for upload (reference client.go:70-225 zips the
    plan/sdk dirs into the multipart request)."""
    root = Path(path)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for p in sorted(root.rglob("*")):
            if p.is_file() and "__pycache__" not in p.parts:
                zf.write(p, p.relative_to(root))
    return buf.getvalue()


class Client:
    # the follow-mode reconnect policy (one retry, capped backoff):
    # long-poll streams (/progress, /logs, /events) ride connections
    # that idle for minutes — a mid-stream reset (worker death behind a
    # federation coordinator, an LB idle timeout) should resume from
    # since=<lines delivered>, not surface a raw socket error
    _FOLLOW_RETRIES = 1
    _FOLLOW_BACKOFF_S = 1.0
    _FOLLOW_BACKOFF_CAP_S = 2.0

    def __init__(self, endpoint: str, token: str = "", timeout: float = 600.0):
        u = urlparse(endpoint)
        self._host = u.hostname or "localhost"
        self._port = u.port or 8042
        self._token = token
        self._timeout = timeout

    # ------------------------------------------------------------ plumbing

    def _request(
        self,
        method: str,
        path: str,
        query: Optional[dict] = None,
        body: Optional[bytes] = None,
        content_type: str = "application/json",
    ):
        conn = HTTPConnection(self._host, self._port, timeout=self._timeout)
        headers = {}
        if self._token:
            headers["Authorization"] = f"Bearer {self._token}"
        if body is not None:
            headers["Content-Type"] = content_type
            headers["Content-Length"] = str(len(body))
        if query:
            path = f"{path}?{urlencode(query)}"
        conn.request(method, path, body=body, headers=headers)
        resp = conn.getresponse()
        if resp.status != 200:
            detail = resp.read().decode(errors="replace")
            conn.close()
            raise RPCError(f"HTTP {resp.status}: {detail}")
        return conn, resp

    def _call(
        self,
        method: str,
        path: str,
        query: Optional[dict] = None,
        body: Optional[bytes] = None,
        content_type: str = "application/json",
        on_progress: Optional[Callable[[str], None]] = None,
        binary_sink=None,
    ) -> Any:
        conn, resp = self._request(method, path, query, body, content_type)
        try:
            return read_response(
                resp, on_progress=on_progress, binary_sink=binary_sink
            )
        finally:
            conn.close()

    def _multipart(
        self, composition_payload: dict, plan_zip: Optional[bytes]
    ) -> tuple[bytes, str]:
        boundary = "tgtpuboundary7b9f2c"
        parts = [
            (
                "composition",
                "application/json",
                json.dumps(composition_payload).encode(),
            )
        ]
        if plan_zip is not None:
            parts.append(("plan", "application/zip", plan_zip))
        buf = io.BytesIO()
        for name, ctype, data in parts:
            buf.write(f"--{boundary}\r\n".encode())
            buf.write(
                f'Content-Disposition: form-data; name="{name}"\r\n'
                f"Content-Type: {ctype}\r\n\r\n".encode()
            )
            buf.write(data)
            buf.write(b"\r\n")
        buf.write(f"--{boundary}--\r\n".encode())
        return buf.getvalue(), f"multipart/form-data; boundary={boundary}"

    # ------------------------------------------------------------ endpoints

    def _queue(
        self,
        kind: str,
        composition,
        plan_dir: Optional[str] = None,
        plan_zip: Optional[bytes] = None,
        priority: int = 0,
        created_by: Optional[dict] = None,
        extra: Optional[dict] = None,
        on_progress: Optional[Callable[[str], None]] = None,
    ) -> str:
        """``plan_zip`` forwards an already-zipped plan verbatim (the
        federation coordinator re-submitting an upload); ``extra``
        merges additional payload fields (task_id / routed_to /
        attempts / resume — the routed-submission surface)."""
        comp_dict = (
            composition if isinstance(composition, dict)
            else composition.to_dict()
        )
        payload = {
            "composition": comp_dict,
            "priority": priority,
            "created_by": created_by or {},
            **(extra or {}),
        }
        if plan_dir is not None:
            plan_zip = zip_dir(plan_dir)
        if plan_zip is not None:
            body, ctype = self._multipart(payload, plan_zip)
        else:
            body, ctype = json.dumps(payload).encode(), "application/json"
        res = self._call(
            "POST", f"/{kind}", body=body, content_type=ctype,
            on_progress=on_progress,
        )
        return res["task_id"]

    def run(self, composition, **kw) -> str:
        return self._queue("run", composition, **kw)

    def build(self, composition, **kw) -> str:
        return self._queue("build", composition, **kw)

    def prewarm(self, composition, **kw) -> str:
        """Queue a PREWARM task (compile-on-upload, docs/federation.md):
        the daemon builds, compiles and persists the composition's
        executor to the durable cache tiers without dispatching a run —
        the first real run then warm-starts with ``compiles=0``."""
        return self._queue("prewarm", composition, **kw)

    def federation(self) -> dict:
        """GET /federation: the daemon's fleet state — role, workers
        (heartbeat age, lease headroom, warm cache keys, routed-task
        counts) and routed tasks (``testground fleet ls``)."""
        return self._call("GET", "/federation")

    def _stream_follow(
        self,
        path: str,
        q: dict,
        since: int,
        follow: bool,
        on_line: Optional[Callable[[str], None]],
    ) -> Any:
        """One long-poll with the follow-mode reconnect policy: a raw
        socket error (or mid-stream truncation) while following retries
        up to ``_FOLLOW_RETRIES`` times with capped backoff, resuming
        from ``since=<lines already delivered>`` so nothing re-prints
        and nothing is lost."""
        delivered = 0

        def _on(line: str) -> None:
            nonlocal delivered
            delivered += 1
            if on_line is not None:
                on_line(line)

        attempts = 0
        while True:
            qq = dict(q)
            resume_at = since + delivered
            if resume_at:
                qq["since"] = str(resume_at)
            if follow:
                qq["follow"] = "1"
            try:
                return self._call("GET", path, query=qq, on_progress=_on)
            except RPCError as e:
                # a server-reported error is authoritative — only the
                # truncation sentinel (connection dropped before the
                # result chunk) is a transport fault worth retrying
                if not (
                    follow
                    and attempts < self._FOLLOW_RETRIES
                    and "without a result" in str(e)
                ):
                    raise
            except (OSError, HTTPException):
                # covers ConnectionResetError/BrokenPipe/IncompleteRead:
                # the socket died mid-stream
                if not (follow and attempts < self._FOLLOW_RETRIES):
                    raise
            attempts += 1
            time.sleep(
                min(
                    self._FOLLOW_BACKOFF_CAP_S,
                    self._FOLLOW_BACKOFF_S * attempts,
                )
            )

    def build_purge(self, plan: str) -> int:
        """Delete cached build artifacts for a plan (reference
        Client.BuildPurge, pkg/client/client.go:62-68)."""
        res = self._call(
            "POST", "/build/purge", body=json.dumps({"plan": plan}).encode()
        )
        return res["purged"]

    def tasks(
        self, states: Optional[list[str]] = None, limit: int = 0
    ) -> list[dict]:
        q: dict = {}
        if states:
            q["state"] = ",".join(states)
        if limit:
            q["limit"] = limit
        return self._call("GET", "/tasks", query=q)

    def status(self, task_id: str) -> dict:
        return self._call("GET", "/status", query={"task_id": task_id})

    def logs(
        self,
        task_id: str,
        follow: bool = False,
        on_line: Optional[Callable[[str], None]] = None,
    ) -> dict:
        """Streams the task log; returns {task_id, outcome}. With follow,
        blocks until the task completes — a connection reset mid-stream
        reconnects once and resumes from the next unseen line."""
        return self._stream_follow(
            "/logs", {"task_id": task_id}, 0, follow, on_line
        )

    def progress(
        self,
        task_id: str,
        follow: bool = False,
        since: int = 0,
        on_snapshot: Optional[Callable[[dict], None]] = None,
    ) -> dict:
        """Streams the run's live-plane snapshots (progress.jsonl lines,
        parsed to dicts for ``on_snapshot``); returns {task_id, outcome,
        snapshots}. With follow, long-polls until the task completes —
        the programmatic form of watching GET /live. A mid-stream
        connection reset reconnects once, resuming from ``since=`` at
        the next undelivered snapshot."""

        def on_line(line: str) -> None:
            if on_snapshot is None:
                return
            try:
                on_snapshot(json.loads(line))
            except json.JSONDecodeError:
                pass

        return self._stream_follow(
            "/progress", {"task_id": task_id}, since, follow, on_line
        )

    def events(
        self,
        task_id: str,
        follow: bool = False,
        since: int = 0,
        scenario: Optional[int] = None,
        on_event: Optional[Callable[[dict], None]] = None,
    ) -> dict:
        """Streams the drain plane's event log (trace.jsonl lines —
        Chrome trace-event objects, parsed to dicts for ``on_event``);
        returns {task_id, outcome, events}. With follow, long-polls
        until the task completes, so a long run's timeline is watchable
        mid-run; ``scenario`` selects one sweep scenario's stream. A
        mid-stream connection reset reconnects once, resuming from
        ``since=`` at the next undelivered event."""
        q: dict = {"task_id": task_id}
        if scenario is not None:
            q["scenario"] = str(scenario)

        def on_line(line: str) -> None:
            if on_event is None:
                return
            try:
                on_event(json.loads(line))
            except json.JSONDecodeError:
                pass

        return self._stream_follow(
            "/events", q, since, follow, on_line
        )

    def cache(self) -> dict:
        """The daemon's executor-cache state (disk warm-start entries,
        tier hit-rate counters, in-memory pool occupancy, live device
        leases) — GET /cache, the serving plane's ops surface."""
        return self._call("GET", "/cache")

    def cache_purge(self, key: Optional[str] = None) -> int:
        """Drop the DAEMON host's disk executor-cache entries (all, or
        those whose entry id starts with ``key``) — POST /cache/purge,
        the remote form of ``testground cache purge``."""
        res = self._call(
            "POST", "/cache/purge",
            body=json.dumps({"key": key}).encode(),
        )
        return res["purged"]

    def collect_outputs(self, task_id: str, writer) -> dict:
        """Streams the run's outputs tar.gz into ``writer``."""
        return self._call(
            "GET", "/outputs", query={"task_id": task_id}, binary_sink=writer
        )

    def kill(self, task_id: str) -> dict:
        return self._call(
            "POST", "/kill", body=json.dumps({"task_id": task_id}).encode()
        )

    def resume(self, task_id: str) -> dict:
        """Requeue an interrupted run task to continue from its last
        checkpoint — POST /resume, the durability plane's ops verb
        (docs/robustness.md)."""
        return self._call(
            "POST", "/resume",
            body=json.dumps({"task_id": task_id}).encode(),
        )

    def delete(self, task_id: str) -> dict:
        return self._call("DELETE", "/delete", query={"task_id": task_id})

    def terminate(self, runner: Optional[str] = None) -> int:
        res = self._call(
            "POST", "/terminate", body=json.dumps({"runner": runner}).encode()
        )
        return res["terminated"]

    def healthcheck(self, fix: bool = False, runner: str = None) -> dict:
        q = {}
        if fix:
            q["fix"] = "1"
        if runner:
            q["runner"] = runner
        return self._call("GET", "/healthcheck", query=q)

    def wait(self, task_id: str, on_line=None) -> str:
        """Follow logs to completion; returns the outcome string."""
        return self.logs(task_id, follow=True, on_line=on_line)["outcome"]
