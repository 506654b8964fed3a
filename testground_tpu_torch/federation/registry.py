"""Worker registry + routing policy (the coordinator's member table; a
copy of ``testground_tpu/federation/registry.py``).

Every worker heartbeat (``POST /federation/heartbeat``, built by
federation/worker.py) lands here; the routing decision reads nothing
else. Policy — cache-affinity first, headroom second:

1. only workers with a FRESH heartbeat (age < ``stale_s``) are
   candidates;
2. a worker whose reported cache-key set contains the submission's
   affinity digest wins outright (its executor pool already holds the
   built and captured program — the run builds and captures nothing);
3. ties — several warm workers, or none — break by free lease bytes
   (sim/leases.py headroom: the worker with the most admissible device
   memory dispatches soonest), then by queue depth, then by name for
   determinism.

A worker that has never reported a lease budget (no run has leased
there yet) is treated as having infinite headroom: an idle fresh worker
is the best cold destination there is.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

DEFAULT_STALE_S = 10.0


def stale_threshold_s() -> float:
    """Heartbeat age beyond which a worker counts as lost
    (``TG_FED_STALE_S``; malformed values fall back to the default —
    liveness policy must not crash the coordinator)."""
    raw = os.environ.get("TG_FED_STALE_S", "")
    try:
        return float(raw) if raw else DEFAULT_STALE_S
    except ValueError:
        return DEFAULT_STALE_S


class WorkerRegistry:
    """Thread-safe heartbeat table keyed by worker name (the peer
    address the coordinator dials it at)."""

    def __init__(self, stale_s: Optional[float] = None, clock=time.monotonic):
        self._stale_s = stale_s
        self._clock = clock
        self._lock = threading.Lock()
        self._workers: dict[str, dict] = {}  # name -> {seen, payload}

    @property
    def stale_s(self) -> float:
        return self._stale_s if self._stale_s is not None else stale_threshold_s()

    def update(self, name: str, payload: dict) -> None:
        with self._lock:
            self._workers[name] = {
                "seen": self._clock(),
                "payload": dict(payload or {}),
            }

    def forget(self, name: str) -> None:
        with self._lock:
            self._workers.pop(name, None)

    def _age(self, rec: dict) -> float:
        return max(0.0, self._clock() - rec["seen"])

    def rows(self) -> list[dict]:
        """Every known worker with its heartbeat age and liveness —
        the GET /federation + fleet-page view."""
        with self._lock:
            items = sorted(self._workers.items())
            out = []
            for name, rec in items:
                p = rec["payload"]
                age = self._age(rec)
                out.append(
                    {
                        "worker": name,
                        "endpoint": p.get("endpoint", ""),
                        "heartbeat_age_s": round(age, 3),
                        "alive": age < self.stale_s,
                        "queue_depth": int(p.get("queue_depth", 0)),
                        "lease": p.get("lease") or {},
                        "cache_keys": list(p.get("cache_keys") or []),
                        "fingerprint": p.get("fingerprint") or {},
                    }
                )
        return out

    def alive(self) -> list[dict]:
        return [r for r in self.rows() if r["alive"]]

    def lost(self) -> list[str]:
        """Workers that HAVE heartbeated but went stale — the requeue
        trigger (a peer that never enrolled is unknown, not lost)."""
        return [r["worker"] for r in self.rows() if not r["alive"]]

    def endpoint(self, name: str) -> Optional[str]:
        with self._lock:
            rec = self._workers.get(name)
        return (rec["payload"].get("endpoint") or name) if rec else None

    def route(
        self, affinity: str = "", exclude=(), extra_load=None
    ) -> Optional[str]:
        """Pick the worker for a submission: cache-affinity first,
        headroom second (docstring above). ``extra_load`` maps worker →
        tasks the CALLER has routed there since the last heartbeat
        (heartbeat queue depths lag by one interval, so without it a
        burst of submissions would all pile onto one worker). Returns
        the worker name, or None when no live worker remains (the
        caller then queues locally)."""
        cand = [r for r in self.alive() if r["worker"] not in set(exclude)]
        if not cand:
            return None
        warm = [r for r in cand if affinity and affinity in r["cache_keys"]]
        pool = warm or cand

        def headroom(r: dict) -> float:
            free = (r.get("lease") or {}).get("free_bytes")
            return float("inf") if free is None else float(free)

        def depth(r: dict) -> int:
            return r["queue_depth"] + (extra_load or {}).get(
                r["worker"], 0
            )

        pool.sort(key=lambda r: (-headroom(r), depth(r), r["worker"]))
        return pool[0]["worker"]
