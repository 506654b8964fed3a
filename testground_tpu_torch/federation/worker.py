"""Worker side of the federation plane: the heartbeat (counterpart of
``testground_tpu/federation/worker.py``).

A worker daemon learns its coordinator from ``POST /federation/enroll``
(the coordinator introduces itself with a callback endpoint and the
name it knows the worker by) and then pushes ``POST
/federation/heartbeat`` every ``interval`` seconds, carrying everything
the routing policy reads, under the JAX worker's keys:

- ``fingerprint``  the device this worker's runs use: platform, device
  name and count, the torch and CUDA versions — reported once this
  process has initialised CUDA (a daemon serving the card does so as it
  starts); otherwise ``{}``: a heartbeat never initialises the card;
- ``lease``        free device-memory headroom from the lease registry
  (sim/leases.py) — ``free_bytes: null`` until the first run has
  loaded it;
- ``cache_keys``   affinity digests of every executor the runner's
  in-memory pool holds (federation/notes.py);
- ``queue_depth``  scheduled + processing tasks.

Heartbeat delivery is best-effort: a down coordinator is retried every
interval forever (the coordinator also re-enrolls stale peers, so
either side heals the pairing).
"""

from __future__ import annotations

import json
import sys
import threading
import time
from typing import Optional

from ..obs import counter as _obs_counter
from . import notes

# fleet metrics plane: the worker side's one family — delivered beats
# (the coordinator counts received ones in tg_fed_heartbeats_total)
_M_BEATS_SENT = _obs_counter(
    "tg_fed_heartbeats_sent_total",
    "Heartbeats this worker successfully delivered to its coordinator.",
)

_SIM_LEASES = "testground_tpu_torch.sim.leases"


def _fingerprint(device="cuda") -> dict:
    """The card this worker's runs use, ONLY once this process has
    initialised CUDA (torch's import and the card's initialisation are
    never paid from the heartbeat thread)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return {}
    try:
        if not torch.cuda.is_initialized():
            return {}
        dev = torch.device(device)
        idx = (dev.index if dev.type == "cuda" and dev.index is not None
               else torch.cuda.current_device())
        return {
            "platform": "cuda",
            "device_kind": torch.cuda.get_device_name(idx),
            "n_devices": torch.cuda.device_count(),
            "torch": torch.__version__,
            "cuda": torch.version.cuda or "",
        }
    except Exception:  # noqa: BLE001 — heartbeat is best-effort
        return {}


def _lease_info(device="cuda") -> dict:
    """Free lease headroom (max committed bytes across devices vs the
    admissible budget). Unknown until a run has loaded the lease
    registry — the routing policy treats that as an idle worker."""
    sim_leases = sys.modules.get(_SIM_LEASES)
    if sim_leases is None:
        return {"free_bytes": None, "active_leases": 0}
    try:
        reg = sim_leases.LEASES
        active = reg.active()
        per_dev: dict = {}
        for lease in active.values():
            for d in lease["devices"]:
                per_dev[d] = per_dev.get(d, 0) + lease["bytes_per_device"]
        if per_dev:
            busiest = max(per_dev, key=per_dev.get)
        elif str(device).startswith("cuda"):
            # the lease registry names a card by its index
            busiest = str(device).partition(":")[2] or "0"
        else:
            busiest = "cpu"
        budget = int(reg._budget([busiest]))
        committed = per_dev.get(busiest, 0)
        return {
            "free_bytes": max(0, budget - committed),
            "budget_bytes": budget,
            "active_leases": len(active),
        }
    except Exception:  # noqa: BLE001
        return {"free_bytes": None, "active_leases": 0}


def heartbeat_payload(engine, worker: str, endpoint: str) -> dict:
    """One heartbeat body (pure function of current process state —
    unit-testable without a coordinator)."""
    from ..task import STATE_PROCESSING

    try:
        processing = len(engine.storage.by_state(STATE_PROCESSING))
    except Exception:  # noqa: BLE001
        processing = 0
    device = getattr(engine, "device", "cuda")
    return {
        "worker": worker,
        "endpoint": endpoint,
        "time": time.time(),
        "fingerprint": _fingerprint(device),
        "lease": _lease_info(device),
        "cache_keys": notes.affinity_keys(),
        "queue_depth": len(engine.queue) + processing,
        "tasks_processing": processing,
    }


class HeartbeatLoop:
    """Background pusher started (or retargeted) by /federation/enroll."""

    def __init__(
        self,
        engine,
        coordinator: str,
        worker: str,
        endpoint: str,
        interval_s: float = 2.0,
        token: str = "",
    ) -> None:
        self.engine = engine
        self.coordinator = coordinator
        self.worker = worker
        self.endpoint = endpoint
        self.interval_s = max(0.05, float(interval_s))
        self.token = token
        self.sent = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "HeartbeatLoop":
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def retarget(
        self, coordinator: str, worker: str, interval_s: float
    ) -> None:
        """An enroll from a (possibly new) coordinator re-aims the
        existing loop instead of stacking threads."""
        self.coordinator = coordinator
        self.worker = worker
        self.interval_s = max(0.05, float(interval_s))

    def beat_once(self) -> bool:
        """Send one heartbeat now; False on any delivery failure."""
        from ..client import Client

        try:
            payload = heartbeat_payload(
                self.engine, self.worker, self.endpoint
            )
            Client(self.coordinator, token=self.token, timeout=5.0)._call(
                "POST",
                "/federation/heartbeat",
                body=json.dumps(payload).encode(),
            )
            self.sent += 1
            _M_BEATS_SENT.inc()
            return True
        except Exception:  # noqa: BLE001 — coordinator down: keep trying
            return False

    def _loop(self) -> None:
        # first beat fires immediately — the coordinator that just
        # enrolled us is waiting on it to mark us alive
        while True:
            self.beat_once()
            if self._stop.wait(self.interval_s):
                return

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
