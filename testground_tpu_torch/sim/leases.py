"""Device leases: admission control for concurrent runs on one card.

Counterpart of ``testground_tpu/sim/leases.py``. Two runs in one process
(two scheduler threads, or a daemon's requests) each hold their own
executor, but nothing else decides whether the card can hold both runs'
state at once. Before its warmup a run leases its footprint (the
pre-flight's ``state_model_bytes_per_device``) on its device; a run whose
footprint does not fit beside the leases already held waits until one is
released. Two runs that fit together run concurrently, two that do not
run one after the other instead of running out of memory.

A run that would never fit (its footprint alone exceeds the budget) is
admitted at once: the pre-flight already refuses an impossible run, so
the registry only orders runs that do not fit together. A bounded wait
(``TG_LEASE_WAIT_S``, default 600 s) stands in for a lost release: past
it the run goes on and its lease record says ``overcommitted: true``.
Every run's journal carries its lease record under ``lease``: its
devices, its bytes, how long admission waited and how many runs held a
lease when it was granted.
"""

from __future__ import annotations

import threading
import time

from ..obs import REGISTRY as _OBS

# the metrics plane's admission counters and live-lease gauge, under the
# JAX registry's names
_M_BYTES = _OBS.counter(
    "tg_lease_bytes_admitted_total",
    "Modeled bytes-per-device admitted by the device-lease registry.",
)
_M_WAIT_S = _OBS.counter(
    "tg_lease_wait_seconds_total",
    "Cumulative seconds runs blocked at lease admission.",
)
_M_OVERCOMMIT = _OBS.counter(
    "tg_lease_overcommitted_total",
    "Leases granted past the HBM budget after the bounded wait "
    "expired (lost-release backstop).",
)
_M_ACTIVE = _OBS.gauge(
    "tg_lease_active_runs",
    "Runs currently holding a device lease.",
)


class DeviceLeaseRegistry:
    """A thread-safe table of leases, keyed by run id."""

    def __init__(self, budget_fn=None) -> None:
        # budget_fn() -> admissible bytes a device; the default reads
        # the runner's budget when first needed
        self._budget_fn = budget_fn
        self._lock = threading.Condition()
        self._leases: dict = {}

    def _budget(self, devices) -> int:
        if self._budget_fn is not None:
            return int(self._budget_fn())
        from .runner import _HBM_FRACTION, device_hbm_bytes

        # a card's index, or "cpu"
        dev = (f"cuda:{devices[0]}" if devices and devices[0] != "cpu"
               else "cpu")
        return int(device_hbm_bytes(dev) * _HBM_FRACTION)

    def _committed(self, devices) -> int:
        """The most bytes leased on any of ``devices``."""
        per_dev: dict = {}
        for lease in self._leases.values():
            for d in lease["devices"]:
                per_dev[d] = per_dev.get(d, 0) + lease["bytes_per_device"]
        return max((per_dev.get(d, 0) for d in devices), default=0)

    def acquire(self, run_id: str, devices: list, bytes_per_device: int,
                wait_timeout_s: float = 600.0, should_stop=None) -> dict:
        """Wait until ``bytes_per_device`` fits on every one of
        ``devices`` beside the leases held, then hold it; returns the
        journal's record. ``should_stop`` (the run's kill flag) ends the
        wait early: a killed run stops at its first chunk boundary."""
        t0 = time.monotonic()
        budget = self._budget(devices)
        overcommitted = False
        with self._lock:
            # a retried run's earlier lease is replaced, not added to
            self._leases.pop(run_id, None)
            while (self._committed(devices) + bytes_per_device > budget
                   and bytes_per_device <= budget):
                if should_stop is not None and should_stop():
                    break
                remaining = wait_timeout_s - (time.monotonic() - t0)
                if remaining <= 0 or not self._lock.wait(
                        timeout=min(remaining, 5.0)):
                    if time.monotonic() - t0 >= wait_timeout_s:
                        overcommitted = True
                        break
            concurrent = len(self._leases)
            self._leases[run_id] = {
                "devices": list(devices),
                "bytes_per_device": int(bytes_per_device),
                "granted": time.time(),
            }
        waited = time.monotonic() - t0
        _M_BYTES.inc(bytes_per_device)
        _M_WAIT_S.inc(round(waited, 3))
        if overcommitted:
            _M_OVERCOMMIT.inc()
        _M_ACTIVE.set(concurrent + 1)
        rec = {
            "devices": list(devices),
            "bytes_per_device": int(bytes_per_device),
            "hbm_budget_bytes_per_device": budget,
            "waited_s": round(waited, 3),
            "concurrent_runs": concurrent,
        }
        if overcommitted:
            rec["overcommitted"] = True
        return rec

    def release(self, run_id: str) -> None:
        """Drop ``run_id``'s lease, if it holds one, and wake the runs
        waiting for room."""
        with self._lock:
            if self._leases.pop(run_id, None) is not None:
                self._lock.notify_all()
            _M_ACTIVE.set(len(self._leases))

    def active(self) -> dict:
        """The leases held now, by run id."""
        with self._lock:
            return {k: dict(v) for k, v in self._leases.items()}


# the process's registry, through which every run path leases
LEASES = DeviceLeaseRegistry()
