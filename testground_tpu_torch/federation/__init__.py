"""Federation plane: N daemons as one serving fleet (counterpart of
``testground_tpu.federation``; docs/federation.md).

A daemon configured with ``[daemon] peers`` (or ``--peer``, repeatable)
acts as COORDINATOR: workers enroll and heartbeat into its registry,
every submitted run/prewarm routes to the best worker (cache-affinity
first, headroom second), and the task-scoped endpoints proxy through to
the owning worker so existing ``Client``/command-line code works
unchanged against the coordinator. Worker death requeues in-flight tasks
on survivors with the durability plane's attempts/backoff policy.
``POST /prewarm`` builds and captures a composition's executor into the
routed worker's in-memory pool (compile-on-upload), and the worker's
heartbeat names it, so the composition's first run routes there and
builds nothing. The port has no disk tier (ROADMAP item 11.3): warm
state does not outlive a worker's process, and there is no fleet-shared
tier.

Torch-free throughout — a coordinator never imports the sim core.
"""

from .affinity import affinity_key
from .coordinator import FederationPlane, heartbeat_interval_s
from .registry import WorkerRegistry, stale_threshold_s
from .worker import HeartbeatLoop, heartbeat_payload

__all__ = [
    "FederationPlane",
    "HeartbeatLoop",
    "WorkerRegistry",
    "affinity_key",
    "heartbeat_interval_s",
    "heartbeat_payload",
    "stale_threshold_s",
]
