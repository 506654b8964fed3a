"""Metrics query layer (a copy of ``testground_tpu.metrics``; reference
pkg/metrics/viewer.go).

The reference stores instance metrics in InfluxDB (``results.*`` series
tagged plan/case/run/group_id) and the daemon dashboard queries them via
``Viewer``. The TPU-native sink is the outputs tree itself — per-instance
``results.out`` / ``diagnostics.out`` JSON lines written by the SDK
recorders (sdk/runtime.py MetricsRecorder), or the combined per-run
``results.out`` written by sim:jax — so the Viewer here scans those files
and exposes the same query surface: measurements, tags, tag values, data
rows keyed by run.
"""

from .viewer import EVENTS_FILE, PROGRESS_FILE, Row, Viewer, read_progress

__all__ = [
    "EVENTS_FILE", "PROGRESS_FILE", "Row", "Viewer", "read_progress",
]
