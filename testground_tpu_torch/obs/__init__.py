"""Fleet metrics plane (a copy of ``testground_tpu/obs/__init__.py``
without the federation coordinator's exposition merge): a minimal
counter/gauge/histogram registry with Prometheus text exposition
(``text/plain; version=0.0.4``) and no third-party deps.

Upstream Testground's daemon continuously pushes runtime metrics so
operators can watch the *platform*, not just individual runs. This
module is our scrape-side equivalent: every daemon serves
``GET /metrics`` from the process-global ``REGISTRY`` here.

It is host-only: it is shared by the daemon and by the runner's
instrumentation, which bumps its counters at chunk boundaries and lease
admission, never inside a captured tick, so a run with the counters
captures the same CUDA graph as one without.

Env knobs (all parsed with the warn-once-on-malformed pattern from
sim/runner.py — a bad value must never crash a run):

- ``TG_METRICS=0|off``      disable the registry (inc/observe become
                            no-ops; ``render()`` returns a stub line)
- ``TG_METRICS_MAX_SERIES`` per-family label-set cardinality cap
                            (default 512; drops are counted in
                            ``tg_metrics_dropped_series_total``)
- ``TG_METRICS_HISTORY``    per-family history ring length for the
                            /fleet sparklines (default 90 samples)
"""

from __future__ import annotations

import math
import os
import sys
import threading
import time
from collections import deque

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_WARNED_ENV: dict = {}


def _env_num(name: str, default, parse):
    """Warn once per bad value instead of raising or silently
    defaulting (same contract as sim/runner.py:_env_num)."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return parse(raw)
    except ValueError:
        if _WARNED_ENV.get(name) != raw:
            _WARNED_ENV[name] = raw
            print(
                f"WARNING: ignoring malformed {name}={raw!r} "
                f"(not a number); using default {default}",
                file=sys.stderr,
            )
        return default


def _env_int(name: str, default: int) -> int:
    return _env_num(name, default, int)


def enabled() -> bool:
    """The global off-switch. Off means every inc()/observe() is a
    no-op and render() emits a single stub gauge — the daemon route
    stays up so scrapers see the plane is intentionally dark."""
    return os.environ.get("TG_METRICS", "").strip().lower() not in (
        "0",
        "off",
        "false",
    )


def _escape_label(value: str) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _escape_help(text: str) -> str:
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(value: float) -> str:
    """Prometheus-friendly number: integers without a trailing .0,
    +Inf for the unbounded bucket."""
    if value == math.inf:
        return "+Inf"
    if float(value).is_integer() and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


def _labels_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _labels_text(key: tuple, extra: str = "") -> str:
    parts = [f'{k}="{_escape_label(v)}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Family:
    """One metric family: a name, a HELP line, a TYPE, and a map of
    label-set -> value (counter/gauge) or -> histogram state."""

    def __init__(self, registry: "Registry", name: str, help: str, kind: str,
                 buckets=None):
        self.registry = registry
        self.name = name
        self.help = help
        self.kind = kind
        self.buckets = tuple(buckets) if buckets else ()
        self._values: dict = {}

    # -- series admission (cardinality cap) --------------------------
    def _series(self, labels: dict, make):
        key = _labels_key(labels)
        ent = self._values.get(key)
        if ent is None:
            if len(self._values) >= self.registry.max_series():
                self.registry.note_dropped(self.name)
                return None, key
            ent = self._values[key] = make()
        return ent, key


class Counter(_Family):
    def __init__(self, registry, name, help):
        super().__init__(registry, name, help, "counter")

    def inc(self, amount: float = 1.0, **labels) -> None:
        if not enabled():
            return
        with self.registry._lock:
            ent, key = self._series(labels, lambda: [0.0])
            if ent is not None:
                ent[0] += amount

    def value(self, **labels) -> float:
        with self.registry._lock:
            ent = self._values.get(_labels_key(labels))
            return ent[0] if ent else 0.0


class Gauge(_Family):
    def __init__(self, registry, name, help):
        super().__init__(registry, name, help, "gauge")

    def set(self, value: float, **labels) -> None:
        if not enabled():
            return
        with self.registry._lock:
            ent, key = self._series(labels, lambda: [0.0])
            if ent is not None:
                ent[0] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        if not enabled():
            return
        with self.registry._lock:
            ent, key = self._series(labels, lambda: [0.0])
            if ent is not None:
                ent[0] += amount

    def value(self, **labels) -> float:
        with self.registry._lock:
            ent = self._values.get(_labels_key(labels))
            return ent[0] if ent else 0.0


# dispatch-scale defaults: chunk dispatches span ~1ms (cpu sim) to
# minutes (wedged); log-spaced so the /fleet p95 is readable at both ends
DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
    30.0, 60.0, 120.0,
)


class Histogram(_Family):
    def __init__(self, registry, name, help, buckets=None):
        super().__init__(registry, name, help, "histogram",
                         buckets or DEFAULT_BUCKETS)

    def observe(self, value: float, **labels) -> None:
        if not enabled():
            return
        with self.registry._lock:
            ent, key = self._series(
                labels,
                lambda: {"buckets": [0] * len(self.buckets),
                         "sum": 0.0, "count": 0},
            )
            if ent is None:
                return
            v = float(value)
            ent["sum"] += v
            ent["count"] += 1
            for i, ub in enumerate(self.buckets):
                if v <= ub:
                    ent["buckets"][i] += 1

    def count(self, **labels) -> int:
        with self.registry._lock:
            ent = self._values.get(_labels_key(labels))
            return ent["count"] if ent else 0


class Registry:
    """Process-global metric store. Families are created idempotently
    (``counter(name, help)`` returns the existing family on repeat
    calls — many Engine instances in one test process share series),
    and scrape-time ``collectors`` let point-in-time gauges (queue
    depth, lease headroom, heartbeat staleness) be computed at render
    without a background thread."""

    def __init__(self):
        self._lock = threading.RLock()
        self._families: "dict[str, _Family]" = {}
        self._collectors: list = []
        self._dropped: dict = {}
        self._history: "dict[str, deque]" = {}

    # -- family constructors -----------------------------------------
    def counter(self, name: str, help: str) -> Counter:
        return self._family(name, help, Counter)

    def gauge(self, name: str, help: str) -> Gauge:
        return self._family(name, help, Gauge)

    def histogram(self, name: str, help: str, buckets=None) -> Histogram:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = Histogram(
                    self, name, help, buckets
                )
            return fam

    def _family(self, name, help, cls):
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = cls(self, name, help)
            return fam

    # -- scrape-time collectors --------------------------------------
    def register_collector(self, fn) -> None:
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def unregister_collector(self, fn) -> None:
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    # -- limits ------------------------------------------------------
    def max_series(self) -> int:
        return max(1, _env_int("TG_METRICS_MAX_SERIES", 512))

    def note_dropped(self, family: str) -> None:
        self._dropped[family] = self._dropped.get(family, 0) + 1

    # -- exposition --------------------------------------------------
    def render(self) -> str:
        """The Prometheus text exposition for this process."""
        if not enabled():
            return (
                "# HELP tg_metrics_enabled Metrics plane on/off switch "
                "(TG_METRICS).\n"
                "# TYPE tg_metrics_enabled gauge\n"
                "tg_metrics_enabled 0\n"
            )
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn()
            except Exception:
                # a broken collector must never take down /metrics
                pass
        out = []
        with self._lock:
            for name in sorted(self._families):
                fam = self._families[name]
                out.append(f"# HELP {name} {_escape_help(fam.help)}")
                out.append(f"# TYPE {name} {fam.kind}")
                for key in sorted(fam._values):
                    ent = fam._values[key]
                    if fam.kind == "histogram":
                        cum = 0
                        for i, ub in enumerate(fam.buckets):
                            cum = ent["buckets"][i]
                            out.append(
                                f"{name}_bucket"
                                f"{_labels_text(key, 'le=' + chr(34) + _fmt(ub) + chr(34))}"
                                f" {_fmt(cum)}"
                            )
                        out.append(
                            f"{name}_bucket"
                            f"{_labels_text(key, 'le=' + chr(34) + '+Inf' + chr(34))}"
                            f" {_fmt(ent['count'])}"
                        )
                        out.append(
                            f"{name}_sum{_labels_text(key)} {_fmt(ent['sum'])}"
                        )
                        out.append(
                            f"{name}_count{_labels_text(key)}"
                            f" {_fmt(ent['count'])}"
                        )
                    else:
                        out.append(
                            f"{name}{_labels_text(key)} {_fmt(ent[0])}"
                        )
            if self._dropped:
                out.append(
                    "# HELP tg_metrics_dropped_series_total Label sets "
                    "dropped by the TG_METRICS_MAX_SERIES cardinality cap."
                )
                out.append("# TYPE tg_metrics_dropped_series_total counter")
                for famname in sorted(self._dropped):
                    out.append(
                        "tg_metrics_dropped_series_total"
                        f'{{family="{_escape_label(famname)}"}}'
                        f" {self._dropped[famname]}"
                    )
        return "\n".join(out) + "\n"

    # -- /fleet sparkline history ------------------------------------
    def sample_history(self, now: float = None) -> None:
        """Append the current per-family total to a bounded ring —
        the /fleet sparklines' data source (one point per scrape)."""
        if not enabled():
            return
        now = time.time() if now is None else now
        maxlen = max(2, _env_int("TG_METRICS_HISTORY", 90))
        with self._lock:
            for name, fam in self._families.items():
                if fam.kind == "histogram":
                    total = sum(e["count"] for e in fam._values.values())
                else:
                    total = sum(e[0] for e in fam._values.values())
                ring = self._history.get(name)
                if ring is None or ring.maxlen != maxlen:
                    ring = self._history[name] = deque(
                        ring or (), maxlen=maxlen
                    )
                ring.append((now, total))

    def history(self, name: str) -> list:
        with self._lock:
            return list(self._history.get(name, ()))

    # -- test hygiene ------------------------------------------------
    def reset(self) -> None:
        with self._lock:
            self._families.clear()
            self._collectors.clear()
            self._dropped.clear()
            self._history.clear()


REGISTRY = Registry()


def counter(name: str, help: str) -> Counter:
    return REGISTRY.counter(name, help)


def gauge(name: str, help: str) -> Gauge:
    return REGISTRY.gauge(name, help)


def histogram(name: str, help: str, buckets=None) -> Histogram:
    return REGISTRY.histogram(name, help, buckets)


def render() -> str:
    return REGISTRY.render()


# ------------------------------------------------------------------
# Exposition parsing (the /fleet page's per-family totals).
# ------------------------------------------------------------------


def _parse_labels(body: str) -> dict:
    """``a="x",b="y\\""`` -> {a: 'x', b: 'y"'} (unescapes the three
    escape sequences the exposition format defines)."""
    labels = {}
    i = 0
    n = len(body)
    while i < n:
        eq = body.index("=", i)
        key = body[i:eq].strip().lstrip(",").strip()
        i = eq + 1
        if i >= n or body[i] != '"':
            raise ValueError(f"unquoted label value near {body[i:]!r}")
        i += 1
        buf = []
        while i < n:
            ch = body[i]
            if ch == "\\" and i + 1 < n:
                nxt = body[i + 1]
                buf.append({"n": "\n", '"': '"', "\\": "\\"}.get(nxt, nxt))
                i += 2
                continue
            if ch == '"':
                i += 1
                break
            buf.append(ch)
            i += 1
        labels[key] = "".join(buf)
        while i < n and body[i] in ", ":
            i += 1
    return labels


def parse_exposition(text: str) -> dict:
    """Prometheus text -> {family: {"type","help","samples":[(suffixed
    name, labels dict, value), ...]}}. Tolerant of unknown lines."""
    fams: dict = {}

    def fam(name):
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in fams:
                base = name[: -len(suffix)]
                break
        return fams.setdefault(
            base, {"type": "untyped", "help": "", "samples": []}
        )

    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            _, _, rest = line.partition("# HELP ")
            name, _, help_text = rest.partition(" ")
            fams.setdefault(
                name, {"type": "untyped", "help": "", "samples": []}
            )["help"] = help_text
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, kind = rest.partition(" ")
            fams.setdefault(
                name, {"type": "untyped", "help": "", "samples": []}
            )["type"] = kind.strip()
            continue
        if line.startswith("#"):
            continue
        try:
            if "{" in line:
                name = line[: line.index("{")]
                body = line[line.index("{") + 1 : line.rindex("}")]
                labels = _parse_labels(body) if body.strip() else {}
                value = float(line[line.rindex("}") + 1 :].strip().split()[0])
            else:
                name, rest = line.split(None, 1)
                labels = {}
                value = float(rest.split()[0])
        except (ValueError, IndexError):
            continue
        fam(name)["samples"].append((name, labels, value))
    return fams
