"""The composition tables of the fault, observer and replay planes:
``[faults]``, ``[trace]``, ``[telemetry]`` and ``[replay]``.

The port's own copy of those tables of ``testground_tpu/api/composition.py``
(the port imports nothing of the JAX package, not even its jax-free
modules): the same fields and defaults, ``from_dict``, validation,
``$param`` references and did-you-mean errors, message for message.
"""

from __future__ import annotations

import difflib
from dataclasses import dataclass, field
from typing import Any, Optional


class CompositionError(ValueError):
    """Raised when a composition table fails validation."""


def _reject_unknown_keys(d: dict, known, tag: str) -> None:
    """Unknown keys in a table are operator errors: the error names the
    nearest valid key."""
    extra = sorted(set(d) - set(known))
    if not extra:
        return
    hints = []
    for k in extra:
        close = difflib.get_close_matches(str(k), sorted(known), n=1)
        hints.append(
            repr(k) + (f" (did you mean {close[0]!r}?)" if close else "")
        )
    raise CompositionError(
        f"{tag}: unknown fields {', '.join(hints)}; known: {sorted(known)}"
    )


# ------------------------------------------------------------------ faults

# hard bound on [faults] events
MAX_FAULT_EVENTS = 64

FAULT_KINDS = ("partition", "heal", "degrade", "kill", "restart")


def _fault_num(v, name: str, allow_ref: bool = True):
    """A fault-event numeric field: a number, or a ``"$param"`` reference
    resolved against test params when the schedule compiles
    (sim/faults.py). Returns the normalized value."""
    if isinstance(v, str):
        if allow_ref and v.startswith("$") and len(v) > 1:
            return v
        raise CompositionError(
            f"faults: {name} must be a number"
            + (" or a '$param' reference" if allow_ref else "")
            + f", got {v!r}"
        )
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise CompositionError(f"faults: {name} must be a number, got {v!r}")
    return float(v)


@dataclass
class FaultEvent:
    """One timed event of the fault schedule (``[[faults.events]]``):
    ``partition``/``heal`` (a symmetric block window between groups
    ``a`` and ``b``, ``"*"`` = any group), ``degrade`` (latency, jitter
    and loss on the pair for ``[at_ms, until_ms)``), ``kill`` (a
    seed-chosen ``fraction`` or ``count`` of ``group`` crashes) and
    ``restart`` (every fault-killed member of ``group`` rejoins with
    fresh memory). Numeric fields but partition/heal times accept
    ``"$param"`` references."""

    kind: str = ""
    at_ms: Any = 0.0
    until_ms: Any = None  # degrade window end
    a: str = ""  # group pair (partition/heal/degrade); "*" = any
    b: str = ""
    latency_ms: Any = 0.0  # degrade magnitudes
    jitter_ms: Any = 0.0
    loss_pct: Any = 0.0
    group: str = ""  # kill/restart target
    fraction: Any = 0.0  # kill: fraction of the group (0, 1]
    count: int = 0  # kill: absolute victim count (XOR fraction)

    def validate(self, index: int) -> None:
        tag = f"faults.events[{index}]"
        if self.kind not in FAULT_KINDS:
            raise CompositionError(
                f"{tag}: unknown kind {self.kind!r}; expected one of "
                f"{', '.join(FAULT_KINDS)}"
            )
        # partition/heal timing is structural (window pairing) — no refs
        at = _fault_num(
            self.at_ms, f"{tag}.at_ms",
            allow_ref=self.kind not in ("partition", "heal"),
        )
        if isinstance(at, float) and at < 0:
            raise CompositionError(f"{tag}: at_ms must be >= 0")
        if self.kind in ("partition", "heal", "degrade"):
            if not self.a or not self.b:
                raise CompositionError(
                    f"{tag}: {self.kind} needs group pair 'a' and 'b'"
                )
            if self.group:
                raise CompositionError(
                    f"{tag}: {self.kind} uses 'a'/'b', not 'group'"
                )
        if self.kind == "degrade":
            if self.until_ms is None:
                raise CompositionError(
                    f"{tag}: degrade needs an until_ms window end"
                )
            until = _fault_num(self.until_ms, f"{tag}.until_ms")
            if (
                isinstance(until, float)
                and isinstance(at, float)
                and until <= at
            ):
                raise CompositionError(
                    f"{tag}: degrade window is empty or inverted "
                    f"(until_ms={until} <= at_ms={at})"
                )
            mags = [
                _fault_num(self.latency_ms, f"{tag}.latency_ms"),
                _fault_num(self.jitter_ms, f"{tag}.jitter_ms"),
                _fault_num(self.loss_pct, f"{tag}.loss_pct"),
            ]
            loss = mags[2]
            if isinstance(loss, float) and not 0 <= loss <= 100:
                raise CompositionError(
                    f"{tag}: loss_pct must be in [0, 100], got {loss}"
                )
            if all(isinstance(m, float) and m == 0 for m in mags):
                raise CompositionError(
                    f"{tag}: degrade with no magnitude (latency_ms, "
                    "jitter_ms and loss_pct all zero) is a no-op — drop "
                    "the event or set a magnitude"
                )
        elif self.until_ms is not None:
            raise CompositionError(
                f"{tag}: until_ms is only valid on degrade (partitions "
                "end at their heal event)"
            )
        # a field on the wrong kind would be silently ignored
        if self.kind != "degrade":
            for name in ("latency_ms", "jitter_ms", "loss_pct"):
                v = getattr(self, name)
                if isinstance(v, str) or v:
                    raise CompositionError(
                        f"{tag}: {name} is only valid on degrade events"
                    )
        if self.kind != "kill":
            frac = self.fraction
            if isinstance(frac, str) or frac or self.count:
                raise CompositionError(
                    f"{tag}: fraction/count are only valid on kill "
                    "events"
                    + (
                        " (a restart always rejoins every fault-killed "
                        "member of the group)"
                        if self.kind == "restart"
                        else ""
                    )
                )
        if self.kind in ("kill", "restart"):
            if not self.group:
                raise CompositionError(f"{tag}: {self.kind} needs a group")
            if self.group == "*":
                raise CompositionError(
                    f"{tag}: {self.kind} needs a concrete group ('*' is "
                    "only valid for partition/degrade pairs)"
                )
            if self.a or self.b:
                raise CompositionError(
                    f"{tag}: {self.kind} uses 'group', not 'a'/'b'"
                )
        if self.kind == "kill":
            frac = _fault_num(self.fraction, f"{tag}.fraction")
            has_frac = not (isinstance(frac, float) and frac == 0)
            if has_frac and self.count:
                raise CompositionError(
                    f"{tag}: kill takes fraction XOR count, not both"
                )
            if not has_frac and not self.count:
                raise CompositionError(
                    f"{tag}: kill needs a fraction (0, 1] or a count"
                )
            if isinstance(frac, float) and not 0 <= frac <= 1:
                raise CompositionError(
                    f"{tag}: kill fraction must be in (0, 1], got {frac}"
                )
            if self.count < 0:
                raise CompositionError(f"{tag}: kill count must be >= 0")

    @classmethod
    def from_dict(cls, d: dict) -> "FaultEvent":
        known = {
            "kind", "at_ms", "until_ms", "a", "b", "latency_ms",
            "jitter_ms", "loss_pct", "group", "fraction", "count",
        }
        _reject_unknown_keys(d, known, "faults event")
        return cls(
            kind=str(d.get("kind", "")),
            at_ms=d.get("at_ms", 0.0),
            until_ms=d.get("until_ms"),
            a=str(d.get("a", "")),
            b=str(d.get("b", "")),
            latency_ms=d.get("latency_ms", 0.0),
            jitter_ms=d.get("jitter_ms", 0.0),
            loss_pct=d.get("loss_pct", 0.0),
            group=str(d.get("group", "")),
            fraction=d.get("fraction", 0.0),
            count=int(d.get("count", 0)),
        )


@dataclass
class Faults:
    """The ``[faults]`` table: an ordered list of timed events, compiled
    by sim/faults.py into schedule tensors. ``disabled`` marks a schedule
    that stays in the composition but compiles to nothing."""

    events: list[FaultEvent] = field(default_factory=list)
    disabled: bool = False

    def validate(self, group_ids: Optional[set] = None) -> None:
        if len(self.events) > MAX_FAULT_EVENTS:
            raise CompositionError(
                f"faults: {len(self.events)} events exceed the "
                f"{MAX_FAULT_EVENTS} bound (the overlay unrolls per event)"
            )
        partitions: list[tuple[str, str]] = []  # open pairs, unordered
        killed_groups: set[str] = set()
        restarted_groups: set[str] = set()
        last_numeric_at = None
        for i, ev in enumerate(self.events):
            ev.validate(i)
            tag = f"faults.events[{i}]"
            if isinstance(ev.at_ms, (int, float)):
                if (
                    last_numeric_at is not None
                    and float(ev.at_ms) < last_numeric_at
                ):
                    raise CompositionError(
                        f"{tag}: events must be ordered by at_ms "
                        f"({ev.at_ms} < {last_numeric_at})"
                    )
                last_numeric_at = float(ev.at_ms)
            if group_ids is not None:
                for g in (ev.a, ev.b, ev.group):
                    if g and g != "*" and g not in group_ids:
                        raise CompositionError(
                            f"{tag}: unknown group {g!r}; composition "
                            f"groups: {sorted(group_ids)}"
                        )
            pair = tuple(sorted((ev.a, ev.b)))
            if ev.kind == "partition":
                if pair in partitions:
                    raise CompositionError(
                        f"{tag}: partition {pair} is already open "
                        "(heal it before re-partitioning)"
                    )
                partitions.append(pair)
            elif ev.kind == "heal":
                if pair not in partitions:
                    raise CompositionError(
                        f"{tag}: heal {pair} has no matching open "
                        "partition"
                    )
                partitions.remove(pair)
            elif ev.kind == "kill":
                if ev.group in restarted_groups:
                    raise CompositionError(
                        f"{tag}: kill of group {ev.group!r} after its "
                        "restart is unsupported (an instance dies at "
                        "most once per run); split the study into "
                        "separate compositions"
                    )
                killed_groups.add(ev.group)
            elif ev.kind == "restart":
                if ev.group not in killed_groups:
                    raise CompositionError(
                        f"{tag}: restart of group {ev.group!r} has no "
                        "earlier kill event for that group"
                    )
                restarted_groups.add(ev.group)

    @classmethod
    def from_dict(cls, d: dict) -> "Faults":
        _reject_unknown_keys(d, {"events", "disabled"}, "[faults]")
        events = d.get("events", [])
        if not isinstance(events, list):
            raise CompositionError(
                f"faults.events must be a list of event tables, got "
                f"{events!r}"
            )
        return cls(
            events=[FaultEvent.from_dict(e) for e in events],
            disabled=bool(d.get("disabled", False)),
        )


# ------------------------------------------------------------------- trace

# the per-lane ring rides in device state; longer logs want shorter runs
MAX_TRACE_CAPACITY = 65_536

# valid [trace] category names (sim/trace.py CATEGORY_NAMES)
TRACE_CATEGORIES = ("lane", "net", "sync", "fault", "user")


@dataclass
class Trace:
    """The ``[trace]`` table: per-lane event rings riding in the state,
    demuxed after the run to Chrome trace-event JSON (sim/trace.py). A
    present but disabled table compiles to the untraced program;
    ``capacity`` is the per-lane slot count, ``categories`` and
    ``groups`` filter what records (empty = all). ``drain`` streams the
    ring out at every chunk boundary (sim/drain.py), so ``capacity``
    bounds one chunk's events instead of the run's."""

    enabled: bool = True
    capacity: int = 256
    categories: list[str] = field(default_factory=list)
    groups: list[str] = field(default_factory=list)
    drain: bool = False

    def validate(self, group_ids: Optional[set] = None) -> None:
        if self.capacity < 1:
            raise CompositionError(
                f"trace.capacity must be >= 1, got {self.capacity}"
            )
        if self.capacity > MAX_TRACE_CAPACITY:
            raise CompositionError(
                f"trace.capacity {self.capacity} exceeds the "
                f"{MAX_TRACE_CAPACITY} bound (the ring rides in device "
                "state; split the run instead)"
            )
        for name in self.categories:
            if name not in TRACE_CATEGORIES:
                raise CompositionError(
                    f"trace.categories: unknown category {name!r}; "
                    f"known: {sorted(TRACE_CATEGORIES)}"
                )
        if group_ids is not None:
            for g in self.groups:
                if g not in group_ids:
                    raise CompositionError(
                        f"trace.groups: unknown group {g!r}; "
                        f"composition groups: {sorted(group_ids)}"
                    )

    @classmethod
    def from_dict(cls, d: dict) -> "Trace":
        _reject_unknown_keys(
            d, {"enabled", "capacity", "categories", "groups", "drain"},
            "[trace]",
        )
        cats = d.get("categories", [])
        groups = d.get("groups", [])
        if not isinstance(cats, list):
            raise CompositionError(
                f"trace.categories must be a list, got {cats!r}"
            )
        if not isinstance(groups, list):
            raise CompositionError(
                f"trace.groups must be a list, got {groups!r}"
            )
        return cls(
            enabled=bool(d.get("enabled", True)),
            capacity=int(d.get("capacity", 256)),
            categories=[str(c) for c in cats],
            groups=[str(g) for g in groups],
            drain=bool(d.get("drain", False)),
        )


# --------------------------------------------------------------- telemetry

# valid [telemetry] probe names (sim/telemetry.py's catalog)
TELEMETRY_PROBES = (
    "net_sends", "net_delivers", "net_drops", "net_drops_partition",
    "net_drops_loss", "net_drops_churn", "net_drops_queue_full",
    "net_drops_filter", "net_drops_disabled", "sync_signals",
    "sync_publishes", "lane_wakes", "user_count", "inbox_depth",
    "user_gauge", "live_lanes", "blocked_frac", "wheel_occ",
)

# bounds on user histograms: [N, n_hist, buckets] i32 in device state
MAX_TELEMETRY_HISTOGRAMS = 8
MAX_TELEMETRY_BUCKETS = 32


@dataclass
class TelemetryHistogram:
    """One user histogram (``[[telemetry.histograms]]``), fed by
    ``PhaseCtrl(observe_hist=<index>, observe_value=...)`` or
    ``ProgramBuilder.observe``; bucket b holds ``[2^b, 2^(b+1))``
    (bucket 0: anything below 2)."""

    name: str = ""
    buckets: int = 24

    def validate(self, index: int) -> None:
        tag = f"telemetry.histograms[{index}]"
        if not self.name:
            raise CompositionError(f"{tag}: a histogram needs a name")
        if not 2 <= self.buckets <= MAX_TELEMETRY_BUCKETS:
            raise CompositionError(
                f"{tag}: buckets must be in [2, {MAX_TELEMETRY_BUCKETS}], "
                f"got {self.buckets}"
            )

    @classmethod
    def from_dict(cls, d: dict) -> "TelemetryHistogram":
        _reject_unknown_keys(
            d, {"name", "buckets"}, "telemetry histogram"
        )
        return cls(
            name=str(d.get("name", "")), buckets=int(d.get("buckets", 24))
        )


@dataclass
class Telemetry:
    """The ``[telemetry]`` table: per-interval counters, boundary gauges
    and log2 histograms riding in the state (sim/telemetry.py). A
    present but disabled table compiles to the unsampled program;
    ``interval`` is ticks a sample, ``probes`` the catalog subset (empty
    = every probe the program can record), ``samples`` an explicit
    buffer depth (0 = the whole run; smaller only with ``drain``, which
    streams the samples out at every chunk boundary, sim/drain.py)."""

    enabled: bool = True
    interval: int = 1000
    probes: list[str] = field(default_factory=list)
    histograms: list[TelemetryHistogram] = field(default_factory=list)
    drain: bool = False
    samples: int = 0

    def validate(self) -> None:
        if self.interval < 1:
            raise CompositionError(
                f"telemetry.interval must be >= 1 tick, got {self.interval}"
            )
        if self.samples < 0:
            raise CompositionError(
                f"telemetry.samples must be >= 0, got {self.samples}"
            )
        for p in self.probes:
            if p not in TELEMETRY_PROBES:
                close = difflib.get_close_matches(
                    str(p), TELEMETRY_PROBES, n=1
                )
                raise CompositionError(
                    f"telemetry.probes: unknown probe {p!r}"
                    + (f" (did you mean {close[0]!r}?)" if close else "")
                    + f"; known: {sorted(TELEMETRY_PROBES)}"
                )
        if len(self.histograms) > MAX_TELEMETRY_HISTOGRAMS:
            raise CompositionError(
                f"telemetry: {len(self.histograms)} histograms exceed "
                f"the {MAX_TELEMETRY_HISTOGRAMS} bound"
            )
        seen: set[str] = set()
        for i, h in enumerate(self.histograms):
            h.validate(i)
            if h.name in seen:
                raise CompositionError(
                    f"telemetry.histograms[{i}]: duplicate name {h.name!r}"
                )
            seen.add(h.name)

    @classmethod
    def from_dict(cls, d: dict) -> "Telemetry":
        _reject_unknown_keys(
            d,
            {"enabled", "interval", "probes", "histograms", "drain",
             "samples"},
            "[telemetry]",
        )
        probes = d.get("probes", [])
        if not isinstance(probes, list):
            raise CompositionError(
                f"telemetry.probes must be a list, got {probes!r}"
            )
        hists = d.get("histograms", [])
        if not isinstance(hists, list):
            raise CompositionError(
                f"telemetry.histograms must be a list of tables, got "
                f"{hists!r}"
            )
        return cls(
            enabled=bool(d.get("enabled", True)),
            interval=int(d.get("interval", 1000)),
            probes=[str(p) for p in probes],
            histograms=[TelemetryHistogram.from_dict(h) for h in hists],
            drain=bool(d.get("drain", False)),
            samples=int(d.get("samples", 0)),
        )


# ------------------------------------------------------------------ replay

# hard bound on the per-lane arrival table: [N, capacity] x 3 leaves in
# device state; longer recorded workloads belong in split traces
MAX_REPLAY_CAPACITY = 16_384


def _replay_num(v, name: str):
    """A replay scaling field: a positive number, or a ``"$param"``
    reference resolved against test params when the trace compiles
    (sim/replay.py). Returns the normalized value."""
    if isinstance(v, str):
        if v.startswith("$") and len(v) > 1:
            return v
        raise CompositionError(
            f"replay: {name} must be a number or a '$param' reference, "
            f"got {v!r}"
        )
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise CompositionError(
            f"replay: {name} must be a number, got {v!r}"
        )
    if float(v) <= 0:
        raise CompositionError(
            f"replay: {name} must be > 0, got {v} (a zero/negative "
            "scaling is an empty or inverted workload)"
        )
    return float(v)


@dataclass
class Replay:
    """The ``[replay]`` table: a recorded workload trace (request
    arrivals per instance per tick, and optional kill/restart rows),
    compiled by sim/replay.py into per-lane schedule tensors riding in
    the state. ``trace`` is the JSON-lines file; ``scale`` multiplies the
    request load (the fractional part keeps each extra copy by a
    seed-keyed draw) and ``time_scale`` stretches the timeline, both
    numbers or ``"$param"`` references; ``capacity`` is the per-lane
    table depth (0 = this trace's at this scale, an overflow is an
    error). A disabled table compiles to the replay-free program and
    never reads the file."""

    trace: str = ""
    scale: Any = 1.0
    time_scale: Any = 1.0
    capacity: int = 0
    enabled: bool = True

    def validate(self) -> None:
        if not self.trace:
            raise CompositionError(
                "replay.trace is required (the recorded workload file; "
                "see docs/replay.md)"
            )
        if self.capacity < 0:
            raise CompositionError(
                f"replay.capacity must be >= 0, got {self.capacity}"
            )
        if self.capacity > MAX_REPLAY_CAPACITY:
            raise CompositionError(
                f"replay.capacity {self.capacity} exceeds the "
                f"{MAX_REPLAY_CAPACITY} bound (the table rides in device "
                "state; split the trace instead)"
            )
        _replay_num(self.scale, "scale")
        _replay_num(self.time_scale, "time_scale")

    def param_refs(self) -> set[str]:
        """Names of test params referenced as ``"$name"`` values."""
        return {
            v[1:]
            for v in (self.scale, self.time_scale)
            if isinstance(v, str) and v.startswith("$")
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Replay":
        _reject_unknown_keys(
            d,
            {"trace", "scale", "time_scale", "capacity", "enabled"},
            "[replay]",
        )
        return cls(
            trace=str(d.get("trace", "")),
            scale=d.get("scale", 1.0),
            time_scale=d.get("time_scale", 1.0),
            capacity=int(d.get("capacity", 0)),
            enabled=bool(d.get("enabled", True)),
        )
