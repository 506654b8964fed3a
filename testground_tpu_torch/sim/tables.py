"""The composition tables of the fault, observer, replay, sweep and
search planes: ``[faults]``, ``[trace]``, ``[telemetry]``, ``[replay]``,
``[sweep]`` and ``[search]`` (the rest of a composition is
api/composition.py).

The port's own copy of those tables of ``testground_tpu/api/composition.py``
(the port imports nothing of the JAX package, not even its jax-free
modules): the same fields and defaults, ``from_dict``/``to_dict``,
validation, ``$param`` references and did-you-mean errors, message for
message.
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

    def param_refs(self) -> set[str]:
        """Names of test params referenced as ``"$name"`` values."""
        out = set()
        for v in (
            self.at_ms, self.until_ms, self.latency_ms, self.jitter_ms,
            self.loss_pct, self.fraction,
        ):
            if isinstance(v, str) and v.startswith("$"):
                out.add(v[1:])
        return out

    def to_dict(self) -> dict:
        d: dict[str, Any] = {"kind": self.kind, "at_ms": self.at_ms}
        if self.until_ms is not None:
            d["until_ms"] = self.until_ms
        for k in ("a", "b", "group"):
            if getattr(self, k):
                d[k] = getattr(self, k)
        for k in ("latency_ms", "jitter_ms", "loss_pct", "fraction"):
            v = getattr(self, k)
            if isinstance(v, str) or v:
                d[k] = v
        if self.count:
            d["count"] = self.count
        return d

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

    def param_refs(self) -> set[str]:
        out: set[str] = set()
        for ev in self.events:
            out |= ev.param_refs()
        return out

    def to_dict(self) -> dict:
        d = {"events": [ev.to_dict() for ev in self.events]}
        if self.disabled:
            d["disabled"] = True
        return d

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

    def to_dict(self) -> dict:
        d: dict[str, Any] = {"enabled": self.enabled}
        if self.capacity != 256:
            d["capacity"] = self.capacity
        if self.categories:
            d["categories"] = list(self.categories)
        if self.groups:
            d["groups"] = list(self.groups)
        if self.drain:
            d["drain"] = True
        return d

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

    def to_dict(self) -> dict:
        d: dict[str, Any] = {"name": self.name}
        if self.buckets != 24:
            d["buckets"] = self.buckets
        return d

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

    def to_dict(self) -> dict:
        d: dict[str, Any] = {"enabled": self.enabled}
        if self.interval != 1000:
            d["interval"] = self.interval
        if self.probes:
            d["probes"] = list(self.probes)
        if self.histograms:
            d["histograms"] = [h.to_dict() for h in self.histograms]
        if self.drain:
            d["drain"] = True
        if self.samples:
            d["samples"] = self.samples
        return d

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

    def to_dict(self) -> dict:
        d: dict[str, Any] = {"trace": self.trace}
        if isinstance(self.scale, str) or self.scale != 1.0:
            d["scale"] = self.scale
        if isinstance(self.time_scale, str) or self.time_scale != 1.0:
            d["time_scale"] = self.time_scale
        if self.capacity:
            d["capacity"] = self.capacity
        if not self.enabled:
            d["enabled"] = False
        return d

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

# ------------------------------------------------------------ sweep, search

# hard bound on the seed-count × param-grid cross product: a sweep is one
# batched program (plus memory-chunked dispatches)
MAX_SWEEP_SCENARIOS = 4096


@dataclass
class Sweep:
    """The sweep plane (``[sweep]`` table): one composition expands into
    ``seeds × prod(len(grid))`` scenarios, run as ONE scenario-batched
    program (sim/sweep.py).

    - ``seeds``: scenario count on the seed axis; scenario *i* of a combo
      runs with RNG/churn seed ``seed_base + i``.
    - ``params``: per-test-param value grids (``[sweep.params]``); values
      are stringified exactly like ``test_params``. Swept params must be
      consumed via ``env.params`` — statics are rejected at build time.
    - ``chunk``: optional scenarios-per-dispatch bound (0 = auto: all at
      once, the memory pre-flight may chunk down).
    - ``mesh``: optional ``[Ds, Di]`` device split for the 2-D
      ``(scenario, instance)`` mesh — Ds devices data-parallel over
      scenarios, Di sharding the instance data plane within each
      scenario row (docs/sweeps.md "Mesh axes"). Absent = auto:
      scenario axis first, leftover devices to the instance axis.
    """

    seeds: int = 1
    seed_base: int = 0
    params: dict[str, list] = field(default_factory=dict)
    chunk: int = 0
    mesh: Optional[list] = None

    def validate(self) -> None:
        if self.seeds < 1:
            raise CompositionError("sweep.seeds must be >= 1")
        if self.seed_base < 0:
            raise CompositionError("sweep.seed_base must be >= 0")
        if self.seed_base + self.seeds > 2**32:
            raise CompositionError(
                "sweep seeds must fit in uint32 (seed_base + seeds <= 2^32)"
            )
        if self.chunk < 0:
            raise CompositionError("sweep.chunk must be >= 0")
        if self.mesh is not None:
            ok = (
                isinstance(self.mesh, (list, tuple))
                and len(self.mesh) == 2
                and all(
                    isinstance(v, int) and not isinstance(v, bool)
                    and v >= 1
                    for v in self.mesh
                )
            )
            if not ok:
                raise CompositionError(
                    f"sweep.mesh must be a [Ds, Di] pair of positive "
                    f"ints (scenario x instance devices), got "
                    f"{self.mesh!r}"
                )
        total = self.seeds
        for name, grid in self.params.items():
            if not isinstance(grid, list) or not grid:
                raise CompositionError(
                    f"sweep.params.{name} must be a non-empty list of "
                    f"values, got {grid!r}"
                )
            total *= len(grid)
        if total > MAX_SWEEP_SCENARIOS:
            raise CompositionError(
                f"sweep expands to {total} scenarios, above the "
                f"{MAX_SWEEP_SCENARIOS} bound (seeds x param-grid cross "
                "product); split the sweep"
            )

    def total_scenarios(self) -> int:
        total = self.seeds
        for grid in self.params.values():
            total *= max(1, len(grid))
        return total

    def expand(self) -> list[dict]:
        """Scenario list ``[{"seed": int, "params": {name: str}}, ...]``:
        param combos in declared grid order (outer), seeds inner — so
        scenario index = combo_index * seeds + seed_index."""
        import itertools

        names = list(self.params.keys())
        grids = [self.params[n] for n in names]
        out = []
        for combo in itertools.product(*grids) if names else [()]:
            # str(), not json.dumps(): Run.from_dict stringifies
            # test_params with str(v), and a sweep point must see the
            # SAME spelling a serial run with that value would (e.g.
            # True -> 'True', not 'true')
            pvals = {
                n: (v if isinstance(v, str) else str(v))
                for n, v in zip(names, combo)
            }
            for i in range(self.seeds):
                out.append({"seed": self.seed_base + i, "params": pvals})
        return out

    def to_dict(self) -> dict:
        d: dict[str, Any] = {"seeds": self.seeds}
        if self.seed_base:
            d["seed_base"] = self.seed_base
        if self.params:
            d["params"] = {
                k: list(v) if isinstance(v, (list, tuple)) else v
                for k, v in self.params.items()
            }
        if self.chunk:
            d["chunk"] = self.chunk
        if self.mesh is not None:
            d["mesh"] = list(self.mesh)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Sweep":
        _reject_unknown_keys(
            d, {"seeds", "seed_base", "params", "chunk", "mesh"}, "[sweep]"
        )
        # scalars pass through UNTOUCHED so validate() can reject them
        # with a CompositionError — list("fast") would silently explode a
        # string into a per-character grid, and list(5) would raise a raw
        # TypeError before validation ever ran
        params = d.get("params", {})
        if not isinstance(params, dict):
            raise CompositionError(
                f"sweep.params must be a table of value lists, got "
                f"{params!r}"
            )
        return cls(
            seeds=int(d.get("seeds", 1)),
            seed_base=int(d.get("seed_base", 0)),
            params={
                k: list(v) if isinstance(v, (list, tuple)) else v
                for k, v in params.items()
            },
            chunk=int(d.get("chunk", 0)),
            # pass through untouched (like params) so validate() can
            # reject a scalar/float mesh with a CompositionError
            mesh=(
                list(d["mesh"])
                if isinstance(d.get("mesh"), (list, tuple))
                else d.get("mesh")
            ),
        )


# valid [search] strategies (sim/search.py drivers)
SEARCH_STRATEGIES = ("bisect", "halving", "coverage")

# per-scenario journal counters a [search] objective may read (the same
# row fields run_sweep_composition writes into scenario sim_summary.json)
SEARCH_COUNTERS = (
    "outcome", "ticks", "ticks_executed", "skip_ratio", "virtual_seconds",
    "crashed_count", "stalled_count", "restarted_count", "net_dropped",
    "net_horizon_clamped", "stream_violations", "metrics_dropped",
    "trace_dropped", "telemetry_clipped",
)

# telemetry roll-up statistics a "telemetry:<probe>:<stat>" objective
# may request (computed per probed scenario from its demuxed series)
SEARCH_TELEMETRY_STATS = ("mean", "min", "max", "p50", "p95", "p99")

# hard bound on the candidate grid a search walks: the grid is VIRTUAL
# (only probed points run), but the journal's frontier and the drivers'
# bookkeeping are host-side lists over it
MAX_SEARCH_GRID = 65_536


@dataclass
class Search:
    """The closed-loop search plane (``[search]`` table): instead of
    enumerating a ``[sweep]`` cross-product, the search runs ROUNDS of fixed-width scenario batches through ONE compiled program
    (sim/search.py + SweepExecutable.rebind), reads each round's
    per-scenario outcomes/telemetry, and chooses the next batch — the
    breaking point of a fault-severity axis costs a handful of rounds,
    not thousands of scenarios (docs/search.md).

    - ``param``: the severity axis — a test param consumed through
      ``env.params`` or referenced as ``"$param"`` from ``[faults]``
      magnitudes/timings (compile-time checked, like sweep grids).
    - ``strategy``: ``bisect`` (first failing value on a sorted grid,
      assuming monotone severity), ``halving`` (successive halving over
      a candidate grid by objective), or ``coverage`` (seed-deterministic
      sampling of the grid — replayable bit-for-bit).
    - grid: either an explicit ``values`` list, or ``lo``/``hi`` with a
      ``step`` (falling back to ``tolerance`` as the step).
    - ``objective``: ``outcome`` (default; 1.0 = scenario failed), a
      per-scenario journal counter (``SEARCH_COUNTERS``), or
      ``telemetry:<probe>:<stat>`` over the scenario's sampled series.
      A probe FAILS when its objective exceeds ``threshold``.
    - ``width``: scenarios per round — every round is padded to this
      shape so one compile (one executor-cache entry) serves all rounds.
    - ``seeds``/``seed_base``: RNG seeds probed per value (a value fails
      when any seed fails; halving averages the objective over them).
    - ``max_rounds``/``budget``: hard caps on rounds / scenarios probed
      (0 = the strategy's own bound).
    """

    param: str = ""
    strategy: str = "bisect"
    enabled: bool = True
    lo: Optional[float] = None
    hi: Optional[float] = None
    step: float = 0.0
    values: list = field(default_factory=list)
    tolerance: float = 0.0
    objective: str = "outcome"
    threshold: float = 0.5
    goal: str = "min"
    width: int = 8
    seeds: int = 1
    seed_base: int = 0
    max_rounds: int = 0
    budget: int = 0

    def validate(self) -> None:
        import difflib

        if not self.param:
            raise CompositionError(
                "search.param is required (the severity axis to probe)"
            )
        if self.strategy not in SEARCH_STRATEGIES:
            close = difflib.get_close_matches(
                str(self.strategy), SEARCH_STRATEGIES, n=1
            )
            raise CompositionError(
                f"search.strategy: unknown strategy {self.strategy!r}"
                + (f" (did you mean {close[0]!r}?)" if close else "")
                + f"; known: {sorted(SEARCH_STRATEGIES)}"
            )
        self._validate_objective()
        if self.goal not in ("min", "max"):
            raise CompositionError(
                f"search.goal must be 'min' or 'max', got {self.goal!r}"
            )
        if self.width < 1:
            raise CompositionError("search.width must be >= 1")
        if self.width > MAX_SWEEP_SCENARIOS:
            raise CompositionError(
                f"search.width {self.width} exceeds the "
                f"{MAX_SWEEP_SCENARIOS} one-batch bound"
            )
        if self.seeds < 1:
            raise CompositionError("search.seeds must be >= 1")
        if self.seeds > self.width:
            raise CompositionError(
                f"search.seeds ({self.seeds}) must fit one round "
                f"(width {self.width}): a round must probe at least one "
                "whole value"
            )
        if self.seed_base < 0:
            raise CompositionError("search.seed_base must be >= 0")
        for name in ("tolerance", "step"):
            if getattr(self, name) < 0:
                raise CompositionError(f"search.{name} must be >= 0")
        for name in ("max_rounds", "budget"):
            if getattr(self, name) < 0:
                raise CompositionError(f"search.{name} must be >= 0")
        grid = self.grid_values()  # raises on an unbuildable grid
        if len(grid) < 2:
            raise CompositionError(
                f"search grid has {len(grid)} distinct value(s); a "
                "search needs at least 2 (nothing to locate otherwise)"
            )
        if len(grid) > MAX_SEARCH_GRID:
            raise CompositionError(
                f"search grid has {len(grid)} values, above the "
                f"{MAX_SEARCH_GRID} bound; coarsen the step"
            )

    def _validate_objective(self) -> None:
        import difflib

        obj = self.objective
        if obj.startswith("telemetry:"):
            parts = obj.split(":")
            if len(parts) != 3:
                raise CompositionError(
                    f"search.objective {obj!r}: telemetry objectives are "
                    "'telemetry:<probe>:<stat>'"
                )
            _, probe, stat = parts
            if probe not in TELEMETRY_PROBES:
                close = difflib.get_close_matches(
                    probe, TELEMETRY_PROBES, n=1
                )
                raise CompositionError(
                    f"search.objective: unknown telemetry probe {probe!r}"
                    + (f" (did you mean {close[0]!r}?)" if close else "")
                    + f"; known: {sorted(TELEMETRY_PROBES)}"
                )
            if stat not in SEARCH_TELEMETRY_STATS:
                raise CompositionError(
                    f"search.objective: unknown stat {stat!r}; known: "
                    f"{sorted(SEARCH_TELEMETRY_STATS)}"
                )
            return
        if obj not in SEARCH_COUNTERS:
            close = difflib.get_close_matches(obj, SEARCH_COUNTERS, n=1)
            raise CompositionError(
                f"search.objective: unknown objective {obj!r}"
                + (f" (did you mean {close[0]!r}?)" if close else "")
                + f"; known: {sorted(SEARCH_COUNTERS)} or "
                "'telemetry:<probe>:<stat>'"
            )

    def grid_values(self) -> list:
        """The sorted, deduplicated candidate grid. Values keep their
        declared type (int grids stay ints) so a probed scenario's
        stringified param matches what the same value in ``test_params``
        or a ``[sweep.params]`` grid would produce — the serial-oracle
        bit-identity contract."""
        if self.values:
            seen: dict[float, Any] = {}
            for v in self.values:
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    raise CompositionError(
                        f"search.values must be numbers, got {v!r}"
                    )
                seen.setdefault(float(v), v)
            return [seen[k] for k in sorted(seen)]
        if self.lo is None or self.hi is None:
            raise CompositionError(
                "search needs a grid: either 'values', or 'lo'/'hi' "
                "with a 'step' (or a 'tolerance' used as the step)"
            )
        lo, hi = self.lo, self.hi
        for name, v in (("lo", lo), ("hi", hi)):
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise CompositionError(
                    f"search.{name} must be a number, got {v!r}"
                )
        if not float(lo) < float(hi):
            raise CompositionError(
                f"search range is empty or inverted (lo={lo} >= hi={hi})"
            )
        step = float(self.step or self.tolerance)
        if step <= 0:
            raise CompositionError(
                "search over lo/hi needs a positive 'step' (or a "
                "positive 'tolerance' used as the step)"
            )
        n = int((float(hi) - float(lo)) / step + 1e-9) + 1
        if n > MAX_SEARCH_GRID:  # bound BEFORE materializing the list
            raise CompositionError(
                f"search grid has {n} values, above the "
                f"{MAX_SEARCH_GRID} bound; coarsen the step"
            )
        out = [float(lo) + i * step for i in range(n)]
        if out[-1] < float(hi) - 1e-9 * step:
            out.append(float(hi))
        else:
            out[-1] = float(hi)
        ints = (
            all(
                isinstance(v, int) and not isinstance(v, bool)
                for v in (self.lo, self.hi)
            )
            and step.is_integer()
        )
        if ints:
            return [int(round(v)) for v in out]
        return out

    def to_dict(self) -> dict:
        d: dict[str, Any] = {
            "param": self.param, "strategy": self.strategy,
        }
        if not self.enabled:
            d["enabled"] = False
        if self.lo is not None:
            d["lo"] = self.lo
        if self.hi is not None:
            d["hi"] = self.hi
        if self.step:
            d["step"] = self.step
        if self.values:
            d["values"] = list(self.values)
        if self.tolerance:
            d["tolerance"] = self.tolerance
        if self.objective != "outcome":
            d["objective"] = self.objective
        if self.threshold != 0.5:
            d["threshold"] = self.threshold
        if self.goal != "min":
            d["goal"] = self.goal
        if self.width != 8:
            d["width"] = self.width
        if self.seeds != 1:
            d["seeds"] = self.seeds
        if self.seed_base:
            d["seed_base"] = self.seed_base
        if self.max_rounds:
            d["max_rounds"] = self.max_rounds
        if self.budget:
            d["budget"] = self.budget
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Search":
        known = {
            "param", "strategy", "enabled", "lo", "hi", "step", "values",
            "tolerance", "objective", "threshold", "goal", "width",
            "seeds", "seed_base", "max_rounds", "budget",
        }
        _reject_unknown_keys(d, known, "[search]")
        values = d.get("values", [])
        if not isinstance(values, list):
            raise CompositionError(
                f"search.values must be a list of numbers, got {values!r}"
            )
        return cls(
            param=str(d.get("param", "")),
            strategy=str(d.get("strategy", "bisect")),
            enabled=bool(d.get("enabled", True)),
            lo=d.get("lo"),
            hi=d.get("hi"),
            step=float(d.get("step", 0.0)),
            values=list(values),
            tolerance=float(d.get("tolerance", 0.0)),
            objective=str(d.get("objective", "outcome")),
            threshold=float(d.get("threshold", 0.5)),
            goal=str(d.get("goal", "min")),
            width=int(d.get("width", 8)),
            seeds=int(d.get("seeds", 1)),
            seed_base=int(d.get("seed_base", 0)),
            max_rounds=int(d.get("max_rounds", 0)),
            budget=int(d.get("budget", 0)),
        )
