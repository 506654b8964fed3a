"""The composition: one run's plan, case, instance groups and tables.

The port's copy of what ``testground_tpu/api/composition.py`` gives a run
(``Composition.from_dict``/``load``, ``validate_for_run`` and
``prepare_for_run``): ``[global]`` and ``[[groups]]`` with count or
percentage instances, ``run.test_params`` trickled to the groups, the
manifest's test-case parameter defaults stringified as JAX does, instance
bounds, and the tables. ``[faults]``, ``[trace]``, ``[telemetry]``,
``[replay]``, ``[sweep]`` and ``[search]`` are sim/tables.py's;
``[live]`` and ``[checkpoint]``, host-only, are here. The TOML schema is
the JAX package's, so the same ``composition.toml`` drives either.
"""

from __future__ import annotations

import json
import tomllib
from dataclasses import dataclass, field
from typing import Any, Optional

from ..sim.tables import (
    CompositionError,
    Faults,
    Replay,
    Search,
    Sweep,
    Telemetry,
    Trace,
    _reject_unknown_keys,
)

# the runner name the repo's compositions give: the port runs them as
# that runner's counterpart
SIM_RUNNER = "sim:jax"


@dataclass
class Metadata:
    name: str = ""
    author: str = ""

    def to_dict(self) -> dict:
        return {"name": self.name, "author": self.author}

    @classmethod
    def from_dict(cls, d: dict) -> "Metadata":
        return cls(name=d.get("name", ""), author=d.get("author", ""))


@dataclass
class Resources:
    memory: str = ""
    cpu: str = ""

    def to_dict(self) -> dict:
        return {"memory": self.memory, "cpu": self.cpu}

    @classmethod
    def from_dict(cls, d: dict) -> "Resources":
        return cls(memory=d.get("memory", ""), cpu=d.get("cpu", ""))


@dataclass
class Instances:
    """Either ``count`` or ``percentage`` (of the global total)."""

    count: int = 0
    percentage: float = 0.0

    def validate(self) -> None:
        has_count = self.count > 0
        has_pct = self.percentage > 0
        if has_count and has_pct:
            raise CompositionError(
                "group instances: count and percentage are mutually exclusive"
            )
        if not has_count and not has_pct:
            raise CompositionError(
                "group instances: either count or percentage is required"
            )

    def to_dict(self) -> dict:
        d: dict[str, Any] = {}
        if self.count:
            d["count"] = self.count
        if self.percentage:
            d["percentage"] = self.percentage
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Instances":
        return cls(count=int(d.get("count", 0)),
                   percentage=float(d.get("percentage", 0.0)))


@dataclass
class Run:
    artifact: str = ""
    test_params: dict[str, str] = field(default_factory=dict)
    profiles: dict[str, str] = field(default_factory=dict)

    def to_dict(self) -> dict:
        d: dict[str, Any] = {}
        if self.artifact:
            d["artifact"] = self.artifact
        if self.test_params:
            d["test_params"] = dict(self.test_params)
        if self.profiles:
            d["profiles"] = dict(self.profiles)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Run":
        return cls(
            artifact=d.get("artifact", ""),
            test_params={k: str(v)
                         for k, v in d.get("test_params", {}).items()},
            profiles={k: str(v) for k, v in d.get("profiles", {}).items()},
        )


@dataclass
class Live:
    """The ``[live]`` table (sim/live.py): progress rows at chunk
    boundaries, on by default. ``enabled = false`` (``--no-live``) keeps
    the table and journals ``"live": "disabled"``; ``interval`` is the
    least seconds between two rows (0: every boundary)."""

    enabled: bool = True
    interval: float = 0.0

    def validate(self) -> None:
        if self.interval < 0:
            raise CompositionError(
                f"live.interval must be >= 0 seconds, got {self.interval}"
            )

    def to_dict(self) -> dict:
        d: dict[str, Any] = {"enabled": self.enabled}
        if self.interval:
            d["interval"] = self.interval
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Live":
        _reject_unknown_keys(d, {"enabled", "interval"}, "[live]")
        return cls(enabled=bool(d.get("enabled", True)),
                   interval=float(d.get("interval", 0.0)))


@dataclass
class Checkpoint:
    """The ``[checkpoint]`` table (sim/checkpoint.py): boundary state
    snapshots for resume, on by default. ``enabled = false``
    (``--no-checkpoint``) journals ``"checkpoint": "disabled"``;
    ``interval`` is the least seconds between two snapshots (0: every
    boundary; default 60)."""

    enabled: bool = True
    interval: float = 60.0

    def validate(self) -> None:
        if self.interval < 0:
            raise CompositionError(
                "checkpoint.interval must be >= 0 seconds, got "
                f"{self.interval}"
            )

    def to_dict(self) -> dict:
        d: dict[str, Any] = {"enabled": self.enabled}
        if self.interval != 60.0:
            d["interval"] = self.interval
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Checkpoint":
        _reject_unknown_keys(d, {"enabled", "interval"}, "[checkpoint]")
        return cls(enabled=bool(d.get("enabled", True)),
                   interval=float(d.get("interval", 60.0)))


@dataclass
class Global:
    plan: str = ""
    case: str = ""
    total_instances: int = 0
    concurrent_builds: int = 0
    builder: str = ""
    build_config: dict[str, Any] = field(default_factory=dict)
    build: Optional[dict] = None
    runner: str = ""
    run_config: dict[str, Any] = field(default_factory=dict)
    run: Optional[Run] = None
    disable_metrics: bool = False

    def to_dict(self) -> dict:
        d: dict[str, Any] = {"plan": self.plan, "case": self.case,
                             "runner": self.runner}
        if self.total_instances:
            d["total_instances"] = self.total_instances
        if self.concurrent_builds:
            d["concurrent_builds"] = self.concurrent_builds
        if self.builder:
            d["builder"] = self.builder
        if self.build_config:
            d["build_config"] = dict(self.build_config)
        if self.build:
            d["build"] = dict(self.build)
        if self.run_config:
            d["run_config"] = dict(self.run_config)
        if self.run:
            d["run"] = self.run.to_dict()
        if self.disable_metrics:
            d["disable_metrics"] = True
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Global":
        return cls(
            plan=d.get("plan", ""),
            case=d.get("case", ""),
            total_instances=int(d.get("total_instances", 0)),
            concurrent_builds=int(d.get("concurrent_builds", 0)),
            builder=d.get("builder", ""),
            build_config=dict(d.get("build_config", {})),
            build=dict(d["build"]) if d.get("build") else None,
            runner=d.get("runner", ""),
            run_config=dict(d.get("run_config", {})),
            run=Run.from_dict(d["run"]) if "run" in d else None,
            disable_metrics=bool(d.get("disable_metrics", False)),
        )


@dataclass
class Group:
    id: str
    instances: Instances = field(default_factory=Instances)
    resources: Resources = field(default_factory=Resources)
    builder: str = ""
    build_config: dict[str, Any] = field(default_factory=dict)
    # the group's [build] table, kept as its dict (the port builds nothing)
    build: dict = field(default_factory=dict)
    run: Run = field(default_factory=Run)
    # computed by Composition.validate_for_run
    calculated_instance_count: int = 0

    def build_key(self) -> str:
        """The key identical builds share (the JAX ``Group.build_key``:
        the builder, its config, and the [build] table's selectors and
        dependencies in canonical order)."""
        if not self.builder:
            raise CompositionError(
                "group must have a builder (prepare first)")
        sel = ",".join(sorted(self.build.get("selectors", [])))
        deps = "|".join(
            f"{d.get('module', '')}:{d.get('version', '')}"
            for d in sorted(self.build.get("dependencies", []),
                            key=lambda d: d.get("module", "")))
        return json.dumps({
            "builder": self.builder,
            "build_config": self.build_config or None,
            "build_as_key": f"selectors={sel};dependencies={deps}",
        }, sort_keys=True)

    def to_dict(self) -> dict:
        d: dict[str, Any] = {"id": self.id,
                             "instances": self.instances.to_dict()}
        res = self.resources.to_dict()
        if any(res.values()):
            d["resources"] = res
        if self.builder:
            d["builder"] = self.builder
        if self.build_config:
            d["build_config"] = dict(self.build_config)
        if self.build:
            d["build"] = dict(self.build)
        r = self.run.to_dict()
        if r:
            d["run"] = r
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Group":
        return cls(
            id=d.get("id", ""),
            instances=Instances.from_dict(d.get("instances", {})),
            resources=Resources.from_dict(d.get("resources", {})),
            builder=d.get("builder", ""),
            build_config=dict(d.get("build_config", {})),
            build={k: v for k, v in d.get("build", {}).items() if v},
            run=Run.from_dict(d.get("run", {})),
        )


def _runner_only(table: str, what: str, runner: str) -> None:
    if runner and runner != SIM_RUNNER:
        raise CompositionError(
            f"[{table}] requires the sim:jax runner ({what}); got runner "
            f"{runner!r}"
        )


@dataclass
class Composition:
    metadata: Metadata = field(default_factory=Metadata)
    global_: Global = field(default_factory=Global)
    groups: list[Group] = field(default_factory=list)
    sweep: Optional[Sweep] = None
    faults: Optional[Faults] = None
    trace: Optional[Trace] = None
    telemetry: Optional[Telemetry] = None
    search: Optional[Search] = None
    live: Optional[Live] = None
    checkpoint: Optional[Checkpoint] = None
    replay: Optional[Replay] = None

    # ------------------------------------------------------------------ IO

    @classmethod
    def from_dict(cls, d: dict) -> "Composition":
        def table(key, typ):
            return typ.from_dict(d[key]) if key in d else None

        return cls(
            metadata=Metadata.from_dict(d.get("metadata", {})),
            global_=Global.from_dict(d.get("global", {})),
            groups=[Group.from_dict(g) for g in d.get("groups", [])],
            sweep=table("sweep", Sweep),
            faults=table("faults", Faults),
            trace=table("trace", Trace),
            telemetry=table("telemetry", Telemetry),
            search=table("search", Search),
            live=table("live", Live),
            checkpoint=table("checkpoint", Checkpoint),
            replay=table("replay", Replay),
        )

    def to_dict(self) -> dict:
        d = {
            "metadata": self.metadata.to_dict(),
            "global": self.global_.to_dict(),
            "groups": [g.to_dict() for g in self.groups],
        }
        for key in ("sweep", "faults", "trace", "telemetry", "search",
                    "live", "checkpoint", "replay"):
            t = getattr(self, key)
            # an empty [faults] is the no-table composition
            if t is not None and (key != "faults" or t.events):
                d[key] = t.to_dict()
        return d

    @classmethod
    def from_toml(cls, text: str) -> "Composition":
        return cls.from_dict(tomllib.loads(text))

    @classmethod
    def load(cls, path) -> "Composition":
        with open(path, "rb") as f:
            return cls.from_dict(tomllib.load(f))

    def clone(self) -> "Composition":
        return Composition.from_dict(json.loads(json.dumps(self.to_dict())))

    # ---------------------------------------------------------- validation

    def _validate_structure(self) -> None:
        if not self.groups:
            raise CompositionError(
                "composition must declare at least one group")
        if not self.global_.plan:
            raise CompositionError("global.plan is required")
        if not self.global_.case:
            raise CompositionError("global.case is required")
        if not self.global_.runner:
            raise CompositionError("global.runner is required")
        seen: set[str] = set()
        for g in self.groups:
            if not g.id:
                raise CompositionError("group id is required")
            if g.id in seen:
                raise CompositionError(f"duplicate group id: {g.id}")
            seen.add(g.id)
            g.instances.validate()

    def validate_for_run(self) -> None:
        """Validate every table, then compute the per-group instance
        counts and check their sum against ``total_instances``, in the
        JAX package's order and with its messages."""
        self._validate_structure()
        runner = self.global_.runner
        gids = {g.id for g in self.groups}
        if self.sweep is not None:
            self.sweep.validate()
            _runner_only("sweep", "scenario batching", runner)
        if self.faults is not None and not self.faults.events:
            self.faults = None
        if self.faults is not None:
            self.faults.validate(group_ids=gids)
            _runner_only("faults", "schedule tensors", runner)
        if self.trace is not None:
            self.trace.validate(group_ids=gids)
            if self.trace.enabled:
                _runner_only("trace", "in-program event rings", runner)
        if self.telemetry is not None:
            self.telemetry.validate()
            if self.telemetry.enabled:
                _runner_only("telemetry", "in-program sample buffers",
                             runner)
        if self.search is not None:
            self._validate_search(runner)
        if self.live is not None:
            self.live.validate()
            if self.live.enabled:
                _runner_only("live", "chunk-boundary progress streaming",
                             runner)
        if self.checkpoint is not None:
            self.checkpoint.validate()
            if self.checkpoint.enabled:
                _runner_only("checkpoint",
                             "chunk-boundary state snapshots", runner)
        if self.replay is not None:
            self._validate_replay(runner)
        self._validate_churn_window()
        total = self.global_.total_instances
        computed = 0
        for g in self.groups:
            if g.instances.percentage > 0 and total == 0:
                raise CompositionError(
                    "group count percentage requires total_instances")
            cnt = g.instances.count
            if cnt == 0:
                cnt = round(g.instances.percentage * total)
            g.calculated_instance_count = cnt
            computed += cnt
        if total > 0 and total != computed:
            raise CompositionError(
                "sum of calculated instances per group doesn't match total; "
                f"total={total}, calculated={computed}"
            )
        self.global_.total_instances = computed

    def _validate_search(self, runner: str) -> None:
        s = self.search
        s.validate()
        if not s.enabled:
            return
        _runner_only("search", "scenario batch re-dispatch", runner)
        if self.sweep is not None:
            raise CompositionError(
                "[search] and [sweep] are mutually exclusive: the search "
                "drives its own scenario batches (fold the seed axis into "
                "search.seeds instead)"
            )
        if (self.faults is not None and self.faults.disabled
                and s.param in self.faults.param_refs()):
            raise CompositionError(
                f"[search] targets ${s.param}, which the [faults] schedule "
                "consumes, but faults are disabled (--no-faults / "
                "Faults.disabled): the search would probe a no-op severity "
                "axis. Re-enable [faults] or retarget [search]."
            )
        if s.objective.startswith("telemetry:"):
            probe = s.objective.split(":")[1]
            if self.telemetry is None or not self.telemetry.enabled:
                raise CompositionError(
                    f"[search] objective {s.objective!r} needs an enabled "
                    "[telemetry] table (its probe is read from the sampled "
                    "series); declare one or switch the objective"
                )
            if self.telemetry.probes and probe not in self.telemetry.probes:
                raise CompositionError(
                    f"[search] objective reads telemetry probe {probe!r}, "
                    "but the [telemetry] table's probes list does not "
                    "record it; add it to telemetry.probes "
                    f"{self.telemetry.probes}"
                )

    def _validate_replay(self, runner: str) -> None:
        rp = self.replay
        rp.validate()
        if rp.enabled:
            _runner_only("replay", "per-lane schedule tensors", runner)
        if (rp.enabled and self.search is not None and self.search.enabled
                and self.search.param in rp.param_refs()
                and not rp.capacity):
            raise CompositionError(
                f"[search] targets ${self.search.param}, which [replay] "
                "consumes as a scaling — that needs an explicit "
                "replay.capacity (the compiled arrival table's shape must "
                "not change across probes); set replay.capacity to the "
                "largest scaled row count (see docs/replay.md 'Sizing')"
            )

    def _validate_churn_window(self) -> None:
        rc = self.global_.run_config or {}
        try:
            frac = float(rc.get("churn_fraction", 0) or 0)
            start = float(rc.get("churn_start_ms", 0) or 0)
            end = float(rc.get("churn_end_ms", 0) or 0)
        except (TypeError, ValueError):
            frac, start, end = 0.0, 0.0, 0.0
        if frac > 0 and end <= start:
            raise CompositionError(
                f"churn window is empty or inverted: churn_end_ms={end} "
                f"<= churn_start_ms={start} with churn_fraction={frac}; "
                "set churn_end_ms > churn_start_ms (the window is "
                "[start, end))"
            )

    # --------------------------------------------------------- preparation

    def validate_for_build(self) -> None:
        if not self.groups:
            raise CompositionError(
                "composition must declare at least one group")
        if not self.global_.plan:
            raise CompositionError("global.plan is required")
        if not self.global_.builder:
            for g in self.groups:
                if not g.builder:
                    raise CompositionError(
                        f"group {g.id}: no builder set and no "
                        "global.builder")

    def prepare_for_build(self, manifest) -> "Composition":
        """A prepared copy for the builder, as the JAX package prepares
        it: the manifest's builder config, the global [build] defaults
        and build config trickled to the groups, each group's builder
        checked against the manifest."""
        c = self.clone()
        c.global_.plan = manifest.name
        if not manifest.builders:
            raise CompositionError(
                "plan supports no builders; review the manifest")
        for k, v in (manifest.builders.get(c.global_.builder) or {}).items():
            c.global_.build_config.setdefault(k, v)
        if c.global_.build is not None:
            gdeps = list(c.global_.build.get("dependencies", []))
            gsel = list(c.global_.build.get("selectors", []))
            for grp in c.groups:
                deps = list(grp.build.get("dependencies", []))
                if not deps:
                    deps = gdeps
                else:
                    have = {d.get("module") for d in deps}
                    deps += [d for d in gdeps if d.get("module") not in have]
                if deps:
                    grp.build["dependencies"] = deps
                if not grp.build.get("selectors") and gsel:
                    grp.build["selectors"] = gsel
        for grp in c.groups:
            for k, v in c.global_.build_config.items():
                grp.build_config.setdefault(k, v)
        for grp in c.groups:
            if not grp.builder:
                grp.builder = c.global_.builder
            if not manifest.has_builder(grp.builder):
                raise CompositionError(
                    f"plan does not support builder '{grp.builder}'; "
                    f"supported: {manifest.supported_builders()}"
                )
        return c

    def prepare_for_run(self, manifest) -> "Composition":
        """A prepared copy: the manifest's runner config applied, the
        instance counts computed and bounded by the test case, the
        global run defaults trickled to the groups and the case's
        parameter defaults applied (strings as they are, anything else
        as its JSON)."""
        c = self.clone()
        c.global_.plan = manifest.name
        tcase = manifest.test_case_by_name(c.global_.case)
        if tcase is None:
            raise CompositionError(
                f"test case {c.global_.case} not found in plan "
                f"{manifest.name}"
            )
        if not manifest.runners:
            raise CompositionError(
                "plan supports no runners; review the manifest")
        if c.global_.runner not in manifest.runners:
            raise CompositionError(
                f"plan does not support runner {c.global_.runner}; "
                f"supported: {sorted(manifest.runners)}"
            )
        for k, v in (manifest.runners.get(c.global_.runner) or {}).items():
            c.global_.run_config.setdefault(k, v)
        c.validate_for_run()
        t = c.global_.total_instances
        if t < tcase.instances.minimum or t > tcase.instances.maximum:
            raise CompositionError(
                f"total instance count ({t}) outside of allowable range "
                f"[{tcase.instances.minimum}, {tcase.instances.maximum}] "
                f"for test case {tcase.name}"
            )
        if c.global_.run is not None:
            gdef = c.global_.run
            for grp in c.groups:
                if not grp.run.artifact:
                    grp.run.artifact = gdef.artifact
                for k, v in gdef.test_params.items():
                    grp.run.test_params.setdefault(k, v)
                for k, v in gdef.profiles.items():
                    grp.run.profiles.setdefault(k, v)
        defaults: dict[str, str] = {}
        for name, p in tcase.parameters.items():
            if p.default is None:
                continue
            defaults[name] = (p.default if isinstance(p.default, str)
                              else json.dumps(p.default))
        for grp in c.groups:
            for k, v in defaults.items():
                grp.run.test_params.setdefault(k, v)
        return c
