"""What flows between the entry point, the builder and the runner (a copy
of ``testground_tpu/api/contracts.py``): ``BuildInput`` and
``BuildOutput`` for the sim builder, ``RunGroup`` and ``RunInput`` in,
``RunOutput`` with its graded ``RunResult`` out."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from .composition import Composition, Group, Resources
from .manifest import TestPlanManifest


@dataclass
class BuildInput:
    """Input to a single builder invocation (one deduped group-set)."""

    build_id: str
    env_config: Any  # config.EnvConfig
    source_dir: str  # unpacked plan sources
    select_build: Group  # representative group carrying build cfg
    composition: Composition
    manifest: TestPlanManifest


@dataclass
class BuildOutput:
    artifact_path: str  # the staged plan directory
    dependencies: dict[str, str] = field(default_factory=dict)


@dataclass
class RunGroup:
    """One group's slice of a run."""

    id: str
    instances: int
    artifact_path: str = ""
    parameters: dict[str, str] = field(default_factory=dict)
    resources: Resources = field(default_factory=Resources)
    profiles: dict[str, str] = field(default_factory=dict)


@dataclass
class RunInput:
    """Input to a runner, field for field the JAX package's. The tables
    (``sweep`` ... ``replay``) are sim/tables.py or api/composition.py
    objects, or their dict forms."""

    run_id: str
    env_config: Any
    run_dir: str  # outputs directory for this run
    test_plan: str
    test_case: str
    total_instances: int
    groups: list[RunGroup] = field(default_factory=list)
    composition: Optional[Composition] = None
    manifest: Optional[TestPlanManifest] = None
    plan_dir: str = ""  # where the plan's data files live
    disable_metrics: bool = False
    run_config: dict[str, Any] = field(default_factory=dict)
    sweep: Optional[Any] = None
    faults: Optional[Any] = None
    trace: Optional[Any] = None
    telemetry: Optional[Any] = None
    search: Optional[Any] = None
    # [live]: progress rows to <run_dir>/progress.jsonl (sim/live.py),
    # on by default
    live: Optional[Any] = None
    # called with each progress row (in-process only)
    on_progress: Optional[Any] = None
    # [checkpoint]: boundary snapshots to <run_dir>/checkpoint/
    # (sim/checkpoint.py), on by default
    checkpoint: Optional[Any] = None
    # continue this run from its last checkpoint (a fresh run when there
    # is none)
    resume: bool = False
    # 0 on the first attempt; journaled when not 0
    attempt: int = 0
    replay: Optional[Any] = None
    # the JAX package's federation digest: carried, not read
    affinity: str = ""


@dataclass
class GroupOutcome:
    ok: int = 0
    total: int = 0


@dataclass
class RunResult:
    """Run grading: a run succeeds iff every group's ok count equals its
    total."""

    outcome: str = "unknown"  # success | failure | terminated | preempted
    outcomes: dict[str, GroupOutcome] = field(default_factory=dict)
    journal: dict[str, Any] = field(default_factory=dict)

    def grade(self) -> None:
        if not self.outcomes:
            self.outcome = "unknown"
            return
        for g in self.outcomes.values():
            if g.ok != g.total:
                self.outcome = "failure"
                return
        self.outcome = "success"

    def to_dict(self) -> dict:
        return {
            "outcome": self.outcome,
            "outcomes": {k: {"ok": v.ok, "total": v.total}
                         for k, v in self.outcomes.items()},
            "journal": self.journal,
        }


@dataclass
class RunOutput:
    result: RunResult
    composition: Optional[Composition] = None
