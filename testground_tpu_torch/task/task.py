"""Task wire model (a copy of ``testground_tpu/task/task.py``; reference
pkg/task/task.go:13-74)."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Optional

STATE_SCHEDULED = "scheduled"
STATE_PROCESSING = "processing"
STATE_COMPLETE = "complete"
STATE_CANCELED = "canceled"
# transient state recorded when the dispatch watchdog flags a wedged
# chunk dispatch (sim/checkpoint.py WedgedDispatchError): the engine
# transitions wedged → scheduled with exponential backoff, and the
# retry resumes from the run's last checkpoint (docs/robustness.md)
STATE_WEDGED = "wedged"

OUTCOME_SUCCESS = "success"
OUTCOME_FAILURE = "failure"
OUTCOME_CANCELED = "canceled"
OUTCOME_UNKNOWN = "unknown"
# a SIGTERM-preempted run: its forced final checkpoint + resume token
# make it continuable with `testground run --resume <task_id>`
OUTCOME_PREEMPTED = "preempted"

TYPE_BUILD = "build"
TYPE_RUN = "run"
# compile-on-upload (the federation plane, docs/federation.md): build +
# compile + persist a composition's executor to the durable cache tiers
# WITHOUT dispatching a run, so the first real run warm-starts
TYPE_PREWARM = "prewarm"

# fleet metrics plane (testground_tpu_torch/obs, docs/observability.md):
# every explicit state transition bumps a labeled counter. Task
# construction and from_dict append StateTransition directly, so
# rehydrating persisted tasks does not double-count.
from ..obs import counter as _obs_counter  # noqa: E402

_TRANSITIONS = _obs_counter(
    "tg_task_transitions_total",
    "Task state transitions by target state (scheduled, processing, "
    "complete, canceled, wedged).",
)


@dataclass
class StateTransition:
    state: str
    created: float

    def to_dict(self) -> dict:
        return {"state": self.state, "created": self.created}


@dataclass
class Task:
    id: str
    type: str
    priority: int = 0
    plan: str = ""
    case: str = ""
    name: str = ""
    created: float = field(default_factory=time.time)
    states: list[StateTransition] = field(default_factory=list)
    input: Optional[dict] = None
    result: Any = None
    error: str = ""
    # metadata for branch-dedup + status posting (reference task.go:59-74)
    created_by: dict = field(default_factory=dict)  # {user, repo, branch, commit}
    composition: Optional[dict] = None
    # latest live-plane snapshot (sim/live.py), mirrored here by the
    # engine while the run executes so /tasks, /status and the /live
    # dashboard see progress without touching the outputs tree
    progress: Optional[dict] = None
    # retry accounting (the wedged-dispatch requeue path): attempts
    # already consumed, the not-before time the queue honors, and the
    # last backoff applied — journaled and surfaced on /tasks, /live
    # and `testground tasks --failed`
    attempts: int = 0
    backoff_until: float = 0.0
    last_backoff_s: float = 0.0
    # which federation worker executes this task (set by the worker
    # from the coordinator's routed submission; "" for local tasks) —
    # surfaced on /tasks, `testground tasks --json` and the fleet page
    routed_to: str = ""

    def __post_init__(self) -> None:
        if not self.states:
            self.states = [StateTransition(STATE_SCHEDULED, self.created)]

    @property
    def state(self) -> str:
        return self.states[-1].state

    @property
    def outcome(self) -> str:
        if self.state == STATE_CANCELED:
            return OUTCOME_CANCELED
        if self.state != STATE_COMPLETE:
            return OUTCOME_UNKNOWN
        if self.error:
            return OUTCOME_FAILURE
        if isinstance(self.result, dict) and "outcome" in self.result:
            return self.result["outcome"]
        return OUTCOME_SUCCESS

    def transition(self, state: str) -> None:
        self.states.append(StateTransition(state, time.time()))
        _TRANSITIONS.inc(state=state)

    def to_dict(self) -> dict:
        return {
            "id": self.id,
            "type": self.type,
            "priority": self.priority,
            "plan": self.plan,
            "case": self.case,
            "name": self.name,
            "created": self.created,
            "states": [s.to_dict() for s in self.states],
            "input": self.input,
            "result": self.result,
            "error": self.error,
            "created_by": self.created_by,
            "composition": self.composition,
            "progress": self.progress,
            "attempts": self.attempts,
            "backoff_until": self.backoff_until,
            "last_backoff_s": self.last_backoff_s,
            "routed_to": self.routed_to,
            "state": self.state,
            "outcome": self.outcome,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Task":
        t = cls(
            id=d["id"],
            type=d["type"],
            priority=int(d.get("priority", 0)),
            plan=d.get("plan", ""),
            case=d.get("case", ""),
            name=d.get("name", ""),
            created=float(d.get("created", 0)),
            states=[
                StateTransition(s["state"], float(s["created"]))
                for s in d.get("states", [])
            ],
            input=d.get("input"),
            result=d.get("result"),
            error=d.get("error", ""),
            created_by=d.get("created_by", {}),
            composition=d.get("composition"),
            progress=d.get("progress"),
            attempts=int(d.get("attempts", 0)),
            backoff_until=float(d.get("backoff_until", 0.0)),
            last_backoff_s=float(d.get("last_backoff_s", 0.0)),
            routed_to=d.get("routed_to", ""),
        )
        return t
