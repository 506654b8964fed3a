"""Persistent prioritized task queue (a copy of ``testground_tpu.task``;
reference pkg/task/): a task store written by either package reads in
the other.

States scheduled→processing→complete (or canceled), outcomes
success/failure/canceled/unknown, types build/run (task.go:13-41).
Storage is SQLite (the LevelDB analog): every state transition is persisted
and scheduled+processing tasks are reloaded into the queue at boot —
crash/resume (queue.go:18-38).
"""

from .task import (
    STATE_CANCELED,
    STATE_COMPLETE,
    STATE_PROCESSING,
    STATE_SCHEDULED,
    STATE_WEDGED,
    OUTCOME_CANCELED,
    OUTCOME_FAILURE,
    OUTCOME_PREEMPTED,
    OUTCOME_SUCCESS,
    OUTCOME_UNKNOWN,
    TYPE_BUILD,
    TYPE_PREWARM,
    TYPE_RUN,
    Task,
)
from .storage import TaskStorage, MemoryTaskStorage
from .queue import TaskQueue

__all__ = [
    "MemoryTaskStorage",
    "OUTCOME_CANCELED",
    "OUTCOME_FAILURE",
    "OUTCOME_PREEMPTED",
    "OUTCOME_SUCCESS",
    "OUTCOME_UNKNOWN",
    "STATE_CANCELED",
    "STATE_COMPLETE",
    "STATE_PROCESSING",
    "STATE_SCHEDULED",
    "STATE_WEDGED",
    "Task",
    "TaskQueue",
    "TaskStorage",
    "TYPE_BUILD",
    "TYPE_PREWARM",
    "TYPE_RUN",
]
