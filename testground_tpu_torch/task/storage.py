"""Task storage: SQLite (disk) and dict (memory) backends (a copy of
``testground_tpu/task/storage.py``: the same file, table and JSON rows).

The reference stores tasks in LevelDB with keys ``<prefix>:<unixtime>_<xid>``
so that range scans list tasks in time order and a state change is an atomic
delete+put across prefixes (pkg/task/storage.go:43-51,157-186). SQLite gives
us the same contract with an indexed ``state`` column and transactions.
"""

from __future__ import annotations

import json
import sqlite3
import threading
from pathlib import Path
from typing import Iterable, Optional

from .task import STATE_CANCELED, STATE_COMPLETE, STATE_PROCESSING, STATE_SCHEDULED, Task


class TaskStorage:
    """SQLite-backed storage; safe for multi-threaded use."""

    def __init__(self, path: str | Path) -> None:
        self._path = str(path)
        self._lock = threading.Lock()
        self._conn = sqlite3.connect(self._path, check_same_thread=False)
        self._conn.execute(
            """CREATE TABLE IF NOT EXISTS tasks (
                id TEXT PRIMARY KEY,
                state TEXT NOT NULL,
                created REAL NOT NULL,
                priority INTEGER NOT NULL DEFAULT 0,
                data TEXT NOT NULL
            )"""
        )
        self._conn.execute(
            "CREATE INDEX IF NOT EXISTS idx_tasks_state ON tasks(state, created)"
        )
        self._conn.commit()

    def put(self, task: Task) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO tasks (id, state, created, priority, data) "
                "VALUES (?, ?, ?, ?, ?)",
                (
                    task.id,
                    task.state,
                    task.created,
                    task.priority,
                    json.dumps(task.to_dict()),
                ),
            )
            self._conn.commit()

    def get(self, task_id: str) -> Optional[Task]:
        with self._lock:
            row = self._conn.execute(
                "SELECT data FROM tasks WHERE id = ?", (task_id,)
            ).fetchone()
        return Task.from_dict(json.loads(row[0])) if row else None

    def delete(self, task_id: str) -> None:
        with self._lock:
            self._conn.execute("DELETE FROM tasks WHERE id = ?", (task_id,))
            self._conn.commit()

    def by_state(self, *states: str, limit: int = 0) -> list[Task]:
        q = (
            "SELECT data FROM tasks WHERE state IN (%s) ORDER BY created DESC"
            % ",".join("?" for _ in states)
        )
        args: list = list(states)
        if limit:
            q += " LIMIT ?"
            args.append(limit)
        with self._lock:
            rows = self._conn.execute(q, args).fetchall()
        return [Task.from_dict(json.loads(r[0])) for r in rows]

    def all(self) -> list[Task]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT data FROM tasks ORDER BY created"
            ).fetchall()
        return [Task.from_dict(json.loads(r[0])) for r in rows]

    def failed_runs(self, limit: int = 0) -> list[Task]:
        """Run tasks that ended badly — failure, canceled, preempted —
        newest first: the ``testground tasks --failed`` listing of
        retryable tasks with their resume tokens (a task's id IS its
        resume token; ``testground run --resume <id>`` continues it
        from its last checkpoint, docs/robustness.md)."""
        from .task import (
            OUTCOME_SUCCESS,
            STATE_CANCELED,
            STATE_COMPLETE,
            TYPE_RUN,
        )

        out = [
            t
            for t in self.by_state(STATE_COMPLETE, STATE_CANCELED)
            if t.type == TYPE_RUN and t.outcome != OUTCOME_SUCCESS
        ]
        return out[:limit] if limit else out

    def pending(self) -> list[Task]:
        """Tasks to reload into the queue at boot (crash/resume,
        reference queue.go:18-38): scheduled first, then interrupted
        ones — processing (the daemon died mid-task) and wedged (it
        died in the instant between recording the wedged transition and
        requeuing; without this, such a task would be orphaned)."""
        from .task import STATE_WEDGED

        return sorted(
            self.by_state(
                STATE_SCHEDULED, STATE_PROCESSING, STATE_WEDGED
            ),
            key=lambda t: (t.state != STATE_SCHEDULED, t.created),
        )

    def close(self) -> None:
        with self._lock:
            self._conn.close()


class MemoryTaskStorage(TaskStorage):
    """In-memory variant (reference NewMemoryTaskStorage) — same contract,
    no file."""

    def __init__(self) -> None:
        super().__init__(":memory:")
