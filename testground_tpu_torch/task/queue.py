"""Priority task queue over persistent storage (a copy of
``testground_tpu/task/queue.py``; reference pkg/task/queue.go).

- heap ordered by (priority desc, created asc) (queue.go:176-206)
- reloads scheduled+processing tasks from storage at construction —
  crash/resume (queue.go:18-38). A RUN task that was processing when
  the daemon died is requeued with ``input.resume = true`` so the
  sim:jax runner continues it from its last checkpoint
  (sim/checkpoint.py) instead of from scratch.
- ``push_unique_by_branch`` cancels queued runs for the same repo/branch
  before pushing (queue.go:80-144)
- ``pop`` honors ``Task.backoff_until``: a task requeued with backoff
  (the wedged-dispatch retry path, docs/robustness.md) is not handed to
  a worker before its not-before time.
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Optional

from .storage import TaskStorage
from .task import STATE_CANCELED, STATE_SCHEDULED, TYPE_RUN, Task


class TaskQueue:
    def __init__(self, storage: TaskStorage, max_size: int = 1000) -> None:
        self.storage = storage
        self._max = max_size
        self._lock = threading.Condition()
        self._heap: list[tuple[int, float, str]] = []
        self._closed = False
        for t in storage.pending():
            # processing tasks go back to scheduled: the daemon died
            # mid-task. Run tasks additionally carry a resume request —
            # the runner picks up from the last checkpoint when one
            # exists, and runs fresh otherwise
            if t.state != STATE_SCHEDULED:
                if t.type == TYPE_RUN:
                    t.input = {**(t.input or {}), "resume": True}
                t.transition(STATE_SCHEDULED)
                storage.put(t)
            heapq.heappush(self._heap, self._entry(t))

    @staticmethod
    def _entry(t: Task) -> tuple[int, float, str]:
        return (-t.priority, t.created, t.id)

    def __len__(self) -> int:
        with self._lock:
            return len(self._heap)

    def depth_and_oldest_age(self) -> tuple[int, float]:
        """(queue depth, age in seconds of the oldest queued entry) —
        the fleet metrics plane's scrape-time gauge source. Heap
        entries are (-priority, created, id), so the minimum created
        across entries gives the oldest age without touching storage."""
        with self._lock:
            if not self._heap:
                return 0, 0.0
            oldest = min(e[1] for e in self._heap)
            return len(self._heap), max(0.0, time.time() - oldest)

    def push(self, task: Task) -> None:
        with self._lock:
            if len(self._heap) >= self._max:
                raise RuntimeError("task queue is full")
            self.storage.put(task)
            heapq.heappush(self._heap, self._entry(task))
            self._lock.notify()

    def push_unique_by_branch(self, task: Task) -> list[str]:
        """Cancels scheduled tasks with the same repo+branch, then pushes.
        Returns ids of canceled tasks."""
        repo = task.created_by.get("repo", "")
        branch = task.created_by.get("branch", "")
        canceled: list[str] = []
        if repo and branch:
            for other in self.storage.by_state(STATE_SCHEDULED):
                if (
                    other.id != task.id
                    and other.created_by.get("repo") == repo
                    and other.created_by.get("branch") == branch
                ):
                    self.cancel(other.id)
                    canceled.append(other.id)
        self.push(task)
        return canceled

    def pop(self, timeout: Optional[float] = None) -> Optional[Task]:
        """Blocks until a scheduled task whose backoff has elapsed is
        available (or timeout). Backing-off tasks are skipped and
        re-heaped; the wait is shortened to the soonest not-before time
        so a worker wakes exactly when the retry becomes runnable."""
        with self._lock:
            while True:
                deferred: list[tuple[int, float, str]] = []
                ready: Optional[Task] = None
                soonest: Optional[float] = None
                now = time.time()
                while self._heap:
                    entry = heapq.heappop(self._heap)
                    t = self.storage.get(entry[2])
                    if t is None or t.state != STATE_SCHEDULED:
                        continue  # canceled/deleted while queued: skip
                    remaining = (t.backoff_until or 0.0) - now
                    if remaining > 0:
                        deferred.append(entry)
                        soonest = (
                            remaining
                            if soonest is None
                            else min(soonest, remaining)
                        )
                        continue
                    ready = t
                    break
                for entry in deferred:
                    heapq.heappush(self._heap, entry)
                if ready is not None:
                    return ready
                if self._closed:
                    return None
                wait = timeout
                if soonest is not None:
                    wait = soonest if wait is None else min(wait, soonest)
                if not self._lock.wait(wait):
                    # timed out; if only a backoff window elapsed, loop
                    # once more to re-check the deferred entries
                    if soonest is not None and (
                        timeout is None or soonest <= timeout
                    ):
                        continue
                    return None

    def cancel(self, task_id: str) -> bool:
        t = self.storage.get(task_id)
        if t is None or t.state != STATE_SCHEDULED:
            return False
        t.transition(STATE_CANCELED)
        self.storage.put(t)
        return True

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._lock.notify_all()
