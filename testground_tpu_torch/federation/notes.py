"""The worker's warm-key notes: the affinity digest of every executor the
runner's in-memory pool holds, for the heartbeat's ``cache_keys``.

The JAX package reports its pool's notes plus its disk tier's entries.
The port has no disk tier behind its pool (ROADMAP item 11.3), so a note
lives exactly as long as the pooled executor it names: the runner notes
a digest when it checks an executor in (a run's or a prewarm's, whose
``RunInput.affinity`` the engine set at queue time) and drops the note
when the executor leaves the pool — checked out by a run (the next
identical run would build its own), evicted (``_executor_checkin``'s
depth bound, ``_make_room``) or cleared. ``cache_keys`` therefore names
only executors that this worker could hand the next run as a
``memory_hit``.

Torch-free, so that the heartbeat thread reads it without importing the
runner.
"""

from __future__ import annotations

import threading

_LOCK = threading.Lock()
# pool key -> the affinity digests of the compositions checked in under it
_NOTES: dict = {}


def hold(key: str, affinity: str) -> None:
    """The pool holds an executor under ``key`` for ``affinity``."""
    if affinity:
        with _LOCK:
            _NOTES.setdefault(key, set()).add(affinity)


def drop(key: str) -> None:
    """The executor under ``key`` left the pool."""
    with _LOCK:
        _NOTES.pop(key, None)


def clear() -> None:
    """The pool was emptied."""
    with _LOCK:
        _NOTES.clear()


def affinity_keys() -> list:
    """Every affinity digest the pool holds an executor for, sorted."""
    with _LOCK:
        return sorted({a for affs in _NOTES.values() for a in affs})
