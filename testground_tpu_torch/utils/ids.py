"""Sortable unique run/task ids (a copy of ``testground_tpu/utils/ids.py``;
the analog of the reference's xid usage, pkg/engine/engine.go:216)."""

from __future__ import annotations

import os
import threading
import time

_counter = 0
_lock = threading.Lock()
_ALPHABET = "0123456789abcdefghijklmnopqrstuv"


def _b32(n: int, width: int) -> str:
    chars = []
    for _ in range(width):
        chars.append(_ALPHABET[n & 31])
        n >>= 5
    return "".join(reversed(chars))


def new_id() -> str:
    """Time-prefixed id: lexicographic order == creation order."""
    global _counter
    with _lock:
        _counter = (_counter + 1) & 0x3FF
        c = _counter
    ts = int(time.time() * 1000)
    rnd = int.from_bytes(os.urandom(3), "big")
    return _b32(ts, 9) + _b32(c, 2) + _b32(rnd, 5)
