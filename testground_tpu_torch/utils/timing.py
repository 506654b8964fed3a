"""Wall-clock stage timing on the host (a copy of ``testground_tpu/
utils/timing.py``).

A :class:`StageClock` keeps its own ``t0``, prints ``[timing]`` stamps to
stderr when ``TESTGROUND_TIMING`` is set, and records every stage as a
span (``{"name", "start_s", "seconds"}``); ``rollup`` aggregates them by
name for the run journal's ``host_spans``."""

from __future__ import annotations

import os
import sys
import time
from contextlib import contextmanager


class StageClock:
    """Wall-clock stage timer: stderr stamps and structured spans.

    - ``stamp(label)``: the ``TESTGROUND_TIMING=1`` stderr line;
    - ``span(name)``: a context manager recording one named span;
    - ``lap(name)``: a span from the previous lap mark (or
      ``reset_lap``) to now, the per-chunk dispatch cadence;
    - ``rollup()``: spans aggregated by name in first-seen order
      (``{"name", "seconds", "count", "max_seconds"}``).
    """

    def __init__(self, tag: str = "", t0: float = None) -> None:
        self.tag = tag
        self.t0 = time.monotonic() if t0 is None else t0
        self.spans: list[dict] = []
        self._lap: float = None

    def elapsed(self) -> float:
        return time.monotonic() - self.t0

    def stamp(self, label: str) -> None:
        if os.environ.get("TESTGROUND_TIMING"):
            prefix = f"{self.tag}: " if self.tag else ""
            print(f"[timing] {prefix}{label}: +{self.elapsed():.2f}s",
                  file=sys.stderr)

    def add_span(self, name: str, start_s: float, seconds: float) -> None:
        self.spans.append({"name": name, "start_s": round(start_s, 6),
                           "seconds": round(seconds, 6)})

    @contextmanager
    def span(self, name: str):
        start = self.elapsed()
        try:
            yield self
        finally:
            self.add_span(name, start, self.elapsed() - start)
            self.stamp(f"{name} done")

    def reset_lap(self) -> None:
        self._lap = self.elapsed()

    def lap(self, name: str) -> float:
        now = self.elapsed()
        start = self._lap if self._lap is not None else 0.0
        self.add_span(name, start, now - start)
        self._lap = now
        return now - start

    def rollup(self) -> list[dict]:
        by_name: dict[str, dict] = {}
        order: list[dict] = []
        for s in self.spans:
            r = by_name.get(s["name"])
            if r is None:
                r = {"name": s["name"], "seconds": 0.0, "count": 0,
                     "max_seconds": 0.0}
                by_name[s["name"]] = r
                order.append(r)
            r["seconds"] += s["seconds"]
            r["count"] += 1
            r["max_seconds"] = max(r["max_seconds"], s["seconds"])
        for r in order:
            r["seconds"] = round(r["seconds"], 6)
            r["max_seconds"] = round(r["max_seconds"], 6)
        return order
