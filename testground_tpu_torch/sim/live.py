"""The live plane: progress rows at chunk boundaries (host side).

Counterpart of ``testground_tpu/sim/live.py``. ``SimExecutable.run``
already reads the tick and the live-lane count back at every chunk
boundary; a :class:`LiveSink` turns that read into one JSON row a
boundary in ``<run_dir>/progress.jsonl`` (and hands each row to the
caller's ``mirror``). Nothing here runs on the device or in the captured
tick: the rows read the boundary state after the replay.

Row schema (one JSON object a line), the JAX package's::

    seq        line number, from 0
    kind       "run" | "sweep" | "search"
    wall_s     seconds since the sink was opened
    phase      "dispatch" | "round" | "done"
    tick       simulated ticks so far
    max_ticks  the run's tick horizon
    progress   completion fraction in [0, 1]
    running    live lanes
    instances  lanes a scenario
    ticks_executed / skip_ratio    event-skip accounting
    trace_events / trace_dropped / telemetry_samples / telemetry_clipped
                                   the observer planes' running totals
    drain_batches                  drained boundaries (sim/drain.py)
    scenarios / chunk / n_chunks   scenario accounting (batched runs)
    outcome                        the final ("done") row only

Every field but ``wall_s`` (and the ``compile_seconds``/``wall_seconds``
the runner adds to its first and last rows) equals the JAX runner's.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

PROGRESS_FILE = "progress.jsonl"


def live_table(rinput):
    """The composition's [live] table as api.composition.Live, or None
    when absent (streaming is on by default)."""
    lv = getattr(rinput, "live", None)
    if lv is None:
        return None
    if isinstance(lv, dict):
        from ..api.composition import Live

        lv = Live.from_dict(lv)
    return lv


def live_disabled(rinput) -> bool:
    """True when the [live] table is marked disabled (``--no-live``)."""
    lv = getattr(rinput, "live", None)
    if lv is None:
        return False
    if isinstance(lv, dict):
        return not lv.get("enabled", True)
    return not getattr(lv, "enabled", True)


def live_interval_s(rinput) -> float:
    lv = live_table(rinput)
    return float(getattr(lv, "interval", 0.0) or 0.0) if lv else 0.0


class LiveSink:
    """Appends rows to ``<run_dir>/progress.jsonl`` and hands each to
    ``mirror``.

    ``interval_s`` rate-limits the rows; ``force=True`` rows (the first,
    the last) always land. ``mirror`` has its own floor
    (``MIRROR_INTERVAL_S``). The file is truncated when the sink opens,
    unless the run resumes (``resume_seq``): then it is cut back to the
    checkpointed ``resume_bytes`` and the seq goes on. A sink failure
    never fails a run."""

    MIRROR_INTERVAL_S = 0.5

    def __init__(
        self,
        run_dir,
        kind: str = "run",
        interval_s: float = 0.0,
        mirror: Optional[Callable[[dict], None]] = None,
        clock: Callable[[], float] = time.monotonic,
        resume_seq: Optional[int] = None,
        resume_bytes: Optional[int] = None,
    ) -> None:
        run_dir = Path(run_dir)
        run_dir.mkdir(parents=True, exist_ok=True)
        self.path = run_dir / PROGRESS_FILE
        self.kind = kind
        self.interval_s = float(interval_s)
        self.mirror = mirror
        self._clock = clock
        self._t0 = clock()
        self._last: Optional[float] = None
        self._last_mirror: Optional[float] = None
        if resume_seq is not None:
            self.seq = int(resume_seq)
            if resume_bytes is not None and self.path.exists():
                try:
                    with open(self.path, "r+b") as f:
                        f.truncate(int(resume_bytes))
                except OSError:
                    pass
        else:
            self.seq = 0
            self.path.write_text("")

    def emit(self, snap: dict, force: bool = False) -> bool:
        """Append one row; False when rate-limited."""
        now = self._clock()
        if (not force and self._last is not None
                and (now - self._last) < self.interval_s):
            return False
        self._last = now
        row = {"seq": self.seq, "kind": self.kind,
               "wall_s": round(now - self._t0, 3), **snap}
        self.seq += 1
        try:
            with open(self.path, "a") as f:
                f.write(json.dumps(row) + "\n")
        except OSError:
            return False
        if self.mirror is not None and (
            force or self._last_mirror is None
            or (now - self._last_mirror) >= self.MIRROR_INTERVAL_S
        ):
            self._last_mirror = now
            try:
                self.mirror(row)
            except Exception:  # noqa: BLE001 — the mirror is best-effort
                pass
        return True


# ------------------------------------------------------------ row reads


def _host(x) -> np.ndarray:
    """A boundary leaf (a tensor on either device, or numpy) on the
    host."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def exec_stats(st, batched: bool = False) -> Optional[tuple[int, float]]:
    """(ticks_executed, skip_ratio) at a boundary, or None without event
    skip. A batched state reduces over its scenario axis (the most
    executed, against the largest tick)."""
    if "ticks_executed" not in st:
        return None
    te = _host(st["ticks_executed"])
    tk = _host(st["tick"])
    executed = int(te.max()) if batched else int(te)
    tick = int(tk.max()) if batched else int(tk)
    return executed, (executed / tick) if tick else 1.0


def chunk_snapshot(
    tick: int,
    running: int,
    info: dict,
    *,
    max_ticks: int,
    n_instances: int,
    phase: str = "dispatch",
) -> dict:
    """One boundary's row. ``info`` is what ``on_chunk`` receives
    (``{"state": st}``, ``observer`` with the drain's watermarks on a
    drained run, and ``live_lanes``/``chunk``/``n_chunks``/
    ``n_scenarios`` on a batched one). The observer totals come from
    the drain on a drained run, else from the state (skipped on an
    undrained multi-chunk sweep, whose buffers restart each chunk)."""
    st = info.get("state")
    tick_frac = min(1.0, int(tick) / max_ticks) if max_ticks else 1.0
    snap = {
        "phase": phase,
        "tick": int(tick),
        "max_ticks": int(max_ticks),
        "progress": round(tick_frac, 4),
        "running": int(running),
        "instances": int(n_instances),
    }
    batched = "live_lanes" in info
    obs = info.get("observer") or {}
    if batched:
        chunk_size = int(np.shape(info["live_lanes"])[0])
        total = int(info.get("n_scenarios", chunk_size))
        ci_ = int(info.get("chunk", 0))
        rows = max(0, min(chunk_size, total - ci_ * chunk_size))
        state_is_cumulative = int(info.get("n_chunks", 1)) == 1
    else:
        rows = None
        state_is_cumulative = True

    def _total(leaf):
        a = _host(leaf)
        if rows is not None:
            a = a[:rows]  # real scenario rows only
        return int(a.sum())

    if st is not None:
        es = exec_stats(st, batched=batched)
        if es is not None:
            snap["ticks_executed"] = es[0]
            snap["skip_ratio"] = round(es[1], 4)
        if "trace" in st:
            if "trace_events" in obs:
                snap["trace_events"] = obs["trace_events"]
                snap["trace_dropped"] = obs["trace_dropped"]
            elif state_is_cumulative:
                tr = st["trace"]
                snap["trace_events"] = _total(tr["trace_cnt"])
                snap["trace_dropped"] = _total(tr["trace_dropped"])
        if "telem" in st:
            if "telemetry_samples" in obs:
                snap["telemetry_samples"] = obs["telemetry_samples"]
                snap["telemetry_clipped"] = obs["telemetry_clipped"]
            elif state_is_cumulative:
                tl = st["telem"]
                snap["telemetry_samples"] = _total(tl["cnt"])
                snap["telemetry_clipped"] = _total(tl["clipped"])
    if "drain_batches" in obs:
        snap["drain_batches"] = obs["drain_batches"]
    if batched:
        lv = _host(info["live_lanes"])
        live_scen = int(lv.any(axis=-1).sum())
        ci = int(info.get("chunk", 0))
        n_chunks = int(info.get("n_chunks", 1))
        chunk_size = int(lv.shape[0])
        total = int(info.get("n_scenarios", chunk_size))
        in_chunk = min(chunk_size, total - ci * chunk_size)
        snap["scenarios"] = {
            "total": total,
            "live": live_scen,
            "done": ci * chunk_size + max(0, in_chunk - live_scen),
        }
        snap["chunk"] = ci
        snap["n_chunks"] = n_chunks
        snap["progress"] = round((ci + tick_frac) / n_chunks, 4)
    return snap


def boundary_callback(
    clock,
    log,
    sink: Optional[LiveSink],
    *,
    max_ticks: int,
    n_instances: int,
    event_skip: bool,
    format_line,
    batched: bool = False,
    decorate=None,
    profiler=None,
):
    """The runner's ``on_chunk``: laps the clock's ``dispatch`` span,
    feeds the profiler (sim/profile.py), logs
    ``format_line(tick, running, info, live_scen)`` (with the event-skip
    suffix) and streams the row. Without a sink only the scalars the log
    line needs are read."""

    def on_chunk(tick, running, info):
        dispatch_lap = clock.lap("dispatch")
        if profiler is not None:
            profiler.on_boundary(dispatch_lap)
        if sink is not None:
            snap = chunk_snapshot(tick, running, info, max_ticks=max_ticks,
                                  n_instances=n_instances)
            if decorate is not None:
                decorate(snap)
            es = ((snap["ticks_executed"], snap["skip_ratio"])
                  if "ticks_executed" in snap else None)
            live_scen = snap.get("scenarios", {}).get("live")
        else:
            snap = None
            es = (exec_stats(info["state"], batched=batched)
                  if event_skip else None)
            live_scen = (int(_host(info["live_lanes"]).any(axis=-1).sum())
                         if "live_lanes" in info else None)
        line = format_line(tick, running, info, live_scen)
        if event_skip and es is not None:
            line += f" ({es[0]} ticks executed, skip_ratio {es[1]:.3f})"
        log(line)
        if sink is not None:
            sink.emit(snap)

    return on_chunk
