"""The streaming result plane: chunk-boundary observer drains
(counterpart of ``testground_tpu/sim/drain.py``).

The trace (sim/trace.py) and telemetry (sim/telemetry.py) planes record
into fixed-capacity device buffers demuxed after the run, so a buffer's
capacity bounds the whole run's depth. With a drain, at every chunk
boundary of ``SimExecutable.run`` the host

1. reads the observer leaves of the boundary state (one device-to-host
   copy, outside the captured tick),
2. zeroes their cursors (``trace_cnt``, ``telem.cnt``) in place, so the
   captured stepper, which replays into the state's own tensors, goes
   on writing from slot 0, and
3. demuxes the batch: trace events append to ``<run_dir>/trace.jsonl``
   (one Chrome trace-event object a line; ``finalize`` assembles
   ``trace.json`` from it) and telemetry samples to ``results.out``.

A buffer then bounds one chunk, not the run. A tick runs wholly inside
one chunk and appends are monotone per lane, so the drained batches
concatenate to an undrained run's end-of-run demux, record for record.
Only the cursors reset: ``trace_dropped`` and ``telem.clipped`` stay
cumulative (a chunk that overflows still reports its loss), and the
interval accumulators, the gauge register and the histograms are
run-scoped (the histograms demux once, at ``finalize``). The drain never
touches the tick: a drained and an undrained run of one executable run
the same loop iteration.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np

from . import telemetry as telemetrymod
from . import trace as tracemod

# the streamed files: the trace events (the event file the daemon tails
# for GET /events) and the telemetry records
EVENTS_FILE = "trace.jsonl"
RESULTS_FILE = "results.out"


def drain_flags(rinput) -> tuple[bool, bool]:
    """(trace_drain, telemetry_drain) asked for by a composition's
    observer tables: ``drain = true`` on an enabled table (a disabled
    one compiles to nothing, so there is nothing to drain)."""

    def _flag(table) -> bool:
        if table is None:
            return False
        if isinstance(table, dict):
            return bool(table.get("enabled", True)) and bool(
                table.get("drain", False)
            )
        return bool(getattr(table, "enabled", True)) and bool(
            getattr(table, "drain", False)
        )

    return (
        _flag(getattr(rinput, "trace", None)),
        _flag(getattr(rinput, "telemetry", None)),
    )


class _Stream:
    """One output stream's host-side watermarks and files. Files are
    truncated on the first append, appended after, and never held
    open."""

    def __init__(self, out_dir: Path) -> None:
        self.dir = Path(out_dir)
        self.trace_events = 0
        self.trace_dropped = 0  # the latest cumulative device value
        self.telemetry_samples = 0
        self.telemetry_clipped = 0  # the latest cumulative device value
        # sample boundaries passed so far, recorded and clipped: the
        # timestamp base of the next batch (a clipped boundary still
        # advances virtual time)
        self.telemetry_boundaries = 0
        self._seen_lanes: set[int] = set()
        self._trace_open = False
        self._results_open = False

    def _append(self, fname: str, lines, fresh_attr: str) -> None:
        if not lines:
            return
        self.dir.mkdir(parents=True, exist_ok=True)
        mode = "a" if getattr(self, fresh_attr) else "w"
        setattr(self, fresh_attr, True)
        with open(self.dir / fname, mode) as f:
            for row in lines:
                # a row is a dict, or its JSON text already
                f.write((row if isinstance(row, str) else json.dumps(row))
                        + "\n")

    def append_trace(self, rows) -> None:
        self._append(EVENTS_FILE, rows, "_trace_open")

    def append_results(self, rows) -> None:
        self._append(RESULTS_FILE, rows, "_results_open")

    def stats(self) -> dict:
        return {
            "trace_events": self.trace_events,
            "trace_dropped": self.trace_dropped,
            "telemetry_samples": self.telemetry_samples,
            "telemetry_clipped": self.telemetry_clipped,
        }


def _host(tree: dict) -> dict:
    """A dict of tensors as numpy arrays on the host."""
    return {k: v.detach().cpu().numpy() for k, v in tree.items()}


class ObserverDrain:
    """The host side of the drain plane for one run (plain, a sweep, or
    one round of a search). Construct it with the executable and either
    ``run_dir`` (a plain run) or ``scenario_dir`` (a batched run: a
    callable from the global scenario index to its directory);
    ``run(drain=...)`` calls :meth:`drain` at every chunk boundary, and
    the caller calls :meth:`finalize` (or :meth:`finalize_scenario` for
    each scenario) with the final state. ``skip_scenarios`` are batched
    rows never streamed (a search round's padding probes)."""

    def __init__(
        self,
        ex,
        *,
        trace_drain: bool = False,
        telem_drain: bool = False,
        run_dir=None,
        scenario_dir=None,
        skip_scenarios=(),
    ) -> None:
        if (run_dir is None) == (scenario_dir is None):
            raise ValueError(
                "ObserverDrain needs exactly one of run_dir/scenario_dir"
            )
        self.ex = ex
        self.skip_scenarios = frozenset(skip_scenarios)
        self.trace_spec = getattr(ex, "trace", None) if trace_drain else None
        self.telem_spec = (
            getattr(ex, "telemetry", None) if telem_drain else None
        )
        self.batched = scenario_dir is not None
        self._scenario_dir = scenario_dir
        self.batches = 0
        self._streams: dict[Optional[int], _Stream] = {}
        if run_dir is not None:
            self._streams[None] = _Stream(run_dir)
        # the lanes demux reads: real instances only (a batched state's
        # rows slice to this too)
        self.n = ex.ctx.n_instances
        self.quantum_ms = ex.config.quantum_ms

    @property
    def active(self) -> bool:
        return self.trace_spec is not None or self.telem_spec is not None

    # --------------------------------------------------------- host side

    def _stream(self, sid: Optional[int]) -> _Stream:
        st = self._streams.get(sid)
        if st is None:
            st = self._streams[sid] = _Stream(self._scenario_dir(sid))
        return st

    def _drain_trace_rows(self, stream: _Stream, buf, cnt, dropped) -> None:
        stream.trace_dropped = int(np.asarray(dropped)[: self.n].sum())
        ev = tracemod.trace_events(
            {"trace_buf": buf, "trace_cnt": cnt}, self.n
        )
        if not len(ev):
            return
        rows: list = []
        if not stream._seen_lanes:
            rows.append(dict(tracemod.PROCESS_META))
        new_lanes = set(ev["lane"].tolist()) - stream._seen_lanes
        if new_lanes:
            rows.extend(tracemod.chrome_thread_meta(new_lanes, self.ex.ctx))
            stream._seen_lanes |= new_lanes
        rows.extend(tracemod.chrome_event_json(ev, self.quantum_ms))
        stream.trace_events += len(ev)
        stream.append_trace(rows)

    def _drain_telem_rows(self, stream: _Stream, leaves: dict) -> None:
        clipped_now = int(np.asarray(leaves["clipped"]))
        clip_delta = clipped_now - stream.telemetry_clipped
        stream.telemetry_clipped = clipped_now
        batch_cnt = min(int(leaves["cnt"]), self.telem_spec.s_cap)
        if batch_cnt:
            # a batch's rows are the first boundaries of its window (a
            # full buffer clips the tail), at [boundaries,
            # boundaries + cnt); the chunk's clipped ones follow them
            lane, glob = telemetrymod.telemetry_records(
                {"telem": leaves},
                self.telem_spec,
                self.ex.ctx,
                self.quantum_ms,
                n_instances=self.n,
                sample_base=stream.telemetry_boundaries,
                include_hist=False,
            )
            stream.telemetry_samples += batch_cnt
            stream.append_results(lane + glob)
        stream.telemetry_boundaries += batch_cnt + clip_delta

    def drain(self, st: dict, chunk: int = 0) -> dict:
        """One chunk boundary: read the observer leaves to the host,
        demux and append the batch, and zero the device cursors in
        place. Returns ``st`` itself (a captured stepper advances its
        own state's tensors). ``chunk`` is a batched run's scenario
        chunk (global scenario = chunk x chunk_size + row)."""
        if not self.active:
            return st
        # one device-to-host read a boundary: the drain's whole cost
        # on the card
        host = {}
        if self.trace_spec is not None:
            host["trace"] = _host(st["trace"])
        if self.telem_spec is not None:
            host["telem"] = _host(st["telem"])
        if self.batched:
            C = self.ex.chunk_size
            n_scen = self.ex.n_scenarios
            for row in range(C):
                sid = chunk * C + row
                if sid >= n_scen:
                    break  # padding rows repeat scenario 0: never demux
                if sid in self.skip_scenarios:
                    continue
                self._drain_rows(self._stream(sid), host, row)
        else:
            self._drain_rows(self._streams[None], host, None)
        if self.trace_spec is not None:
            st["trace"]["trace_cnt"].zero_()
        if self.telem_spec is not None:
            st["telem"]["cnt"].zero_()
        self.batches += 1
        return st

    def _drain_rows(self, stream: _Stream, host: dict, row) -> None:
        """Demux one stream's batch: ``row`` is its scenario's row of a
        batched boundary (None: the plain run's leaves)."""
        def at(v):
            return v if row is None else v[row]

        if "trace" in host:
            tr = host["trace"]
            self._drain_trace_rows(stream, at(tr["trace_buf"]),
                                   at(tr["trace_cnt"]),
                                   at(tr["trace_dropped"]))
        if "telem" in host:
            self._drain_telem_rows(
                stream, {k: at(v) for k, v in host["telem"].items()})

    # -------------------------------------------------------- finalizing

    def _finalize_stream(self, sid: Optional[int], state: dict,
                         fault_plan) -> None:
        stream = self._stream(sid) if self.batched else self._streams[None]
        if self.trace_spec is not None:
            tail: list[dict] = []
            if not stream._trace_open:
                # an event-free run still gets a (metadata-only) stream
                tail.append(dict(tracemod.PROCESS_META))
            if (
                fault_plan is not None
                and fault_plan.has_windows
                and "faults" in state
            ):
                tail.extend(
                    tracemod.fault_window_events(
                        fault_plan,
                        state["faults"],
                        float(self.quantum_ms) * 1e3,
                        last_tick=int(tracemod._np(state.get("tick", 0))),
                    )
                )
            stream.append_trace(tail)
            _assemble_trace_json(stream.dir)
        if self.telem_spec is not None and self.telem_spec.n_hist:
            # the histograms were never reset: they demux once, from
            # the final state
            lane, glob = telemetrymod.telemetry_records(
                state,
                self.telem_spec,
                self.ex.ctx,
                self.quantum_ms,
                n_instances=self.n,
                include_samples=False,
            )
            stream.append_results(lane + glob)

    def finalize(self, state: dict, fault_plan=None) -> None:
        """After a plain run: the fault windows' track from the final
        state's window leaves and, for an event-free run, the metadata
        row, onto the trace stream; the cumulative histograms onto the
        results stream; then ``trace.json`` assembled from
        ``trace.jsonl``."""
        self._finalize_stream(None, state, fault_plan)

    def finalize_scenario(self, s: int, state: dict, fault_plan=None) -> None:
        """:meth:`finalize` for scenario ``s`` of a batched run, from its
        own final state (its fault windows ride it)."""
        self._finalize_stream(s, state, fault_plan)

    # -------------------------------------------------------- accounting

    def _planes(self, raw: dict) -> dict:
        out: dict = {}
        if self.trace_spec is not None:
            out["trace_events"] = raw["trace_events"]
            out["trace_dropped"] = raw["trace_dropped"]
        if self.telem_spec is not None:
            out["telemetry_samples"] = raw["telemetry_samples"]
            out["telemetry_clipped"] = raw["telemetry_clipped"]
        return out

    def scenario_stats(self, s: Optional[int] = None) -> dict:
        """The watermarks of one stream (the plain run's: ``s=None``),
        of the drained planes."""
        stream = self._streams.get(s)
        raw = (
            stream.stats()
            if stream is not None
            else {
                "trace_events": 0,
                "trace_dropped": 0,
                "telemetry_samples": 0,
                "telemetry_clipped": 0,
            }
        )
        return self._planes(raw)

    def stats(self) -> dict:
        """The cumulative watermarks of the drained planes summed over
        every stream, and the batch count."""
        raws = [s.stats() for s in self._streams.values()]
        total = {k: sum(r[k] for r in raws)
                 for k in ("trace_events", "trace_dropped",
                           "telemetry_samples", "telemetry_clipped")}
        out = self._planes(total)
        out["drain_batches"] = self.batches
        return out

    def journal(self) -> dict:
        """The run journal's ``drain`` record."""
        return {
            "trace": self.trace_spec is not None,
            "telemetry": self.telem_spec is not None,
            "batches": self.batches,
        }

    # ------------------------------------------------- resume position

    def snapshot(self) -> dict:
        """The drain's host-side position: each stream's watermarks and
        the byte sizes of its files at this boundary. :meth:`restore`
        truncates the files back to them, so a resumed stream equals an
        uninterrupted run's."""
        streams = {}
        for sid, stream in self._streams.items():
            streams["root" if sid is None else str(sid)] = {
                **stream.stats(),
                "telemetry_boundaries": stream.telemetry_boundaries,
                "seen_lanes": sorted(stream._seen_lanes),
                "trace_open": stream._trace_open,
                "results_open": stream._results_open,
                "trace_bytes": _file_size(stream.dir / EVENTS_FILE),
                "results_bytes": _file_size(stream.dir / RESULTS_FILE),
            }
        return {"batches": self.batches, "streams": streams}

    def restore(self, snap: dict) -> None:
        """Re-enter the position :meth:`snapshot` recorded: the
        watermarks, and each streamed file truncated to its recorded
        size. Raises OSError when a file it names is gone."""
        self.batches = int(snap.get("batches", 0))
        for key, rec in (snap.get("streams") or {}).items():
            sid = None if key == "root" else int(key)
            if sid is None and None not in self._streams:
                continue
            stream = (
                self._streams[None] if sid is None else self._stream(sid)
            )
            stream.trace_events = int(rec.get("trace_events", 0))
            stream.trace_dropped = int(rec.get("trace_dropped", 0))
            stream.telemetry_samples = int(rec.get("telemetry_samples", 0))
            stream.telemetry_clipped = int(rec.get("telemetry_clipped", 0))
            stream.telemetry_boundaries = int(
                rec.get("telemetry_boundaries", 0)
            )
            stream._seen_lanes = set(
                int(x) for x in rec.get("seen_lanes", []))
            stream._trace_open = bool(rec.get("trace_open", False))
            stream._results_open = bool(rec.get("results_open", False))
            for fname, size_key, open_flag in (
                (EVENTS_FILE, "trace_bytes", stream._trace_open),
                (RESULTS_FILE, "results_bytes", stream._results_open),
            ):
                if not open_flag:
                    continue  # the next append truncates anyway
                with open(stream.dir / fname, "r+b") as f:
                    f.truncate(int(rec.get(size_key, 0)))


def _file_size(path: Path) -> int:
    try:
        return path.stat().st_size
    except OSError:
        return 0


def _assemble_trace_json(out_dir: Path) -> None:
    """Wrap the streamed ``trace.jsonl`` lines into a Perfetto-loadable
    ``trace.json`` document (a streaming copy)."""
    src = Path(out_dir) / EVENTS_FILE
    if not src.exists():
        return
    dst = Path(out_dir) / "trace.json"
    with open(dst, "w") as out, open(src) as f:
        out.write('{"traceEvents": [')
        first = True
        for line in f:
            line = line.strip()
            if not line:
                continue
            if not first:
                out.write(", ")
            out.write(line)
            first = False
        out.write('], "displayTimeUnit": "ms"}')
