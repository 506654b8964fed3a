"""File-backed metrics viewer (a copy of ``testground_tpu/metrics/viewer.py``;
reference pkg/metrics/viewer.go:24-238).

Series naming follows the reference convention: ``results.<plan>.<metric>``
(R() recorder) and ``diagnostics.<plan>.<metric>`` (D() recorder). Tags are
``run``, ``group_id``, ``instance``. ``GetData`` returns one Row per run
with fields keyed by tag variation (the reference's per-tag-variation
column split, viewer.go GetData).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator, Optional

# the live plane's chunk-boundary stream (sim/live.py writes it)
PROGRESS_FILE = "progress.jsonl"

# the drain plane's streaming event log (sim/drain.py appends one
# Chrome trace-event JSON object per line at every chunk boundary; the
# daemon's GET /events tails it mid-run, and the drain's finalize step
# assembles the Perfetto-loadable trace.json from it)
EVENTS_FILE = "trace.jsonl"


# generous per-snapshot byte estimate for read_progress's tail window
# (real lines are ~150-350 B; undershooting only trims the tail)
_PROGRESS_LINE_EST = 1024


def read_progress(run_dir, limit: int = 0) -> list[dict]:
    """Parse ``<run_dir>/progress.jsonl`` (last ``limit`` snapshots;
    0 = all), oldest first. Tolerates a torn final line — the writer
    may be mid-append while a run is still executing. With ``limit``
    set, only a bounded TAIL of the file is read and decoded (the
    /live page re-reads every shown run's stream on each auto-refresh;
    a long dense run's stream can hold 10^5+ superseded lines)."""
    path = Path(run_dir) / PROGRESS_FILE
    if not path.exists():
        return []
    try:
        if limit:
            window = limit * _PROGRESS_LINE_EST
            with open(path, "rb") as f:
                size = f.seek(0, 2)
                if size > window:
                    f.seek(size - window)
                    f.readline()  # drop the partial first line
                else:
                    f.seek(0)
                raw = f.read().decode(errors="replace")
        else:
            raw = path.read_text()
    except OSError:
        return []
    lines = raw.split("\n")
    if lines and lines[-1]:
        lines.pop()  # torn tail: the writer is mid-append
    kept = [ln for ln in lines if ln]
    if limit:
        kept = kept[-limit:]
    out: list[dict] = []
    for ln in kept:
        try:
            out.append(json.loads(ln))
        except json.JSONDecodeError:
            continue
    return out


@dataclass
class Record:
    plan: str
    run: str
    group: str
    instance: str
    name: str
    type: str
    ts: float
    value: float
    diagnostic: bool = False
    # telemetry histogram records (sim/telemetry.py): the log2 bucket
    # index this record's count belongs to; None for point samples
    bucket: Optional[int] = None


@dataclass
class Row:
    """One run's aggregated samples for a measurement
    (reference viewer.go Row{Run, Timestamp, Fields})."""

    run: str
    timestamp: float
    fields: dict[str, float] = field(default_factory=dict)  # tag variation -> value
    counts: dict[str, int] = field(default_factory=dict)


class Viewer:
    def __init__(self, outputs_dir: str | Path) -> None:
        self.outputs = Path(outputs_dir)

    # ------------------------------------------------------------ scanning

    def _iter_records(self, plan: str = "") -> Iterator[Record]:
        if not self.outputs.exists():
            return
        for plan_dir in sorted(self.outputs.iterdir()):
            if not plan_dir.is_dir():
                continue
            if plan and plan_dir.name != plan:
                continue
            for run_dir in sorted(plan_dir.iterdir()):
                if not run_dir.is_dir():
                    continue
                yield from self._iter_run(plan_dir.name, run_dir)

    def _iter_run(self, plan: str, run_dir: Path) -> Iterator[Record]:
        # sim:jax: combined <run>/results.out with an `instance` column
        for fname, diag in (("results.out", False), ("diagnostics.out", True)):
            combined = run_dir / fname
            if combined.exists():
                yield from self._parse_file(
                    combined, plan, run_dir.name, group="", instance="", diag=diag
                )
        # sim:jax sweep: <run>/scenario/<s>/results.out — each sweep point
        # is its own pseudo-run ("<run>@s<i>") so grids/seed studies chart
        # as separate series instead of collapsing into one aggregate.
        # The layout marker is ANY sim_summary.json under scenario/ (or a
        # run-root roll-up with scenario rows): once one scenario's summary
        # landed, ALL result-bearing scenario dirs chart as sweep points,
        # even those whose own summary a mid-run kill cut off. A local:exec
        # GROUP that happens to be named "scenario" has no summaries
        # anywhere and falls through to the group scan below — which also
        # catches the degenerate sweep killed before its FIRST summary
        # (records then surface group-labeled rather than vanish).
        scen_root = run_dir / "scenario"
        handled_sweep = False
        if scen_root.is_dir():
            sdirs = sorted(
                (p for p in scen_root.iterdir() if p.is_dir()),
                key=lambda p: (len(p.name), p.name),
            )
            is_sweep = any(
                (p / "sim_summary.json").exists() for p in sdirs
            )
            if not is_sweep and (run_dir / "sim_summary.json").exists():
                try:
                    root = json.loads(
                        (run_dir / "sim_summary.json").read_text()
                    )
                    is_sweep = isinstance(root.get("scenarios"), list)
                except (OSError, json.JSONDecodeError):
                    pass
            if is_sweep:
                handled_sweep = True
                for sdir in sdirs:
                    f = sdir / "results.out"
                    if f.exists():
                        yield from self._parse_file(
                            f, plan, f"{run_dir.name}@s{sdir.name}",
                            group="", instance="", diag=False,
                        )
        # local:exec: <run>/<group>/<instance>/{results,diagnostics}.out
        for group_dir in sorted(
            p
            for p in run_dir.iterdir()
            if p.is_dir()
            and not (p.name == "scenario" and handled_sweep)  # done above
        ):
            for inst_dir in sorted(p for p in group_dir.iterdir() if p.is_dir()):
                for fname, diag in (
                    ("results.out", False),
                    ("diagnostics.out", True),
                ):
                    f = inst_dir / fname
                    if f.exists():
                        yield from self._parse_file(
                            f, plan, run_dir.name,
                            group=group_dir.name, instance=inst_dir.name,
                            diag=diag,
                        )

    def _parse_file(
        self, path: Path, plan: str, run: str, group: str, instance: str,
        diag: bool,
    ) -> Iterator[Record]:
        try:
            lines = path.read_text().splitlines()
        except OSError:
            return
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            name = rec.get("name")
            value = rec.get("value")
            if name is None or not isinstance(value, (int, float)) or isinstance(value, bool):
                continue
            try:
                ts_raw = rec.get("ts", rec.get("virtual_time_s", 0.0))
                bucket = rec.get("bucket")
                record = Record(
                    plan=plan,
                    run=run,
                    group=group or str(rec.get("group", "")),
                    instance=(
                        instance if instance != "" else str(rec.get("instance", ""))
                    ),
                    name=str(name),
                    type=str(rec.get("type", "point")),
                    ts=float(ts_raw if ts_raw is not None else 0.0),
                    value=float(value),
                    diagnostic=diag,
                    bucket=int(bucket) if bucket is not None else None,
                )
            except (TypeError, ValueError):
                continue  # skip malformed lines, like bad JSON above
            yield record

    # ------------------------------------------------------------- queries

    def get_measurements(self, plan: str = "", limit: int = 20) -> list[str]:
        """Series names ``results.<plan>.<metric>`` (viewer.go
        GetMeasurements: `SHOW MEASUREMENTS … =~ /results.<plan>.*/
        LIMIT 20`)."""
        seen: dict[str, None] = {}
        for r in self._iter_records(plan):
            prefix = "diagnostics" if r.diagnostic else "results"
            seen.setdefault(f"{prefix}.{r.plan}.{r.name}")
            if len(seen) >= limit > 0:
                break
        return sorted(seen)

    def _split_series(self, series: str) -> tuple[str, str, bool]:
        parts = series.split(".", 2)
        if len(parts) != 3 or parts[0] not in ("results", "diagnostics"):
            raise ValueError(f"bad series name: {series!r}")
        return parts[1], parts[2], parts[0] == "diagnostics"

    def _series_records(self, series: str) -> Iterator[Record]:
        plan, metric, diag = self._split_series(series)
        for r in self._iter_records(plan):
            if r.name == metric and r.diagnostic == diag:
                yield r

    def get_tags(self, series: str) -> list[str]:
        return ["group_id", "instance", "run"]

    def get_tag_values(self, series: str, tag: str) -> list[str]:
        attr = {"group_id": "group", "instance": "instance", "run": "run"}.get(tag)
        if attr is None:
            return []
        return sorted({getattr(r, attr) for r in self._series_records(series)})

    def get_data(self, series: str, limit: int = 50) -> list[Row]:
        """One Row per run; fields keyed by `group_id=…,instance=…` tag
        variation, value = mean of that variation's samples."""
        rows: dict[str, Row] = {}
        sums: dict[tuple[str, str], float] = {}
        counts: dict[tuple[str, str], int] = {}
        for r in self._series_records(series):
            row = rows.setdefault(r.run, Row(run=r.run, timestamp=r.ts))
            row.timestamp = max(row.timestamp, r.ts)
            variation = f"group_id={r.group},instance={r.instance}"
            key = (r.run, variation)
            sums[key] = sums.get(key, 0.0) + r.value
            counts[key] = counts.get(key, 0) + 1
        for (run, variation), total in sums.items():
            c = counts[(run, variation)]
            rows[run].fields[variation] = total / c
            rows[run].counts[variation] = c
        out = sorted(rows.values(), key=lambda r: r.run, reverse=True)
        return out[:limit] if limit > 0 else out

    def summarize(self, series: str) -> dict[str, dict[str, float]]:
        """Per-run summary stats (count/mean/min/max/p50/p95/p99)
        across all variations — the dashboard's measurement table.
        Histogram series (telemetry ``type: "histogram"`` records)
        aggregate their bucket counts and report bucket-interpolated
        percentiles instead (docs/observability.md)."""
        per_run: dict[str, list[float]] = {}
        hist_run: dict[str, dict[int, float]] = {}
        for r in self._series_records(series):
            if r.type == "histogram" and r.bucket is not None:
                b = hist_run.setdefault(r.run, {})
                b[r.bucket] = b.get(r.bucket, 0.0) + r.value
            else:
                per_run.setdefault(r.run, []).append(r.value)
        out = {run: self._stats(vals) for run, vals in per_run.items()}
        for run, buckets in hist_run.items():
            out[run] = {**out.get(run, {}), **self._hist_stats(buckets)}
        return dict(sorted(out.items(), reverse=True))

    @staticmethod
    def _percentile(sorted_vals: list[float], q: float) -> float:
        """Linear-interpolated percentile of an ascending-sorted list
        (numpy's default method, without the numpy dependency)."""
        if not sorted_vals:
            return 0.0
        pos = (len(sorted_vals) - 1) * q / 100.0
        lo = int(pos)
        hi = min(lo + 1, len(sorted_vals) - 1)
        frac = pos - lo
        return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac

    @classmethod
    def _stats(cls, vals: list[float]) -> dict[str, float]:
        s = sorted(vals)
        return {
            "count": len(vals),
            "mean": sum(vals) / len(vals),
            "min": s[0],
            "max": s[-1],
            "p50": cls._percentile(s, 50),
            "p95": cls._percentile(s, 95),
            "p99": cls._percentile(s, 99),
        }

    @staticmethod
    def _hist_stats(buckets: dict[int, float]) -> dict[str, float]:
        """Summary stats from log2 bucket counts (sim/telemetry.py
        ``bucket_of``: bucket 0 covers [0, 2), bucket b covers
        [2^b, 2^(b+1))): percentiles interpolate linearly WITHIN the
        crossing bucket's value range — exact to a bucket's width, the
        standard histogram-percentile estimate."""

        def bounds(b: int) -> tuple[float, float]:
            lo = 0.0 if b == 0 else float(2**b)
            return lo, float(2 ** (b + 1))

        total = sum(buckets.values())
        if total <= 0:
            return {"count": 0, "mean": 0.0, "min": 0.0, "max": 0.0,
                    "p50": 0.0, "p95": 0.0, "p99": 0.0}
        items = sorted(buckets.items())
        mean = sum(
            c * (bounds(b)[0] + bounds(b)[1]) / 2.0 for b, c in items
        ) / total

        def pct(q: float) -> float:
            target = total * q / 100.0
            cum = 0.0
            for b, c in items:
                if c <= 0:
                    continue
                if cum + c >= target:
                    lo, hi = bounds(b)
                    frac = (target - cum) / c
                    return lo + (hi - lo) * frac
                cum += c
            return bounds(items[-1][0])[1]

        return {
            "count": total,
            "mean": mean,
            "min": bounds(items[0][0])[0],
            "max": bounds(items[-1][0])[1],
            "p50": pct(50),
            "p95": pct(95),
            "p99": pct(99),
        }

    # --------------------------------------------------------- time-series

    def timeseries(
        self, series: str, limit: int = 50
    ) -> dict[str, list[tuple[float, float]]]:
        """Per-run time-series ``[(ts, value), ...]`` ordered by
        timestamp, values at the same instant averaged across tag
        variations (lanes) — the dashboard's sparkline source. The
        telemetry plane's sampled probes chart here (one point per
        sample boundary); point-event metrics with a single timestamp
        collapse to one point. Histogram records are end-of-run
        snapshots and are excluded."""
        acc: dict[str, dict[float, tuple[float, int]]] = {}
        for r in self._series_records(series):
            if r.type == "histogram":
                continue
            by_ts = acc.setdefault(r.run, {})
            s, c = by_ts.get(r.ts, (0.0, 0))
            by_ts[r.ts] = (s + r.value, c + 1)
        out: dict[str, list[tuple[float, float]]] = {}
        for run in sorted(acc, reverse=True)[: limit if limit > 0 else None]:
            out[run] = sorted(
                (ts, s / c) for ts, (s, c) in acc[run].items()
            )
        return out

    def measurements_all(
        self, plan: str = "", limit: int = 20
    ) -> dict[str, dict[str, dict]]:
        """``{series: {run: {"stats": ..., "points": [(ts, value)]}}}``
        in ONE scan of the outputs tree — the measurements page's single
        query: summary stats (count/mean/min/max/p50/p95/p99) and the
        sparkline time-series come from the same record pass, under one
        series limit, so the stats table and its chart column can never
        disagree about which series exist. Histogram series (telemetry
        ``type: "histogram"`` records) report bucket-interpolated stats
        and no points (they are end-of-run snapshots, not series);
        values at the same instant average across tag variations."""
        vals: dict[str, dict[str, list[float]]] = {}
        hist: dict[str, dict[str, dict[int, float]]] = {}
        pts: dict[str, dict[str, dict[float, tuple[float, int]]]] = {}
        for r in self._iter_records(plan):
            prefix = "diagnostics" if r.diagnostic else "results"
            series = f"{prefix}.{r.plan}.{r.name}"
            if (
                series not in vals
                and series not in hist
                and len(vals) + len(hist) >= limit > 0
            ):
                continue
            if r.type == "histogram" and r.bucket is not None:
                b = hist.setdefault(series, {}).setdefault(r.run, {})
                b[r.bucket] = b.get(r.bucket, 0.0) + r.value
            else:
                vals.setdefault(series, {}).setdefault(r.run, []).append(
                    r.value
                )
                by_ts = pts.setdefault(series, {}).setdefault(r.run, {})
                s, c = by_ts.get(r.ts, (0.0, 0))
                by_ts[r.ts] = (s + r.value, c + 1)
        out: dict[str, dict[str, dict]] = {}
        for series, runs in vals.items():
            out[series] = {
                run: {
                    "stats": self._stats(v),
                    "points": sorted(
                        (ts, s / c)
                        for ts, (s, c) in pts[series][run].items()
                    ),
                }
                for run, v in sorted(runs.items(), reverse=True)
            }
        for series, runs in hist.items():
            tgt = out.setdefault(series, {})
            for run, buckets in sorted(runs.items(), reverse=True):
                row = tgt.setdefault(run, {"stats": {}, "points": []})
                row["stats"] = {**row["stats"], **self._hist_stats(buckets)}
        return dict(sorted(out.items()))

    # robustness counters a fault run is triaged by, with their journal
    # defaults — surfaced per run/per sweep scenario so chaos runs are
    # read off the dashboard instead of grepping per-scenario journals
    _ROBUSTNESS_KEYS = (
        "crashed_count", "stalled_count", "restarted_count",
        "net_dropped", "net_horizon_clamped", "stream_violations",
        "metrics_dropped", "ticks_executed",
        # trace plane (docs/observability.md): recorded events and
        # ring-overflow losses per run / per sweep scenario — a nonzero
        # trace_dropped means the trace.json timeline is incomplete
        # (raise [trace] capacity)
        "trace_events", "trace_dropped",
        # telemetry plane: sample boundaries recorded and boundaries
        # lost to a full buffer — a nonzero telemetry_clipped means the
        # tail of the time-series is missing (raise [telemetry]
        # interval)
        "telemetry_samples", "telemetry_clipped",
    )

    # the PR 18 per-stage compile split (journal ``compile_breakdown``:
    # python trace / StableHLO lower / XLA backend) — surfaced beside
    # the robustness counters so compile regressions triage from the
    # same table; None (cache hits skip the fresh compile) renders 0
    _COMPILE_KEYS = ("trace_seconds", "lower_seconds", "backend_seconds")

    def summarize_search(
        self, plan: str = "", limit: int = 50
    ) -> dict[str, dict]:
        """Per-run breaking-point search results from
        ``sim_summary.json`` (runs whose journal carries
        ``search_rounds``): the strategy/param, rounds walked, scenarios
        probed vs the exhaustive grid, compiles paid, the located
        ``breaking_point`` and the probed ``frontier`` — the dashboard's
        search page (docs/search.md). Rows sort newest-run-first."""
        rows: dict[str, dict] = {}
        if not self.outputs.exists():
            return rows
        for plan_dir in sorted(self.outputs.iterdir()):
            if not plan_dir.is_dir() or (plan and plan_dir.name != plan):
                continue
            for run_dir in sorted(plan_dir.iterdir(), reverse=True):
                summary = run_dir / "sim_summary.json"
                if not run_dir.is_dir() or not summary.exists():
                    continue
                try:
                    root = json.loads(summary.read_text())
                except (OSError, json.JSONDecodeError):
                    continue
                rounds = root.get("search_rounds")
                if not isinstance(rounds, list):
                    continue
                spec = root.get("search") or {}
                rows[run_dir.name] = {
                    "outcome": str(root.get("outcome", "unknown")),
                    "strategy": str(spec.get("strategy", "")),
                    "param": str(spec.get("param", "")),
                    "rounds": len(rounds),
                    "scenarios_probed": int(
                        root.get("scenarios_probed", 0) or 0
                    ),
                    "grid_size": int(root.get("grid_size", 0) or 0),
                    "exhaustive_scenarios": int(
                        root.get("exhaustive_scenarios", 0) or 0
                    ),
                    "compiles": int(root.get("compiles", 0) or 0),
                    "breaking_point": root.get("breaking_point") or {},
                    "frontier": root.get("frontier") or [],
                    "search_rounds": rounds,
                }
                if limit > 0 and len(rows) >= limit:
                    return rows
        return rows

    def progress_history(
        self, plan: str, run: str, limit: int = 0
    ) -> list[dict]:
        """One run's live-plane snapshots (``progress.jsonl`` — the
        chunk-boundary stream sim/live.py writes), oldest first; the
        last ``limit`` when set. Empty for runs that never streamed
        (live disabled, non-sim runners). The /live dashboard's
        sparklines and progress bars read from here."""
        run_dir = self.outputs / plan / run
        if not run_dir.is_dir():
            return []
        return read_progress(run_dir, limit=limit)

    def summarize_robustness(
        self, plan: str = "", limit: int = 50
    ) -> dict[str, dict]:
        """Per-run robustness counters from ``sim_summary.json`` —
        crashed / stalled / restarted instance totals, inbox drops
        (``net_dropped``), horizon clamps, stream violations and metric
        drops, plus the outcome, the realized fault-event count and the
        event-horizon accounting (``ticks_executed`` + ``skip_ratio``; a
        surprising 1.0 ratio on a skip-enabled run flags a plan that
        never sleeps — docs/perf.md). Sweep runs expand to one row per
        scenario (``<run>@s<i>``), like the metrics charts. Rows sort
        newest-run-first."""
        rows: dict[str, dict] = {}
        if not self.outputs.exists():
            return rows

        def counters(d: dict, *, faults_key: bool = True) -> dict:
            out = {k: int(d.get(k, 0) or 0) for k in self._ROBUSTNESS_KEYS}
            out["outcome"] = str(d.get("outcome", "unknown"))
            sr = d.get("skip_ratio")
            if sr is not None:
                out["skip_ratio"] = float(sr)
            breakdown = d.get("compile_breakdown")
            if not isinstance(breakdown, dict):
                breakdown = {}
            for k in self._COMPILE_KEYS:
                out[k] = float(breakdown.get(k, 0.0) or 0.0)
            if faults_key:
                f = d.get("faults")
                out["fault_events"] = len(f) if isinstance(f, list) else 0
            return out

        for plan_dir in sorted(self.outputs.iterdir()):
            if not plan_dir.is_dir() or (plan and plan_dir.name != plan):
                continue
            for run_dir in sorted(plan_dir.iterdir(), reverse=True):
                summary = run_dir / "sim_summary.json"
                if not run_dir.is_dir() or not summary.exists():
                    continue
                try:
                    root = json.loads(summary.read_text())
                except (OSError, json.JSONDecodeError):
                    continue
                scen = root.get("scenarios")
                if isinstance(scen, list):
                    # sweep roll-up: one row per scenario, keyed like the
                    # chart series ("<run>@s<i>")
                    for srow in scen:
                        if not isinstance(srow, dict):
                            continue
                        key = f"{run_dir.name}@s{srow.get('scenario')}"
                        rows[key] = counters(srow)
                else:
                    rows[run_dir.name] = counters(root)
                if limit > 0 and len(rows) >= limit:
                    return rows
        return rows

