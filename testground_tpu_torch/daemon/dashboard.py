"""HTML task dashboard (a copy of ``testground_tpu/daemon/dashboard.py``,
named for the port; reference pkg/daemon/dashboard.go:23-80 +
tmpl/tasks.html). Server-rendered, zero static assets."""

from __future__ import annotations

import html
import json
import time

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>testground-tpu-torch dashboard</title>
<style>
 body {{ font-family: system-ui, sans-serif; margin: 2rem; color: #1a1a1a; }}
 table {{ border-collapse: collapse; width: 100%; }}
 th, td {{ text-align: left; padding: .4rem .8rem; border-bottom: 1px solid #ddd;
          font-size: .9rem; }}
 th {{ background: #f5f5f5; }}
 .success {{ color: #0a7d33; }} .failure {{ color: #b00020; }}
 .canceled {{ color: #8a6d00; }} .unknown {{ color: #666; }}
 .preempted {{ color: #8a4500; }} .terminated {{ color: #8a6d00; }}
 code {{ background: #f0f0f0; padding: .1rem .3rem; border-radius: 3px; }}
</style></head>
<body>
<h1>testground-tpu-torch</h1>
<p>{nrunners} runners &middot; {nbuilders} builders &middot; {ntasks} tasks</p>
<table>
<tr><th>task</th><th>type</th><th>plan/case</th><th>state</th>
<th>outcome</th><th>retries</th><th>created</th></tr>
{rows}
</table>
{cache}
</body></html>
"""

_ROW = (
    "<tr><td><code>{id}</code></td><td>{type}</td><td>{plan}/{case}</td>"
    '<td>{state}</td><td class="{outcome}">{outcome}</td>'
    "<td>{retries}</td><td>{created}</td></tr>"
)


def _retries_cell(t) -> str:
    """Retry/durability accounting for one task row: attempt count,
    the active backoff (the wedged-dispatch requeue path), and a
    [wedged] badge when the state history records one."""
    parts = []
    if getattr(t, "attempts", 0):
        cell = f"{t.attempts}"
        remaining = (getattr(t, "backoff_until", 0.0) or 0.0) - time.time()
        if remaining > 0:
            cell += f" (backoff {remaining:.0f}s)"
        elif getattr(t, "last_backoff_s", 0.0):
            cell += f" (backoff {t.last_backoff_s:.0f}s)"
        parts.append(cell)
    if any(s.state == "wedged" for s in t.states):
        parts.append('<span class="failure">wedged</span>')
    return " ".join(parts) or "&mdash;"

# ---- executor cache section (the serving plane's warm-start tier:
# sim/excache.py disk entries + the in-memory pool's hit-rate counters,
# the HTML face of GET /cache) ---------------------------------------------

_CACHE_SECTION = """
<h2>executor cache</h2>
<p>{summary}</p>
<table>
<tr><th>entry</th><th>kind</th><th>plan/case</th><th>size</th>
<th>age</th><th>hits</th></tr>
{rows}
</table>
"""

_CACHE_ROW = (
    "<tr><td><code>{id}</code></td><td>{kind}</td><td>{plan}/{case}</td>"
    "<td>{size}</td><td>{age}</td><td>{hits}</td></tr>"
)


def _fmt_size(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.0f} {unit}" if unit == "B" else f"{n:.1f} {unit}"
        n /= 1024.0
    return f"{n} B"


def _fmt_age(s: float) -> str:
    if s < 120:
        return f"{s:.0f}s"
    if s < 7200:
        return f"{s / 60:.0f}m"
    if s < 172800:
        return f"{s / 3600:.1f}h"
    return f"{s / 86400:.1f}d"


def _hit_rate(hits: int, misses: int) -> str:
    total = hits + misses
    return f"{100.0 * hits / total:.0f}%" if total else "&ndash;"


def render_cache_section(engine) -> str:
    """The dashboard's executor-cache table. Best-effort: a cache-tier
    hiccup must never 500 the task dashboard."""
    try:
        info = engine.executor_cache_info()
    except Exception:  # noqa: BLE001 — observability only
        return ""
    if not info.get("enabled") and not info.get("entries"):
        return _CACHE_SECTION.format(
            summary="disk tier disabled (TG_EXECUTOR_CACHE_DIR=off)",
            rows="",
        )
    disk = info.get("disk", {})
    parts = [
        f"disk: {len(info.get('entries', []))} entries at "
        f"<code>{html.escape(info.get('dir', ''))}</code>, "
        f"hit rate {_hit_rate(disk.get('disk_hits', 0), disk.get('disk_misses', 0))} "
        f"({disk.get('disk_hits', 0)} hits / "
        f"{disk.get('disk_misses', 0)} misses / "
        f"{disk.get('stores', 0)} stores)"
    ]
    mem = info.get("memory")
    if mem:
        parts.append(
            f"memory pool: {mem.get('pooled_executors', 0)} executors over "
            f"{mem.get('keys', 0)} keys (depth {mem.get('pool_depth', 0)}), "
            f"hit rate {_hit_rate(mem.get('memory_hits', 0), mem.get('misses', 0))}"
        )
    leases = info.get("leases")
    if leases:
        parts.append(f"{len(leases)} live device lease(s)")
    rows = "\n".join(
        _CACHE_ROW.format(
            id=html.escape(e["id"][:12]),
            kind=html.escape(str(e.get("kind", "?"))),
            plan=html.escape(str(e.get("plan", ""))),
            case=html.escape(str(e.get("case", ""))),
            size=_fmt_size(int(e.get("size_bytes", 0))),
            age=_fmt_age(float(e.get("age_seconds", 0))),
            hits=int(e.get("hits", 0)),
        )
        for e in info.get("entries", [])[:50]
    )
    return _CACHE_SECTION.format(
        summary=" &middot; ".join(parts), rows=rows
    )


# ---- fleet page (the federation plane's ops surface: per-worker
# heartbeat age, lease headroom, warm cache keys, routed tasks — the
# HTML face of GET /federation; docs/federation.md) -----------------------

_FLEET_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>testground-tpu-torch fleet</title>
<meta http-equiv="refresh" content="5">
<style>
 body {{ font-family: system-ui, sans-serif; margin: 2rem; color: #1a1a1a; }}
 table {{ border-collapse: collapse; width: 100%; margin-bottom: 1.5rem; }}
 th, td {{ text-align: left; padding: .4rem .8rem;
          border-bottom: 1px solid #ddd; font-size: .9rem; }}
 th {{ background: #f5f5f5; }}
 .success {{ color: #0a7d33; }} .failure {{ color: #b00020; }}
 .unknown {{ color: #666; }}
 td.spark {{ padding: .15rem .8rem; }} .nochart {{ color: #888; }}
 code {{ background: #f0f0f0; padding: .1rem .3rem; border-radius: 3px; }}
</style></head>
<body>
<h1>fleet</h1>
<p>{summary}</p>
<h2>workers</h2>
<table>
<tr><th>worker</th><th>alive</th><th>heartbeat age</th><th>queue</th>
<th>lease headroom</th><th>warm keys</th><th>routed tasks</th></tr>
{workers}
</table>
<h2>routed tasks</h2>
<table>
<tr><th>task</th><th>kind</th><th>worker</th><th>plan/case</th>
<th>state</th><th>outcome</th><th>attempts</th></tr>
{routes}
</table>
<h2>fleet metrics</h2>
<p>process totals from <a href="/metrics"><code>GET /metrics</code></a>
(Prometheus text exposition; a coordinator's scrape additionally merges
every worker's families under <code>worker=</code> labels —
docs/observability.md)</p>
<table>
<tr><th>family</th><th>total</th><th>trend</th></tr>
{metrics}
</table>
</body></html>
"""

# headline families on the /fleet metrics table — one row per family,
# process-total + a sparkline over the obs history ring (sampled at
# every /metrics scrape and /fleet render)
_FLEET_METRIC_FAMILIES = (
    "tg_tasks_queue_depth",
    "tg_task_transitions_total",
    "tg_task_retries_total",
    "tg_watchdog_fires_total",
    "tg_excache_ops_total",
    "tg_lease_active_runs",
    "tg_run_chunk_seconds",
    "tg_fed_routes_total",
    "tg_fed_requeues_total",
    "tg_fed_heartbeats_total",
)


def render_fleet_metrics() -> str:
    """The /fleet page's metrics rows: for each headline family the
    summed current value (histograms report their observation count)
    and a sparkline over the registry's history ring — the same
    renderer the live page's per-run charts use."""
    from .. import obs

    obs.REGISTRY.sample_history()
    fams = obs.parse_exposition(obs.render())
    rows = []
    for name in _FLEET_METRIC_FAMILIES:
        fam = fams.get(name)
        total = sum(
            v
            for sname, _, v in (fam or {}).get("samples", ())
            if sname in (name, f"{name}_count")
        )
        pts = obs.REGISTRY.history(name)
        rows.append(
            f"<tr><td><code>{html.escape(name)}</code></td>"
            f"<td>{total:g}</td>"
            f'<td class="spark">{_sparkline_svg(pts)}</td></tr>'
        )
    return "\n".join(rows)

_FLEET_WORKER_ROW = (
    "<tr><td><code>{worker}</code></td>"
    '<td class="{alive_cls}">{alive}</td><td>{age}</td><td>{queue}</td>'
    "<td>{headroom}</td><td>{keys}</td><td>{routed}</td></tr>"
)

_FLEET_ROUTE_ROW = (
    "<tr><td><code>{id}</code></td><td>{kind}</td>"
    "<td><code>{worker}</code></td><td>{plan}/{case}</td><td>{state}</td>"
    '<td class="{outcome}">{outcome}</td><td>{attempts}</td></tr>'
)


def render_fleet(info: dict) -> str:
    role = info.get("role", "standalone")
    if role == "coordinator":
        summary = (
            f"coordinator of {len(info.get('peers', []))} peer(s) "
            f"&middot; heartbeat every "
            f"{info.get('heartbeat_interval_s', 0):g}s, stale after "
            f"{info.get('stale_after_s', 0):g}s"
        )
    elif role == "worker":
        enr = info.get("enrolled", {})
        summary = (
            "worker enrolled with coordinator "
            f"<code>{html.escape(str(enr.get('coordinator', '')))}</code> "
            f"({enr.get('heartbeats_sent', 0)} heartbeats sent)"
        )
    else:
        summary = (
            "standalone daemon — no [daemon] peers configured "
            "(see docs/federation.md for the two-daemon quickstart)"
        )
    workers = "\n".join(
        _FLEET_WORKER_ROW.format(
            worker=html.escape(w.get("worker", "")),
            alive_cls="success" if w.get("alive") else "failure",
            alive="yes" if w.get("alive") else "LOST",
            age=_fmt_age(float(w.get("heartbeat_age_s", 0.0))),
            queue=int(w.get("queue_depth", 0)),
            headroom=(
                _fmt_size(int((w.get("lease") or {}).get("free_bytes")))
                if (w.get("lease") or {}).get("free_bytes") is not None
                else "&ndash;"
            ),
            keys=len(w.get("cache_keys", [])),
            routed=int(w.get("routed_tasks", 0)),
        )
        for w in info.get("workers", [])
    )
    routes = "\n".join(
        _FLEET_ROUTE_ROW.format(
            id=html.escape(str(r.get("task_id", ""))[:12]),
            kind=html.escape(str(r.get("kind", "run"))),
            worker=html.escape(str(r.get("worker", ""))),
            plan=html.escape(str(r.get("plan", ""))),
            case=html.escape(str(r.get("case", ""))),
            state=html.escape(str(r.get("state", ""))),
            outcome=html.escape(str(r.get("outcome", "unknown"))),
            attempts=int(r.get("attempts", 0)),
        )
        for r in info.get("routes", [])
    )
    return _FLEET_PAGE.format(
        summary=summary, workers=workers, routes=routes,
        metrics=render_fleet_metrics(),
    )


def render_dashboard(engine, query: dict) -> str:
    try:
        limit = int(query.get("limit", 50))
    except ValueError:
        limit = 50
    tasks = engine.tasks(limit=limit)
    rows = "\n".join(
        _ROW.format(
            id=html.escape(t.id),
            type=html.escape(t.type),
            plan=html.escape(t.plan),
            case=html.escape(t.case),
            state=html.escape(t.state),
            outcome=html.escape(t.outcome),
            retries=_retries_cell(t),
            created=time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(t.created)),
        )
        for t in tasks
    )
    return _PAGE.format(
        nrunners=len(engine.runners),
        nbuilders=len(engine.builders),
        ntasks=len(tasks),
        rows=rows,
        cache=render_cache_section(engine),
    )


# ---- live page (the live run plane, sim/live.py: chunk-boundary
# snapshots streamed to progress.jsonl + the task store — rendered here
# as per-task progress bars and sparklines so a long sweep or a
# multi-round search is watchable mid-run; auto-refreshes) ------------------

_LIVE_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>live runs</title>
<meta http-equiv="refresh" content="2">
<style>
 body {{ font-family: system-ui, sans-serif; margin: 2rem; color: #1a1a1a; }}
 table {{ border-collapse: collapse; width: 100%; }}
 th, td {{ text-align: left; padding: .35rem .7rem;
          border-bottom: 1px solid #ddd; font-size: .85rem; }}
 th {{ background: #f5f5f5; }}
 code {{ background: #f0f0f0; padding: .1rem .3rem; border-radius: 3px; }}
 .bar {{ width: 160px; height: 12px; background: #eee; border-radius: 3px;
        overflow: hidden; display: inline-block; vertical-align: middle; }}
 .bar > div {{ height: 100%; background: #2a78d6; }}
 .bar.done > div {{ background: #0a7d33; }}
 .bar.fail > div {{ background: #b00020; }}
 td.spark {{ padding: .15rem .7rem; }} .nochart {{ color: #888; }}
 .pct {{ font-size: .75rem; color: #555; padding-left: .4rem; }}
 .phase {{ color: #555; }}
 .loss {{ color: #b00020; font-size: .75rem; font-weight: 600; }}
</style></head>
<body>
<h1>live runs</h1>
<p>{nprocessing} processing &middot; {ntasks} shown &middot;
auto-refreshes every 2s</p>
<table>
<tr><th>task</th><th>plan/case</th><th>state</th><th>kind</th>
<th>phase</th><th>progress</th><th>running</th><th>scenarios</th>
<th>round</th><th>skip ratio</th><th>lanes</th>
<th>trace events</th><th>telemetry samples</th><th>attempts</th></tr>
{rows}
</table>
</body></html>
"""


def _progress_bar(frac, state: str, outcome: str) -> str:
    if frac is None:
        return '<span class="nochart">&mdash;</span>'
    frac = min(1.0, max(0.0, float(frac)))
    cls = "bar"
    if state == "complete":
        cls += " done" if outcome == "success" else " fail"
    return (
        f'<span class="{cls}"><div style="width:{frac * 100:.1f}%">'
        f'</div></span><span class="pct">{frac * 100:.0f}%</span>'
    )


def render_live(engine, viewer, query: dict) -> str:
    try:
        limit = int(query.get("limit", 25))
    except ValueError:
        limit = 25
    # processing runs first (they are what one watches), then recent
    tasks = [t for t in engine.tasks(limit=200) if t.type == "run"]
    tasks.sort(key=lambda t: (t.state != "processing", -t.created))
    tasks = tasks[:limit]
    rows = []
    for t in tasks:
        history = viewer.progress_history(t.plan, t.id, limit=400)
        snap = t.progress or (history[-1] if history else None) or {}
        frac = None
        if snap.get("phase") == "done" or t.state == "complete":
            frac = 1.0 if snap else None
        elif snap.get("progress") is not None:
            # the snapshot's own global fraction (folds a sweep's
            # scenario-chunk position in — tick alone runs backwards
            # across HBM chunks)
            frac = snap["progress"]
        elif snap.get("tick") is not None and snap.get("max_ticks"):
            frac = snap["tick"] / snap["max_ticks"]
        scen = snap.get("scenarios") or {}
        scen_txt = (
            f"{scen.get('done', 0)}/{scen.get('total', 0)} done"
            if scen
            else "&mdash;"
        )
        rnd = snap.get("round")
        rounds = snap.get("rounds")
        rnd_txt = (
            f"{rnd}" + (f" ({rounds} total)" if rounds else "")
            if rnd is not None
            else "&mdash;"
        )
        sr = snap.get("skip_ratio")
        spark_run = _sparkline_svg(
            [
                (s.get("wall_s", 0.0), s.get("running", 0))
                for s in history
                if "running" in s
            ]
        )
        spark_skip = _sparkline_svg(
            [
                (s.get("wall_s", 0.0), s["skip_ratio"])
                for s in history
                if "skip_ratio" in s
            ]
        )
        sr_txt = f"{sr:.3f} {spark_skip}" if sr is not None else "&mdash;"
        kind = snap.get("kind")
        phase = snap.get("phase")
        running = snap.get("running")
        # cumulative observer counters (sim/live.py stamps them on every
        # snapshot; on drained runs they are the drain plane's host
        # watermarks): overflow is visible WHILE the run executes, not
        # only in the final sim_summary.json — sparklines fill in as
        # batches land
        ev_txt = _observer_cell(
            snap, history, "trace_events", "trace_dropped", "dropped",
        )
        sm_txt = _observer_cell(
            snap, history, "telemetry_samples", "telemetry_clipped",
            "clipped",
        )
        # durability accounting: the wedged-retry attempt counter with
        # its backoff, and a preempted/wedged badge so an interrupted
        # run is distinguishable from a merely-finished one at a glance
        att_txt = _retries_cell(t)
        state_txt = html.escape(t.state)
        if t.outcome == "preempted":
            state_txt += ' <span class="loss">preempted</span>'
        rows.append(
            f"<tr><td><code>{html.escape(t.id)}</code></td>"
            f"<td>{html.escape(t.plan)}/{html.escape(t.case)}</td>"
            f"<td>{state_txt}</td>"
            f"<td>{html.escape(kind) if kind else '&mdash;'}</td>"
            f'<td class="phase">'
            f"{html.escape(phase) if phase else '&mdash;'}</td>"
            f"<td>{_progress_bar(frac, t.state, t.outcome)}</td>"
            f"<td>{running if running is not None else '&mdash;'}</td>"
            f"<td>{scen_txt}</td>"
            f"<td>{rnd_txt}</td>"
            f'<td class="spark">{sr_txt}</td>'
            f'<td class="spark">{spark_run}</td>'
            f'<td class="spark">{ev_txt}</td>'
            f'<td class="spark">{sm_txt}</td>'
            f"<td>{att_txt}</td></tr>"
        )
    return _LIVE_PAGE.format(
        nprocessing=sum(1 for t in tasks if t.state == "processing"),
        ntasks=len(tasks),
        rows="\n".join(rows)
        or '<tr><td colspan="14">no run tasks yet</td></tr>',
    )


def _observer_cell(
    snap: dict, history: list, key: str, loss_key: str, loss_word: str
) -> str:
    """One observer-plane cell: the cumulative count, a red loss badge
    when the honesty counter is nonzero, and a mid-run sparkline of the
    count's growth across snapshots."""
    val = snap.get(key)
    if val is None:
        return '<span class="nochart">&mdash;</span>'
    spark = _sparkline_svg(
        [
            (s.get("wall_s", 0.0), s[key])
            for s in history
            if key in s
        ]
    )
    lost = snap.get(loss_key) or 0
    badge = (
        f' <span class="loss">{lost} {loss_word}</span>' if lost else ""
    )
    return f"{val}{badge} {spark}"


# ---- measurements page (reference daemon/dashboard.go measurements view +
# tmpl/measurements.html, backed by pkg/metrics Viewer Influx queries; ours
# reads the outputs tree) ---------------------------------------------------

_MEASUREMENTS_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>measurements</title>
<style>
 body {{ font-family: system-ui, sans-serif; margin: 2rem; color: #1a1a1a; }}
 table {{ border-collapse: collapse; margin-bottom: 1.6rem; }}
 th, td {{ text-align: left; padding: .3rem .7rem; border-bottom: 1px solid #ddd;
          font-size: .85rem; }}
 th {{ background: #f5f5f5; }}
 h2 {{ margin-top: 1.6rem; font-size: 1rem; }} code {{ background: #f0f0f0; }}
 td.spark {{ padding: .15rem .7rem; }} .nochart {{ color: #888; }}
</style></head>
<body>
<h1>measurements{for_plan}</h1>
{sections}
</body></html>
"""

# one series per sparkline (the run column names it); hue = a validated
# single-series chart color, 2px stroke, recessive — the cell is a trend
# glance, the stats columns beside it carry the numbers
_SPARK_W, _SPARK_H, _SPARK_PAD = 140, 26, 2
_SPARK_STROKE = "#2a78d6"


def _sparkline_svg(points: list) -> str:
    """Inline-SVG sparkline for one run's ``[(ts, value), ...]``
    time-series (viewer.measurements_all). Fewer than two points is not
    a trend — render the explicit empty-series fallback instead of a
    degenerate dot."""
    if len(points) < 2:
        return '<span class="nochart">&mdash;</span>'
    xs = [float(p[0]) for p in points]
    ys = [float(p[1]) for p in points]
    x0, y0 = min(xs), min(ys)
    xr = (max(xs) - x0) or 1.0
    yr = (max(ys) - y0) or 1.0
    w = _SPARK_W - 2 * _SPARK_PAD
    h = _SPARK_H - 2 * _SPARK_PAD
    pts = " ".join(
        f"{_SPARK_PAD + (x - x0) / xr * w:.1f},"
        f"{_SPARK_H - _SPARK_PAD - (y - y0) / yr * h:.1f}"
        for x, y in zip(xs, ys)
    )
    label = (
        f"{len(points)} samples, {min(ys):.6g}&#8211;{max(ys):.6g}, "
        f"last {ys[-1]:.6g}"
    )
    return (
        f'<svg width="{_SPARK_W}" height="{_SPARK_H}" '
        f'viewBox="0 0 {_SPARK_W} {_SPARK_H}" role="img" '
        f'aria-label="{label}"><title>{label}</title>'
        f'<polyline fill="none" stroke="{_SPARK_STROKE}" '
        f'stroke-width="2" stroke-linejoin="round" '
        f'stroke-linecap="round" points="{pts}"/></svg>'
    )


def render_measurements(viewer, query: dict) -> str:
    plan = query.get("plan", "")
    sections = []
    # ONE outputs-tree scan: summary stats and the sparkline time-series
    # come from the same query (the telemetry plane's sampled probes
    # chart here; single-timestamp point metrics and histogram
    # snapshots fall back to the em-dash)
    for series, runs in viewer.measurements_all(plan).items():
        rows = [
            "<tr><th>run</th><th>chart</th><th>count</th><th>mean</th>"
            "<th>min</th><th>max</th><th>p50</th><th>p95</th>"
            "<th>p99</th></tr>"
        ]
        for run, row in runs.items():
            s = row["stats"]
            spark = _sparkline_svg(row["points"])
            rows.append(
                f"<tr><td><code>{html.escape(run)}</code></td>"
                f'<td class="spark">{spark}</td>'
                f"<td>{s['count']}</td><td>{s['mean']:.6g}</td>"
                f"<td>{s['min']:.6g}</td><td>{s['max']:.6g}</td>"
                f"<td>{s.get('p50', 0.0):.6g}</td>"
                f"<td>{s.get('p95', 0.0):.6g}</td>"
                f"<td>{s.get('p99', 0.0):.6g}</td></tr>"
            )
        sections.append(
            f"<h2><code>{html.escape(series)}</code></h2>"
            f"<table>{''.join(rows)}</table>"
        )
    # robustness counters per run / per sweep scenario: fault runs are
    # triaged from this table (crashed/stalled/restarted totals, inbox
    # drops, clamps) instead of grepping per-scenario journals
    robust = viewer.summarize_robustness(plan)
    if robust:
        # column set derives from the viewer's counter list: a counter
        # added there shows up here without a second edit
        cols = ("outcome", "fault_events") + tuple(
            viewer._ROBUSTNESS_KEYS
        ) + ("skip_ratio",) + tuple(viewer._COMPILE_KEYS)
        rrows = [
            "<tr><th>run</th>"
            + "".join(f"<th>{c.replace('_', ' ')}</th>" for c in cols)
            + "</tr>"
        ]
        for run, s in robust.items():
            rrows.append(
                f"<tr><td><code>{html.escape(run)}</code></td>"
                + "".join(f"<td>{html.escape(str(s.get(c, 0)))}</td>"
                          for c in cols)
                + "</tr>"
            )
        sections.append(
            "<h2>robustness (per run / sweep scenario)</h2>"
            f"<table>{''.join(rrows)}</table>"
        )
    return _MEASUREMENTS_PAGE.format(
        for_plan=f" — {html.escape(plan)}" if plan else "",
        sections="\n".join(sections) or "<p>no measurements recorded yet</p>",
    )


# ---- search page (closed-loop breaking-point searches, docs/search.md:
# per run the strategy header, the located breaking point, the probed
# frontier, and each round's probes/bracket) --------------------------------

_SEARCH_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>breaking-point searches</title>
<style>
 body {{ font-family: system-ui, sans-serif; margin: 2rem; color: #1a1a1a; }}
 table {{ border-collapse: collapse; margin-bottom: 1.2rem; }}
 th, td {{ text-align: left; padding: .3rem .7rem; border-bottom: 1px solid #ddd;
          font-size: .85rem; }}
 th {{ background: #f5f5f5; }}
 h2 {{ margin-top: 1.6rem; font-size: 1rem; }} code {{ background: #f0f0f0; }}
 .fail {{ color: #b00020; font-weight: 600; }} .pass {{ color: #0a7d33; }}
 .verdict {{ background: #f7f7f7; border-left: 3px solid #2a78d6;
            padding: .5rem .8rem; margin: .5rem 0 1rem; font-size: .9rem; }}
</style></head>
<body>
<h1>breaking-point searches{for_plan}</h1>
{sections}
</body></html>
"""


def _verdict_line(bp: dict) -> str:
    """The one-sentence robustness verdict a search exists to produce."""
    if not bp:
        return "no verdict recorded"
    parts = []
    if bp.get("survives"):
        parts.append("survives the whole probed range")
    if bp.get("first_failing") is not None:
        parts.append(f"first fails at <b>{html.escape(str(bp['first_failing']))}</b>")
    if bp.get("last_passing") is not None:
        parts.append(f"survives &le; <b>{html.escape(str(bp['last_passing']))}</b>")
    if bp.get("winner") is not None:
        parts.append(
            f"winner <b>{html.escape(str(bp['winner']))}</b> "
            f"(objective {html.escape(str(bp.get('objective')))})"
        )
    if bp.get("first_failing_observed") is not None:
        parts.append(
            "first failing observed at "
            f"<b>{html.escape(str(bp['first_failing_observed']))}</b>"
        )
    if bp.get("coverage") is not None:
        parts.append(f"coverage {bp['coverage']:.0%}")
    if bp.get("non_monotone"):
        parts.append("&#9888; non-monotone outcomes")
    if not bp.get("resolved"):
        parts.append(
            "UNRESOLVED"
            + (f" (stopped: {html.escape(str(bp.get('stopped')))})"
               if bp.get("stopped") else "")
        )
    return ", ".join(parts) or html.escape(str(bp))


def render_search(viewer, query: dict) -> str:
    plan = query.get("plan", "")
    sections = []
    for run, s in viewer.summarize_search(plan).items():
        bp = s["breaking_point"]
        head = (
            f"<h2><code>{html.escape(run)}</code> &middot; "
            f"{html.escape(s['strategy'])} over "
            f"<code>{html.escape(s['param'])}</code> &middot; "
            f"{s['rounds']} rounds &middot; {s['scenarios_probed']} of "
            f"{s['exhaustive_scenarios']} exhaustive scenarios &middot; "
            f"{s['compiles']} compile(s) &middot; "
            f"<span class=\""
            f"{'pass' if s['outcome'] == 'success' else 'fail'}\">"
            f"{html.escape(s['outcome'])}</span></h2>"
            f'<div class="verdict">{_verdict_line(bp)}</div>'
        )
        frows = [
            "<tr><th>value</th><th>seeds</th><th>objective</th>"
            "<th>verdict</th></tr>"
        ]
        for pt in s["frontier"]:
            cls = "fail" if pt.get("failed") else "pass"
            word = "FAIL" if pt.get("failed") else "pass"
            frows.append(
                f"<tr><td>{html.escape(str(pt.get('value')))}</td>"
                f"<td>{pt.get('seeds', 1)}</td>"
                f"<td>{html.escape(str(pt.get('objective')))}</td>"
                f'<td class="{cls}">{word}</td></tr>'
            )
        rrows = [
            "<tr><th>round</th><th>probed values</th>"
            "<th>failing</th><th>state</th></tr>"
        ]
        for rec in s["search_rounds"]:
            probes = rec.get("probes", [])
            vals = sorted({str(p.get("value")) for p in probes})
            fails = sorted(
                {str(p.get("value")) for p in probes if p.get("failed")}
            )
            state = {
                k: v
                for k, v in rec.items()
                if k not in ("round", "probes")
            }
            rrows.append(
                f"<tr><td>{rec.get('round')}</td>"
                f"<td>{html.escape(', '.join(vals))}</td>"
                f"<td>{html.escape(', '.join(fails)) or '&mdash;'}</td>"
                f"<td><code>{html.escape(json.dumps(state))}</code>"
                "</td></tr>"
            )
        sections.append(
            head
            + f"<h3>frontier</h3><table>{''.join(frows)}</table>"
            + f"<h3>rounds</h3><table>{''.join(rrows)}</table>"
        )
    return _SEARCH_PAGE.format(
        for_plan=f" — {html.escape(plan)}" if plan else "",
        sections="\n".join(sections)
        or "<p>no breaking-point searches recorded yet "
        "(declare a [search] table — docs/search.md)</p>",
    )
