"""The runner: a ``RunInput`` (or a composition file, through
``python -m testground_tpu_torch run composition``) run on the card, and
the JAX runner's output files written from it.

Counterpart of ``testground_tpu/sim/runner.py``. It resolves the plan by
its manifest name to ``testground_tpu_torch.plans.<name>``, sizes the run
to the card before building it, leases its memory on the card
(sim/leases.py), builds and captures the loop iteration
(``SimExecutable.warmup``), runs it with the live, drain, profile and
durability planes at the chunk boundaries, grades the groups and
writes::

  <run_dir>/run.out                 the plan's log and fail_if strings,
                                    then the outcome line
  <run_dir>/<group>/<n>/results.out per-instance metric records, for
                                    runs of up to 1,024 instances
  <run_dir>/results.out             combined records with an
                                    ``instance`` column above that (and
                                    first on a telemetry-drained run)
  <run_dir>/trace.json              the trace plane's Chrome trace
  <run_dir>/progress.jsonl          the live plane's rows
  <run_dir>/checkpoint/             the durability plane's snapshots
  <run_dir>/sim_summary.json        outcome and the journal, under the
                                    JAX runner's keys

A composition with a ``[sweep]`` table runs its scenarios as one
scenario-batched program (sim/sweep.py, :func:`run_sweep_composition`)
and one with an enabled ``[search]`` table runs a breaking-point search
through one (sim/search.py, :func:`run_search_composition`); each
scenario demuxes to ``<run_dir>/scenario/<s>/`` (a search's to
``<run_dir>/round/<r>/scenario/<s>/``) with its own ``results.out``,
``trace.json`` and ``sim_summary.json``, under a roll-up
``sim_summary.json``.

A built and captured executor is pooled in memory, keyed by the plan
module's source, the config without its runtime fields, the tables, the
torch version and the device: a repeat run of the same program builds
and captures nothing (``executor_cache: "memory_hit"``, ``compiles: 0``).
While the pool holds it, the affinity digest its run or prewarm carried
(``RunInput.affinity``) is noted in federation/notes.py, which a fleet
worker's heartbeat reports as its ``cache_keys``.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import importlib
import importlib.util
import json
import os
import threading
import time
from collections import OrderedDict
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..api.contracts import GroupOutcome, RunInput, RunOutput, RunResult
from ..config.coalescing import CoalescedConfig
from ..device import resolve_device
from ..federation import notes as affinity_notes
from ..utils.timing import StageClock
from .context import BuildContext, GroupSpec
from .core import SimConfig, compile_program, watchdog_chunk_ticks
from .program import CRASHED, RUNNING
from .sweep import state_bytes


# ------------------------------------------------------------ the tables


def _table(rinput, key: str, typ):
    """The composition's ``key`` table as a ``typ`` object (from its
    dict form when given one), or None when absent."""
    t = getattr(rinput, key, None)
    if isinstance(t, dict):
        t = typ.from_dict(t)
    return t


def _marked_disabled(rinput, key: str) -> bool:
    """True when the composition carries a ``key`` table the operator
    switched off (``--no-<key>``): the journal records ``"disabled"``."""
    t = getattr(rinput, key, None)
    if t is None:
        return False
    if isinstance(t, dict):
        return not t.get("enabled", True)
    return not getattr(t, "enabled", True)


def _faults_disabled(faults) -> bool:
    """True for a [faults] schedule stripped with ``--no-faults``."""
    if faults is None:
        return False
    if isinstance(faults, dict):
        return bool(faults.get("disabled"))
    return bool(getattr(faults, "disabled", False))


def _enabled_table(rinput, key: str, typ):
    t = _table(rinput, key, typ)
    return t if t is not None and getattr(t, "enabled", True) else None


def _trace_table(rinput):
    from .tables import Trace

    return _enabled_table(rinput, "trace", Trace)


def _telemetry_table(rinput):
    from .tables import Telemetry

    return _enabled_table(rinput, "telemetry", Telemetry)


def _search_table(rinput):
    """The [search] table, or None when absent or disabled (a disabled
    one runs the plain or sweep path and journals ``"disabled"``)."""
    from .tables import Search

    return _enabled_table(rinput, "search", Search)


def _trace_capped(trace_table, extra):
    """The trace table with the pre-flight ladder's capacity."""
    tc = (extra or {}).get("trace_capacity")
    if trace_table is None or not tc or tc == trace_table.capacity:
        return trace_table
    return dataclasses.replace(trace_table, capacity=int(tc))


def _telemetry_capped(telem_table, extra):
    """The telemetry table with the pre-flight ladder's interval."""
    ti = (extra or {}).get("telemetry_interval")
    if telem_table is None or not ti or ti == telem_table.interval:
        return telem_table
    return dataclasses.replace(telem_table, interval=int(ti))


def _trace_tiers(trace_table):
    """The trace capacity ladder: the requested capacity, then every
    smaller ``_TRACE_TIERS`` rung (None untraced)."""
    if trace_table is None:
        return None
    cap = int(trace_table.capacity)
    return [cap] + [t for t in _TRACE_TIERS if t < cap]


def _telemetry_tiers(telem_table, cfg):
    """The telemetry interval ladder: the requested interval, then
    doublings until one sample row is left (None unsampled)."""
    if telem_table is None:
        return None
    iv = max(1, int(telem_table.interval))
    tiers = [iv]
    while -(-cfg.max_ticks // iv) > 1:
        iv *= 2
        tiers.append(iv)
    return tiers


def _replay_table(rinput):
    """The [replay] table with its trace path resolved (absolute as it
    is; relative against each group's artifact, the plan dir, then the
    working directory), or None when absent or disabled."""
    from .tables import Replay

    rp = _enabled_table(rinput, "replay", Replay)
    if rp is None:
        return None
    p = Path(rp.trace)
    if p.is_absolute():
        return rp
    bases = [Path(g.artifact_path) for g in (rinput.groups or [])
             if getattr(g, "artifact_path", "")]
    if getattr(rinput, "plan_dir", ""):
        bases.append(Path(rinput.plan_dir))
    bases.append(Path.cwd())
    tried = []
    for base in bases:
        cand = base / p
        tried.append(str(cand))
        if cand.exists():
            return dataclasses.replace(rp, trace=str(cand))
    raise FileNotFoundError(
        f"[replay] trace {rp.trace!r} not found; tried: "
        + ", ".join(dict.fromkeys(tried)))


# ---------------------------------------------------------- termination

_TERM_FLAGS: dict = {}
_TERM_REASONS: dict = {}
_TERM_LOCK = threading.Lock()


def request_terminate(run_id: str, reason: str = "terminated") -> None:
    """Ask the run ``run_id`` to stop at its next chunk boundary
    (``terminated``; ``preempted`` adds a forced final checkpoint and a
    resume token). Safe before the run starts."""
    with _TERM_LOCK:
        _TERM_FLAGS.setdefault(run_id, threading.Event()).set()
        _TERM_REASONS.setdefault(run_id, reason)


def request_preempt(run_id: str) -> None:
    """Stop ``run_id`` at its next boundary as ``preempted``."""
    request_terminate(run_id, reason="preempted")


def preempt_all_runs() -> int:
    """Preempt every run in flight; returns how many were flagged."""
    with _TERM_LOCK:
        rids = [rid for rid, ev in _TERM_FLAGS.items() if not ev.is_set()]
    for rid in rids:
        request_preempt(rid)
    return len(rids)


def _term_event(run_id: str):
    with _TERM_LOCK:
        return _TERM_FLAGS.setdefault(run_id, threading.Event())


def _term_reason(run_id: str) -> str:
    with _TERM_LOCK:
        return _TERM_REASONS.get(run_id, "terminated")


def _clears_term_flag(fn):
    """Registers the run's flag up front (so ``preempt_all_runs`` sees a
    run still building), and on every exit, an exception's too, clears
    it and releases the run's device lease (sim/leases.py)."""

    @functools.wraps(fn)
    def wrapped(rinput, ow=None, device="cuda"):
        rid = getattr(rinput, "run_id", "") or ""
        if rid:
            _term_event(rid)
        try:
            return fn(rinput, ow=ow, device=device)
        finally:
            with _TERM_LOCK:
                _TERM_FLAGS.pop(rid, None)
                _TERM_REASONS.pop(rid, None)
            if rid:
                from .leases import LEASES

                LEASES.release(rid)

    return wrapped


def _make_should_stop(rinput: RunInput):
    """The run loop's ``should_stop`` (None without a run id)."""
    rid = getattr(rinput, "run_id", "") or ""
    if not rid:
        return None
    return _term_event(rid).is_set


def _apply_termination(result, rinput, log, path_label="run") -> None:
    """The outcome of a run stopped at a boundary: ``terminated``, or
    ``preempted`` with its resume token."""
    rid = getattr(rinput, "run_id", "") or ""
    reason = _term_reason(rid) if rid else "terminated"
    result.outcome = reason
    result.journal["terminated"] = True
    if reason == "preempted":
        result.journal["preempted"] = True
        if rid:
            result.journal["resume_token"] = rid
        log(f"sim:torch {path_label} preempted at a chunk boundary — "
            "final checkpoint forced; resume with --resume "
            f"{rid or '<run id>'}")
    else:
        log(f"sim:torch {path_label} terminated at a chunk boundary")


# ------------------------------------------------------ the plan module


def plan_name(rinput: RunInput) -> str:
    """The plan's manifest name: the RunInput's manifest, else the
    ``manifest.toml`` beside the first group's artifact, else
    ``test_plan``."""
    man = getattr(rinput, "manifest", None)
    if man is not None and getattr(man, "name", ""):
        return man.name
    art = rinput.groups[0].artifact_path if rinput.groups else ""
    mpath = Path(art) / "manifest.toml" if art else None
    if mpath is not None and mpath.exists():
        from ..api.manifest import TestPlanManifest

        return TestPlanManifest.load(mpath).name
    return rinput.test_plan


def load_plan_module(name: str):
    """``testground_tpu_torch.plans.<name>`` (``-`` read as ``_``).
    Raises, naming the plan, when the port has no such plan: a plan
    directory's own ``sim.py`` is written against the JAX package and is
    never run in its place."""
    modname = f"{__package__.rsplit('.', 1)[0]}.plans.{name.replace('-', '_')}"
    if not name or importlib.util.find_spec(modname) is None:
        raise ValueError(
            f"plan {name!r} has no port in testground_tpu_torch.plans: the "
            "port runs only the plans it carries (its own copy of each "
            "plan's sim.py), never a plan directory's sim.py")
    return importlib.import_module(modname)


def _load_build_fn(rinput: RunInput):
    """(plan module, the requested case's build function)."""
    mod = load_plan_module(plan_name(rinput))
    cases = getattr(mod, "testcases", None)
    if not isinstance(cases, dict) or rinput.test_case not in cases:
        raise KeyError(
            f"sim plan has no test case {rinput.test_case!r}; "
            f"available: {sorted(cases) if cases else []}")
    return mod, cases[rinput.test_case]


def build_context_from_input(rinput: RunInput) -> BuildContext:
    groups = [GroupSpec(id=g.id, index=i, instances=g.instances,
                        parameters=dict(g.parameters))
              for i, g in enumerate(rinput.groups)]
    return BuildContext(groups, test_case=rinput.test_case,
                        test_run=rinput.run_id)


# --------------------------------------------------- the executor pool

# key -> (executor, pre-flight report), least recently used first
_EX_CACHE: "OrderedDict[str, tuple]" = OrderedDict()
_EX_CACHE_LOCK = threading.Lock()
# keys the pool keeps, one executor each (the JAX runner's default depth)
_EXECUTOR_CACHE_N = 4
# patched into a pooled executor's config on a hit: they shape no state
_RUNTIME_CFG_FIELDS = ("chunk_ticks", "max_ticks")
# statuses of a run that built and captured nothing
_WARM_STATUSES = ("memory_hit",)
# the pool's process counters (GET /cache and the dashboard's hit rate)
_EX_STATS = {"memory_hits": 0, "misses": 0, "checkins": 0}


def _excache_obs(op: str, n: int = 1) -> None:
    """The pool's ``op`` (hit, miss, checkin, evict) counted in the
    metrics plane's ``tg_excache_ops_total`` under ``tier="memory"``, as
    the JAX runner counts its pool's."""
    from ..obs import counter

    c = counter("tg_excache_ops_total",
                "Executor-cache operations by tier (memory/disk/shared) "
                "and op (hit/miss/store/evict/tombstone/error/checkin).")
    for _ in range(n):
        c.inc(tier="memory", op=op)


def executor_cache_stats() -> dict:
    """The pool's counters and occupancy, under the JAX runner's keys
    (one executor a key: ``pool_depth`` 1)."""
    with _EX_CACHE_LOCK:
        return {**_EX_STATS, "keys": len(_EX_CACHE),
                "pooled_executors": len(_EX_CACHE), "pool_depth": 1,
                "cache_depth": _EXECUTOR_CACHE_N}


def clear_executor_pool() -> None:
    """Drop every pooled executor (and the card memory it holds)."""
    with _EX_CACHE_LOCK:
        _EX_CACHE.clear()
        affinity_notes.clear()


def _dict_of(t):
    return t.to_dict() if hasattr(t, "to_dict") else t


def _executor_cache_key(mod, rinput: RunInput, cfg: SimConfig,
                        device: torch.device) -> str:
    """The pool key: the plan module's source, the case and groups, the
    config without its runtime fields, every program-shaping table (the
    host-only [live] and [checkpoint] by their disabled bit alone, the
    observer tables without their host-only drain flag unless a
    telemetry table fixes its sample depth, an enabled [search] by the
    fields that shape its batch), the replay trace's content, the torch
    version and the device."""
    cfg_d = dataclasses.asdict(cfg)
    for f in _RUNTIME_CFG_FIELDS:
        cfg_d.pop(f, None)
    groups = [(g.id, g.instances, sorted((g.parameters or {}).items()))
              for g in rinput.groups]
    src = hashlib.sha256(Path(mod.__file__).read_bytes()).hexdigest()
    trace_d = _dict_of(getattr(rinput, "trace", None))
    if isinstance(trace_d, dict):
        trace_d = {k: v for k, v in trace_d.items() if k != "drain"}
    telem_d = _dict_of(getattr(rinput, "telemetry", None))
    if isinstance(telem_d, dict) and not telem_d.get("samples"):
        telem_d = {k: v for k, v in telem_d.items() if k != "drain"}

    def disabled_bit(key):
        d = _dict_of(getattr(rinput, key, None))
        if isinstance(d, dict):
            return None if d.get("enabled", True) else {"enabled": False}
        return d

    replay_d = _dict_of(getattr(rinput, "replay", None))
    replay_sha = None
    if isinstance(replay_d, dict):
        if not replay_d.get("enabled", True):
            replay_d = {"enabled": False}
        else:
            try:
                resolved = _replay_table(rinput)
                if resolved is not None:
                    replay_sha = hashlib.sha256(
                        Path(resolved.trace).read_bytes()).hexdigest()
            except OSError:
                replay_sha = None
    search_d = _dict_of(getattr(rinput, "search", None))
    if isinstance(search_d, dict):
        search_d = ({k: search_d.get(k) for k in ("param", "width", "seeds")}
                    if search_d.get("enabled", True) else None)
    material = [
        mod.__name__, src, rinput.test_case, groups, sorted(cfg_d.items()),
        _dict_of(getattr(rinput, "sweep", None)),
        _dict_of(getattr(rinput, "faults", None)), trace_d, telem_d,
        search_d, disabled_bit("live"), disabled_bit("checkpoint"),
        replay_d, replay_sha, torch.__version__, str(device),
    ]
    return json.dumps(material, default=str)


def _affinity(rinput) -> str:
    """The run's affinity digest (set by the engine at queue time)."""
    return getattr(rinput, "affinity", "") or ""


def _executor_checkout(key):
    """(pooled (executor, pre-flight report) or None, status):
    ``memory_hit``, ``miss``, or ``evicted`` when this run's checkin will
    push the oldest key out."""
    with _EX_CACHE_LOCK:
        entry = _EX_CACHE.pop(key, None)
        if entry is not None:
            # checked out: the next identical run would build its own
            affinity_notes.drop(key)
            _EX_STATS["memory_hits"] += 1
            _excache_obs("hit")
            return entry, "memory_hit"
        _EX_STATS["misses"] += 1
        _excache_obs("miss")
        status = ("evicted" if len(_EX_CACHE) >= _EXECUTOR_CACHE_N
                  else "miss")
        return None, status


def _executor_checkin(key, ex, report=None, affinity="") -> None:
    """Pool ``ex`` (with its pre-flight report, minus the per-run keys)
    for the next run of the same program, noting ``affinity`` (the run's
    or prewarm's digest) for the fleet heartbeat while the pool holds
    it."""
    clean = {k: v for k, v in (report or {}).items()
             if k not in ("executor_cache", "observer_drain", "lease")}
    evicted = 0
    with _EX_CACHE_LOCK:
        _EX_STATS["checkins"] += 1
        _EX_CACHE[key] = (ex, clean)
        _EX_CACHE.move_to_end(key)
        affinity_notes.hold(key, affinity)
        while len(_EX_CACHE) > _EXECUTOR_CACHE_N:
            affinity_notes.drop(_EX_CACHE.popitem(last=False)[0])
            evicted += 1
    _excache_obs("checkin")
    _excache_obs("evict", evicted)


def _held_bytes(report) -> int:
    """The card memory a built and captured executor holds, idle or
    running: its state and its capture's private pool, modeled as the
    pre-flight models a run's peak (its state over ``_HBM_FRACTION``)."""
    return int(report.get("state_model_bytes_per_device", 0)
               / _HBM_FRACTION)


def _make_room(report, device, log) -> bool:
    """Evict pooled executors, least recently used first, until what the
    pool holds and this run's executor (``report``) fit the memory
    budget together. The pre-flight sizes a run against the whole
    budget (a sweep against the free memory with the pool's share
    added back), so a run's tiers never depend on what the pool holds;
    this frees the pool's share before the run builds and captures.
    Returns whether anything was evicted."""
    budget = device_hbm_bytes(device)
    need = _held_bytes(report)
    evicted = []
    with _EX_CACHE_LOCK:
        while _EX_CACHE and need + sum(
                _held_bytes(r) for _, r in _EX_CACHE.values()) > budget:
            evicted.append(_EX_CACHE.popitem(last=False))
            affinity_notes.drop(evicted[-1][0])
    if not evicted:
        return False
    _excache_obs("evict", len(evicted))
    freed = sum(_held_bytes(r) for _, (_, r) in evicted)
    del evicted
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    log(f"pre-flight HBM: evicted pooled executors holding "
        f"{freed / 1e9:.2f} GB (modeled) to fit this run's "
        f"{need / 1e9:.2f} GB in {budget / 1e9:.2f} GB")
    return True


def _reuse(ex, ctx: BuildContext, cfg: SimConfig) -> SimConfig:
    """A pooled executor (plain, or a sweep's) takes this run's metadata
    and runtime fields. A new ``max_ticks`` drops the kept capture (the
    captured guard holds the old one): the next ``warmup`` captures
    again."""
    base = getattr(ex, "base_ex", ex)
    if base is ex:
        ex.ctx = BuildContext(ctx.groups, test_case=ctx.test_case,
                              test_run=ctx.test_run, padded_n=ex.n)
    else:
        # a sweep's base context carries its first combo's params
        base.ctx.test_run = ctx.test_run
    if cfg.max_ticks != base.config.max_ticks:
        ex.release_capture()
    base.config = dataclasses.replace(
        base.config, **{f: getattr(cfg, f) for f in _RUNTIME_CFG_FIELDS})
    return base.config


# ------------------------------------------------------------ pre-flight

# The card's memory model: a run's peak is its state plus what the
# captured iteration allocates in its private pool (the guard's select
# over every leaf, the out-of-place ring merge, the count scatter's copy
# of the wheel): about three states. On an H100 80GB HBM3 the
# state/peak ratio measured 0.324-0.333 at storm, dht and sampled storm
# @ 10k and gossipsub @ 1M (chip_smoke.py [39], PERF.md); the pre-flight
# admits a state of at most this fraction of the card's memory, just
# under the smallest ratio.
_HBM_FRACTION = 0.3
_METRICS_TIERS = (64, 32, 16, 8)
_TRACE_TIERS = (256, 128, 64, 32, 16)


def device_hbm_bytes(device="cuda", free: bool = False) -> int:
    """The memory budget: ``TESTGROUND_HBM_BYTES`` when set, 2**62 on
    the CPU, else the card's total memory (``torch.cuda.mem_get_info``)
    or, with ``free``, its free memory as if the executor pool were
    empty: the allocator's idle blocks released and the pool's held
    bytes (modeled, as ``_make_room`` counts them) added back, at most
    the total. A sweep's pre-flight sizes against the latter, so its
    chunk and tiers never depend on what the pool holds."""
    env = os.environ.get("TESTGROUND_HBM_BYTES")
    if env:
        return int(env)
    dev = torch.device(device)
    if dev.type != "cuda":
        return 1 << 62
    if not free:
        return int(torch.cuda.mem_get_info(dev)[1])
    torch.cuda.empty_cache()
    avail, total = torch.cuda.mem_get_info(dev)
    with _EX_CACHE_LOCK:
        pooled = sum(_held_bytes(r) for _, r in _EX_CACHE.values())
    return int(min(total, avail + pooled))


def preflight_autosize(
    make_executor,
    cfg: SimConfig,
    extra_tiers=({},),
    metrics_tiers=None,
    budget: Optional[int] = None,
    allow_shrink: bool = True,
    log=lambda msg: None,
    trace_tiers=None,
    telemetry_tiers=None,
    device="cuda",
    fraction: float = _HBM_FRACTION,
):
    """Size the run to the card before building it: walk (plan param,
    metrics_capacity, trace_capacity, telemetry_interval) tiers largest
    first (the telemetry ladder innermost, then the trace ladder) and
    take the first whose state model fits ``fraction`` of the budget.
    ``make_executor(extra, cfg)`` builds an executor whose tick is not
    built yet (a sweep's models its own state: ``state_model_bytes``).
    Returns (executor, report); raises with the model's numbers when
    nothing fits (or the first tier does not and ``allow_shrink`` is
    False)."""
    budget = budget if budget is not None else device_hbm_bytes(device)
    admissible = int(budget * fraction)
    req = cfg.metrics_capacity
    tier_src = _METRICS_TIERS if metrics_tiers is None else metrics_tiers
    tiers = [req] + [t for t in tier_src if t < req]
    t_tiers = list(trace_tiers) if trace_tiers else [None]
    ti_tiers = list(telemetry_tiers) if telemetry_tiers else [None]
    if not allow_shrink:
        tiers = tiers[:1]
        extra_tiers = tuple(extra_tiers)[:1]
        t_tiers = t_tiers[:1]
        ti_tiers = ti_tiers[:1]
    tried = []
    for extra in extra_tiers:
        for mc in tiers:
            for tc in t_tiers:
                for ti in ti_tiers:
                    cfg2 = dataclasses.replace(cfg, metrics_capacity=mc)
                    probe_extra = dict(extra)
                    if tc is not None:
                        probe_extra["trace_capacity"] = tc
                    if ti is not None:
                        probe_extra["telemetry_interval"] = ti
                    ex = make_executor(probe_extra, cfg2)
                    own = getattr(ex, "state_model_bytes", None)
                    per_dev = own() if callable(own) else state_bytes(ex)
                    tried.append((dict(extra), mc, tc, ti, per_dev))
                    if per_dev > admissible:
                        continue
                    report = {
                        "hbm_budget_bytes": budget,
                        "hbm_admissible_bytes": admissible,
                        "state_model_bytes_per_device": per_dev,
                        "metrics_capacity_requested": req,
                        "metrics_capacity": mc,
                        "plan_param_overrides": dict(extra),
                    }
                    if tc is not None:
                        report["trace_capacity_requested"] = t_tiers[0]
                        report["trace_capacity"] = tc
                    if ti is not None:
                        report["telemetry_interval_requested"] = ti_tiers[0]
                        report["telemetry_interval"] = ti
                    shrunk = (mc != req or extra
                              or (tc is not None and tc != t_tiers[0])
                              or (ti is not None and ti != ti_tiers[0]))
                    if shrunk:
                        log("pre-flight HBM: auto-sized to "
                            f"metrics_capacity={mc}"
                            + (f", trace_capacity={tc}"
                               if tc is not None and tc != t_tiers[0] else "")
                            + (f", telemetry_interval={ti}"
                               if ti is not None and ti != ti_tiers[0]
                               else "")
                            + (f", {extra}" if extra else "")
                            + f" (model {per_dev / 1e9:.2f} GB/device, "
                            f"admissible {admissible / 1e9:.2f} GB)")
                    return ex, report
    lines = "; ".join(
        f"{e or 'defaults'}+metrics={m}"
        + (f"+trace={t}" if t is not None else "")
        + (f"+telem_interval={ti}" if ti is not None else "")
        + f": {b / 1e9:.2f} GB"
        for e, m, t, ti, b in tried)
    raise RuntimeError(
        "run cannot fit the device at any tier: admissible "
        f"{admissible / 1e9:.2f} GB/device ({fraction:.0%} of "
        f"{budget / 1e9:.1f} GB device memory); modeled: {lines}. Reduce "
        "the instance count or ring capacities.")


# --------------------------------------------------------- the run path


def _drain_for(rinput, ex, *, run_dir=None, scenario_dir=None,
               skip_scenarios=()):
    """The drain plane's ObserverDrain for this run (``run_dir``) or
    batched run (``scenario_dir(s)``, without the ``skip_scenarios``
    rows demux drops: a search's pad probes), or None when no built
    observer plane asks to drain."""
    from .drain import ObserverDrain, drain_flags

    trace_drain, telem_drain = drain_flags(rinput)
    trace_drain = trace_drain and ex.trace is not None
    telem_drain = telem_drain and ex.telemetry is not None
    if not (trace_drain or telem_drain):
        return None
    return ObserverDrain(ex, trace_drain=trace_drain,
                         telem_drain=telem_drain, run_dir=run_dir,
                         scenario_dir=scenario_dir,
                         skip_scenarios=skip_scenarios)


def _journal_drain(journal: dict, hbm_report: dict, drain, log) -> None:
    if drain is None:
        return
    journal["drain"] = drain.journal()
    hbm_report["observer_drain"] = {
        "trace": drain.trace_spec is not None,
        "telemetry": drain.telem_spec is not None,
        "lossless_tiers": True,
    }
    shrunk = []
    if (drain.trace_spec is not None and hbm_report.get("trace_capacity")
            and hbm_report.get("trace_capacity")
            != hbm_report.get("trace_capacity_requested")):
        shrunk.append(f"trace_capacity={hbm_report['trace_capacity']}")
    if (drain.telem_spec is not None
            and hbm_report.get("telemetry_interval")
            and hbm_report.get("telemetry_interval")
            != hbm_report.get("telemetry_interval_requested")):
        shrunk.append(
            f"telemetry_interval={hbm_report['telemetry_interval']}")
    if shrunk:
        log("pre-flight HBM: shrunk observer tiers drain at chunk "
            f"boundaries ({', '.join(shrunk)}) — capacity bounds one "
            "chunk, no data is lost, only per-boundary drain overhead "
            "added")


def _make_live_sink(rinput, run_dir, resume_point=None, kind="run"):
    """The live plane's sink of ``kind`` (run, sweep, search), or None
    under ``--no-live``; a resumed run continues the stream at its
    checkpointed seq."""
    from .live import LiveSink, live_disabled, live_interval_s

    if live_disabled(rinput):
        return None
    seq = nbytes = None
    if resume_point is not None:
        seq = int(resume_point.host.get("live_seq", 0))
        rb = resume_point.host.get("live_bytes")
        nbytes = int(rb) if rb is not None else None
    return LiveSink(run_dir, kind=kind, interval_s=live_interval_s(rinput),
                    mirror=getattr(rinput, "on_progress", None),
                    resume_seq=seq, resume_bytes=nbytes)


def _journal_live(journal, rinput, sink) -> None:
    from .live import live_disabled, live_interval_s

    if sink is not None:
        journal["live"] = {"snapshots": sink.seq,
                           "interval_s": live_interval_s(rinput)}
    elif live_disabled(rinput):
        journal["live"] = "disabled"


def _load_resume(rinput, run_dir, log):
    """The run's checkpoint when it asks to resume and one exists."""
    if not getattr(rinput, "resume", False):
        return None
    from .checkpoint import load_checkpoint

    rp = load_checkpoint(run_dir, log=log)
    if rp is None:
        log("resume requested but no usable checkpoint found — running "
            "from scratch")
    else:
        log(f"resuming from checkpoint seq={rp.seq} chunk={rp.chunk} "
            f"tick={rp.tick} ({rp.dir})")
    return rp


def _verify_resume(resume_point, rinput, ex_key) -> None:
    """Refuse another program's checkpoint before anything is built."""
    if resume_point is None:
        return
    from .checkpoint import composition_digest, key_digest

    resume_point.verify(key_digest(ex_key), composition_digest(
        getattr(rinput, "composition", None)))


def _restore_drain(drain, resume_point, rebuild, log):
    """Re-enter the drain's checkpointed stream positions; a stream that
    cannot be restored makes the run start fresh."""
    if resume_point is None or drain is None:
        return drain, resume_point
    snap = resume_point.host.get("drain")
    if not snap:
        return drain, resume_point
    try:
        drain.restore(snap)
        return drain, resume_point
    except OSError as e:
        log(f"WARNING: resume cannot restore drained streams ({e}) — "
            "running from scratch")
        return rebuild(), None


def _make_checkpointer(rinput, run_dir, ex_key, log, resume_point=None,
                       kind="run"):
    """The run's Checkpointer of ``kind`` (run, sweep, search), or None
    under ``--no-checkpoint``."""
    from .checkpoint import (Checkpointer, checkpoint_disabled,
                             checkpoint_table, composition_digest,
                             key_digest)

    if checkpoint_disabled(rinput):
        return None
    return Checkpointer(
        run_dir, key_hash=key_digest(ex_key),
        comp_hash=composition_digest(getattr(rinput, "composition", None)),
        kind=kind, interval_s=checkpoint_table(rinput).interval, log=log,
        start_seq=(resume_point.seq + 1) if resume_point else 0)


def _journal_checkpoint(journal, rinput, ckpt, resume_point,
                        cache_status) -> None:
    from .checkpoint import checkpoint_disabled

    if ckpt is not None:
        journal["checkpoint"] = ckpt.journal()
    elif checkpoint_disabled(rinput):
        journal["checkpoint"] = "disabled"
    attempt = int(getattr(rinput, "attempt", 0) or 0)
    if attempt:
        journal["attempt"] = attempt
    if resume_point is not None:
        if resume_point.kind == "search":
            # a search journals resumed_from_round; its checkpoint holds
            # the driver alone
            journal["resume"] = {
                "checkpoint_seq": resume_point.seq,
                "from_round": int(resume_point.host.get("search_round",
                                                        -1)) + 1,
            }
        else:
            journal["resumed_from_chunk"] = resume_point.chunk
            journal["resumed_from_tick"] = resume_point.tick
            journal["resume"] = {"checkpoint_seq": resume_point.seq,
                                 "from_chunk": resume_point.chunk,
                                 "from_tick": resume_point.tick}
        # a search journals its own count of builds: kept
        journal.setdefault("compiles",
                           0 if cache_status in _WARM_STATUSES else 1)
    elif getattr(rinput, "resume", False):
        journal["resume"] = "no_checkpoint"


def _write_json_atomic(path, obj) -> None:
    from .checkpoint import atomic_write_json

    atomic_write_json(path, obj)


def _write_trace_json(path: Path, res, fault_plan=None) -> None:
    """The trace rings as ``trace.json`` (Chrome trace-event JSON); a
    sweep scenario's fault windows from its own ``fault_plan``."""
    with open(path, "w") as f:
        f.write(res.chrome_trace_json(fault_plan))


def _lease_acquire(rinput, hbm_report, device, log):
    """Lease the run's modeled footprint (the pre-flight's
    ``state_model_bytes_per_device``) on its device before the warmup
    (sim/leases.py): two runs that fit together run concurrently, two
    that do not, one after the other. A run without an id leases
    nothing. Returns the journal's ``lease`` record, or None."""
    rid = getattr(rinput, "run_id", "") or ""
    if not rid:
        return None
    from .leases import LEASES
    from .profile import env_num

    per_dev = int(hbm_report.get("state_model_bytes_per_device", 0))
    dev = torch.device(device)
    devices = [str(dev.index or 0) if dev.type == "cuda" else "cpu"]
    rec = LEASES.acquire(
        rid, devices, per_dev,
        wait_timeout_s=env_num("TG_LEASE_WAIT_S", 600.0, float),
        # a killed run stops waiting: it ends at its first boundary
        should_stop=_make_should_stop(rinput))
    if rec["waited_s"] > 0.05:
        log(f"device lease: waited {rec['waited_s']}s for "
            f"{per_dev / 1e9:.2f} GB/device ({rec['concurrent_runs']} "
            "concurrent runs at grant)")
    return rec


def _run_profiled(ex, rinput, device, log, **run_kw):
    """``ex.run(**run_kw)``, under the profiler when a group asks for
    profiles (``<run_dir>/profiles``)."""
    if any(g.profiles for g in rinput.groups):
        from .profile import profiled

        pdir = Path(rinput.run_dir) / "profiles"
        with profiled(pdir, device):
            res = ex.run(**run_kw)
        log(f"device trace captured: {pdir}")
        return res
    return ex.run(**run_kw)


def _config(rinput):
    return CoalescedConfig().append(rinput.run_config).coalesce_into(
        SimConfig)


def _build(rinput, device, log, tag="compiling"):
    """Everything before a plain run's executor: (plan module, build
    function, config with the watchdog chunk, build context)."""
    mod, build_fn = _load_build_fn(rinput)
    cfg = _config(rinput)
    ctx = build_context_from_input(rinput)
    if "chunk_ticks" not in (rinput.run_config or {}):
        cfg.chunk_ticks = watchdog_chunk_ticks(ctx.n_instances)
    log(f"sim:torch {tag}: case={rinput.test_case} instances="
        f"{ctx.n_instances} quantum={cfg.quantum_ms}ms device={device}")
    return mod, build_fn, cfg, ctx


def _preflight(rinput, build_fn, ctx, cfg, device, log):
    """The pre-flight-sized executor (not built yet) and its report."""
    faults = getattr(rinput, "faults", None)
    if _faults_disabled(faults):
        faults = None  # the --no-faults leg builds nothing
    trace_table = _trace_table(rinput)
    telem_table = _telemetry_table(rinput)
    replay_table = _replay_table(rinput)
    ex, report = preflight_autosize(
        lambda extra, cfg2: compile_program(
            build_fn, ctx, cfg2, device=device, faults=faults,
            trace=_trace_capped(trace_table, extra),
            telemetry=_telemetry_capped(telem_table, extra),
            replay=replay_table),
        cfg,
        allow_shrink="metrics_capacity" not in (rinput.run_config or {}),
        log=log,
        trace_tiers=_trace_tiers(trace_table),
        telemetry_tiers=_telemetry_tiers(telem_table, cfg),
        device=device,
    )
    if ex.replay is not None:
        report["replay_bytes"] = ex.replay.model_bytes()
    return ex, report


@_clears_term_flag
def run_composition(rinput: RunInput, ow=None, device="cuda") -> RunOutput:
    """Run a composition on ``device`` and write its outputs to
    ``rinput.run_dir`` (module docstring): an enabled [search] table
    runs :func:`run_search_composition`, a [sweep] table
    :func:`run_sweep_composition`, anything else the plain path."""
    if _search_table(rinput) is not None:
        return run_search_composition(rinput, ow=ow, device=device)
    if getattr(rinput, "sweep", None):
        return run_sweep_composition(rinput, ow=ow, device=device)
    log = ow or (lambda msg: None)
    device = resolve_device(device)
    mod, build_fn, cfg, ctx = _build(rinput, device, log)
    clock = StageClock("sim")
    t0 = time.monotonic()
    run_dir = Path(rinput.run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    resume_point = _load_resume(rinput, run_dir, log)
    sink = _make_live_sink(rinput, run_dir, resume_point)
    with clock.span("preflight"):
        ex_key = _executor_cache_key(mod, rinput, cfg, device)
        _verify_resume(resume_point, rinput, ex_key)
        cached, cache_status = _executor_checkout(ex_key)
        if cached is not None:
            ex, cached_report = cached
            cfg = _reuse(ex, ctx, cfg)
            hbm_report = {"executor_cache": "memory_hit", **cached_report}
            log("sim:torch executor reused (build and capture skipped)")
        else:
            ex, hbm_report = _preflight(rinput, build_fn, ctx, cfg, device,
                                        log)
            cfg = ex.config
            hbm_report["executor_cache"] = cache_status
        if _make_room(hbm_report, device, log) and cached is None:
            hbm_report["executor_cache"] = "evicted"
    lease = _lease_acquire(rinput, hbm_report, device, log)
    with clock.span("warmup_compile"):
        ex.warmup()
    compile_s = time.monotonic() - t0

    from .live import boundary_callback, exec_stats
    from .profile import ChunkProfiler, profiled

    if sink is not None:
        sink.emit({"phase": "dispatch", "tick": 0,
                   "max_ticks": cfg.max_ticks, "progress": 0.0,
                   "running": ctx.n_instances,
                   "instances": ctx.n_instances,
                   "compile_seconds": round(compile_s, 3)}, force=True)
    clock.reset_lap()
    profiler = ChunkProfiler.from_env(log, device)
    on_chunk = boundary_callback(
        clock, log, sink, max_ticks=cfg.max_ticks,
        n_instances=ctx.n_instances, event_skip=ex.event_skip,
        format_line=lambda tick, running, info, live_scen: (
            f"sim tick {tick}: {running} instances running"),
        profiler=profiler)
    drain = _drain_for(rinput, ex, run_dir=run_dir)
    drain, resume_point = _restore_drain(
        drain, resume_point, lambda: _drain_for(rinput, ex, run_dir=run_dir),
        log)
    ckpt = _make_checkpointer(rinput, run_dir, ex_key, log, resume_point)
    if ckpt is not None:
        ckpt.attach(sink=sink, drain=drain)
    from .checkpoint import DispatchWatchdog

    watchdog = DispatchWatchdog.from_env(log=log)
    if watchdog is not None and sink is not None:
        from .profile import env_num

        watchdog.attach_heartbeat(
            lambda row: sink.emit(row, force=True),
            interval_s=max(0.1, env_num("TG_DISPATCH_HEARTBEAT_S", 5.0,
                                        float)))
    run_kw = dict(on_chunk=on_chunk, drain=drain,
                  should_stop=_make_should_stop(rinput), watchdog=watchdog,
                  checkpoint=ckpt,
                  resume_state=resume_point.state if resume_point else None)
    try:
        if any(g.profiles for g in rinput.groups):
            with profiled(run_dir / "profiles", device):
                res = ex.run(**run_kw)
            log(f"device trace captured: {run_dir / 'profiles'}")
        else:
            res = ex.run(**run_kw)
    finally:
        if watchdog is not None:
            watchdog.detach_heartbeat()
        profiler.close()
    clock.stamp("run done")

    # ---- grade
    g0 = clock.elapsed()
    result = RunResult()
    for gid, (ok, total) in res.outcomes().items():
        result.outcomes[gid] = GroupOutcome(ok=ok, total=total)
    result.grade()
    if res.timed_out():
        result.outcome = "failure"
    dropped = res.metrics_dropped()
    if dropped:
        log(f"WARNING: {dropped} metric records dropped (metrics_capacity="
            f"{cfg.metrics_capacity}; raise it in run_config)")
    result.journal = {
        "ticks": res.ticks,
        "ticks_simulated": res.ticks,
        "ticks_executed": res.ticks_executed,
        "skip_ratio": round(res.skip_ratio, 4),
        "event_skip": bool(ex.event_skip),
        "virtual_seconds": res.virtual_seconds,
        "wall_seconds": res.wall_seconds,
        # build + capture (and the pre-flight before them)
        "compile_seconds": compile_s,
        "compile_breakdown": ex.compile_breakdown,
        "compiles": (0 if hbm_report.get("executor_cache") in _WARM_STATUSES
                     else 1),
        "timed_out": res.timed_out(),
        "metrics_dropped": dropped,
        "mesh": {"instance": 1},
        "hbm_preflight": hbm_report,
    }
    if lease is not None:
        result.journal["lease"] = lease
    device_profile = profiler.journal()
    if device_profile is not None:
        result.journal["device_profile"] = device_profile
    if res.terminated:
        _apply_termination(result, rinput, log)
    _journal_checkpoint(result.journal, rinput, ckpt, resume_point,
                        hbm_report.get("executor_cache"))
    _journal_drain(result.journal, hbm_report, drain, log)
    if ex.faults is not None:
        result.journal["faults"] = ex.faults.timeline
        restarted = res.restarts_total()
        if restarted:
            result.journal["restarted_count"] = restarted
    elif _faults_disabled(getattr(rinput, "faults", None)):
        result.journal["faults"] = "disabled"
    if ex.replay is not None:
        result.journal["replay"] = {**ex.replay.journal(),
                                    "consumed": res.replay_consumed()}
    elif _marked_disabled(rinput, "replay"):
        result.journal["replay"] = "disabled"
    for key, val in (("net_dropped", res.net_dropped()),
                     ("net_horizon_clamped", res.net_horizon_clamped()),
                     ("stream_violations", res.stream_violations())):
        if val:
            result.journal[key] = val
            log(f"WARNING: {key}={val}")
    trace_drained = drain is not None and drain.trace_spec is not None
    telem_drained = drain is not None and drain.telem_spec is not None
    if ex.trace is not None:
        if trace_drained:
            tstats = drain.scenario_stats(None)
            result.journal["trace_events"] = tstats["trace_events"]
            t_dropped = tstats["trace_dropped"]
        else:
            result.journal["trace_events"] = res.trace_events_total()
            t_dropped = res.trace_dropped_total()
        result.journal["trace_dropped"] = t_dropped
        if t_dropped:
            log(f"WARNING: {t_dropped} trace events dropped (capacity="
                f"{ex.trace.capacity}; "
                + ("one chunk outgrew the drained ring — raise [trace] "
                   "capacity or lower chunk_ticks)" if trace_drained
                   else "raise [trace] capacity, or set [trace] drain = "
                   "true so capacity bounds one chunk)"))
    if ex.telemetry is not None:
        if telem_drained:
            tlstats = drain.scenario_stats(None)
            result.journal["telemetry_samples"] = tlstats[
                "telemetry_samples"]
            t_clipped = tlstats["telemetry_clipped"]
        else:
            result.journal["telemetry_samples"] = res.telemetry_samples()
            t_clipped = res.telemetry_clipped()
        result.journal["telemetry_clipped"] = t_clipped
        if t_clipped:
            log(f"WARNING: {t_clipped} telemetry boundaries clipped "
                f"(interval={ex.telemetry.interval}; "
                + ("one chunk outgrew the drained buffer — raise "
                   "[telemetry] samples or lower chunk_ticks)"
                   if telem_drained else "raise [telemetry] interval)"))
    elif _marked_disabled(rinput, "telemetry"):
        result.journal["telemetry"] = "disabled"
    if _marked_disabled(rinput, "search"):
        result.journal["search"] = "disabled"
    statuses = res.statuses()[: ctx.n_instances]
    for label, code in (("crashed", CRASHED), ("stalled", RUNNING)):
        idx = np.nonzero(statuses == code)[0]
        if idx.size:
            result.journal[f"{label}_instances"] = idx[:100].tolist()
            result.journal[f"{label}_count"] = int(idx.size)
    clock.add_span("grade", g0, clock.elapsed() - g0)

    # ---- outputs
    d0 = clock.elapsed()
    if drain is not None:
        drain.finalize(res.state, fault_plan=ex.faults)
    with open(run_dir / "run.out", "w") as f:
        for m in ex.program.messages:
            f.write(m + "\n")
        if dropped:
            f.write(f"WARNING: {dropped} metric records dropped\n")
        f.write(f"outcome={result.outcome} ticks={res.ticks} "
                f"virtual={res.virtual_seconds:.3f}s "
                f"wall={res.wall_seconds:.3f}s\n")
    _write_results(run_dir, res, ex, rinput, ctx, telem_drained)
    if ex.trace is not None and not trace_drained:
        _write_trace_json(run_dir / "trace.json", res)
    clock.add_span("demux", d0, clock.elapsed() - d0)
    result.journal["host_spans"] = clock.rollup()
    if sink is not None:
        final = {"phase": "done", "outcome": result.outcome,
                 "progress": 1.0, "tick": res.ticks,
                 "max_ticks": cfg.max_ticks, "running": 0,
                 "instances": ctx.n_instances,
                 "wall_seconds": round(res.wall_seconds, 3)}
        es = exec_stats(res.state)
        if es is not None:
            final["ticks_executed"] = es[0]
            final["skip_ratio"] = round(es[1], 4)
        sink.emit(final, force=True)
    _journal_live(result.journal, rinput, sink)
    _write_json_atomic(run_dir / "sim_summary.json", {
        "outcome": result.outcome,
        "outcomes": {k: {"ok": v.ok, "total": v.total}
                     for k, v in result.outcomes.items()},
        **result.journal,
    })
    log(f"sim:torch done: outcome={result.outcome} ticks={res.ticks} "
        f"wall={res.wall_seconds:.3f}s (compile {compile_s:.1f}s)")
    _executor_checkin(ex_key, ex, hbm_report, _affinity(rinput))
    return RunOutput(result=result)


def _write_results(run_dir: Path, res, ex, rinput, ctx,
                   telem_drained: bool) -> None:
    """The metric records (and undrained telemetry series): appended
    after the streamed file on a telemetry-drained run, per instance up
    to 1,024 instances (the run root then holds only the global
    telemetry gauges), combined above."""
    telem_lane: list = []
    telem_glob: list = []
    if ex.telemetry is not None and not telem_drained:
        telem_lane, telem_glob = res.telemetry_records()
    if telem_drained:
        with open(run_dir / "results.out", "a") as f:
            f.writelines(res.metrics_lines())
    elif rinput.total_instances <= 1024:
        all_recs = res.metrics_records() + telem_lane
        ginst = np.asarray(ctx.group_instance_index)
        by_dir: dict = {}
        for rec in all_recs:
            gi = int(ginst[rec["instance"]])
            by_dir.setdefault((rec["group"], gi), []).append(rec)
        for g in rinput.groups:
            for gi in range(g.instances):
                odir = run_dir / g.id / str(gi)
                odir.mkdir(parents=True, exist_ok=True)
                with open(odir / "results.out", "w") as f:
                    for rec in by_dir.get((g.id, gi), []):
                        f.write(json.dumps(rec) + "\n")
        if telem_glob:
            with open(run_dir / "results.out", "w") as f:
                for rec in telem_glob:
                    f.write(json.dumps(rec) + "\n")
    else:
        with open(run_dir / "results.out", "w") as f:
            f.writelines(res.metrics_lines())
            for rec in telem_lane + telem_glob:
                f.write(json.dumps(rec) + "\n")


def prewarm_composition(rinput: RunInput, ow=None,
                        device="cuda") -> RunOutput:
    """Build and capture a composition's executor (a sweep's too) into
    the pool without running it: the next run of it journals
    ``executor_cache: "memory_hit"`` and ``compiles: 0``, and the
    pool's note of its affinity digest routes a fleet's next run of it
    here. (The JAX runner's prewarm fills its disk tiers; the port has
    none yet: its journal's ``persisted_local`` and ``persisted_shared``
    are false.) A [search] composition is refused, as by the JAX runner:
    its executor's shape depends on the driver's round-0 probes."""
    log = ow or (lambda msg: None)
    if _search_table(rinput) is not None:
        raise ValueError(
            "prewarm does not support [search] compositions (the "
            "executable's shape depends on the driver's round-0 "
            "probes); prewarm an equivalent [sweep] instead")
    device = resolve_device(device)
    sweep = _sweep_of(rinput)
    if sweep is None:
        mod, build_fn, cfg, ctx = _build(rinput, device, log, tag="prewarm")
    else:
        mod, build_fn = _load_build_fn(rinput)
        cfg, ctx = _config(rinput), build_context_from_input(rinput)
        log(f"sim:torch prewarm: case={rinput.test_case} instances="
            f"{ctx.n_instances} (sweep) device={device}")
    t0 = time.monotonic()
    ex_key = _executor_cache_key(mod, rinput, cfg, device)
    aff = _affinity(rinput)
    with _EX_CACHE_LOCK:
        pooled = ex_key in _EX_CACHE
        if pooled:
            affinity_notes.hold(ex_key, aff)
    if pooled:
        status, hbm_report = "memory_hit", {}
    else:
        if sweep is None:
            ex, hbm_report = _preflight(rinput, build_fn, ctx, cfg, device,
                                        log)
        else:
            ex, hbm_report = _sweep_preflight(
                rinput, build_fn, ctx, cfg, sweep.expand(), device, log,
                explicit_chunk=sweep.chunk, mesh=sweep.mesh)
            _sweep_chunk_ticks(ex, rinput, ctx)
        _make_room(hbm_report, device, log)
        ex.warmup()
        _executor_checkin(ex_key, ex, hbm_report, aff)
        status = "miss"
    compile_s = time.monotonic() - t0
    result = RunResult(outcome="success")
    result.journal = {
        "prewarm": True,
        "executor_cache": status,
        "compiles": 0 if status in _WARM_STATUSES else 1,
        "compile_seconds": round(compile_s, 3),
        # the JAX prewarm's disk tiers: the port has none (item 11.3)
        "persisted_local": False,
        "persisted_shared": False,
        "hbm_preflight": hbm_report,
    }
    if aff:
        result.journal["affinity"] = aff
    log(f"sim:torch prewarm done: executor_cache={status} "
        f"compile={compile_s:.1f}s")
    return RunOutput(result=result)


# ------------------------------------------------- the batched run paths


def _sweep_of(rinput):
    """The [sweep] table as a validated sim/tables.py ``Sweep``, or
    None."""
    from .tables import Sweep

    sweep = _table(rinput, "sweep", Sweep)
    if sweep is not None:
        sweep.validate()
    return sweep


def _sweep_preflight(rinput, build_fn, ctx, cfg, scenarios, device, log,
                     explicit_chunk=0, mesh=None):
    """The pre-flight-sized scenario-batched executable of ``scenarios``
    (not built yet) and its report: sim/sweep.py ``sweep_preflight``
    over ``compile_sweep`` with the composition's tables, its trace and
    telemetry tiers walked as the plain path walks them."""
    from .sweep import compile_sweep, sweep_preflight

    trace_table = _trace_table(rinput)
    telem_table = _telemetry_table(rinput)
    replay_table = _replay_table(rinput)

    def make(cfg2, c, trace_cap=None, telem_interval=None):
        return compile_sweep(
            build_fn, ctx.groups, cfg2, scenarios,
            test_case=ctx.test_case, test_run=ctx.test_run, chunk=c,
            faults=getattr(rinput, "faults", None),
            trace=_trace_capped(
                trace_table,
                {"trace_capacity": trace_cap} if trace_cap else None),
            telemetry=_telemetry_capped(
                telem_table,
                {"telemetry_interval": telem_interval}
                if telem_interval else None),
            mesh_shape=mesh, replay=replay_table, device=device)

    return sweep_preflight(
        make, cfg, len(scenarios), explicit_chunk=explicit_chunk,
        allow_shrink="metrics_capacity" not in (rinput.run_config or {}),
        log=log, trace_tiers=_trace_tiers(trace_table),
        telemetry_tiers=_telemetry_tiers(telem_table, cfg))


def _sweep_chunk_ticks(ex, rinput, ctx) -> None:
    """A batched iteration carries chunk x N lanes: the watchdog tier of
    that lane count, unless the run config sets ``chunk_ticks``."""
    if "chunk_ticks" not in (rinput.run_config or {}):
        ex.base_ex.config = dataclasses.replace(
            ex.config, chunk_ticks=watchdog_chunk_ticks(
                ctx.n_instances * ex.chunk_size))


def _batched_executor(rinput, ex_key, build_fn, cfg, ctx, scenarios,
                      device, log, tag, explicit_chunk=0, mesh=None):
    """The batched paths' executor: (executor, pre-flight report,
    whether it came from the pool), its chunk_ticks set and the pool's
    room made."""
    cached, cache_status = _executor_checkout(ex_key)
    if cached is not None:
        ex, cached_report = cached
        _reuse(ex, ctx, cfg)
        hbm_report = {"executor_cache": "memory_hit", **cached_report}
        log(f"sim:torch {tag} executor reused (build and capture skipped)")
    else:
        ex, hbm_report = _sweep_preflight(
            rinput, build_fn, ctx, cfg, scenarios, device, log,
            explicit_chunk=explicit_chunk, mesh=mesh)
        hbm_report["executor_cache"] = cache_status
    _sweep_chunk_ticks(ex, rinput, ctx)
    if _make_room(hbm_report, device, log) and cached is None:
        hbm_report["executor_cache"] = "evicted"
    return ex, hbm_report, cached is not None


def _demux_scenario(res, s, sc, sdir, ex, rinput, ctx, log, tag=None,
                    drain=None):
    """Demux scenario ``s`` of a batched run (a sweep point or a search
    probe) into ``sdir``: its records (and telemetry series),
    ``trace.json`` and ``sim_summary.json`` row. Where ``drain`` already
    streamed the scenario's events and samples into ``sdir``, it
    finalizes that stream (the fault windows' track, the histograms,
    ``trace.json``) and reports the drain's watermarks instead of the
    emptied buffers. Returns (row, the scenario's SimResult)."""
    tag = tag if tag is not None else f"scenario {s}"
    trace_drained = drain is not None and drain.trace_spec is not None
    telem_drained = drain is not None and drain.telem_spec is not None
    r = res.scenario(s)
    sres = RunResult()
    for gid, (ok, total) in r.outcomes().items():
        sres.outcomes[gid] = GroupOutcome(ok=ok, total=total)
    sres.grade()
    if r.timed_out():
        sres.outcome = "failure"
    dropped = r.metrics_dropped()
    sdir.mkdir(parents=True, exist_ok=True)
    fplans = ex._fault_plans
    fplan = fplans[s] if fplans is not None else None
    if drain is not None:
        drain.finalize_scenario(s, r.state, fault_plan=fplan)
    # a telemetry-drained scenario's samples already stream in
    # results.out: its metric records follow them
    with open(sdir / "results.out", "a" if telem_drained else "w") as f:
        f.writelines(r.metrics_lines())
        if ex.telemetry is not None and not telem_drained:
            t_lane, t_glob = r.telemetry_records()
            for rec in t_lane + t_glob:
                f.write(json.dumps(rec) + "\n")
    if ex.trace is not None and not trace_drained:
        _write_trace_json(sdir / "trace.json", r, fplan)
    row = {
        "scenario": s,
        "seed": sc["seed"],
        "params": dict(sc["params"]),
        "outcome": sres.outcome,
        "outcomes": {k: {"ok": v.ok, "total": v.total}
                     for k, v in sres.outcomes.items()},
        "ticks": r.ticks,
        # each scenario skips by its own schedule
        "ticks_executed": r.ticks_executed,
        "skip_ratio": round(r.skip_ratio, 4),
        "virtual_seconds": r.virtual_seconds,
        "timed_out": r.timed_out(),
        "metrics_dropped": dropped,
    }
    if ex.trace is not None:
        if trace_drained:
            ds = drain.scenario_stats(s)
            row["trace_events"] = ds["trace_events"]
            row["trace_dropped"] = ds["trace_dropped"]
        else:
            row["trace_events"] = r.trace_events_total()
            row["trace_dropped"] = r.trace_dropped_total()
    if ex.telemetry is not None:
        if telem_drained:
            ds = drain.scenario_stats(s)
            row["telemetry_samples"] = ds["telemetry_samples"]
            row["telemetry_clipped"] = ds["telemetry_clipped"]
        else:
            row["telemetry_samples"] = r.telemetry_samples()
            row["telemetry_clipped"] = r.telemetry_clipped()
    elif _marked_disabled(rinput, "telemetry"):
        row["telemetry"] = "disabled"
    statuses = r.statuses()[: ctx.n_instances]
    for label, code in (("crashed", CRASHED), ("stalled", RUNNING)):
        n_abn = int((statuses == code).sum())
        if n_abn:
            row[f"{label}_count"] = n_abn
    # the scenario's own realized fault timeline
    if fplan is not None:
        row["faults"] = fplan.timeline
        restarted = r.restarts_total()
        if restarted:
            row["restarted_count"] = restarted
    elif _faults_disabled(getattr(rinput, "faults", None)):
        row["faults"] = "disabled"
    if ex.replay is not None:
        row["replay_consumed"] = r.replay_consumed()
    elif _marked_disabled(rinput, "replay"):
        row["replay"] = "disabled"
    for key, val in (("net_dropped", r.net_dropped()),
                     ("net_horizon_clamped", r.net_horizon_clamped()),
                     ("stream_violations", r.stream_violations())):
        if val:
            row[key] = val
            log(f"WARNING: {tag}: {key}={val}")
    _write_json_atomic(sdir / "sim_summary.json", row)
    return row, r


@_clears_term_flag
def run_sweep_composition(rinput: RunInput, ow=None,
                          device="cuda") -> RunOutput:
    """A composition with a ``[sweep]`` table: its S scenarios run as one
    scenario-batched program on ``device`` (sim/sweep.py: one build, one
    capture, one chunk of scenarios after another when the pre-flight
    chunks them), each demuxed so that it grades alone::

      <run_dir>/scenario/<s>/results.out       its records
      <run_dir>/scenario/<s>/trace.json        its trace, when traced
      <run_dir>/scenario/<s>/sim_summary.json  its outcome and counters
      <run_dir>/sim_summary.json               the sweep's roll-up
    """
    log = ow or (lambda msg: None)
    device = resolve_device(device)
    sweep = _sweep_of(rinput)
    scenarios = sweep.expand()
    mod, build_fn = _load_build_fn(rinput)
    cfg, ctx = _config(rinput), build_context_from_input(rinput)
    log(f"sim:torch sweep compiling: case={rinput.test_case} instances="
        f"{ctx.n_instances} scenarios={len(scenarios)} device={device}")
    clock = StageClock("sim")
    t0 = time.monotonic()
    run_dir = Path(rinput.run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    resume_point = _load_resume(rinput, run_dir, log)
    sink = _make_live_sink(rinput, run_dir, resume_point, kind="sweep")
    with clock.span("preflight"):
        ex_key = _executor_cache_key(mod, rinput, cfg, device)
        _verify_resume(resume_point, rinput, ex_key)
        ex, hbm_report, _ = _batched_executor(
            rinput, ex_key, build_fn, cfg, ctx, scenarios, device, log,
            "sweep", explicit_chunk=sweep.chunk, mesh=sweep.mesh)
    cfg = ex.config
    lease = _lease_acquire(rinput, hbm_report, device, log)
    with clock.span("warmup_compile"):
        ex.warmup()
    compile_s = time.monotonic() - t0

    from .checkpoint import DispatchWatchdog
    from .live import boundary_callback
    from .state_io import state_from_numpy

    if sink is not None:
        sink.emit({"phase": "dispatch", "tick": 0,
                   "max_ticks": cfg.max_ticks, "progress": 0.0,
                   "running": ctx.n_instances * len(scenarios),
                   "instances": ctx.n_instances,
                   "scenarios": {"total": len(scenarios),
                                 "live": len(scenarios), "done": 0},
                   "compile_seconds": round(compile_s, 3)}, force=True)
    clock.reset_lap()
    on_chunk = boundary_callback(
        clock, log, sink, max_ticks=cfg.max_ticks,
        n_instances=ctx.n_instances, event_skip=ex.event_skip,
        batched=True,
        format_line=lambda tick, running, info, live_scen: (
            f"sweep tick {tick}: {running} scenario-instance lanes "
            f"running ({live_scen} of {len(scenarios)} scenarios live, "
            f"chunk {info['chunk'] + 1}/{info['n_chunks']})"))

    # each batched row drains to its own scenario directory
    def mk_drain():
        return _drain_for(
            rinput, ex, scenario_dir=lambda s: run_dir / "scenario" / str(s))

    drain, resume_point = _restore_drain(mk_drain(), resume_point, mk_drain,
                                         log)
    # the snapshots carry the batched state, the chunk index and the
    # completed chunks' finals
    ckpt = _make_checkpointer(rinput, run_dir, ex_key, log, resume_point,
                              kind="sweep")
    if ckpt is not None:
        ckpt.attach(sink=sink, drain=drain)
    res = _run_profiled(
        ex, rinput, device, log, on_chunk=on_chunk, drain=drain,
        should_stop=_make_should_stop(rinput),
        watchdog=DispatchWatchdog.from_env(log=log), checkpoint=ckpt,
        resume=({"chunk": resume_point.chunk, "state": resume_point.state}
                if resume_point is not None else None))
    clock.stamp("run done")
    if resume_point is not None:
        # the chunks the first leg completed, from their checkpointed
        # finals: the demux below covers the whole sweep
        for ci in range(resume_point.chunk):
            if res.chunk_states[ci] is None:
                res.chunk_states[ci] = state_from_numpy(
                    resume_point.load_final(ci), "cpu")

    # ---- grade and demux one scenario at a time; a chunk's state is
    # released once demuxed (the aggregate ticks are read first). A
    # terminated sweep's never-run chunks hold no state.
    total_ticks = res.ticks
    result = RunResult()
    scen_rows = []
    total_dropped = 0
    any_timed_out = False
    for s, sc in enumerate(scenarios):
        if not res.has_scenario(s):
            continue
        d0 = clock.elapsed()
        row, _ = _demux_scenario(res, s, sc, run_dir / "scenario" / str(s),
                                 ex, rinput, ctx, log, drain=drain)
        clock.add_span("demux", d0, clock.elapsed() - d0)
        for gid, oc in row["outcomes"].items():
            result.outcomes[f"{gid}[s{s}]"] = GroupOutcome(
                ok=oc["ok"], total=oc["total"])
        any_timed_out = any_timed_out or row["timed_out"]
        total_dropped += row["metrics_dropped"]
        scen_rows.append(row)
        if (s + 1) % ex.chunk_size == 0 or s == len(scenarios) - 1:
            res.release_chunk(s // ex.chunk_size)
    g0 = clock.elapsed()
    result.grade()
    if any_timed_out:
        result.outcome = "failure"
    if total_dropped:
        log(f"WARNING: {total_dropped} metric records dropped across the "
            f"sweep (metrics_capacity={cfg.metrics_capacity})")
    wall = res.wall_seconds
    result.journal = {
        "ticks": total_ticks,
        "ticks_simulated": total_ticks,
        # the slowest scenario's, as "ticks"
        "ticks_executed": max((row["ticks_executed"] for row in scen_rows),
                              default=0),
        "event_skip": bool(ex.event_skip),
        "wall_seconds": wall,
        "compile_seconds": compile_s,
        "compile_breakdown": ex.compile_breakdown,
        "compiles": (0 if hbm_report.get("executor_cache") in _WARM_STATUSES
                     else 1),
        "timed_out": any_timed_out,
        "metrics_dropped": total_dropped,
        "scenarios": len(scenarios),
        "scenario_chunk": ex.chunk_size,
        "scenarios_per_sec": (round(len(scenarios) / wall, 3)
                              if wall > 0 else None),
        "sweep": sweep.to_dict(),
        "mesh": {"scenario": 1, "instance": 1},
        "hbm_preflight": hbm_report,
    }
    if lease is not None:
        result.journal["lease"] = lease
    if res.terminated:
        _apply_termination(result, rinput, log, path_label="sweep")
        result.journal["scenarios_demuxed"] = len(scen_rows)
    _journal_checkpoint(result.journal, rinput, ckpt, resume_point,
                        hbm_report.get("executor_cache"))
    _journal_drain(result.journal, hbm_report, drain, log)
    if _faults_disabled(getattr(rinput, "faults", None)):
        result.journal["faults"] = "disabled"
    # the base scenario's replay facts (the table's shape is the same in
    # every scenario) and the arrivals consumed over the demuxed ones
    if ex.replay is not None:
        result.journal["replay"] = {
            **ex.replay.journal(),
            "consumed": sum(row.get("replay_consumed", 0)
                            for row in scen_rows)}
    elif _marked_disabled(rinput, "replay"):
        result.journal["replay"] = "disabled"
    if ex.trace is not None:
        result.journal["trace_events"] = sum(
            row.get("trace_events", 0) for row in scen_rows)
        result.journal["trace_dropped"] = sum(
            row.get("trace_dropped", 0) for row in scen_rows)
    if ex.telemetry is not None:
        result.journal["telemetry_samples"] = sum(
            row.get("telemetry_samples", 0) for row in scen_rows)
        t_clipped = sum(row.get("telemetry_clipped", 0) for row in scen_rows)
        result.journal["telemetry_clipped"] = t_clipped
        if t_clipped:
            log(f"WARNING: {t_clipped} telemetry boundaries clipped across "
                "the sweep (raise [telemetry] interval)")
    elif _marked_disabled(rinput, "telemetry"):
        result.journal["telemetry"] = "disabled"
    if _marked_disabled(rinput, "search"):
        result.journal["search"] = "disabled"
    clock.add_span("grade", g0, clock.elapsed() - g0)
    result.journal["host_spans"] = clock.rollup()
    ok_n = sum(1 for row in scen_rows if row["outcome"] == "success")
    if sink is not None:
        sink.emit({"phase": "done", "outcome": result.outcome,
                   "progress": 1.0, "tick": total_ticks,
                   "max_ticks": cfg.max_ticks, "running": 0,
                   "instances": ctx.n_instances,
                   "scenarios": {"total": len(scenarios), "live": 0,
                                 "done": len(scenarios), "ok": ok_n},
                   "wall_seconds": round(wall, 3)}, force=True)
    _journal_live(result.journal, rinput, sink)
    with open(run_dir / "run.out", "w") as f:
        for m in ex.program.messages:
            f.write(m + "\n")
        for row in scen_rows:
            f.write(f"scenario {row['scenario']} seed={row['seed']} "
                    f"outcome={row['outcome']} ticks={row['ticks']}\n")
        f.write(f"outcome={result.outcome} scenarios={len(scenarios)} "
                f"wall={wall:.3f}s\n")
    _write_json_atomic(run_dir / "sim_summary.json", {
        **result.journal,
        "outcome": result.outcome,
        # the rows win over the journal's scenario count
        "scenarios": scen_rows,
    })
    log(f"sim:torch sweep done: outcome={result.outcome} "
        f"{ok_n}/{len(scenarios)} scenarios ok wall={wall:.3f}s "
        f"(compile {compile_s:.1f}s, one program)")
    _executor_checkin(ex_key, ex, hbm_report, _affinity(rinput))
    return RunOutput(result=result)


class _SearchTerminated(Exception):
    """A search's round ended at a stop request."""


@_clears_term_flag
def run_search_composition(rinput: RunInput, ow=None,
                           device="cuda") -> RunOutput:
    """A composition with an enabled ``[search]`` table: a closed-loop
    breaking-point search (sim/search.py) on ``device``. The driver
    proposes rounds of fixed-width (value, seed) probe batches; round
    0's batch builds and captures one scenario-batched executable, and
    every later round replays the same capture with fresh per-scenario
    tensors (``SweepExecutable.rebind``): the journal's ``compiles``
    counts the builds. The driver is checkpointed after every round, so
    a resumed search replays from the next one. Outputs demux per
    round::

      <run_dir>/round/<r>/scenario/<s>/results.out       probe records
      <run_dir>/round/<r>/scenario/<s>/sim_summary.json  probe journal
      <run_dir>/sim_summary.json    search_rounds, breaking_point,
                                    frontier and compiles roll-up
    """
    from .drain import drain_flags
    from .search import (SearchRebinder, make_driver, objective_value,
                         probe_scenarios, run_search_loop)
    from .sweep import chunk_compiles

    log = ow or (lambda msg: None)
    device = resolve_device(device)
    search = _search_table(rinput)
    driver = make_driver(search)  # validates the table
    run_dir = Path(rinput.run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    resume_point = _load_resume(rinput, run_dir, log)
    start_round = 0
    if resume_point is not None:
        restored = resume_point.load_driver()
        if restored is not None:
            driver = restored
            start_round = len(driver.rounds)
            log(f"search resume: {start_round} completed round(s) "
                "restored from the checkpointed driver")
        else:
            resume_point = None  # not a search's checkpoint: run fresh
    mod, build_fn = _load_build_fn(rinput)
    cfg, ctx = _config(rinput), build_context_from_input(rinput)
    log(f"sim:torch search compiling: case={rinput.test_case} instances="
        f"{ctx.n_instances} strategy={search.strategy} "
        f"param={search.param} grid={len(driver.grid)} "
        f"width={search.width} device={device}")
    batch0 = driver.next_batch()
    if batch0 is None and start_round:
        # the checkpointed search had resolved already: replay it fresh
        # (deterministic: the same verdict)
        driver = make_driver(search)
        start_round = 0
        resume_point = None
        batch0 = driver.next_batch()
    if batch0 is None:
        raise ValueError("search proposed no probes (empty grid?)")
    scenarios0 = probe_scenarios(batch0, search.param)

    clock = StageClock("sim")
    t0 = time.monotonic()
    sink = _make_live_sink(rinput, run_dir, resume_point, kind="search")
    compiles0 = chunk_compiles()
    with clock.span("preflight"):
        ex_key = _executor_cache_key(mod, rinput, cfg, device)
        _verify_resume(resume_point, rinput, ex_key)
        ex, hbm_report, pooled = _batched_executor(
            rinput, ex_key, build_fn, cfg, ctx, scenarios0, device, log,
            "search")
    cfg = ex.config
    faults_in = getattr(rinput, "faults", None)
    if _faults_disabled(faults_in):
        faults_in = None
    rebinder = SearchRebinder(ex, faults_in, build_fn, ctx.groups, cfg,
                              test_case=ctx.test_case,
                              test_run=ctx.test_run,
                              replay=_replay_table(rinput))
    if pooled:
        # the pooled executor holds its last run's probes
        rebinder.rebind(scenarios0)
    lease = _lease_acquire(rinput, hbm_report, device, log)
    with clock.span("warmup_compile"):
        ex.warmup()
    compile_s = time.monotonic() - t0

    telem_objective = search.objective.startswith("telemetry:")
    if telem_objective and ex.telemetry is None:
        raise ValueError(
            f"search objective {search.objective!r} needs the "
            "[telemetry] plane compiled in, but this run samples nothing")
    wall_total = 0.0
    max_ticks_seen = 0
    any_timed_out = False
    cur_round = [0]  # the round being dispatched

    from .checkpoint import DispatchWatchdog
    from .live import boundary_callback

    if sink is not None:
        sink.emit({"phase": "dispatch", "round": 0, "tick": 0,
                   "max_ticks": cfg.max_ticks, "progress": 0.0,
                   "running": ctx.n_instances * search.width,
                   "instances": ctx.n_instances,
                   "grid_size": len(driver.grid),
                   "compile_seconds": round(compile_s, 3)}, force=True)
    clock.reset_lap()
    on_chunk = boundary_callback(
        clock, log, sink, max_ticks=cfg.max_ticks,
        n_instances=ctx.n_instances, event_skip=ex.event_skip,
        batched=True,
        format_line=lambda tick, running, info, live_scen: (
            f"search round {cur_round[0]} tick {tick}: {running} "
            "probe-instance lanes running"),
        # each streamed row names the round being dispatched
        decorate=lambda snap: snap.update(round=cur_round[0]))
    should_stop = _make_should_stop(rinput)
    terminated = [False]
    watchdog = DispatchWatchdog.from_env(log=log)
    ckpt = _make_checkpointer(rinput, run_dir, ex_key, log, resume_point,
                              kind="search")
    if ckpt is not None:
        ckpt.attach(sink=sink)

    def evaluate(r: int, batch) -> None:
        nonlocal wall_total, max_ticks_seen, any_timed_out
        r0 = clock.elapsed()
        cur_round[0] = r
        if r > 0:
            rebinder.rebind(probe_scenarios(batch, search.param))
        clock.reset_lap()
        # each round's probes drain to their own directories (a pad
        # probe's duplicate row is never streamed)
        round_drain = _drain_for(
            rinput, ex,
            scenario_dir=lambda s, r=r: (
                run_dir / "round" / str(r) / "scenario" / str(s)),
            skip_scenarios={p.scenario for p in batch if p.pad})
        res = _run_profiled(ex, rinput, device, log, on_chunk=on_chunk,
                            drain=round_drain, should_stop=should_stop,
                            watchdog=watchdog)
        wall_total += res.wall_seconds
        max_ticks_seen = max(max_ticks_seen, res.ticks)
        scens = ex.scenarios
        for p in batch:
            if p.pad or not res.has_scenario(p.scenario):
                continue
            s = p.scenario
            d0 = clock.elapsed()
            row, scen_res = _demux_scenario(
                res, s, scens[s],
                run_dir / "round" / str(r) / "scenario" / str(s),
                ex, rinput, ctx, log, tag=f"round {r} scenario {s}",
                drain=round_drain)
            clock.add_span("demux", d0, clock.elapsed() - d0)
            any_timed_out = any_timed_out or row["timed_out"]
            telem_recs = ()
            if telem_objective:
                t_lane, t_glob = scen_res.telemetry_records()
                telem_recs = t_lane + t_glob
            p.outcome = row["outcome"]
            p.objective = objective_value(search.objective, row, telem_recs)
            p.failed = p.objective > search.threshold
        for ci in range(ex.n_chunks):
            res.release_chunk(ci)
        vals = sorted({p.value for p in batch if not p.pad})
        fails = sorted({p.value for p in batch if not p.pad and p.failed})
        log(f"search round {r}: probed {search.param}={vals}"
            + (f" failing={fails}" if fails else " (all passing)"))
        # one "round" span a round, and a row as each round lands
        clock.add_span("round", r0, clock.elapsed() - r0)
        if sink is not None:
            sink.emit({"phase": "round", "round": r, "probed": vals,
                       "failing": fails, "state": driver.state_record(),
                       "round_wall_seconds": round(res.wall_seconds, 3)},
                      force=True)
        if res.terminated:
            terminated[0] = True
            raise _SearchTerminated()

    try:
        verdict = run_search_loop(
            driver, evaluate, first_batch=batch0, start_round=start_round,
            on_round=((lambda r, d: ckpt.search_round(r, d))
                      if ckpt is not None else None))
    except _SearchTerminated:
        try:
            partial = driver.verdict()
        except Exception:  # noqa: BLE001 — a driver stopped mid-round
            partial = {}
        verdict = {**partial, "resolved": False, "stopped": "terminated"}
    compiles = chunk_compiles() - compiles0
    wall = wall_total

    result = RunResult()
    # the search's own grade: did it resolve a verdict within its caps
    # (failing probes are its data, not its grade)
    result.outcome = "success" if verdict.get("resolved") else "failure"
    result.journal = {
        "ticks": max_ticks_seen,
        "wall_seconds": wall,
        "compile_seconds": compile_s,
        "compile_breakdown": ex.compile_breakdown,
        "timed_out": any_timed_out,
        "event_skip": bool(ex.event_skip),
        "search": search.to_dict(),
        "search_rounds": driver.rounds,
        "breaking_point": verdict,
        "frontier": driver.frontier(),
        # every round after the first replayed the same build
        "compiles": compiles,
        "rounds": len(driver.rounds),
        "scenarios_probed": driver.scenarios_probed,
        "grid_size": len(driver.grid),
        "exhaustive_scenarios": len(driver.grid) * search.seeds,
        "scenario_chunk": ex.chunk_size,
        "mesh": {"scenario": 1, "instance": 1},
        "hbm_preflight": hbm_report,
    }
    if lease is not None:
        result.journal["lease"] = lease
    if _faults_disabled(getattr(rinput, "faults", None)):
        result.journal["faults"] = "disabled"
    elif ex._fault_plans is not None:
        result.journal["fault_events"] = len(ex._fault_plans[0].timeline)
    if _marked_disabled(rinput, "telemetry"):
        result.journal["telemetry"] = "disabled"
    if terminated[0]:
        _apply_termination(result, rinput, log, path_label="search")
    _journal_checkpoint(result.journal, rinput, ckpt, resume_point,
                        hbm_report.get("executor_cache"))
    if start_round:
        result.journal["resumed_from_round"] = start_round
    trace_drain, telem_drain = drain_flags(rinput)
    trace_drain = trace_drain and ex.trace is not None
    telem_drain = telem_drain and ex.telemetry is not None
    if trace_drain or telem_drain:
        result.journal["drain"] = {"trace": trace_drain,
                                   "telemetry": telem_drain,
                                   "per_round": True}
    result.journal["host_spans"] = clock.rollup()
    if sink is not None:
        sink.emit({"phase": "done", "outcome": result.outcome,
                   "progress": 1.0, "round": len(driver.rounds) - 1,
                   "rounds": len(driver.rounds),
                   "breaking_point": verdict,
                   "scenarios_probed": driver.scenarios_probed,
                   "wall_seconds": round(wall, 3)}, force=True)
    _journal_live(result.journal, rinput, sink)
    with open(run_dir / "run.out", "w") as f:
        for m in ex.program.messages:
            f.write(m + "\n")
        for rec in driver.rounds:
            vals = [p["value"] for p in rec["probes"]]
            fails = [p["value"] for p in rec["probes"] if p["failed"]]
            f.write(f"round {rec['round']}: probed {vals} failing {fails}\n")
        f.write(f"breaking_point: {json.dumps(verdict)}\n")
        f.write(f"outcome={result.outcome} rounds={len(driver.rounds)} "
                f"probed={driver.scenarios_probed}/"
                f"{result.journal['exhaustive_scenarios']} "
                f"compiles={compiles} wall={wall:.3f}s\n")
    _write_json_atomic(run_dir / "sim_summary.json",
                       {"outcome": result.outcome, **result.journal})
    log(f"sim:torch search done: outcome={result.outcome} "
        f"breaking_point={verdict} rounds={len(driver.rounds)} "
        f"probed={driver.scenarios_probed} of "
        f"{result.journal['exhaustive_scenarios']} exhaustive "
        f"(compile {compile_s:.1f}s, {compiles} compile(s))")
    _executor_checkin(ex_key, ex, hbm_report, _affinity(rinput))
    return RunOutput(result=result)
