"""Storm at 10,000 instances on the card: the port's counterpart of
``bench.py``'s headline; with ``--skip``, ``TG_BENCH_SKIP``'s event-skip
run of the sparse-timer plan; with ``--faults``, ``--trace`` or
``--telem``, ``TG_BENCH_FAULTS``', ``TG_BENCH_TRACE``'s and
``TG_BENCH_TELEM``'s runs of storm under the fault, trace and telemetry
planes; with ``--replay`` and ``--drain``, ``TG_BENCH_REPLAY``'s and
``TG_BENCH_DRAIN``'s legs (``replay_main`` and ``drain_main`` of
``bench.py``); with ``--sweep`` and ``--search``, ``TG_BENCH_SWEEP=64``'s
and ``TG_BENCH_SEARCH``'s (``sweep_main`` and ``search_main``); with
``--live``, ``--metrics``, ``--ckpt`` and ``--compile``,
``TG_BENCH_LIVE``'s, ``TG_BENCH_METRICS``', ``TG_BENCH_CKPT``'s and
``TG_BENCH_COMPILE``'s (``live_main``, ``metrics_main``, ``ckpt_main``
and ``compile_main``); with ``--feder``, ``TG_BENCH_FEDER``'s
(``feder_main``).

    python -m testground_tpu_torch.bench [--shaped | --skip | --faults |
                                          --trace | --telem | --replay |
                                          --drain | --sweep | --search |
                                          --live | --metrics | --ckpt |
                                          --compile | --feder]

Runs the storm plan (testground_tpu_torch/plans/benchmarks.py) with
``bench.py``'s ``PARAMS`` and ``SimConfig`` (10 ms quantum, max 100,000
ticks, metrics capacity 16, phase gating) to termination, once. With
``--shaped``, ``TG_BENCH_SHAPED``'s scenario: 50 ms links, 5% loss, SYN
retries with a 1 s per-attempt timeout, churn-tolerant rendezvous and 2%
churn over 5-20 s. Asserts what ``bench.py`` asserts (every instance ok;
shaped: exactly the scheduled victims crashed and every survivor ok;
zero inbox drops, horizon clamps and metric drops) and prints one JSON
line: the wall seconds of the run, its ticks and executed ticks, and the
card's name and power limit from ``nvidia-smi``.

With ``--skip``: the sparsetimer plan at 10,000 instances with
``TG_BENCH_SKIP``'s configuration (50 rounds of a 100 ms period, 1 ms
quantum, metrics capacity 16, max ``max(50,000, rounds * period * 3)``
ticks), run dense and then with event skip. Both runs must end with
every instance ok, and the skipped run's final state must equal the
dense run's on every leaf but the skip's own (``ticks_executed`` and the
occupancy counts, ``EVENT_SKIP_STATE_LEAVES``). Prints both walls and
the executed/simulated tick ratio.

With ``--faults``, ``--trace`` or ``--telem``: storm at 10,000 without
the plane, then under it, each to termination, with the plane-off build
first checked to have the plain build's state leaves (an empty
``[faults]``, a disabled ``[trace]`` or ``[telemetry]``). ``--faults``:
``PARAMS`` with churn-tolerant rendezvous, 3 SYN retries and a 1 s
timeout, under ``FAULT_EVENTS`` (three degrade windows, a partition and
its heal, two 1% kills, one restart); asserts no timeout, at least one
restart, the still-dead victims crashed and every survivor ok.
``--trace``: a 64-slot ring a lane; asserts every instance ok and
events recorded. ``--telem``: interval 100, every probe storm can
record; asserts every instance ok and samples taken. Each prints one
JSON line with ``bench.py``'s fields for the plane (its HLO-identity
field becomes the leaf-set check).

With ``--replay``: storm at 10,000 without a [replay] table and with a
disabled one must build the same state leaves and run the same ops a
tick; then an echo workload at 10,000 instances, ``REPLAY_K`` requests
a lane every ``REPLAY_PERIOD`` ticks, once self-driven (a sleep loop)
and once replayed from a recorded trace through ``on_arrival``, and a
sparse trace (one request every ``REPLAY_SPARSE`` ticks), each with
every lane's ``got == K``; the sparse leg must consume n x K arrivals
and execute under half its ticks. Prints ms per executed tick of both
dense legs (timed after the capture), arrivals/s and the sparse leg's
executed and simulated ticks.

With ``--drain``: sparsetimer at 10,000 (``DRAIN_ROUNDS`` rounds of
``DRAIN_PERIOD_MS``, dense, ``DRAIN_CHUNK``-tick chunks) traced and
sampled. The drain flag must change no state leaf and no tick op; an
undrained run with ``DRAIN_REF_CAP`` slots a lane is the reference
(no drops; its busiest lane at least 8x ``DRAIN_CAP``); then the same
executable with ``DRAIN_CAP`` slots and ``chunk // interval + 2`` sample
rows runs plain and drained (twice each): the drained runs
lose nothing, their streamed events equal the reference's Chrome
events and their streamed samples its telemetry records, and they
capture the loop iteration once a run. Prints the drain's overhead, its
cost a batch and the count-scatter launches of a drained run.

With ``--sweep``: storm at 10,000 with ``PARAMS`` over 64 seeds as one
scenario-batched run (sim/sweep.py: the loop iteration vmapped over the
scenario axis, captured once in a CUDA graph), every scenario asserted
as ``sweep_main`` asserts (all ok, no inbox or metric drop), then a
serial sample of 2 seeds, each its own executable and capture. Prints
scenarios/s batched and serial, the speedup, the capture's seconds and
the capture count (1).

With ``--search``: bisects the cliff case's edge (``x_fail`` = 0.663) at
10,000 over a 257-value grid of x in [0, 1], 8 scenarios a round,
through one sweep executable rebound every round (sim/search.py); asserts
one build and one capture, at most ceil(log2 grid) + 1 rounds and the
edge at the first grid value above 0.663. Prints the rounds, the
scenarios probed and the edge.

With ``--live``, ``--metrics`` or ``--ckpt``: the sparsetimer at 10,000
(50 rounds of 100 ms, dense, ``PLANE_CHUNK``-tick chunks) run in
``PLANE_RUNS`` pairs, plain and under the host plane, in turns (the
overhead is the median pair's): a ``LiveSink`` through
``boundary_callback``; a ``ChunkProfiler`` and an obs counter at every
boundary; a ``Checkpointer`` snapshotting every boundary. Each asserts
what bench.py asserts in the port's terms: the planed build's loop
iteration (``loop_signature``: its ops, and on the card its CUDA graph's
nodes) equal to the plain build's before and after its runs (bench.py:
the same lowered HLO); the live rows one a boundary, their ticks sorted;
the profiler's chunks journaled, both families in the exposition, and
the overhead under 5% when the plain runs take 2 s or more; a resume
from the last snapshot bit-equal to the uninterrupted run. Prints the
overhead against the 5% target.

With ``--compile``: the faultsdemo chaos ladder
(``tools/compile_ladder.py``): each combo's build and capture seconds,
its ops and its graph nodes, each within ``tools/op_budgets.json``.

With ``--feder``: the federation plane (``feder_leg``). (a) A coordinator
and two worker daemons, each a process of its own on the card: the
sparsetimer at 10,000 (``TG_BENCH_TIMER_ROUNDS``, default 20, beats 50
ms apart) prewarmed through the coordinator journals ``miss`` on the
worker it routes to; once that worker's heartbeat names the
composition's affinity digest, its run routes there and journals
``memory_hit`` and ``compiles: 0``, and its outputs equal a cold
in-process run's. (b) Two distinct compositions on a two-worker fleet
against a one-worker fleet: the wall ratio, reported and not asserted
(both workers share the one card). ``TG_BENCH_FEDER_DAEMONS=0`` skips
(b).

The other builders here (``barrier_executable``, ``subtree_executable``)
are those of ``testground_tpu_torch.tools.bench_barrier`` and
``bench_subtree``; ``splitbrain_executable`` builds the splitbrain
plan's partition-policy cases."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .plans import benchmarks, splitbrain
from .sim import BuildContext, GroupSpec, PhaseCtrl, SimConfig
from .sim import compile_program
from .sim.core import EVENT_SKIP_STATE_LEAVES
from .sim.state_io import compare_leaves, flatten, state_to_numpy
from .sim.tables import Faults, Replay, Telemetry, Trace

N = 10_000  # bench.py's instance count
CHUNK_TICKS = 32  # ticks a loop chunk, between host reads of the end

# bench.py's PARAMS, and what TG_BENCH_SHAPED adds
PARAMS = {
    "conn_count": 5,
    "conn_outgoing": 5,
    "conn_delay_ms": 30_000,
    "data_size_kb": 128,
    "storm_quiet_ms": 500,
}
SHAPED_PARAMS = {
    "link_latency_ms": 50,
    "link_loss_pct": 5,
    "churn_tolerant": 1,
    "dial_retries": 3,
    "dial_timeout_ms": 1_000,
}


# bench.py faults_main's knobs: survivors rendezvous past the kills and
# keep dialing through the windows
FAULT_PARAMS = {"churn_tolerant": 1, "dial_retries": 3,
                "dial_timeout_ms": 1_000}
# bench.py faults_main's 8-event timeline
FAULT_EVENTS = [
    {"kind": "degrade", "at_ms": 1_000, "until_ms": 3_000,
     "a": "single", "b": "single", "latency_ms": 20},
    {"kind": "degrade", "at_ms": 2_000, "until_ms": 4_000,
     "a": "single", "b": "single", "loss_pct": 2},
    {"kind": "degrade", "at_ms": 3_000, "until_ms": 5_000,
     "a": "single", "b": "single", "jitter_ms": 5},
    {"kind": "partition", "at_ms": 5_000, "a": "single", "b": "single"},
    {"kind": "heal", "at_ms": 5_500, "a": "single", "b": "single"},
    {"kind": "kill", "at_ms": 6_000, "group": "single", "fraction": 0.01},
    {"kind": "kill", "at_ms": 7_000, "group": "single", "fraction": 0.01},
    {"kind": "restart", "at_ms": 9_000, "group": "single"},
]
TRACE_CAPACITY = 64  # TG_BENCH_TRACE_CAP's default
TELEM_INTERVAL = 100  # TG_BENCH_TELEM_INTERVAL's default
PLANES = ("faults", "trace", "telem")


def fault_timeline(scale: float = 1.0) -> dict:
    """``FAULT_EVENTS`` as a ``[faults]`` dict, every time multiplied by
    ``scale`` (the tests compress it with storm's dial window)."""
    out = []
    for ev in FAULT_EVENTS:
        ev = dict(ev)
        for k in ("at_ms", "until_ms"):
            if k in ev:
                ev[k] = ev[k] * scale
        out.append(ev)
    return {"events": out}


def plane_tables(plane, off=False) -> dict:
    """``compile_program``'s keyword for one plane's table: bench.py's
    (``off``: an empty ``[faults]``, a disabled ``[trace]`` or
    ``[telemetry]``, which must build the plain program)."""
    if plane == "faults":
        return {"faults": Faults() if off
                else Faults.from_dict(fault_timeline())}
    if plane == "trace":
        return {"trace": Trace(enabled=not off, capacity=TRACE_CAPACITY)}
    if plane == "telem":
        return {"telemetry": Telemetry(enabled=not off,
                                       interval=TELEM_INTERVAL)}
    raise ValueError(f"unknown plane {plane!r}; expected one of {PLANES}")


def _case_executable(case, n, params, cfg, device, plan=benchmarks,
                     **tables):
    """The ``plan`` module's ``case`` at ``n`` instances in one group with
    ``params``, built with ``cfg`` on ``device`` (``tables``: the
    ``faults``/``trace``/``telemetry`` tables)."""
    ctx = BuildContext(
        [GroupSpec("single", 0, n, {k: str(v) for k, v in params.items()})],
        test_case=case,
        test_run="bench",
    )
    return compile_program(plan.testcases[case], ctx, cfg, device=device,
                           **tables)


def storm_config(shaped=False, chunk_ticks=CHUNK_TICKS, seed=0) -> SimConfig:
    """bench.py's storm SimConfig (``shaped``: with TG_BENCH_SHAPED's
    churn)."""
    cfg = SimConfig(
        quantum_ms=10.0,
        chunk_ticks=chunk_ticks,
        max_ticks=100_000,
        metrics_capacity=16,
        phase_gating=True,
        seed=seed,
    )
    if shaped:
        cfg.churn_fraction = 0.02
        cfg.churn_start_ms = 5_000.0
        cfg.churn_end_ms = 20_000.0
    return cfg


def storm_executable(n, device="cuda", shaped=False, chunk_ticks=CHUNK_TICKS,
                     planes=(), off=False, fault_params=None, seed=0):
    """bench.py's storm executable at ``n`` instances on ``device``;
    ``planes`` (of "faults", "trace", "telem") add those planes' bench
    tables (``off``: their empty or disabled forms), and
    ``fault_params`` (by default: an active fault plane)
    ``FAULT_PARAMS``."""
    params = dict(PARAMS, **(SHAPED_PARAMS if shaped else {}))
    tables = {}
    for plane in planes:
        tables.update(plane_tables(plane, off))
    if fault_params is None:
        fault_params = "faults" in planes and not off
    if fault_params:
        params.update(FAULT_PARAMS)
    cfg = storm_config(shaped, chunk_ticks, seed)
    ex = _case_executable("storm", n, params, cfg, device, **tables)
    if shaped:
        assert not ex.program.net_spec.fixed_next_tick, (
            "shaped storm must exercise the wheel path")
    return ex


def barrier_executable(n, iters, device="cuda"):
    """tools/bench_barrier.py's barrier executable: ``iters`` rounds of
    five subset barriers, 1 ms quantum, a metrics ring that holds all
    5 x ``iters`` records (+ 8), max 600,000 ticks."""
    cfg = SimConfig(quantum_ms=1.0, chunk_ticks=CHUNK_TICKS,
                    max_ticks=600_000, metrics_capacity=5 * iters + 8)
    return _case_executable("barrier", n, {"barrier_iterations": iters}, cfg,
                            device)


def subtree_executable(n, iters, device="cuda"):
    """tools/bench_subtree.py's subtree executable: ``iters`` items a size
    class, 1 ms quantum, max 600,000 ticks."""
    cfg = SimConfig(quantum_ms=1.0, chunk_ticks=CHUNK_TICKS,
                    max_ticks=600_000)
    return _case_executable("subtree", n, {"subtree_iterations": iters}, cfg,
                            device)


def splitbrain_executable(n, device="cuda", case="drop-sampled"):
    """The splitbrain plan's ``case`` at ``n`` instances (the ``*-sampled``
    cases with their default 8 probes a node) with the plan tests'
    SimConfig: 1 ms quantum, max 100,000 ticks."""
    cfg = SimConfig(chunk_ticks=CHUNK_TICKS, max_ticks=100_000)
    return _case_executable(case, n, {}, cfg, device, plan=splitbrain)


def check_splitbrain(res, n):
    """The splitbrain plan's own oracle, read back: every instance ok
    (each asserted its probes' outcomes against the policy), and the
    per-instance ``errors`` records; returns a summary."""
    ok = int((res.statuses()[:n] == 1).sum())
    assert ok == n, f"only {ok}/{n} instances ok"
    errors = [r["value"] for r in res.metrics_records()
              if r["name"] == "errors"]
    assert len(errors) == n, (len(errors), n)
    out = {"ok": ok, "errors": int(sum(errors)),
           "metrics_dropped": res.metrics_dropped(),
           "net_dropped": res.net_dropped(),
           "egress_overflow": res.net_egress_overflow(),
           "egress_abandoned": res.net_egress_abandoned(),
           "egress_deferred": res.net_egress_deferred()}
    for k in ("metrics_dropped", "net_dropped", "egress_overflow",
              "egress_abandoned"):
        assert out[k] == 0, (k, out[k])
    return out


SKIP_ROUNDS = 50  # TG_BENCH_TIMER_ROUNDS' default
SKIP_PERIOD_MS = 100  # TG_BENCH_TIMER_PERIOD_MS' default


def sparsetimer_executable(n, event_skip, device="cuda", rounds=SKIP_ROUNDS,
                           chunk_ticks=CHUNK_TICKS):
    """bench.py's TG_BENCH_SKIP sparsetimer executable, dense
    (``event_skip=False``) or skipped (the live, metrics and checkpoint
    legs run it dense in ``PLANE_CHUNK``-tick chunks)."""
    cfg = SimConfig(quantum_ms=1.0, chunk_ticks=chunk_ticks,
                    max_ticks=max(50_000, rounds * SKIP_PERIOD_MS * 3),
                    metrics_capacity=16, event_skip=event_skip)
    return _case_executable(
        "sparsetimer", n,
        {"timer_rounds": rounds, "timer_period_ms": SKIP_PERIOD_MS}, cfg,
        device)


def check_skip(dense, skipped, n):
    """TG_BENCH_SKIP's assertions on a dense and a skipped sparsetimer
    run: all ok in both, and the skipped run's state equal to the dense
    run's on every leaf but the skip's own; returns the number of leaves
    compared."""
    for res in (dense, skipped):
        ok = int((res.statuses()[:n] == 1).sum())
        assert ok == n, f"only {ok}/{n} instances ok"
    assert skipped.ticks == dense.ticks, (skipped.ticks, dense.ticks)
    leaves = compare_leaves(flatten(state_to_numpy(dense.state)),
                            flatten(state_to_numpy(skipped.state)),
                            "skipped vs dense", skip=EVENT_SKIP_STATE_LEAVES)
    assert skipped.skip_ratio < 1.0, "sparse-timer plan skipped nothing"
    return leaves


def check(res, n, shaped):
    """bench.py's assertions on a finished run; returns a summary."""
    statuses = res.statuses()[:n]
    out = {"ok": int((statuses == 1).sum())}
    if shaped:
        assert not res.timed_out(), f"stalled at {res.ticks} ticks"
        victims = res.state["kill_tick"].cpu().numpy()[:n] >= 0
        out["victims"] = int(victims.sum())
        assert out["victims"] > 0, "churn schedule empty"
        assert (statuses[victims] == 3).all(), "victim not crashed"
        assert (statuses[~victims] == 1).all(), "survivor not ok"
    else:
        assert out["ok"] == n, f"only {out['ok']}/{n} instances ok"
    out["net_dropped"] = res.net_dropped()
    assert out["net_dropped"] == 0, f"{out['net_dropped']} messages dropped"
    out["horizon_clamped"] = res.net_horizon_clamped()
    assert out["horizon_clamped"] == 0, (
        f"{out['horizon_clamped']} messages clamped (delay wheel too short)")
    out["metrics_dropped"] = res.metrics_dropped()
    assert out["metrics_dropped"] == 0, (
        f"{out['metrics_dropped']} metric records dropped")
    recs = res.metrics_records()
    out["bytes_sent"] = float(sum(r["value"] for r in recs
                                  if r["name"] == "bytes.sent"))
    out["bytes_read"] = float(sum(r["value"] for r in recs
                                  if r["name"] == "bytes.read"))
    if not shaped:
        assert out["bytes_read"] == out["bytes_sent"], (
            out["bytes_read"], out["bytes_sent"])
    return out


def check_plane(res, n, plane):
    """bench.py's assertions on a storm run under ``plane``; returns a
    summary. ``faults``: no timeout, at least one restart, the
    still-dead victims (a rejoin clears its lane's kill_tick) crashed
    and every survivor, the restarted included, ok. ``trace``: all ok,
    events recorded. ``telem``: all ok, samples taken."""
    statuses = res.statuses()[:n]
    out = {"ok": int((statuses == 1).sum())}
    if plane == "faults":
        assert not res.timed_out(), (
            f"faulted storm stalled at {res.ticks} ticks")
        still_dead = res.state["kill_tick"].cpu().numpy()[:n] >= 0
        restarted = int(res.state["restarts"].cpu().numpy()[:n].sum())
        assert restarted >= 1, "restart event never fired"
        assert (statuses[still_dead] == 3).all(), "dead victim not crashed"
        assert (statuses[~still_dead] == 1).all(), "survivor not ok"
        out.update(victims=int(still_dead.sum()) + restarted,
                   restarted=restarted, still_dead=int(still_dead.sum()))
    else:
        assert out["ok"] == n, f"only {out['ok']}/{n} ok"
    if plane == "trace":
        out.update(trace_events=res.trace_events_total(),
                   trace_dropped=res.trace_dropped_total())
        assert out["trace_events"] > 0, "traced storm recorded no events"
    if plane == "telem":
        spec = res.executable.telemetry
        out.update(telemetry_samples=res.telemetry_samples(),
                   telemetry_clipped=res.telemetry_clipped(),
                   sample_points=res.telemetry_samples()
                   * (spec.k_lane * n + len(spec.glob)))
        assert out["telemetry_samples"] > 0, "sampled storm took no samples"
    return out


def same_leaves(a, b) -> bool:
    """The two executables build the same state leaves (names, shapes,
    dtypes): the port's form of the planes' zero-overhead promise."""
    fa, fb = (flatten(state_to_numpy(ex.init_state())) for ex in (a, b))
    return set(fa) == set(fb) and all(
        fa[k].shape == fb[k].shape and fa[k].dtype == fb[k].dtype
        for k in fa)


def device_line() -> str:
    """``name, power limit`` of the card as nvidia-smi gives them."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def skip_main() -> int:
    runs = {}
    for event_skip in (False, True):
        ex = sparsetimer_executable(N, event_skip, "cuda")
        ex.tick_fn()  # built before the clock starts
        runs[event_skip] = ex.run()
    dense, skipped = runs[False], runs[True]
    leaves = check_skip(dense, skipped, N)
    print(json.dumps({
        "metric": f"event-skip wall-clock speedup on sparse-timer at {N} "
                  "instances",
        "value": dense.wall_seconds / skipped.wall_seconds,
        "unit": "x",
        "dense_wall_seconds": dense.wall_seconds,
        "skip_wall_seconds": skipped.wall_seconds,
        "ticks_simulated": skipped.ticks,
        "ticks_executed": skipped.ticks_executed,
        "skip_ratio": skipped.skip_ratio,
        "equal_leaves": leaves,
        "timer_rounds": SKIP_ROUNDS,
        "timer_period_ms": SKIP_PERIOD_MS,
        "device": device_line(),
    }))
    return 0


_PLANE_LINE = {
    # plane: (metric, on/off ms keys, ticks read)
    "faults": (f"fault-plane tick overhead at {N} instances (8-event "
               "timeline)", "baseline_ms_per_tick", "faulted_ms_per_tick",
               "ticks"),
    "trace": (f"trace-plane tick overhead at {N} instances (capacity "
              f"{TRACE_CAPACITY})", "untraced_ms_per_tick",
              "traced_ms_per_tick", "ticks_executed"),
    "telem": (f"telemetry-plane tick overhead at {N} instances (interval "
              f"{TELEM_INTERVAL})", "unsampled_ms_per_tick",
              "sampled_ms_per_tick", "ticks_executed"),
}


def plane_main(plane) -> int:
    """storm at ``N`` without ``plane`` (its empty or disabled table),
    then under it; one JSON line of bench.py's fields for the plane."""
    # the baseline keeps the plane's params (bench.py's, too)
    fp = plane == "faults"
    ex_off = storm_executable(N, "cuda", planes=(plane,), off=True,
                              fault_params=fp)
    plain = storm_executable(N, "cuda", fault_params=fp)
    assert same_leaves(ex_off, plain), f"an off [{plane}] table added state"
    del plain
    runs = {}
    for off in (True, False):
        ex = ex_off if off else storm_executable(N, "cuda", planes=(plane,))
        ex.tick_fn()  # built before the clock starts
        runs[off] = ex.run()
    base, res = runs[True], runs[False]
    summary = check_plane(res, N, plane)
    metric, k_off, k_on, ticks = _PLANE_LINE[plane]
    ms = {off: r.wall_seconds * 1e3 / max(1, getattr(r, ticks))
          for off, r in runs.items()}
    line = {
        "metric": metric,
        "value": (ms[False] - ms[True]) / ms[True] * 100.0,
        "unit": "percent",
        "vs_baseline": None,
        "leaves_identical_when_off": True,
        k_off: ms[True],
        k_on: ms[False],
    }
    if plane == "faults":
        line.update(baseline_ticks=base.ticks, faulted_ticks=res.ticks,
                    victims=summary["victims"],
                    restarted=summary["restarted"])
    elif plane == "trace":
        line.update(trace_events=summary["trace_events"],
                    trace_dropped=summary["trace_dropped"],
                    events_per_sec=summary["trace_events"]
                    / max(res.wall_seconds, 1e-9),
                    traced_wall_seconds=res.wall_seconds)
    else:
        line.update(telemetry_samples=summary["telemetry_samples"],
                    telemetry_clipped=summary["telemetry_clipped"],
                    sample_points=summary["sample_points"],
                    samples_per_sec=summary["telemetry_samples"]
                    / max(res.wall_seconds, 1e-9),
                    sampled_wall_seconds=res.wall_seconds)
    line["device"] = device_line()
    print(json.dumps(line))
    return 0


# ------------------------------------------------------------ replay leg

REPLAY_K = 32  # TG_BENCH_REPLAY_K's default: requests a lane
REPLAY_PERIOD = 50  # TG_BENCH_REPLAY_PERIOD's default, ticks
REPLAY_SPARSE = 1_000  # TG_BENCH_REPLAY_SPARSE's default, ticks


def write_echo_trace(path, n, K=REPLAY_K, period=REPLAY_PERIOD) -> str:
    """bench.py replay_main's recorded workload: every lane gets a request
    (op 1) at ticks period, 2·period, ..., K·period."""
    with open(path, "w") as f:
        f.write(json.dumps({"replay_version": 1}) + "\n")
        for lane in range(n):
            for k in range(K):
                f.write(json.dumps({"lane": lane, "tick": (k + 1) * period,
                                    "op": 1}) + "\n")
    return str(path)


def echo_replayed(b):
    """The replayed echo: count each arrival as on_arrival consumes it."""
    got = b.declare("got", (), torch.int32, 0)

    def handler(env, mem, due):
        mem = dict(mem)
        mem[got] = mem[got] + due.to(torch.int32)
        return mem, PhaseCtrl()

    b.on_arrival(handler)
    b.end_ok()


def echo_self(K=REPLAY_K):
    """The self-driven echo: K rounds of a REPLAY_PERIOD ms sleep and a
    count."""

    def build(b):
        got = b.declare("got", (), torch.int32, 0)
        h = b.loop_begin(K)
        b.sleep_ms(REPLAY_PERIOD)  # 1 ms quantum: REPLAY_PERIOD ticks

        def bump(env, mem):
            mem = dict(mem)
            mem[got] = mem[got] + 1
            return mem, PhaseCtrl(advance=1)

        b.phase(bump, "bump")
        b.loop_end(h)
        b.end_ok()

    return build


def echo_executable(n, device="cuda", trace_path=None, K=REPLAY_K,
                    event_skip=None):
    """replay_main's echo at ``n`` instances: replayed from the recorded
    trace at ``trace_path`` (a [replay] table), or self-driven without
    one. replay_main's SimConfig: 1 ms quantum, metrics capacity 8, max
    (K + 2)·max(REPLAY_PERIOD, REPLAY_SPARSE) + 1,000 ticks."""
    cfg = SimConfig(quantum_ms=1.0, chunk_ticks=CHUNK_TICKS,
                    max_ticks=(K + 2) * max(REPLAY_PERIOD, REPLAY_SPARSE)
                    + 1_000,
                    metrics_capacity=8, event_skip=event_skip)
    ctx = BuildContext([GroupSpec("single", 0, n, {})], test_case="echo",
                       test_run="bench-replay")
    if trace_path is None:
        return compile_program(echo_self(K), ctx, cfg, device=device)
    return compile_program(echo_replayed, ctx, cfg, device=device,
                           replay=Replay(trace=str(trace_path)))


def check_echo(res, n):
    """Every lane counted its REPLAY_K requests."""
    got = res.state["mem"]["got"].cpu().numpy()[:n]
    assert (got == REPLAY_K).all(), (
        f"echo workload dropped requests: {got.min()}..{got.max()} of "
        f"{REPLAY_K}")
    return {"ok": int((res.statuses()[:n] == 1).sum())}


class OpLog(TorchDispatchMode):
    """Records the name of every torch op dispatched under it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def tick_ops(ex, iterations=2) -> list:
    """The names of the ops ``iterations`` loop iterations of ``ex``
    dispatch from its initial state (the port's form of "the same
    compiled tick")."""
    st = ex.init_state()
    # the build-time probe, and the constants a first tick caches, stay
    # outside the log
    ex.guarded_tick(ex.init_state())
    with torch.no_grad(), OpLog() as log:
        for _ in range(iterations):
            st = ex.guarded_tick(st)
    return log.ops


# cudaGraphNodeType values (CUDA runtime API)
GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
                    4: "graph", 5: "empty"}


def graph_node_counts(ex) -> dict:
    """The nodes of the CUDA graph ``SimExecutable.stepper`` captures for
    ``ex`` on the card (one loop iteration and its copy back into the
    state), by type: what every replay launches. Read from the kept
    graph with the CUDA runtime's ``cudaGraphGetNodes`` /
    ``cudaGraphNodeGetType``."""
    import ctypes

    from .sim import core

    st = ex.init_state()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(core.STEPPER_WARMUP):
            ex.guarded_tick(st)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    ins = list(core._leaves(st))
    with torch.cuda.graph(graph):
        out = ex.guarded_tick(st)
        for dst, src in zip(ins, core._leaves(out)):
            dst.copy_(src)
    rt = ctypes.CDLL(f"libcudart.so.{torch.version.cuda.split('.')[0]}")

    def call(fn, *args):
        rc = getattr(rt, fn)(*args)
        if rc != 0:
            raise RuntimeError(f"{fn} returned CUDA error {rc}")

    g = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    call("cudaGraphGetNodes", g, None, ctypes.byref(count))
    nodes = (ctypes.c_void_p * count.value)()
    call("cudaGraphGetNodes", g, nodes, ctypes.byref(count))
    kinds: dict = {}
    for node in nodes:
        kind = ctypes.c_int(-1)
        call("cudaGraphNodeGetType", ctypes.c_void_p(node),
             ctypes.byref(kind))
        name = GRAPH_NODE_TYPES.get(kind.value, str(kind.value))
        kinds[name] = kinds.get(name, 0) + 1
    return kinds


def loop_signature(ex) -> dict:
    """What one loop iteration of ``ex`` runs, the port's form of the
    JAX package's lowered dispatcher: the ops two iterations dispatch
    (``tick_ops``) and, on the card, the nodes of the CUDA graph its
    stepper captures (``graph_node_counts``)."""
    sig = {"ops": tick_ops(ex)}
    if ex.device.type == "cuda":
        sig["graph_nodes"] = graph_node_counts(ex)
    return sig


def signature_summary(sig) -> dict:
    """A signature's sizes: its op count and graph nodes by type."""
    return {"ops": len(sig["ops"]), **sig.get("graph_nodes", {})}


def assert_same_loop(sig, ref, what) -> None:
    """``sig`` (``loop_signature``) equal to ``ref``; the error names
    ``what`` and both sizes."""
    if sig != ref:
        raise AssertionError(
            f"{what} changed the loop iteration: {signature_summary(sig)} "
            f"against {signature_summary(ref)}")


def replay_off_storm(n, device="cuda"):
    """storm @ ``n`` with bench.py's params and a disabled [replay] table
    naming a file that does not exist (never read), beside the plain
    build: (off, plain)."""
    plain = storm_executable(n, device)
    off = compile_program(
        benchmarks.storm, plain.ctx, plain.config, device=device,
        replay=Replay(trace="never-read.jsonl", enabled=False))
    return off, plain


def replay_leg(n=N, device="cuda") -> dict:
    """replay_main's legs at ``n`` on ``device`` (asserting what it
    asserts); returns its fields and the three results."""
    off, plain = replay_off_storm(n, device)
    assert off.replay is None and same_leaves(off, plain), (
        "a disabled [replay] table added state")
    assert tick_ops(off) == tick_ops(plain), (
        "a disabled [replay] table changed the tick's ops")
    del off, plain
    runs, launches = {}, {}
    with tempfile.TemporaryDirectory(prefix="tg-bench-replay-") as tmp:
        for leg, trace in (
            ("self", None),
            ("replayed", write_echo_trace(Path(tmp) / "dense.jsonl", n)),
            ("sparse", write_echo_trace(Path(tmp) / "sparse.jsonl", n,
                                        period=REPLAY_SPARSE)),
        ):
            ex = echo_executable(n, device, trace)
            ex.tick_fn()  # built before the clock starts
            kernel_launches(reset=True)
            runs[leg] = ex.run()
            launches[leg] = kernel_launches()
            check_echo(runs[leg], n)
    ms = {k: r.wall_seconds * 1e3 / max(1, r.ticks_executed)
          for k, r in runs.items()}
    sp = runs["sparse"]
    arrivals = sp.replay_consumed()
    assert arrivals == n * REPLAY_K, (arrivals, n * REPLAY_K)
    assert sp.skip_ratio < 0.5, (
        f"sparse replay executed {sp.skip_ratio:.2%} of its ticks: the "
        "next-arrival term of the event-horizon min is not jumping")
    return {
        "metric": f"replay-plane tick overhead at {n} instances "
                  f"({REPLAY_K} requests/lane)",
        "value": (ms["replayed"] - ms["self"]) / ms["self"] * 100.0,
        "unit": "percent",
        "vs_baseline": None,
        "leaves_and_ops_identical_off": True,
        "selfdriven_ms_per_tick": ms["self"],
        "replayed_ms_per_tick": ms["replayed"],
        "arrivals": arrivals,
        "arrivals_per_sec": arrivals / max(sp.wall_seconds, 1e-9),
        "skip_ratio_sparse": sp.skip_ratio,
        "sparse_ticks_executed": sp.ticks_executed,
        "sparse_ticks_simulated": sp.ticks,
        # the stepper's warm-up and capture, outside every wall above
        "capture_seconds": {k: r.capture_seconds for k, r in runs.items()},
        "launches": launches,
        "results": runs,
    }


def replay_main(n=N) -> int:
    line = replay_leg(n)
    line.pop("results")
    line["device"] = device_line()
    print(json.dumps(line))
    return 0


# ------------------------------------------------------------- drain leg

DRAIN_ROUNDS = 40  # TG_BENCH_TIMER_ROUNDS' default in drain_main
DRAIN_PERIOD_MS = 50  # TG_BENCH_TIMER_PERIOD_MS' default in drain_main
DRAIN_CHUNK = 100  # TG_BENCH_CHUNK's default in drain_main
DRAIN_CAP = 16  # TG_BENCH_DRAIN_CAP's default: slots a lane, drained
DRAIN_REF_CAP = 1_024  # TG_BENCH_DRAIN_REF_CAP's default: the reference
DRAIN_INTERVAL = 100  # TG_BENCH_DRAIN_TELEM_INTERVAL's default
# the drained sample buffer: one chunk's boundaries and slack
DRAIN_SAMPLES = max(2, DRAIN_CHUNK // DRAIN_INTERVAL + 2)


def drain_executable(n, device="cuda", capacity=DRAIN_CAP, drain=True,
                     samples=DRAIN_SAMPLES, rounds=DRAIN_ROUNDS,
                     chunk_ticks=DRAIN_CHUNK):
    """drain_main's sparsetimer at ``n``, dense, traced with ``capacity``
    slots a lane and sampled every DRAIN_INTERVAL ticks into ``samples``
    rows (0: the whole run), the tables' drain flag set to ``drain``;
    max max(20,000, rounds·period·3) ticks."""
    cfg = SimConfig(quantum_ms=1.0, chunk_ticks=chunk_ticks,
                    max_ticks=max(20_000, rounds * DRAIN_PERIOD_MS * 3),
                    metrics_capacity=16, event_skip=False)
    return _case_executable(
        "sparsetimer", n,
        {"timer_rounds": rounds, "timer_period_ms": DRAIN_PERIOD_MS}, cfg,
        device, trace=Trace(capacity=capacity, drain=drain),
        telemetry=Telemetry(interval=DRAIN_INTERVAL, drain=drain,
                            samples=samples))


def drained_run(ex, out_dir):
    """``ex`` run to the end with both planes drained into ``out_dir`` and
    finalized: (result, drain)."""
    from .sim.drain import ObserverDrain

    d = ObserverDrain(ex, trace_drain=True, telem_drain=True,
                      run_dir=out_dir)
    res = ex.run(drain=d)
    d.finalize(res.state, fault_plan=ex.faults)
    return res, d


def check_drained(ref, out_dir, stats):
    """The drained stream against the undrained reference ``ref``: no
    event dropped and no sample clipped; the streamed events equal the
    reference's Chrome events, the streamed samples its telemetry
    records. Returns the number of events and records compared."""
    from .sim.drain import EVENTS_FILE, RESULTS_FILE

    assert stats["trace_dropped"] == 0, (
        f"{stats['trace_dropped']} events dropped under drain")
    assert stats["telemetry_clipped"] == 0, (
        f"{stats['telemetry_clipped']} boundaries clipped under drain")
    lines = [json.loads(ln) for ln in
             (Path(out_dir) / EVENTS_FILE).read_text().splitlines()]
    got_ev = [e for e in lines if e.get("ph") != "M"]
    ref_ev = [e for e in ref.chrome_trace()["traceEvents"]
              if e.get("ph") != "M"]
    assert got_ev == ref_ev, "drained trace stream != undrained demux"
    lane, glob = ref.telemetry_records()
    got_t = [json.loads(ln) for ln in
             (Path(out_dir) / RESULTS_FILE).read_text().splitlines()]

    def key(r):
        return (r["virtual_time_s"], r["name"], str(r["instance"]))

    assert sorted(got_t, key=key) == sorted(lane + glob, key=key), (
        "drained telemetry stream != undrained demux")
    return len(got_ev), len(got_t)


def kernel_launches(reset=False) -> dict:
    """The launch counts of the three kernel wrappers (``reset``: set
    them to 0 first)."""
    from .sim import count_scatter as csc
    from .sim import deliver_front as df
    from .sim import ring_merge as rm

    if reset:
        df.reset_counters()
        rm.merge.launches.reset()
        csc.scatter_add.launches.reset()
    return {"deliver_front": int(df.front_lanes.launches),
            "ring_merge": int(rm.merge.launches),
            "count_scatter": int(csc.scatter_add.launches)}


def drain_leg(n=N, device="cuda", runs=2, rounds=DRAIN_ROUNDS) -> dict:
    """drain_main's legs at ``n`` on ``device`` (asserting what it
    asserts), ``runs`` runs each plain and drained; returns its fields."""
    # (a) the drain flag builds the same state and runs the same ops
    # (the whole-run sample buffer: a fixed depth needs the drain)
    flag_off = drain_executable(n, device, drain=False, samples=0,
                                rounds=rounds)
    flag_on = drain_executable(n, device, samples=0, rounds=rounds)
    assert same_leaves(flag_off, flag_on)
    assert tick_ops(flag_off) == tick_ops(flag_on), (
        "the drain flag changed the tick's ops")
    del flag_off, flag_on
    # (b) the undrained reference with rings for the whole run
    ex_big = drain_executable(n, device, capacity=DRAIN_REF_CAP,
                              drain=False, samples=0, rounds=rounds)
    ex_big.tick_fn()
    ref = ex_big.run()
    ok = int((ref.statuses()[:n] == 1).sum())
    assert ok == n, f"only {ok}/{n} ok"
    assert ref.trace_dropped_total() == 0, "reference ring too small"
    per_lane = ref.state["trace"]["trace_cnt"].cpu().numpy()[:n]
    overflow_x = float(per_lane.max()) / DRAIN_CAP
    assert overflow_x >= 8.0, (
        f"event volume only {overflow_x:.1f}x the drained capacity")
    # (c) one small executable, run plain and drained
    ex = drain_executable(n, device, rounds=rounds)
    ex.tick_fn()
    walls_plain = [ex.run().wall_seconds for _ in range(runs)]
    walls_drain = []
    with tempfile.TemporaryDirectory(prefix="tg-bench-drain-") as tmp:
        for i in range(runs):
            dest = Path(tmp) / str(i)
            captures = ex.captures
            kernel_launches(reset=True)
            res, d = drained_run(ex, dest)
            launches = kernel_launches()
            walls_drain.append(res.wall_seconds)
            # the boundaries drain around the one captured iteration
            if ex.device.type == "cuda":
                assert ex.captures == captures + 1, (ex.captures, captures)
        stats = d.stats()
        events, records = check_drained(ref, dest, stats)
    wall_plain, wall_drain = min(walls_plain), min(walls_drain)
    return {
        "metric": f"drain-plane per-chunk overhead at {n} instances "
                  f"(capacity {DRAIN_CAP}, chunk {DRAIN_CHUNK})",
        "value": (wall_drain - wall_plain) / wall_plain * 100.0,
        "unit": "percent",
        "vs_baseline": None,
        "overhead_target_pct": 5.0,
        "leaves_and_ops_identical_drain_flag": True,
        "stream_equal_to_undrained": True,
        "trace_dropped": 0,
        "telemetry_clipped": 0,
        "overflow_factor": overflow_x,
        "drained_events": stats["trace_events"],
        "drained_samples": stats["telemetry_samples"],
        "drain_batches": stats["drain_batches"],
        "events_compared": events,
        "records_compared": records,
        "undrained_wall_seconds": wall_plain,
        "drained_wall_seconds": wall_drain,
        "per_batch_ms": (wall_drain - wall_plain) * 1e3
        / max(1, stats["drain_batches"]),
        "ticks": res.ticks,
        "ticks_executed": res.ticks_executed,
        "launches": launches,
        "reference_wall_seconds": ref.wall_seconds,
    }


def drain_main(n=N) -> int:
    line = drain_leg(n)
    line["device"] = device_line()
    print(json.dumps(line))
    return 0


# ------------------------------------- the live, metrics and checkpoint legs

PLANE_ROUNDS = 50  # TG_BENCH_TIMER_ROUNDS' default in live/metrics/ckpt_main
PLANE_CHUNK = 128  # TG_BENCH_CHUNK's default there
# pairs of runs, plain and planed: bench.py's TG_BENCH_RUNS is 2, but
# the median of 3 pairs survives one flip of the card's speed
# (``timed_pair``)
PLANE_RUNS = 3


def host_plane_pair(n, device="cuda", rounds=PLANE_ROUNDS):
    """Two builds of the host planes' sparsetimer at ``n`` (dense,
    ``PLANE_CHUNK``-tick chunks, ``rounds`` beats of ``SKIP_PERIOD_MS``):
    one run plain, one run under a plane. A host plane has no build
    input, so the second's loop iteration must be the first's. Returns
    (plain, planed, the plain one's ``loop_signature``)."""
    off, on = (sparsetimer_executable(n, False, device, rounds,
                                      chunk_ticks=PLANE_CHUNK)
               for _ in range(2))
    ref = loop_signature(off)
    assert_same_loop(loop_signature(on), ref, "a second build")
    return off, on, ref


def timed_pair(ex_off, ex_on, n, runs, hooks) -> dict:
    """``ex_off`` and ``ex_on`` warmed up (built, and on the card
    captured), then run in ``runs`` back-to-back pairs, in turns (off
    then on, on then off, ...), ``ex_on`` with ``hooks()``'s keyword
    arguments, every instance ok each time. The card's speed flips
    between two levels some 12% apart and holds each for many runs, so
    the plane's cost is read within each pair and the overhead is the
    median pair's: one flip spoils one pair, not the figure. Returns
    the least walls (``off``, ``on``), the median pair's ``overhead_pct``
    and ``extra_seconds``, the ``pairs``' walls, the warm-ups'
    ``warmup_seconds`` and the last results (``last_off``,
    ``last_on``)."""
    import statistics

    out = {"warmup_seconds": ex_off.warmup() + ex_on.warmup(), "pairs": []}
    for i in range(runs):
        walls = {}
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            ex = ex_on if on else ex_off
            res = ex.run(**(hooks() if on else {}))
            ok = int((res.statuses()[:n] == 1).sum())
            assert ok == n, f"only {ok}/{n} ok"
            walls[on] = res.wall_seconds
            out["last_on" if on else "last_off"] = res
        out["pairs"].append((walls[False], walls[True]))
    out["off"] = min(off for off, _ in out["pairs"])
    out["on"] = min(on for _, on in out["pairs"])
    out["overhead_pct"] = statistics.median(
        (on - off) / off * 100.0 for off, on in out["pairs"])
    out["extra_seconds"] = statistics.median(
        on - off for off, on in out["pairs"])
    return out


def boundary_hook(ex, n, sink=None, profiler=None):
    """The runner's ``on_chunk`` (sim/live.py ``boundary_callback``) over
    a fresh clock, logging nothing."""
    from .sim.live import boundary_callback
    from .utils.timing import StageClock

    clock = StageClock()
    clock.reset_lap()
    return boundary_callback(
        clock, lambda msg: None, sink, max_ticks=ex.config.max_ticks,
        n_instances=n, event_skip=ex.event_skip,
        format_line=lambda tick, running, info, live_scen: "",
        profiler=profiler)


def live_leg(n=N, device="cuda", runs=PLANE_RUNS, rounds=PLANE_ROUNDS):
    """bench.py live_main at ``n`` on ``device``: the sparsetimer run
    in ``runs`` pairs (``timed_pair``), plain and with a ``LiveSink`` attached
    through ``boundary_callback``. Asserts the streamed build's loop
    iteration equal to the plain one's before and after its runs, one
    progress row a boundary (at least one), the rows' ticks sorted and
    every instance ok. Returns its fields and the last run's rows."""
    from .metrics.viewer import read_progress
    from .sim.live import LiveSink

    ex_off, ex_live, ref = host_plane_pair(n, device, rounds)
    last = {}
    with tempfile.TemporaryDirectory(prefix="tg-bench-live-") as tmp:

        def hooks():
            sink = LiveSink(tmp, kind="run")
            cb = boundary_hook(ex_live, n, sink=sink)
            last.update(sink=sink, chunks=0)

            def on_chunk(tick, running, info):
                last["chunks"] += 1
                cb(tick, running, info)

            return {"on_chunk": on_chunk}

        t = timed_pair(ex_off, ex_live, n, runs, hooks)
        # the build that streamed, after its runs: still the plain loop
        assert_same_loop(loop_signature(ex_live), ref, "streaming")
        snaps = read_progress(tmp)
    sink, chunks = last["sink"], last["chunks"]
    assert sink.seq == len(snaps), (
        "progress.jsonl line count disagrees with the sink")
    assert len(snaps) >= 1 and chunks >= 1, "the run streamed no row"
    ticks = [s["tick"] for s in snaps]
    assert ticks == sorted(ticks), ticks
    return {
        "metric": f"live-plane per-chunk streaming overhead at {n} "
                  f"instances (chunk {PLANE_CHUNK})",
        "value": t["overhead_pct"],
        "unit": "percent",
        "vs_baseline": None,
        "loop_identical_live_off": True,
        "overhead_target_pct": 5.0,
        "ok": n,
        "chunks": chunks,
        "snapshots": len(snaps),
        "ticks": t["last_on"].ticks,
        "off_wall_seconds": t["off"],
        "live_wall_seconds": t["on"],
        "pair_walls": t["pairs"],
        "per_snapshot_ms": t["extra_seconds"] * 1e3 / max(1, len(snaps)),
        "warmup_seconds": t["warmup_seconds"],
        "loop": signature_summary(ref),
        "rows": snaps,
    }


def metrics_leg(n=N, device="cuda", runs=PLANE_RUNS, rounds=PLANE_ROUNDS):
    """bench.py metrics_main at ``n`` on ``device``: the sparsetimer run
    in ``runs`` pairs (``timed_pair``), plain and with the metrics plane at
    every boundary (a ``ChunkProfiler`` feeding ``tg_run_chunk_seconds``
    through ``boundary_callback``, and ``tg_bench_chunks_total`` bumped;
    no profiler window). Asserts the loop iteration equal before and
    after, the profiler's chunks equal to its journal's, both families
    in the exposition, and, as bench.py does when the plain wall is at
    least 2 s over 2 runs or more, the overhead under 5%."""
    from . import obs
    from .sim.profile import ChunkProfiler

    ex_off, ex_obs, ref = host_plane_pair(n, device, rounds)
    chunks_c = obs.counter("tg_bench_chunks_total",
                           "Chunk boundaries seen by the metrics bench.")
    last = {}

    def hooks():
        prof = ChunkProfiler(device=ex_obs.device)
        cb = boundary_hook(ex_obs, n, profiler=prof)
        last["prof"] = prof

        def on_chunk(tick, running, info):
            cb(tick, running, info)
            chunks_c.inc()

        return {"on_chunk": on_chunk}

    t = timed_pair(ex_off, ex_obs, n, runs, hooks)
    assert_same_loop(loop_signature(ex_obs), ref, "the metrics plane")
    prof = last["prof"]
    assert prof.chunks >= 1, "instrumented run saw no chunk boundaries"
    dp = prof.journal()
    assert dp is not None and dp["chunks"] == prof.chunks, dp
    exposition = obs.render()
    assert "tg_run_chunk_seconds_count" in exposition, (
        "chunk histogram missing from the exposition")
    assert "tg_bench_chunks_total" in exposition
    overhead = t["overhead_pct"]
    asserted = t["off"] >= 2.0 and runs >= 2
    if asserted:
        assert overhead < 5.0, (
            f"metrics-plane per-chunk overhead {overhead:.2f}% breaches "
            "the 5% target")
    return {
        "metric": f"metrics-plane per-chunk overhead at {n} instances "
                  f"(chunk {PLANE_CHUNK})",
        "value": overhead,
        "unit": "percent",
        "vs_baseline": None,
        "loop_identical_metrics_off": True,
        "overhead_target_pct": 5.0,
        "overhead_asserted": asserted,
        "ok": n,
        "chunks": prof.chunks,
        "ticks": t["last_on"].ticks,
        "dispatch_mean_s": dp["dispatch_mean_s"],
        "hbm_high_water_bytes": dp.get("hbm_high_water_bytes"),
        "off_wall_seconds": t["off"],
        "metrics_wall_seconds": t["on"],
        "pair_walls": t["pairs"],
        "per_chunk_ms": t["extra_seconds"] * 1e3 / max(1, prof.chunks),
        "warmup_seconds": t["warmup_seconds"],
        "loop": signature_summary(ref),
    }


def ckpt_leg(n=N, device="cuda", runs=PLANE_RUNS, rounds=PLANE_ROUNDS):
    """bench.py ckpt_main at ``n`` on ``device``: the sparsetimer run
    in ``runs`` pairs (``timed_pair``), plain and with a ``Checkpointer`` at
    interval 0 (a snapshot at every boundary but the last). Asserts the
    loop iteration equal before and after, at least one snapshot, and a
    run resumed from the last snapshot (``load_checkpoint``) ending in
    the plain run's final state, leaf for leaf and bit for bit. Returns
    its fields and both final states (flattened numpy leaves)."""
    from .sim.checkpoint import Checkpointer, key_digest, load_checkpoint

    ex_off, ex_ck, ref = host_plane_pair(n, device, rounds)
    khash = key_digest("bench-ckpt")
    last = {}
    with tempfile.TemporaryDirectory(prefix="tg-bench-ckpt-") as tmp:

        def hooks():
            last["ck"] = Checkpointer(tmp, key_hash=khash, kind="run",
                                      interval_s=0.0)
            return {"checkpoint": last["ck"]}

        t = timed_pair(ex_off, ex_ck, n, runs, hooks)
        res_off = t["last_off"]
        # the executor's own state (ex_off runs no more)
        full = flatten(state_to_numpy(res_off.state))
        ck = last["ck"]
        assert ck.snapshots >= 1, "no snapshots landed"
        assert_same_loop(loop_signature(ex_ck), ref, "checkpointing")
        rp = load_checkpoint(tmp)
        assert rp is not None, "no loadable checkpoint"
        rp.verify(khash)
        resumed = ex_ck.run(resume_state=rp.state)
        ok = int((resumed.statuses()[:n] == 1).sum())
        assert ok == n, f"only {ok}/{n} ok after the resume"
        resumed_state = flatten(state_to_numpy(resumed.state))
    leaves = compare_leaves(full, resumed_state,
                            "resumed vs uninterrupted final state")
    return {
        "metric": f"checkpoint-plane per-chunk snapshot overhead at {n} "
                  f"instances (chunk {PLANE_CHUNK})",
        "value": t["overhead_pct"],
        "unit": "percent",
        "vs_baseline": None,
        "loop_identical_ckpt_off": True,
        "resume_bit_identical": True,
        "leaves_compared": leaves,
        "overhead_target_pct": 5.0,
        "ok": n,
        "snapshots": ck.snapshots,
        "ticks": res_off.ticks,
        "resumed_from_tick": rp.tick,
        "off_wall_seconds": t["off"],
        "ckpt_wall_seconds": t["on"],
        "pair_walls": t["pairs"],
        "resumed_wall_seconds": resumed.wall_seconds,
        "per_snapshot_ms": t["extra_seconds"] * 1e3 / max(1, ck.snapshots),
        "warmup_seconds": t["warmup_seconds"],
        "loop": signature_summary(ref),
        "states": {"uninterrupted": full, "resumed": resumed_state},
    }


HOST_PLANE_LEGS = {"live": live_leg, "metrics": metrics_leg,
                   "ckpt": ckpt_leg}


def host_plane_main(plane, n=N) -> int:
    """``--live``, ``--metrics`` or ``--ckpt``: one JSON line."""
    line = HOST_PLANE_LEGS[plane](n)
    line.pop("rows", None)
    line.pop("states", None)
    line["device"] = device_line()
    print(json.dumps(line))
    return 0


def compile_leg(device="cuda") -> dict:
    """bench.py compile_main in the port's terms: the faultsdemo chaos
    ladder (testground_tpu_torch/tools/compile_ladder.py), each combo
    built on ``device`` with its build and capture seconds, its ``ops``
    (counted on a CPU build) and, on the card, its ``graph_nodes``, each
    asserted within tools/op_budgets.json."""
    from .tools import compile_ladder

    rows = compile_ladder.ladder(device)
    over = compile_ladder.over_budget(rows, compile_ladder.load_budgets())
    assert not over, f"over the recorded budgets: {over}"
    all_row = rows[-1]
    return {
        "metric": "all-planes faultsdemo build and capture seconds",
        "value": all_row["build_seconds"] + all_row["capture_seconds"],
        "unit": "seconds",
        "vs_baseline": None,
        "ops": all_row["ops"],
        "graph_nodes": all_row.get("graph_nodes"),
        "within_budgets": True,
        "ladder": rows,
    }


def compile_main() -> int:
    line = compile_leg()
    line["device"] = device_line()
    print(json.dumps(line))
    return 0


# ------------------------------------------------------ sweep and search

SWEEP_SEEDS = 64  # TG_BENCH_SWEEP=64, docs/sweeps.md's 64-seed churn study
SWEEP_SERIAL = 2  # TG_BENCH_SWEEP_SERIAL's default: serial sample seeds
SEARCH_GRID = 256  # TG_BENCH_SEARCH_GRID's default
SEARCH_WIDTH = 8  # TG_BENCH_SEARCH_WIDTH's default
CLIFF_AT = 0.663  # search_main's cliff: strictly between grid points


def storm_sweep(n, seeds, device="cuda"):
    """bench.py sweep_main's batched executable: storm at ``n`` with
    ``PARAMS`` over seeds 0..seeds-1, one scenario each, chunked by the
    memory pre-flight."""
    from .sim.sweep import compile_sweep, sweep_preflight

    groups = [GroupSpec("single", 0, n,
                        {k: str(v) for k, v in PARAMS.items()})]
    scenarios = [{"seed": s, "params": {}} for s in range(seeds)]

    def make(cfg, chunk):
        return compile_sweep(benchmarks.storm, groups, cfg, scenarios,
                             test_case="storm", test_run="bench",
                             chunk=chunk, device=device)

    ex, report = sweep_preflight(make, storm_config(), seeds,
                                 allow_shrink=False)
    ex.preflight = report
    return ex


def assert_sweep_run(res, n):
    """sweep_main's ``assert_run`` on one scenario: every instance ok,
    no inbox drop and no metric drop."""
    statuses = res.statuses()[:n]
    ok = int((statuses == 1).sum())
    assert ok == n, f"only {ok}/{n} instances ok"
    assert res.net_dropped() == 0, f"{res.net_dropped()} messages dropped"
    assert res.metrics_dropped() == 0, (
        f"{res.metrics_dropped()} metric records dropped")


def sweep_leg(n=N, device="cuda", serial_seeds=SWEEP_SERIAL):
    """bench.py sweep_main at ``n`` on ``device``: the SWEEP_SEEDS-seed
    storm sweep as one batched run (every scenario asserted), then a
    serial sample of ``serial_seeds`` seeds, each its own executable and
    capture. Returns (its fields, the sweep result, the serial
    results)."""
    from .sim.sweep import chunk_compiles

    seeds = SWEEP_SEEDS
    builds0 = chunk_compiles()
    t0 = time.monotonic()
    ex = storm_sweep(n, seeds, device)
    kernel_launches(reset=True)
    res = ex.run()
    batched_total = time.monotonic() - t0
    launches = kernel_launches()
    for s in range(seeds):
        assert_sweep_run(res.scenario(s), n)
    if ex.device.type == "cuda":
        assert ex.captures == 1, f"{ex.captures} captures, not 1"
    serial, serial_s = [], []
    for s in range(serial_seeds):
        t1 = time.monotonic()
        ex_s = storm_executable(n, device, seed=s)
        r = ex_s.run()
        serial_s.append(time.monotonic() - t1)
        assert_sweep_run(r, n)
        serial.append(r)
    per_run = sum(serial_s) / len(serial_s)
    sps_batched = seeds / batched_total
    sps_serial = 1.0 / per_run
    line = {
        "metric": f"storm {seeds}-seed sweep scenarios/sec at {n} "
                  "instances",
        "value": sps_batched,
        "unit": "scenarios/sec",
        "vs_baseline": None,
        "speedup_vs_serial": sps_batched / sps_serial,
        "batched_wall_seconds": batched_total,
        "batched_run_seconds": res.wall_seconds,
        "capture_seconds": res.capture_seconds,
        "captures": ex.captures,
        "batched_tick_builds": chunk_compiles() - builds0,
        "scenario_chunks": ex.n_chunks,
        "state_model_bytes": ex.preflight["state_model_bytes_per_device"],
        "ticks": res.ticks,
        "launches": launches,
        "serial_sample_seconds": serial_s,
        "serial_scenarios_per_sec": sps_serial,
        "serial_extrapolated_seconds": per_run * seeds,
    }
    return line, res, serial


def sweep_main() -> int:
    line, _, _ = sweep_leg()
    line["device"] = device_line()
    print(json.dumps(line))
    return 0


def search_leg(n=N, device="cuda", grid_n=SEARCH_GRID) -> dict:
    """bench.py search_main at ``n`` on ``device``: bisect ``cliff``'s
    edge (``x_fail`` = ``CLIFF_AT``) over a ``grid_n``-point grid of x in
    [0, 1], SEARCH_WIDTH scenarios a round, through one batched executable
    rebound every round. Asserts one build of the batched tick (and on
    the card one capture), at most ceil(log2 grid) + 1 rounds, and the
    edge at the first grid value above ``CLIFF_AT``."""
    import math

    from .sim.search import (
        SearchRebinder, make_driver, probe_scenarios, run_search_loop,
    )
    from .sim.sweep import chunk_compiles, compile_sweep
    from .sim.tables import Search

    build_fn = benchmarks.cliff
    groups = [GroupSpec("single", 0, n, {"x_fail": str(CLIFF_AT)})]
    cfg = SimConfig(quantum_ms=10.0, max_ticks=10_000,
                    chunk_ticks=CHUNK_TICKS, metrics_capacity=8)
    spec = Search(param="x", lo=0.0, hi=1.0, step=1.0 / grid_n,
                  width=SEARCH_WIDTH)
    driver = make_driver(spec)
    grid = driver.grid
    t0 = time.monotonic()
    builds0 = chunk_compiles()
    batch0 = driver.next_batch()
    ex = compile_sweep(build_fn, groups, cfg, probe_scenarios(batch0, "x"),
                       test_case="cliff", test_run="bench-search",
                       device=device)
    rebinder = SearchRebinder(ex, None, build_fn, groups, ex.config,
                              test_case="cliff")

    def evaluate(r, batch):
        if r > 0:
            rebinder.rebind(probe_scenarios(batch, "x"))
        res = ex.run()
        for p in batch:
            if p.pad:
                continue
            oc = res.scenario(p.scenario).outcomes()
            ok = all(o[0] == o[1] for o in oc.values())
            p.outcome = "success" if ok else "failure"
            p.failed = not ok
            p.objective = 0.0 if ok else 1.0

    verdict = run_search_loop(driver, evaluate, first_batch=batch0)
    wall = time.monotonic() - t0
    builds = chunk_compiles() - builds0
    assert builds == 1, f"search built the batched tick {builds} times"
    if ex.device.type == "cuda":
        assert ex.captures == 1, f"search captured {ex.captures} times"
    bound = math.ceil(math.log2(len(grid))) + 1
    assert len(driver.rounds) <= bound, (len(driver.rounds), bound)
    want = min(v for v in grid if v > CLIFF_AT)
    assert verdict["first_failing"] == want, (verdict, want)
    assert verdict["last_passing"] == max(v for v in grid if v <= CLIFF_AT)
    exhaustive = len(grid) * spec.seeds
    return {
        "metric": f"breaking-point search scenarios probed at {n} "
                  f"instances (grid {len(grid)})",
        "value": driver.scenarios_probed,
        "unit": "scenarios",
        "vs_baseline": None,
        "exhaustive_scenarios": exhaustive,
        "probe_savings_x": exhaustive / driver.scenarios_probed,
        "rounds": len(driver.rounds),
        "round_bound": bound,
        "batched_tick_builds": builds,
        "captures": ex.captures,
        "one_capture": ex.captures == 1,
        "breaking_point": verdict["first_failing"],
        "last_passing": verdict["last_passing"],
        "wall_seconds": wall,
        "capture_seconds": ex.capture_seconds,
    }


def search_main() -> int:
    line = search_leg()
    line["device"] = device_line()
    print(json.dumps(line))
    return 0


# ------------------------------------------------------------ federation

FEDER_ROUNDS = 20  # TG_BENCH_TIMER_ROUNDS' default in feder_main
FEDER_CHUNK = 4_096  # TG_BENCH_CHUNK's default there
# the fleet's liveness and retry knobs (feder_main boots its daemons with
# a 0.3 s beat and a 3 s staleness): beats a quarter second apart, a
# worker lost after 4 s without one (a worker's first run imports torch's
# dispatch machinery for seconds; a shorter bound would take that for a
# loss), a lost worker's run redispatched after 0.1 s
FEDER_ENV = {"TG_FED_HEARTBEAT_S": "0.25", "TG_FED_STALE_S": "4",
             "TG_TASK_RETRY_BACKOFF_S": "0.1"}
_PKG_ROOT = str(Path(__file__).resolve().parent.parent)


class DaemonProcess:
    """``python -m testground_tpu_torch daemon --listen 127.0.0.1:0`` as a
    process of its own, as users start it: its own ``home`` (with an
    ``.env.toml`` requiring ``token`` when one is given), its runs on
    ``device``, ``peers`` making it their coordinator, ``env`` added to
    its environment; its output in ``home/daemon<k>.log``. ``entry``
    replaces ``python -m testground_tpu_torch`` (a command that takes
    the same arguments)."""

    def __init__(self, home, device="cuda", peers=(), env=None, token="",
                 entry=None):
        import os

        self.home, self.device, self.peers = str(home), device, list(peers)
        self.env, self.token = dict(env or {}), token
        self.entry = list(entry or (sys.executable, "-m",
                                    "testground_tpu_torch"))
        os.makedirs(self.home, exist_ok=True)
        if token:
            with open(os.path.join(self.home, ".env.toml"), "w") as f:
                f.write(f'[daemon]\ntokens = ["{token}"]\n'
                        f'[client]\ntoken = "{token}"\n')
        self.starts = 0
        self.start()

    def start(self) -> None:
        import os

        env = dict(os.environ, TESTGROUND_HOME=self.home, **self.env)
        self.starts += 1
        self.log_path = os.path.join(self.home, f"daemon{self.starts}.log")
        self._log = open(self.log_path, "w")
        self.t0 = time.monotonic()
        cmd = self.entry + ["daemon", "--listen", "127.0.0.1:0",
                            "--device", str(self.device)]
        for peer in self.peers:
            cmd += ["--peer", peer]
        self.proc = subprocess.Popen(cmd, stdout=self._log,
                                     stderr=subprocess.STDOUT,
                                     cwd=_PKG_ROOT, env=env)
        self._endpoint = None

    def endpoint(self, timeout=120.0) -> str:
        """The daemon's URL once it listens (its log's first line);
        ``ready_seconds`` is how long that took from its start."""
        deadline = time.monotonic() + timeout
        while self._endpoint is None:
            with open(self.log_path) as f:
                for line in f:
                    if line.startswith("daemon listening on "):
                        self._endpoint = line.split()[3]
                        self.ready_seconds = time.monotonic() - self.t0
            if self._endpoint is None:
                if self.proc.poll() is not None:
                    raise RuntimeError(
                        f"the daemon exited {self.proc.returncode}: "
                        + open(self.log_path).read()[-3000:])
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"no daemon listening after {timeout} s")
                time.sleep(0.05)
        return self._endpoint

    def client(self, timeout=600.0):
        from .client import Client

        return Client(self.endpoint(), token=self.token, timeout=timeout)

    def kill(self) -> None:
        """SIGKILL, as a host that dies takes it."""
        self.proc.kill()
        self.proc.wait()
        self._log.close()

    def stop(self, timeout=120.0) -> int:
        """SIGTERM, as a scheduler stops a job; its exit code."""
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self._log.close()
        return self.proc.returncode

    def run_dir(self, plan, tid) -> str:
        return str(Path(self.home) / "data" / "outputs" / plan / tid)


class Fleet:
    """A coordinator daemon and ``workers`` worker daemons, each its own
    process and home under ``root``, all on ``device``: the workers
    (by ``worker_entry``, DaemonProcess's ``entry``) start together, each
    on a port it picks, then the coordinator with a ``--peer`` for each
    worker's endpoint."""

    def __init__(self, root, workers=2, device="cuda", env=None, token="",
                 worker_entry=None):
        env = dict(FEDER_ENV, **(env or {}))
        self.t0 = time.monotonic()
        self.workers = [DaemonProcess(Path(root) / f"w{i}", device, (), env,
                                      token, worker_entry)
                        for i in range(workers)]
        try:
            peers = [w.endpoint() for w in self.workers]
            self.coordinator = DaemonProcess(Path(root) / "coord", device,
                                             peers, env, token)
            self.coordinator.endpoint()
        except BaseException:
            for w in self.workers:
                w.stop()
            if hasattr(self, "coordinator"):
                self.coordinator.stop()
            raise

    def client(self, timeout=600.0):
        return self.coordinator.client(timeout)

    def by_endpoint(self, endpoint) -> DaemonProcess:
        return next(w for w in self.workers if w.endpoint() == endpoint)

    def wait_alive(self, n=None, timeout=120.0) -> float:
        """Seconds from the fleet's start until ``/federation`` shows
        ``n`` (default: every) workers alive."""
        n = len(self.workers) if n is None else n
        cli = self.client(timeout=10.0)
        deadline = time.monotonic() + timeout
        while sum(w["alive"] for w in cli.federation()["workers"]) != n:
            if time.monotonic() > deadline:
                raise TimeoutError(f"{n} workers never alive: "
                                   f"{cli.federation()['workers']}")
            time.sleep(0.05)
        return time.monotonic() - self.t0

    def wait_cache_key(self, worker, affinity, timeout=60.0) -> None:
        """Until ``worker``'s heartbeat names ``affinity``."""
        cli = self.client(timeout=10.0)
        deadline = time.monotonic() + timeout
        while not any(w["worker"] == worker and affinity in w["cache_keys"]
                      for w in cli.federation()["workers"]):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{worker} never named {affinity}")
            time.sleep(0.05)

    def close(self) -> dict:
        """Every daemon stopped by SIGTERM; their exit codes."""
        procs = [self.coordinator] + self.workers
        return {p.home: (p.stop() if p.proc.returncode is None
                         else p.proc.returncode) for p in procs}


def wait_task(client, tid, states=("complete", "canceled"), timeout=600.0):
    """Task ``tid``'s status once its state is one of ``states``."""
    deadline = time.monotonic() + timeout
    while True:
        st = client.status(tid)
        if st["state"] in states:
            return st
        if time.monotonic() > deadline:
            raise TimeoutError(f"{tid} still {st['state']}")
        time.sleep(0.05)


def collect(client, tid, dest) -> str:
    """Task ``tid``'s outputs tarball unpacked into ``dest``; its run
    directory there."""
    import io
    import tarfile

    buf = io.BytesIO()
    client.collect_outputs(tid, buf)
    buf.seek(0)
    with tarfile.open(fileobj=buf, mode="r:gz") as tf:
        tf.extractall(dest, filter="data")
    return str(Path(dest) / tid)


def feder_composition(n, period_ms, rounds=FEDER_ROUNDS,
                      chunk_ticks=FEDER_CHUNK) -> dict:
    """feder_main's sparsetimer composition at ``n`` (POST /run's dict
    form)."""
    return {
        "metadata": {},
        "global": {"plan": "benchmarks", "case": "sparsetimer",
                   "runner": "sim:jax", "builder": "sim:module",
                   "total_instances": n,
                   "run_config": {"quantum_ms": 1.0,
                                  "chunk_ticks": chunk_ticks,
                                  "max_ticks": max(20_000, rounds * 100 * 3),
                                  "metrics_capacity": 16}},
        "groups": [{"id": "single", "instances": {"count": n},
                    "run": {"test_params": {
                        "timer_rounds": str(rounds),
                        "timer_period_ms": str(period_ms)}}}],
    }


def in_process_run(comp, run_dir, device="cuda"):
    """``comp`` (one group) run by this process's runner, as the engine
    would prepare it; its summary."""
    from .api.contracts import RunGroup, RunInput
    from .runner.outputs import summary
    from .sim import runner

    g, grp = comp["global"], comp["groups"][0]
    ri = RunInput(
        run_id=Path(run_dir).name, env_config=None, run_dir=str(run_dir),
        test_plan=g["plan"], test_case=g["case"],
        total_instances=g["total_instances"],
        groups=[RunGroup(id=grp["id"], instances=grp["instances"]["count"],
                         artifact_path=str(Path(_PKG_ROOT) / "plans"
                                           / g["plan"]),
                         parameters=dict(grp["run"]["test_params"]))],
        run_config=dict(g["run_config"]))
    runner.run_composition(ri, device=device)
    return summary(run_dir)


def routed_prewarm(fleet, comp) -> tuple:
    """``comp`` prewarmed through ``fleet``'s coordinator: a ``miss`` on
    the worker it routes to. (Its status, the seconds from submission to
    completion.)"""
    cli = fleet.client()
    plan_dir = str(Path(_PKG_ROOT) / "plans" / comp["global"]["plan"])
    t0 = time.monotonic()
    pw = wait_task(cli, cli.prewarm(comp, plan_dir=plan_dir))
    jp = pw["result"]["journal"]
    assert pw["outcome"] == "success", (pw["outcome"], pw.get("error"))
    assert jp["prewarm"] is True and jp["executor_cache"] == "miss", jp
    assert pw["routed_to"], "the prewarm was not routed"
    return pw, time.monotonic() - t0


def routed_run(fleet, comp, warm) -> tuple:
    """``comp`` run through ``fleet``'s coordinator once worker
    ``warm``'s heartbeat names its digest: routed there, ``memory_hit``,
    ``compiles: 0``. (Its status, the seconds from submission to
    completion.)"""
    from .federation import affinity_key

    fleet.wait_cache_key(warm, affinity_key(comp))
    cli = fleet.client()
    plan_dir = str(Path(_PKG_ROOT) / "plans" / comp["global"]["plan"])
    t0 = time.monotonic()
    st = wait_task(cli, cli.run(comp, plan_dir=plan_dir))
    j = st["result"]["journal"]
    assert st["routed_to"] == warm == j["routed_to"], (st["routed_to"], warm)
    assert j["hbm_preflight"]["executor_cache"] == "memory_hit", j
    assert j["compiles"] == 0, j
    return st, time.monotonic() - t0


def compile_on_upload(fleet, comp, tmp) -> dict:
    """Leg (a) on a live ``fleet``: ``routed_prewarm``, then
    ``routed_run`` on the worker it chose. Returns both tasks' statuses,
    the run's directory collected through the coordinator and the
    seconds from each submission to its completion."""
    pw, pw_s = routed_prewarm(fleet, comp)
    st, run_s = routed_run(fleet, comp, pw["routed_to"])
    assert st["outcome"] == "success", (st["outcome"], st.get("error"))
    got = collect(fleet.client(), st["id"], Path(tmp) / "collected")
    return {"prewarm": pw, "run": st, "dir": got,
            "prewarm_submit_to_complete_seconds": pw_s,
            "run_submit_to_complete_seconds": run_s}


def fleet_wall(root, workers, comps, device="cuda") -> tuple:
    """Leg (b): a fresh fleet of ``workers`` workers runs ``comps``
    submitted at once; (seconds from the first submission to the last
    completion, the workers the coordinator used)."""
    import threading

    fleet = Fleet(root, workers, device)
    try:
        fleet.wait_alive()
        cli = fleet.client()
        plan_dir = str(Path(_PKG_ROOT) / "plans" / "benchmarks")
        t0 = time.monotonic()
        tids = [cli.run(c, plan_dir=plan_dir) for c in comps]
        outcomes = {}

        def waiter(tid):
            outcomes[tid] = wait_task(fleet.client(), tid)["outcome"]

        threads = [threading.Thread(target=waiter, args=(t,)) for t in tids]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.monotonic() - t0
        used = {r["worker"] for r in cli.federation()["routes"]}
        assert set(outcomes.values()) == {"success"}, outcomes
    finally:
        rcs = fleet.close()
    assert set(rcs.values()) == {0}, rcs
    return wall, used


def feder_leg(n=N, device="cuda", rounds=FEDER_ROUNDS, daemons=True) -> dict:
    """bench.py feder_main in the port's terms, on ``device``.

    (a) compile-on-upload: a coordinator and two workers, each a
    daemon process; the sparsetimer at ``n`` (``rounds`` beats 50 ms
    apart) prewarmed through the coordinator, then run: the run routes
    to the prewarmed worker, journals ``memory_hit`` and ``compiles: 0``,
    and its results.out (every output file) and run.out equal a cold
    in-process run's. The worker's prewarm (a fresh process: its first
    build and capture) against the routed run's build and capture is
    the headline.

    (b) with ``daemons``: two distinct compositions (100 and 50 ms
    beats) submitted at once to a fresh two-worker fleet and to a fresh
    one-worker fleet; the wall ratio, reported and not asserted: the
    workers share one card (JAX asserts < 0.9x only with a CPU device
    for each worker)."""
    from .runner.outputs import output_files, run_out_lines

    tmp = tempfile.mkdtemp(prefix="tg-bench-feder-")
    comp = feder_composition(n, 50, rounds)
    ref = Path(tmp) / "cold"
    assert in_process_run(comp, ref, device)["outcome"] == "success"
    fleet = Fleet(Path(tmp) / "fleet-a", 2, device)
    try:
        alive_s = fleet.wait_alive()
        a = compile_on_upload(fleet, comp, tmp)
    finally:
        rcs = fleet.close()
    assert set(rcs.values()) == {0}, rcs
    assert output_files(a["dir"]) == output_files(ref), "outputs differ"
    assert run_out_lines(a["dir"]) == run_out_lines(ref)
    jp = a["prewarm"]["result"]["journal"]
    j = a["run"]["result"]["journal"]
    warm_s = j["compile_seconds"]
    line = {
        "metric": ("prewarmed first-run speedup (the worker's cold build "
                   f"and capture / the routed run's) at {n} instances"),
        "value": jp["compile_seconds"] / warm_s if warm_s > 0 else None,
        "unit": "x",
        "vs_baseline": None,
        "fleet_alive_seconds": alive_s,
        "prewarm_compile_seconds": jp["compile_seconds"],
        "prewarmed_first_run_compile_seconds": warm_s,
        "prewarmed_first_run_executor_cache":
            j["hbm_preflight"]["executor_cache"],
        "prewarmed_first_run_compiles": j["compiles"],
        "routed_to_prewarmed_worker": True,
        "outputs_equal_cold_in_process": True,
        "prewarm_submit_to_complete_seconds":
            a["prewarm_submit_to_complete_seconds"],
        "run_submit_to_complete_seconds": a["run_submit_to_complete_seconds"],
        "fleet_measured": False,
    }
    if daemons:
        comps = [feder_composition(n, 100, rounds), comp]
        wall_2w, used_2w = fleet_wall(Path(tmp) / "fleet-2w", 2, comps,
                                      device)
        assert len(used_2w) == 2, (
            "two distinct compositions should spread over both workers, "
            f"used only {used_2w}")
        wall_1w, _ = fleet_wall(Path(tmp) / "fleet-1w", 1, comps, device)
        line.update({
            "fleet_measured": True,
            "wall_2workers_s": wall_2w,
            "wall_1worker_s": wall_1w,
            "fleet_speedup_ratio": wall_2w / wall_1w,
            "fleet_asserted": False,
            "workers_used_2w": len(used_2w),
        })
    return line


def feder_main() -> int:
    import os

    line = feder_leg(
        rounds=int(os.environ.get("TG_BENCH_TIMER_ROUNDS", FEDER_ROUNDS)),
        daemons=os.environ.get("TG_BENCH_FEDER_DAEMONS", "1") != "0")
    line["device"] = device_line()
    print(json.dumps(line))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--shaped", action="store_true")
    mode.add_argument("--skip", action="store_true")
    for plane in PLANES:
        mode.add_argument(f"--{plane}", action="store_true")
    mode.add_argument("--replay", action="store_true")
    mode.add_argument("--drain", action="store_true")
    mode.add_argument("--sweep", action="store_true")
    mode.add_argument("--search", action="store_true")
    for plane in HOST_PLANE_LEGS:
        mode.add_argument(f"--{plane}", action="store_true")
    mode.add_argument("--compile", action="store_true")
    mode.add_argument("--feder", action="store_true")
    args = ap.parse_args(argv)
    if args.feder:
        return feder_main()
    for plane in HOST_PLANE_LEGS:
        if getattr(args, plane):
            return host_plane_main(plane)
    if args.compile:
        return compile_main()
    if args.sweep:
        return sweep_main()
    if args.search:
        return search_main()
    if args.skip:
        return skip_main()
    if args.replay:
        return replay_main()
    if args.drain:
        return drain_main()
    for plane in PLANES:
        if getattr(args, plane):
            return plane_main(plane)
    ex = storm_executable(N, "cuda", args.shaped)
    ex.tick_fn()  # built before the clock starts
    res = ex.run()
    summary = check(res, N, args.shaped)
    print(json.dumps({
        "metric": f"storm wall-clock at {N} instances"
        + (" (shaped, churn)" if args.shaped else ""),
        "value": res.wall_seconds,
        "unit": "seconds",
        "ticks": res.ticks,
        "ticks_executed": res.ticks_executed,
        "device": device_line(),
        **summary,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
