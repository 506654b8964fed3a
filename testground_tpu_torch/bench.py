"""Storm at 10,000 instances on the card: the port's counterpart of
``bench.py``'s headline; with ``--skip``, ``TG_BENCH_SKIP``'s event-skip
run of the sparse-timer plan; with ``--faults``, ``--trace`` or
``--telem``, ``TG_BENCH_FAULTS``', ``TG_BENCH_TRACE``'s and
``TG_BENCH_TELEM``'s runs of storm under the fault, trace and telemetry
planes; with ``--replay`` and ``--drain``, ``TG_BENCH_REPLAY``'s and
``TG_BENCH_DRAIN``'s legs (``replay_main`` and ``drain_main`` of
``bench.py``); with ``--sweep`` and ``--search``, ``TG_BENCH_SWEEP=64``'s
and ``TG_BENCH_SEARCH``'s (``sweep_main`` and ``search_main``).

    python -m testground_tpu_torch.bench [--shaped | --skip | --faults |
                                          --trace | --telem | --replay |
                                          --drain | --sweep | --search]

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


def sparsetimer_executable(n, event_skip, device="cuda", rounds=SKIP_ROUNDS):
    """bench.py's TG_BENCH_SKIP sparsetimer executable, dense
    (``event_skip=False``) or skipped."""
    cfg = SimConfig(quantum_ms=1.0, chunk_ticks=CHUNK_TICKS,
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


def tick_ops(ex) -> list:
    """The names of the ops two loop iterations of ``ex`` dispatch from
    its initial state (the port's form of "the same compiled tick")."""
    st = ex.init_state()
    # the build-time probe, and the constants a first tick caches, stay
    # outside the log
    ex.guarded_tick(ex.init_state())
    with torch.no_grad(), OpLog() as log:
        for _ in range(2):
            st = ex.guarded_tick(st)
    return log.ops


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
    args = ap.parse_args(argv)
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
