"""Storm at 10,000 instances on the card: the port's counterpart of
``bench.py``'s headline; and with ``--skip``, ``TG_BENCH_SKIP``'s
event-skip run of the sparse-timer plan.

    python -m testground_tpu_torch.bench [--shaped | --skip]

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

The other builders here (``barrier_executable``, ``subtree_executable``)
are those of ``testground_tpu_torch.tools.bench_barrier`` and
``bench_subtree``."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

from .plans import benchmarks
from .sim import BuildContext, GroupSpec, SimConfig, compile_program
from .sim.core import EVENT_SKIP_STATE_LEAVES
from .sim.state_io import compare_leaves, flatten, state_to_numpy

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


def _case_executable(case, n, params, cfg, device):
    """The benchmarks plan's ``case`` at ``n`` instances in one group with
    ``params``, built with ``cfg`` on ``device``."""
    ctx = BuildContext(
        [GroupSpec("single", 0, n, {k: str(v) for k, v in params.items()})],
        test_case=case,
        test_run="bench",
    )
    return compile_program(benchmarks.testcases[case], ctx, cfg,
                           device=device)


def storm_executable(n, device="cuda", shaped=False, chunk_ticks=CHUNK_TICKS):
    """bench.py's storm executable at ``n`` instances on ``device``."""
    params = dict(PARAMS, **(SHAPED_PARAMS if shaped else {}))
    cfg = SimConfig(
        quantum_ms=10.0,
        chunk_ticks=chunk_ticks,
        max_ticks=100_000,
        metrics_capacity=16,
        phase_gating=True,
    )
    if shaped:
        cfg.churn_fraction = 0.02
        cfg.churn_start_ms = 5_000.0
        cfg.churn_end_ms = 20_000.0
    ex = _case_executable("storm", n, params, cfg, device)
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--shaped", action="store_true")
    mode.add_argument("--skip", action="store_true")
    args = ap.parse_args(argv)
    if args.skip:
        return skip_main()
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
