"""Storm at 10,000 instances on the card: the port's counterpart of
``bench.py``'s headline.

    python -m testground_tpu_torch.bench [--shaped]

Runs the storm plan (testground_tpu_torch/plans/benchmarks.py) with
``bench.py``'s ``PARAMS`` and ``SimConfig`` (10 ms quantum, max 100,000
ticks, metrics capacity 16, phase gating) to termination, once. With
``--shaped``, ``TG_BENCH_SHAPED``'s scenario: 50 ms links, 5% loss, SYN
retries with a 1 s per-attempt timeout, churn-tolerant rendezvous and 2%
churn over 5-20 s. Asserts what ``bench.py`` asserts (every instance ok;
shaped: exactly the scheduled victims crashed and every survivor ok;
zero inbox drops, horizon clamps and metric drops) and prints one JSON
line: the wall seconds of the run, its ticks and executed ticks, and the
card's name and power limit from ``nvidia-smi``."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

from .plans import benchmarks
from .sim import BuildContext, GroupSpec, SimConfig, compile_program

N = 10_000  # bench.py's instance count

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


def storm_executable(n, device="cuda", shaped=False, chunk_ticks=32):
    """bench.py's storm executable at ``n`` instances on ``device``."""
    params = dict(PARAMS, **(SHAPED_PARAMS if shaped else {}))
    ctx = BuildContext(
        [GroupSpec("single", 0, n, {k: str(v) for k, v in params.items()})],
        test_case="storm",
        test_run="bench",
    )
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
    ex = compile_program(benchmarks.storm, ctx, cfg, device=device)
    if shaped:
        assert not ex.program.net_spec.fixed_next_tick, (
            "shaped storm must exercise the wheel path")
    return ex


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shaped", action="store_true")
    args = ap.parse_args(argv)
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
