"""The barrier benchmark on the card: the port's counterpart of
``tools/bench_barrier.py``.

    python -m testground_tpu_torch.tools.bench_barrier [N] [iters]

Runs the benchmarks plan's ``barrier`` case (``iters`` rounds x five
subset barriers at 20-100% of N, each after an all-instance line-up) at
N instances (default 100,000; 20 iterations) with the JAX tool's
SimConfig, asserts every instance ok and zero metric drops, and prints
the wall seconds, ticks and barriers/s with the card's name and power
limit."""

from __future__ import annotations

import json
import sys

from ..bench import barrier_executable, device_line


def check(res, n, iters):
    """The tool's assertions; returns a summary. Every round runs five
    subset levels, each a line-up and a timed barrier."""
    ok = int((res.statuses()[:n] == 1).sum())
    assert ok == n, f"{ok}/{n} ok"
    assert res.metrics_dropped() == 0, "metric ring overflow"
    barriers = iters * 5 * 2
    return {"ok": ok, "barriers": barriers,
            "barriers_per_s": barriers / res.wall_seconds,
            "metrics_dropped": 0}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 100_000
    iters = int(argv[1]) if len(argv) > 1 else 20
    ex = barrier_executable(n, iters, "cuda")
    ex.tick_fn()  # built before the clock starts
    res = ex.run()
    print(json.dumps({
        "metric": f"barrier wall-clock at {n} instances, {iters} iterations",
        "value": res.wall_seconds, "unit": "seconds", "ticks": res.ticks,
        "ticks_executed": res.ticks_executed, **check(res, n, iters),
        "device": device_line(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
