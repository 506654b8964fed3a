"""The subtree (pub/sub payload pump) benchmark on the card: the port's
counterpart of ``tools/bench_subtree.py``.

    python -m testground_tpu_torch.tools.bench_subtree [N] [iters]

One publisher pumps ``iters`` items a size class (64 B to 4 KiB, size/4
f32 lanes on a stream topic each) while every other instance consumes
and verifies each item against the topic's head register. At N
instances (default 10,000; 2,000 iterations) with the JAX tool's
SimConfig. Asserts every instance ok, zero stream-topic violations,
zero in-loop verification faults (``sub_bad``, ``sub_unverified``) and,
on the host, that row r of every size topic is ``[r] * pay``; prints the
wall seconds, ticks and the virtual seconds of each size class with the
card's name and power limit."""

from __future__ import annotations

import json
import sys

import numpy as np

from ..bench import device_line, subtree_executable


def check(res, n, iters):
    """The tool's assertions; returns a summary."""
    ok = int((res.statuses()[:n] == 1).sum())
    assert ok == n, f"{ok}/{n} ok"
    viol = res.stream_violations()
    assert viol == 0, f"{viol} stream-topic publisher-contract violations"
    mem = res.state["mem"]
    bad = int(mem["sub_bad"].sum())
    unverified = int(mem["sub_unverified"].sum())
    assert bad == 0 and unverified == 0, (bad, unverified)
    checked = 0
    topics = res.executable.program.topics.by_name()
    for name, (tid, _, pay, stream) in topics.items():
        if not name.startswith("subtree_time_"):
            continue
        assert stream, name
        buf = res.state["topic_bufs"][tid].cpu().numpy()
        want = np.repeat(np.arange(iters, dtype=np.float32)[:, None], pay, 1)
        assert buf.shape == (iters, pay), (name, buf.shape)
        assert (buf == want).all(), f"payload corruption in {name}"
        checked += 1
    assert checked == 7, checked
    per_size = {r["name"]: r["value"] for r in res.metrics_records()
                if r["name"].startswith("subtree_time_")
                and r["instance"] == 0}
    return {"ok": ok, "stream_violations": 0, "sub_bad": 0,
            "sub_unverified": 0, "topics_checked": checked,
            "virtual_secs": per_size}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 10_000
    iters = int(argv[1]) if len(argv) > 1 else 2_000
    ex = subtree_executable(n, iters, "cuda")
    ex.tick_fn()  # built before the clock starts
    res = ex.run()
    print(json.dumps({
        "metric": f"subtree wall-clock at {n} instances, {iters} items a "
                  "size class",
        "value": res.wall_seconds, "unit": "seconds", "ticks": res.ticks,
        "ticks_executed": res.ticks_executed, **check(res, n, iters),
        "device": device_line(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
