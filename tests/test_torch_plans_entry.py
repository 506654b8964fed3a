"""The entry-mode plans of the port (testground_tpu_torch/plans: network,
splitbrain, example, placebo, verify) against the JAX package's
(plans/*/sim.py) on the CPU, at the sizes of the JAX package's own tests
of them: every state leaf equal, bit for bit, and ``SimResult.ticks``
equal; with the outcomes the plans assert (ping-pong's RTT windows,
splitbrain's partition matrix and its errors per instance). Also the
splitbrain builder ``bench.splitbrain_executable`` and its check."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import pytest
import torch
from _storm_parity import assert_leaves_equal, case_pair

from testground_tpu_torch import bench

CFG = dict(max_ticks=100_000)

# (plan, case, n, expected per-group outcome)
CASES = [
    ("network", "ping-pong", 2, (2, 2)),
    ("network", "traffic-allowed", 2, (2, 2)),
    ("network", "traffic-blocked", 2, (2, 2)),
    ("splitbrain", "drop", 6, (6, 6)),
    ("splitbrain", "reject", 6, (6, 6)),
    ("splitbrain", "accept", 6, (6, 6)),
    ("splitbrain", "drop-sampled", 24, (24, 24)),
    ("splitbrain", "reject-sampled", 24, (24, 24)),
    ("splitbrain", "accept-sampled", 24, (24, 24)),
    ("example", "output", 5, (5, 5)),
    ("example", "failure", 5, (0, 5)),
    ("example", "panic", 5, (0, 5)),
    ("example", "params", 5, (5, 5)),
    ("example", "sync", 5, (5, 5)),
    ("example", "metrics", 5, (5, 5)),
    ("example", "artifact", 5, (5, 5)),
    ("placebo", "ok", 1, (1, 1)),
    ("placebo", "panic", 1, (0, 1)),
    ("placebo", "stall", 1, (0, 1)),
    ("placebo", "abort", 1, (0, 1)),
    ("placebo", "metrics", 1, (1, 1)),
    ("verify", "uses-data-network", 4, (4, 4)),
]


def _errors(res):
    return {r["instance"]: int(r["value"]) for r in res.metrics_records()
            if r["name"] == "errors"}


@pytest.mark.parametrize("plan,case,n,outcome", CASES,
                         ids=[f"{p}-{c}-n{n}" for p, c, n, _ in CASES])
def test_plan_case_matches_jax(plan, case, n, outcome):
    jr, tr = case_pair(case, n, plan=plan, **CFG)
    assert tr.ticks == jr.ticks
    assert assert_leaves_equal(jr.state, tr.state) > 0
    assert tr.outcomes() == jr.outcomes() == {"single": outcome}
    if case == "ping-pong":
        rtts = {(r["name"], r["instance"]): r["value"] * 1000
                for r in tr.metrics_records()
                if r["name"].startswith("ping_rtt")}
        for i in (0, 1):
            assert 200 <= rtts[("ping_rtt_200", i)] <= 215
            assert 20 <= rtts[("ping_rtt_10", i)] <= 35
    if case in ("drop", "reject", "accept"):
        # regions: seq = i + 1, region (i + 1) % 3; A = {2, 5}, B = {0, 3}
        want = ({0: 2, 1: 0, 2: 2, 3: 2, 4: 0, 5: 2} if case != "accept"
                else {i: 0 for i in range(6)})
        assert _errors(tr) == _errors(jr) == want
    if case.endswith("-sampled"):
        errs = sum(_errors(tr).values())
        assert errs == sum(_errors(jr).values())
        assert (errs == 0) == (case == "accept-sampled")
    if case == "stall":
        assert tr.ticks == CFG["max_ticks"]


def test_splitbrain_builder_and_check():
    ex = bench.splitbrain_executable(24, device="cpu", case="accept-sampled")
    assert (ex.config.quantum_ms, ex.config.max_ticks) == (1.0, 100_000)
    assert ex.program.net_spec.send_slots is None  # the queue is > 50k
    res = ex.run()
    out = bench.check_splitbrain(res, 24)
    assert out["ok"] == 24 and out["errors"] == 0
    assert out["net_dropped"] == out["egress_overflow"] == 0
    # the check catches an instance that did not finish ok
    res.state["status"][3] = 2
    with pytest.raises(AssertionError, match="23/24"):
        bench.check_splitbrain(res, 24)


def test_splitbrain_builder_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        bench.splitbrain_executable(24)
