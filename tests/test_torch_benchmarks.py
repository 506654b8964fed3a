"""The benchmarks plan's cases in the port
(testground_tpu_torch/plans/benchmarks.py) against the JAX package's
(plans/benchmarks/sim.py) on the CPU, at small sizes (the sizes of
tests/test_benchmarks_exec.py and a few lanes): every state leaf equal,
bit for bit, and ``SimResult.ticks`` equal. Storm has its own files
(tests/test_torch_storm*.py). Also the port's bench builders and their
checks (testground_tpu_torch/bench.py, tools/bench_barrier.py,
tools/bench_subtree.py) at a small size on the CPU."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import numpy as np
import pytest
import torch
from _storm_parity import (
    assert_leaves_equal,
    case_pair,
    jax_plan,
    jax_run,
    torch_run,
)

from testground_tpu_torch import bench
from testground_tpu_torch.plans import benchmarks as tbench
from testground_tpu_torch.tools import bench_barrier, bench_subtree

# (case, n, params, SimConfig fields)
CASES = [
    ("startup", 3, {}, dict(max_ticks=1_000)),
    ("startup", 3, {}, dict(max_ticks=1_000, quantum_ms=10.0)),
    ("netinit", 4, {}, dict(max_ticks=1_000, quantum_ms=10.0)),
    ("netlinkshape", 4, {}, dict(max_ticks=1_000, quantum_ms=10.0)),
    ("barrier", 3, {"barrier_iterations": 2},
     dict(max_ticks=5_000, metrics_capacity=18)),
    ("barrier", 7, {"barrier_iterations": 2},
     dict(max_ticks=5_000, quantum_ms=10.0, metrics_capacity=18)),
    ("subtree", 2, {"subtree_iterations": 5}, dict(max_ticks=5_000)),
    ("subtree", 5, {"subtree_iterations": 5},
     dict(max_ticks=5_000, quantum_ms=10.0, event_skip=False)),
    ("sparsetimer", 4, {"timer_rounds": 3, "timer_period_ms": 10},
     dict(max_ticks=50_000, metrics_capacity=16)),
]


@pytest.mark.parametrize(
    "case,n,params,cfg", CASES,
    ids=[f"{c}-n{n}-q{cfg.get('quantum_ms', 1.0):g}" for c, n, _, cfg in CASES])
def test_case_matches_jax(case, n, params, cfg):
    jr, tr = case_pair(case, n, params, chunk_ticks=16, **cfg)
    assert tr.ticks == jr.ticks
    assert assert_leaves_equal(jr.state, tr.state) > 0
    assert (tr.statuses()[:n] == 1).all(), tr.statuses()


def test_sparsetimer_dense_and_skipped_match_jax_and_each_other():
    """Both loops against JAX, and the skipped state equal to the dense
    one but for the skip's own leaves; the skip executes fewer ticks."""
    params = {"timer_rounds": 4, "timer_period_ms": 20}
    cfg = dict(max_ticks=50_000, metrics_capacity=16)
    runs = {}
    for skip in (False, True):
        jr, tr = case_pair("sparsetimer", 6, params, chunk_ticks=16,
                           event_skip=skip, **cfg)
        assert tr.ticks == jr.ticks
        assert assert_leaves_equal(jr.state, tr.state) > 0
        runs[skip] = tr
    dense, skipped = runs[False], runs[True]
    assert bench.check_skip(dense, skipped, 6) > 0
    assert skipped.ticks_executed < dense.ticks_executed == dense.ticks
    # one beat a round, every beat's ping read
    beats = [r["value"] for r in skipped.metrics_records()
             if r["name"] == "beats"]
    assert beats == [4.0] * 6


@pytest.mark.parametrize("x,x_fail,status", [
    (0.3, 0.5, 1), (0.7, 0.5, 2), (0.5, 0.5, 1)])
def test_cliff_both_sides(x, x_fail, status):
    jr, tr = case_pair("cliff", 3, {"x": x, "x_fail": x_fail},
                       max_ticks=100)
    assert tr.ticks == jr.ticks
    assert assert_leaves_equal(jr.state, tr.state) > 0
    assert (tr.statuses()[:3] == status).all()


def test_cliff_per_instance_params():
    """Two groups on either side of the cliff: the params are per
    instance, and the case returns them."""
    groups = [("below", 0, 2, {"x": "0.25"}),
              ("above", 1, 3, {"x": "0.75", "x_fail": "0.5"})]
    jr = jax_run(jax_plan("cliff"), groups, dict(max_ticks=100),
                 case="cliff")
    tr = torch_run(tbench.cliff, groups, dict(max_ticks=100), case="cliff")
    assert assert_leaves_equal(jr.state, tr.state) > 0
    assert tr.outcomes() == {"below": (2, 2), "above": (0, 3)}
    assert tr.executable.params["x"].tolist()[:5] == [0.25, 0.25, 0.75,
                                                      0.75, 0.75]


def test_bench_barrier_builder_and_check():
    ex = bench.barrier_executable(4, 3, device="cpu")
    assert ex.config.metrics_capacity == 5 * 3 + 8
    res = ex.run()
    out = bench_barrier.check(res, 4, 3)
    assert out["barriers"] == 30 and out["ok"] == 4
    names = {r["name"] for r in res.metrics_records()}
    assert names == {f"barrier_time_{p}_percent" for p in (20, 40, 60, 80,
                                                            100)}


def test_bench_subtree_builder_and_check():
    res = bench.subtree_executable(3, 4, device="cpu").run()
    out = bench_subtree.check(res, 3, 4)
    assert out["topics_checked"] == 7 and out["stream_violations"] == 0
    assert len(out["virtual_secs"]) == 7
    # the check catches a corrupted row
    res.state["topic_bufs"][3][2, 1] += 1.0
    with pytest.raises(AssertionError, match="payload corruption"):
        bench_subtree.check(res, 3, 4)


def test_bench_skip_config():
    ex = bench.sparsetimer_executable(8, True, device="cpu")
    cfg = ex.config
    assert (cfg.quantum_ms, cfg.metrics_capacity, cfg.max_ticks) == (
        1.0, 16, max(50_000, 50 * 100 * 3))
    assert ex.event_skip and not bench.sparsetimer_executable(
        8, False, device="cpu").event_skip
    assert np.all(ex.init_state()["status"].numpy() == 0)


def test_new_entry_points_need_cuda_unless_cpu(monkeypatch):
    """The builders and the tools default to the card and raise without
    one; the CPU runs only when asked for (the tests above)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: bench.barrier_executable(4, 2),
                 lambda: bench.subtree_executable(4, 2),
                 lambda: bench.sparsetimer_executable(4, True),
                 lambda: bench_barrier.main(["4", "2"]),
                 lambda: bench_subtree.main(["4", "2"]),
                 lambda: bench.main(["--skip"])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
