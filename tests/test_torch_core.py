"""The port's tick-engine pieces (testground_tpu_torch/sim/core.py,
subkernels.py) against the JAX package's: the signal ranking, the
stable same-id ranks, the metrics ring append and the churn schedule.
Exact equality."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from testground_tpu.sim import core as jc
from testground_tpu.sim import subkernels as jsk
from testground_tpu_torch.sim import core as tc
from testground_tpu_torch.sim import net as tn
from testground_tpu_torch.sim import subkernels as tsk


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _eq(got, want, msg=""):
    g, w = got.numpy(), np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (msg, g.dtype, w.dtype)
    if g.dtype.kind == "f":
        g, w = g.view(np.int32), w.view(np.int32)
    np.testing.assert_array_equal(g, w, err_msg=msg)


@pytest.mark.parametrize(
    "seed,n,table,distinct,emit_p",
    [
        (0, 300, 4, 4, 0.5),      # small table: the JAX one-hot path
        (1, 1000, 64, 30, 0.3),   # largest one-hot table
        (2, 2000, 500, 5, 0.6),   # large table, few ids: the few path
        (3, 2000, 500, 200, 0.6),  # large table, many ids: the sort path
        (4, 128, 10, 3, 0.0),     # nobody emits
    ],
)
def test_ranked_scatter(seed, n, table, distinct, emit_p):
    rng = np.random.default_rng(seed)
    pool = rng.choice(table, size=distinct, replace=False)
    ids = np.where(rng.random(n) < emit_p, pool[rng.integers(0, distinct, n)],
                   -1).astype(np.int32)
    prev = rng.integers(0, 1000, table).astype(np.int32)
    want = jax.jit(lambda i, p: jc._ranked_scatter(i, table, p))(
        jnp.asarray(ids), jnp.asarray(prev))
    got = tc._ranked_scatter(_t(ids), table, _t(prev))
    for g, w, name in zip(got, want, ("counts", "seq", "valid")):
        _eq(g, w, name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sort_rank(seed):
    rng = np.random.default_rng(seed)
    safe = rng.integers(0, 20, 700).astype(np.int32)
    want = jax.jit(jc._sort_rank)(jnp.asarray(safe))
    got = tn.sort_rank(_t(safe))
    _eq(got[0].to(torch.int32), want[0], "order")
    _eq(got[1], want[1], "sorted")
    _eq(got[2], want[2], "rank")


@pytest.mark.parametrize("seed,cap", [(0, 4), (1, 8)])
def test_ring_append(seed, cap):
    rng = np.random.default_rng(seed)
    n = 300
    buf = (rng.random((n, cap, 3)) * 10).astype(np.float32)
    cnt = rng.integers(0, cap + 2, n).astype(np.int32)
    dropped = rng.integers(0, 3, n).astype(np.int32)
    mask = rng.random(n) < 0.5
    rec = (rng.random((n, 3)) * 10).astype(np.float32)
    want = jsk.ring_append(*map(jnp.asarray, (buf, cnt, dropped, mask, rec)))
    got = tsk.ring_append(*map(_t, (buf, cnt, dropped, mask, rec)))
    for g, w, name in zip(got, want, ("buf", "cnt", "dropped")):
        _eq(g, w, name)


@pytest.mark.parametrize(
    "kw",
    [
        dict(churn_fraction=0.05, churn_start_ms=100.0, churn_end_ms=5000.0,
             quantum_ms=10.0, seed=0),
        dict(churn_fraction=0.3, churn_start_ms=0.0, churn_end_ms=7.0,
             quantum_ms=1.0, seed=17),
        dict(churn_fraction=0.0, seed=3),
    ],
)
def test_churn_kill_tick(kw):
    group_ids = np.zeros(1000, np.int32)
    group_ids[-40:] = -1  # padding rows never die
    want = jc.churn_kill_tick(jc.SimConfig(**kw), group_ids)
    got = tc.churn_kill_tick(tc.SimConfig(**kw), group_ids)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    other = np.where(np.arange(1000) % 7 == 0, 50, -1).astype(np.int32)
    np.testing.assert_array_equal(tc.merge_kill_ticks(got, other),
                                  jc.merge_kill_ticks(want, other))


def test_launch_count_host_path_and_cpu_stepper():
    """An eager launch counts on the host; the count resets. On the CPU
    the run loop steps with ``guarded_tick`` itself (the CUDA-graph
    stepper is the card's: tests/test_torch_cuda.py and chip_smoke.py
    hold its runs to the CPU's)."""
    from testground_tpu_torch import graft
    from testground_tpu_torch.kernels import LaunchCount

    c = LaunchCount()
    for _ in range(3):
        c.bump(torch.device("cpu"))
    assert int(c) == 3
    c.reset()
    assert int(c) == 0
    ex = graft.storm_executable(8, device="cpu")
    assert ex.stepper(ex.init_state()) == ex.guarded_tick
