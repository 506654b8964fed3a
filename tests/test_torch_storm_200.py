"""storm in count mode at n = 200, the port against the JAX package on
the CPU, with ``__graft_entry__``'s compressed params: unshaped and
shaped with churn, with event skip on (the default) and off, and
``phase_gating=True`` as bench.py runs it. Every state leaf bit-equal,
ticks and ticks executed equal."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import numpy as np
import pytest

from _storm_parity import assert_leaves_equal, storm_pair


@pytest.mark.parametrize("shaped", [False, True])
def test_storm_200_matches_jax(shaped):
    n = 200
    jr, tr = storm_pair(n, shaped)
    assert (tr.ticks, tr.ticks_executed) == (jr.ticks, jr.ticks_executed)
    assert assert_leaves_equal(jr.state, tr.state) >= 40
    assert tr.outcomes() == jr.outcomes()
    recs = tr.metrics_records()
    sent = sum(r["value"] for r in recs if r["name"] == "bytes.sent")
    read = sum(r["value"] for r in recs if r["name"] == "bytes.read")
    if not shaped:
        assert tr.outcomes()["single"] == (n, n)
        assert read == sent == n * 4 * 32 * 1024
    else:
        assert 0 < read <= sent


@pytest.mark.parametrize("shaped", [False, True])
def test_storm_200_dense_matches_jax(shaped):
    """Event skip off: the dense leaf set (no ``ticks_executed``,
    ``staging_cnt`` or ``wheel_occ``), every tick executed."""
    n = 200
    jr, tr = storm_pair(n, shaped, event_skip=False)
    assert tr.ticks == jr.ticks
    assert tr.ticks_executed == jr.ticks_executed == tr.ticks
    assert "ticks_executed" not in tr.state
    assert assert_leaves_equal(jr.state, tr.state) >= 38
    assert tr.outcomes() == jr.outcomes()
    st = tr.statuses()[:n]
    if shaped:
        victims = tr.state["kill_tick"].numpy()[:n] >= 0
        assert victims.any()
        assert (st[victims] == 3).all() and (st[~victims] == 1).all()
        assert tr.net_horizon_clamped() == 0
    else:
        assert (st == 1).all()
    assert np.asarray(tr.state["net"]["inbox_dropped"]).sum() == 0
