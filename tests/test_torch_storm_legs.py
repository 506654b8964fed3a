"""storm in count mode, the port against the JAX package on the CPU at
n = 64, with ``__graft_entry__``'s compressed params: unshaped (the
fixed-next-tick staging row) and shaped with churn (the delay wheel, 2%
loss, SYN retries, churn-tolerant rendezvous, 5% churn), each with
event skip on and off, under ``phase_gating=True`` (which the JAX
package runs as its gated step). Every state leaf must be bit-equal by
name, and so must ticks and ticks executed."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import numpy as np
import pytest

from _storm_parity import assert_leaves_equal, storm_pair


@pytest.mark.parametrize("event_skip", [True, False])
@pytest.mark.parametrize("shaped", [False, True])
def test_storm_64_matches_jax(shaped, event_skip):
    n = 64
    jr, tr = storm_pair(n, shaped, event_skip=event_skip)
    assert tr.ticks == jr.ticks
    assert tr.ticks_executed == jr.ticks_executed
    assert_leaves_equal(jr.state, tr.state)
    st = tr.statuses()[:n]
    if shaped:
        victims = tr.state["kill_tick"].numpy()[:n] >= 0
        assert victims.any()
        assert (st[victims] == 3).all() and (st[~victims] == 1).all()
        assert tr.net_horizon_clamped() == 0
    else:
        assert (st == 1).all()
    if event_skip is False:
        assert "ticks_executed" not in tr.state
    assert np.asarray(tr.state["net"]["inbox_dropped"]).sum() == 0
