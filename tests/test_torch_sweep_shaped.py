"""The port's sweep of storm shaped with churn against its serial runs and
the JAX package's sweep on the CPU (tests/test_torch_sweep.py's storm
case at 32, shaped: each seed draws its own churn victims, the delay
wheel, loss, SYN retries), dense and event-skipped (the scenarios jump
apart); and an unshaped sweep chunked smaller than its batch, equal to
the unchunked run and to the JAX chunked sweep, with the last chunk's
padding row frozen. Every state leaf bit for bit."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import pytest
from _storm_parity import assert_leaves_equal, jax_plan, torch_plan
from test_torch_sweep import (
    STORM_N, assert_scenario, check_storm_sweep, j_sweep, scenarios,
    storm_case, t_sweep,
)

from testground_tpu_torch.sim import sweep as tsweep


@pytest.mark.parametrize("event_skip", [False, True])
def test_shaped_storm_sweep_matches_serial_and_jax(event_skip):
    tex, tres = check_storm_sweep(True, event_skip)
    # churn: each seed kills its own victims, and they crashed
    kills = [tres.scenario(s).state["kill_tick"].numpy()[:STORM_N]
             for s in range(2)]
    assert kills[0].tobytes() != kills[1].tobytes()
    assert any((k >= 0).any() for k in kills)
    for s in range(2):
        v = kills[s] >= 0
        assert (tres.scenario(s).statuses()[:STORM_N][v] == 3).all()
    if event_skip:
        # the scenarios jumped apart: their ticks differ
        assert tres.scenario(0).ticks != tres.scenario(1).ticks


def test_chunk_smaller_than_the_batch_equals_the_unchunked_run():
    groups, cfg = storm_case(False, event_skip=True)
    scen = scenarios(range(3))
    whole = t_sweep(torch_plan(), groups, scen, "storm", **cfg)
    chunked = t_sweep(torch_plan(), groups, scen, "storm", chunk=2, **cfg)
    assert (chunked.chunk_size, chunked.n_chunks) == (2, 2)
    a = whole.run()
    builds = tsweep.chunk_compiles()
    b = chunked.run()
    assert tsweep.chunk_compiles() == builds + 1  # one build, two chunks
    for s in range(3):
        assert_leaves_equal(a.scenario(s).state, b.scenario(s).state)
    # the padding row of the last chunk (scenario 0 again) was frozen
    pad = b.chunk_states[1]["status"][1].numpy()
    assert (pad == 4).all()
    jb = j_sweep(jax_plan(), groups, scen, "storm", chunk=2, **cfg).run()
    for s in range(3):
        assert_scenario(jb, b, s)
