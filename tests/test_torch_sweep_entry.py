"""An entry-mode sweep, the port (testground_tpu_torch/sim/sweep.py)
against the JAX package on the CPU: dht's find-providers on the default
lowering with churn at 160 (past its 128 send slots, so an egress queue
and the bounded append), whose batched tick merges each scenario's
messages into its inbox rings through the ring merge's vmap rule
(sim/ring_merge.py). Scenario s of the port sweep equals the JAX sweep's scenario s and
the port's serial run on every state leaf, bit for bit."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads)
from _storm_parity import jax_plan, torch_plan
from test_torch_dht import CFG, PARAMS
from test_torch_sweep import assert_scenario, j_sweep, t_serial, t_sweep

N = 160


def test_entry_mode_sweep_matches_serial_and_jax():
    """find-providers at N over two seeds, which end apart."""
    case = "find-providers"
    groups = [("single", 0, N, {k: str(v) for k, v in PARAMS.items()})]
    scen = [{"seed": s, "params": {}} for s in (0, 5)]
    cfg = dict(CFG, pallas_front=None)
    jres = j_sweep(jax_plan(case, "dht"), groups, scen, case, **cfg).run()
    tres = t_sweep(torch_plan(case, "dht"), groups, scen, case,
                   **cfg).run()
    assert tres.scenario(0).ticks != tres.scenario(1).ticks
    for s in range(2):
        serial = t_serial(torch_plan(case, "dht"), groups, scen[s], case,
                          **cfg)
        assert assert_scenario(jres, tres, s, serial) > 30
        r = tres.scenario(s)
        assert int(r.state["net"]["inbox_w"].sum()) > 0
        assert "pend_dest" in r.state["net"]
