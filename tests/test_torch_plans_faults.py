"""The slice as a whole against the JAX package, on the CPU: the
faultsdemo plan's chaos case at its composition's 4 instances with the
composition's own [faults], [trace] and [telemetry] tables
(plans/faultsdemo/composition.toml), and storm at n = 64 with
``__graft_entry__``'s compressed params under bench.py's 8-event fault
timeline (``testground_tpu_torch.bench.FAULT_EVENTS``, its times
compressed with the dial window, 2 s of 30 s), traced (bench.py's 64
slots a lane) and sampled together, dense and with event skip. Every
state leaf, the trace events, the Chrome trace JSON text and the
telemetry records equal."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import tomllib

import pytest
from _plane_parity import assert_planes_equal, run_pair
from _storm_parity import jax_plan, leg_config, leg_params, torch_plan
from test_torch_trace import REPO, faultsdemo

from testground_tpu_torch import bench
from testground_tpu_torch import graft
from testground_tpu_torch.plans import faultsdemo as tdemo


def _composition():
    with open(REPO / "plans" / "faultsdemo" / "composition.toml", "rb") as f:
        return tomllib.load(f)


def test_port_copy_of_the_composition():
    comp = _composition()
    mine = tdemo.COMPOSITION
    assert mine["total_instances"] == comp["global"]["total_instances"]
    assert mine["groups"] == tuple(g["id"] for g in comp["groups"])
    assert mine["test_params"] == comp["global"]["run"]["test_params"]
    for k in ("faults", "trace", "telemetry"):
        assert mine[k] == comp[k], k


@pytest.mark.parametrize("event_skip", [False, True])
def test_faultsdemo_chaos_4_matches_jax(event_skip):
    comp = _composition()
    params = {k: str(v) for k, v in comp["global"]["run"]["test_params"].items()}
    groups = [(g["id"], i, g["instances"]["count"], params)
              for i, g in enumerate(comp["groups"])]
    assert sum(g[2] for g in groups) == comp["global"]["total_instances"] == 4
    jplan, tplan = faultsdemo()
    pair = run_pair(jplan, tplan, groups, case="chaos",
                    faults=comp["faults"], trace=comp["trace"],
                    telemetry=comp["telemetry"], max_ticks=2_000,
                    event_skip=event_skip)
    assert_planes_equal(*pair)
    (_, _), (ex, res) = pair
    from _storm_parity import assert_leaves_equal

    # the port's own `chaos_executable` gives the same run
    mine = tdemo.chaos_executable(4, "cpu", max_ticks=2_000,
                                  event_skip=event_skip).run()
    assert_leaves_equal(mine.state, res.state)
    assert res.outcomes() == {"left": (2, 2), "right": (2, 2)}
    assert res.restarts_total() == 1
    assert res.trace_events_total() > 0 and res.telemetry_samples() > 0
    # (the 256-slot rings fill before the kill at 140 ms)
    names = {e["name"] for e in res.chrome_trace()["traceEvents"]}
    assert {"drop:partition", "drop:loss"} <= names


@pytest.mark.parametrize("event_skip", [False, True])
def test_storm_64_faults_trace_telemetry_matches_jax(event_skip):
    n = 64
    params = leg_params(False)
    params.update({k: str(v) for k, v in bench.FAULT_PARAMS.items()})
    scale = graft.STORM_PARAMS["conn_delay_ms"] / bench.PARAMS["conn_delay_ms"]
    cfg = leg_config(False, max_ticks=2_000, event_skip=event_skip)
    pair = run_pair(jax_plan(), torch_plan(), [("single", 0, n, params)],
                    case="storm", faults=bench.fault_timeline(scale),
                    trace={"capacity": bench.TRACE_CAPACITY},
                    telemetry={"interval": 10}, **cfg)
    assert_planes_equal(*pair)
    (_, _), (ex, res) = pair
    summary = bench.check_plane(res, n, "faults")
    assert summary["restarted"] >= 1
    assert res.trace_events_total() > 0 and res.telemetry_samples() > 0
    spec = ex.program.net_spec
    # the degrade windows force latency (the wheel), loss and jitter
    assert spec.uses_latency and spec.uses_loss and spec.uses_jitter
    assert not spec.fixed_next_tick
