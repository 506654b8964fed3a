"""The port's runner against the JAX package's with the planes on, on the
CPU: faultsdemo's chaos case at its composition's 4 instances with the
composition's [faults], [trace] and [telemetry] tables (traced and
sampled), the same drained (trace.jsonl and the streamed results.out),
and with every table marked disabled (the ``--no-*`` legs, each
journaled "disabled"); election's quorum case with its composition's
[replay] and [faults]. Then the pre-flight: the state model equal to
JAX's and, from the same admissible bytes, the same tier chosen."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import tomllib

import pytest
from _runner_parity import REPO, assert_runs_equal, one_device_jax, run_pair

from testground_tpu.api import composition as jcomp
from testground_tpu.sim import runner as jrunner
from testground_tpu_torch.sim import runner as trunner
from testground_tpu_torch.sim import tables as ttables
from testground_tpu_torch.sim.sweep import state_bytes


def _comp(plan):
    with open(REPO / "plans" / plan / "composition.toml", "rb") as f:
        return tomllib.load(f)


def _tables(**dicts):
    """Each table dict as (JAX table, port table)."""
    kinds = {"faults": (jcomp.Faults, ttables.Faults),
             "trace": (jcomp.Trace, ttables.Trace),
             "telemetry": (jcomp.Telemetry, ttables.Telemetry),
             "replay": (jcomp.Replay, ttables.Replay)}
    return {k: (kinds[k][0].from_dict(v), kinds[k][1].from_dict(v))
            for k, v in dicts.items() if v is not None}


def _faultsdemo_groups():
    comp = _comp("faultsdemo")
    params = {k: str(v)
              for k, v in comp["global"]["run"]["test_params"].items()}
    params["min_pings"] = "0"  # the manifest's default
    return comp, [(g["id"], g["instances"]["count"], params)
                  for g in comp["groups"]]


def test_faultsdemo_4_traced_and_sampled_matches_jax(tmp_path):
    comp, groups = _faultsdemo_groups()
    (_, jd), (_, td) = run_pair(
        "faultsdemo", "chaos", groups, tmp_path,
        run_config={"max_ticks": 2_000},
        **_tables(faults=comp["faults"], trace=comp["trace"],
                  telemetry=comp["telemetry"]))
    s = assert_runs_equal(jd, td)
    assert s["outcome"] == "success" and s["restarted_count"] == 1
    assert s["trace_events"] > 0 and s["telemetry_samples"] > 0
    assert s["faults"]  # the realized timeline
    assert (td / "trace.json").exists() and (td / "results.out").exists()


def test_faultsdemo_4_drained_matches_jax(tmp_path):
    comp, groups = _faultsdemo_groups()
    (_, jd), (_, td) = run_pair(
        "faultsdemo", "chaos", groups, tmp_path,
        run_config={"max_ticks": 2_000, "chunk_ticks": 50},
        **_tables(faults=comp["faults"],
                  trace=dict(comp["trace"], drain=True),
                  telemetry=dict(comp["telemetry"], drain=True)))
    s = assert_runs_equal(jd, td)
    assert s["drain"]["batches"] > 1 and s["trace_dropped"] == 0
    assert s["hbm_preflight"]["observer_drain"]["lossless_tiers"]
    assert (td / "trace.jsonl").stat().st_size > 0


def test_faultsdemo_4_disabled_tables_match_jax(tmp_path):
    comp, groups = _faultsdemo_groups()
    off = {"enabled": False}
    (_, jd), (_, td) = run_pair(
        "faultsdemo", "chaos", groups, tmp_path,
        run_config={"max_ticks": 2_000},
        live=(off, off), checkpoint=(off, off),
        **_tables(faults=dict(comp["faults"], disabled=True),
                  trace=dict(comp["trace"], enabled=False),
                  telemetry=dict(comp["telemetry"], enabled=False)))
    s = assert_runs_equal(jd, td)
    for key in ("faults", "telemetry", "live", "checkpoint"):
        assert s[key] == "disabled", key
    assert "trace_events" not in s
    assert not (td / "progress.jsonl").exists()
    assert not (td / "trace.json").exists()


def test_election_5_with_replay_matches_jax(tmp_path):
    comp = _comp("election")
    params = {k: str(v)
              for k, v in comp["global"]["run"]["test_params"].items()}
    groups = [(g["id"], g["instances"]["count"], params)
              for g in comp["groups"]]
    (_, jd), (_, td) = run_pair(
        "election", "quorum", groups, tmp_path,
        **_tables(faults=comp["faults"], replay=comp["replay"]))
    s = assert_runs_equal(jd, td)
    assert s["outcome"] == "success"
    assert s["replay"]["consumed"] > 0 and s["restarted_count"] == 1


# ------------------------------------------------------------ pre-flight


def _rinputs(trace, telemetry, metrics_capacity=64):
    """The faultsdemo RunInputs of both packages (never run)."""
    comp, groups = _faultsdemo_groups()
    from _runner_parity import rinputs

    ri_j, ri_t = rinputs("faultsdemo", "chaos", groups, "/nonexistent/j",
                         "/nonexistent/t",
                         run_config={"max_ticks": 2_000,
                                     "metrics_capacity": metrics_capacity},
                         **_tables(faults=comp["faults"], trace=trace,
                                   telemetry=telemetry))
    return ri_j, ri_t


@pytest.mark.parametrize("trace,telemetry", [
    ({"capacity": 256}, {"interval": 10}),
    ({"capacity": 64}, None),
    (None, {"interval": 1, "probes": ["net_sends", "live_lanes"]}),
])
def test_preflight_state_model_and_tier_match_jax(trace, telemetry):
    comp, _ = _faultsdemo_groups()
    ri_j, ri_t = _rinputs(trace, telemetry)
    _, jbuild = jrunner._load_build_fn(ri_j)
    _, tbuild = trunner._load_build_fn(ri_t)
    jctx = jrunner.build_context_from_input(ri_j)
    tctx = trunner.build_context_from_input(ri_t)
    from testground_tpu.sim.core import SimConfig as JConfig
    from testground_tpu.sim.core import compile_program as jcompile
    from testground_tpu_torch.sim.core import SimConfig as TConfig
    from testground_tpu_torch.sim.core import compile_program as tcompile

    cfg = dict(max_ticks=2_000, metrics_capacity=64, chunk_ticks=8_192)
    jtr, ttr = (jrunner._trace_table(ri_j), trunner._trace_table(ri_t))
    jtl, ttl = (jrunner._telemetry_table(ri_j),
                trunner._telemetry_table(ri_t))

    def jmake(extra, c):
        return jcompile(jbuild, jctx, c, faults=ri_j.faults,
                        trace=jrunner._trace_capped(jtr, extra),
                        telemetry=jrunner._telemetry_capped(jtl, extra))

    def tmake(extra, c):
        return tcompile(tbuild, tctx, c, device="cpu", faults=ri_t.faults,
                        trace=trunner._trace_capped(ttr, extra),
                        telemetry=trunner._telemetry_capped(ttl, extra))

    def both(admissible):
        with one_device_jax():
            jex, jrep = jrunner.preflight_autosize(
                jmake, JConfig(**cfg),
                budget=int(admissible / jrunner._HBM_FRACTION),
                trace_tiers=jrunner._trace_tiers(jtr),
                telemetry_tiers=jrunner._telemetry_tiers(jtl, JConfig(**cfg)))
        tex, trep = trunner.preflight_autosize(
            tmake, TConfig(**cfg),
            budget=int(admissible / trunner._HBM_FRACTION),
            trace_tiers=trunner._trace_tiers(ttr),
            telemetry_tiers=trunner._telemetry_tiers(ttl, TConfig(**cfg)),
            device="cpu")
        for r in (jrep, trep):
            for k in ("hbm_budget_bytes", "hbm_admissible_bytes"):
                r.pop(k)
        return jex, jrep, tex, trep

    # no limit: the requested tiers, the state model equal to JAX's
    jex, jrep, tex, trep = both(1 << 50)
    assert trep == jrep
    full = trep["state_model_bytes_per_device"]
    assert full == jrunner.state_model_bytes(jex) == state_bytes(tex)
    # a budget just under the full model: both shrink to the same tier
    _, jrep, _, trep = both(full - 1_000)
    assert trep == jrep
    assert trep["state_model_bytes_per_device"] < full
    # nothing fits: both refuse
    with one_device_jax(), pytest.raises(RuntimeError, match="cannot fit"):
        jrunner.preflight_autosize(jmake, JConfig(**cfg), budget=1_000)
    with pytest.raises(RuntimeError, match="cannot fit"):
        trunner.preflight_autosize(tmake, TConfig(**cfg), budget=1_000,
                                   device="cpu")
