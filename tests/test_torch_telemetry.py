"""The telemetry plane of the port (testground_tpu_torch/sim/telemetry.py,
the hook sites of sim/core.py and sim/net.py, the [telemetry] table of
sim/tables.py) against the JAX package, on the CPU: the mirrors of
tests/test_telemetry.py's TestSampling, TestRecordsDemux,
TestEventSkipIdentity and TestRestartContinuity, each run through both
packages with every state leaf and the demuxed records equal; the log2
bucket thresholds (XLA's ``exp2``, which is not exact from 2^13 on) and
observations on them; the compile errors and the table's errors,
message for message; and a disabled [telemetry] table, which builds
the plain program (the same leaves and ops a tick)."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import jax.numpy as jnp
import numpy as np
import pytest
from _plane_parity import assert_planes_equal, run_pair, t_build, tick_op_log
from test_torch_trace import CHAOS_GROUPS, CHAOS_TIMELINE, faultsdemo

from testground_tpu.api import CompositionError as JCompositionError
from testground_tpu.api import Telemetry as JTelemetry
from testground_tpu.api import TelemetryHistogram as JHist
from testground_tpu.sim import telemetry as jtel
from testground_tpu_torch.sim import tables
from testground_tpu_torch.sim import telemetry as ttel


def groups(n):
    return [("single", 0, n, {})]


def pair_of(build, n, telemetry, **cfg):
    cfg.setdefault("max_ticks", 100)
    cfg.setdefault("quantum_ms", 1.0)
    return run_pair(build, build, groups(n), telemetry=telemetry, **cfg)


def chaos_pair(telemetry, event_skip=None, fused=True):
    jplan, tplan = faultsdemo()
    return run_pair(jplan, tplan, CHAOS_GROUPS, case="chaos",
                    faults=CHAOS_TIMELINE, telemetry=telemetry,
                    quantum_ms=1.0, max_ticks=400, event_skip=event_skip,
                    fused_observers=fused)


def telem(pair):
    return {k: v.numpy() for k, v in pair[1][1].state["telem"].items()}


class TestSampling:
    @pytest.mark.parametrize("event_skip", [False, True])
    def test_counters_gauges_and_histograms_record(self, event_skip):
        def build(b):
            b.count(2)
            b.gauge(lambda env, mem: env.instance * 1.0)
            b.observe(0, lambda env, mem: 7.0)
            b.sleep_ms(5)
            b.signal_and_wait("all")
            b.end_ok()

        pair = pair_of(build, 4, {"interval": 10,
                                  "histograms": [{"name": "lat"}]},
                       event_skip=event_skip)
        assert_planes_equal(*pair)
        (_, _), (ex, res) = pair
        assert res.outcomes() == {"single": (4, 4)}
        assert res.telemetry_samples() == 1 and res.telemetry_clipped() == 0
        spec, st = ex.telemetry, telem(pair)
        probes = {p: k for k, p in enumerate(spec.lane_probes)}
        buf = st["lane_buf"]
        np.testing.assert_array_equal(buf[:4, 0, probes["user_count"]], 2)
        np.testing.assert_array_equal(buf[:4, 0, probes["user_gauge"]],
                                      [0.0, 1.0, 2.0, 3.0])
        np.testing.assert_array_equal(buf[:4, 0, probes["sync_signals"]], 1)
        assert (st["hist"][:4, 0, 2] == 1).all() and st["hist"].sum() == 4
        assert st["glob_buf"][0, spec.glob.index("live_lanes")] == 4.0

    def test_counters_reset_at_each_boundary(self):
        def build(b):
            h = b.loop_begin(30)
            b.count(1)
            b.loop_end(h)
            b.end_ok()

        pair = pair_of(build, 2, {"interval": 10, "probes": ["user_count"]})
        assert_planes_equal(*pair)
        res = pair[1][1]
        cnt = res.telemetry_samples()
        buf = telem(pair)["lane_buf"]
        assert cnt >= 2
        assert (buf[0, :cnt, 0] <= 10).all() and buf[0, :cnt, 0].sum() <= 30

    def test_histograms_clamp_to_their_own_declared_width(self):
        def build(b):
            b.observe(0, lambda env, mem: 1e6)
            b.observe(1, lambda env, mem: 1e6)
            b.end_ok()

        pair = pair_of(build, 2, {"interval": 10, "histograms": [
            {"name": "narrow", "buckets": 4},
            {"name": "wide", "buckets": 24}]}, max_ticks=50)
        assert_planes_equal(*pair)
        ex = pair[1][0]
        assert ex.telemetry.n_buckets == 24
        assert ex.telemetry.hist_buckets == (4, 24)
        hist = telem(pair)["hist"]
        assert (hist[:2, 0, 3] == 1).all() and hist[:, 0, 4:].sum() == 0
        assert (hist[:2, 1, 19] == 1).all()

    def test_observations_on_the_bucket_thresholds(self):
        """Values at and next to every power of two up to 2^30 (XLA's
        exp2 thresholds miss some powers by a few ulp, so a value equal
        to the power can fall in the bucket below)."""
        vals = sorted({float(v) for k in range(31) for v in (
            np.float32(2.0 ** k), np.nextafter(np.float32(2.0 ** k), 0),
            np.nextafter(np.float32(2.0 ** k), np.inf))})
        chunks = [vals[i:i + 24] for i in range(0, len(vals), 24)]

        def prog(xp):
            def build(b):
                for chunk in chunks:
                    table = np.asarray(chunk, np.float32)

                    def fn(env, mem, table=table):
                        return xp.asarray(table)[env.instance % len(table)]

                    b.observe(0, fn)
                b.end_ok()

            return build

        import torch

        pair = run_pair(prog(jnp), prog(torch), groups(24), quantum_ms=1.0,
                        max_ticks=50, telemetry={"interval": 10,
                                                 "histograms": [
                                                     {"name": "h",
                                                      "buckets": 32}]})
        assert_planes_equal(*pair)
        assert telem(pair)["hist"].sum() == 24 * len(chunks)

    def test_probe_subset_compiles_only_selected(self):
        def build(b):
            b.signal_and_wait("all")
            b.end_ok()

        pair = pair_of(build, 2, {"interval": 50, "probes": ["sync_signals"]},
                       max_ticks=20000)
        assert_planes_equal(*pair)
        spec = pair[1][0].telemetry
        assert spec.counters == ("sync_signals",)
        assert spec.gauges == () and spec.glob == ()
        assert set(telem(pair)) == {"cnt", "clipped", "lane_buf",
                                    "acc_sync_signals"}

    def test_full_buffer_counts_clipped_boundaries(self):
        # a hand-built spec with a 2-row buffer under a 10-boundary run
        from _plane_parity import j_build
        from _storm_parity import assert_leaves_equal

        def build(b):
            b.sleep_ms(99)
            b.end_ok()

        kw = dict(interval=10, s_cap=2, counters=("user_count",),
                  glob=("live_lanes",))
        jex = j_build(build, groups(2), quantum_ms=1.0, max_ticks=100)
        jex = type(jex)(jex.program, jex.ctx, jex.config, mesh=jex.mesh,
                        telemetry=jtel.TelemetrySpec(**kw))
        tex = t_build(build, groups(2), quantum_ms=1.0, max_ticks=100)
        tex = type(tex)(tex.program, tex.ctx, tex.config, device="cpu",
                        telemetry=ttel.TelemetrySpec(**kw))
        jr, tr = jex.run(), tex.run()
        assert tr.telemetry_samples() == jr.telemetry_samples() == 2
        assert tr.telemetry_clipped() == jr.telemetry_clipped() == 8
        assert_leaves_equal(jr.state, tr.state)


@pytest.mark.parametrize("table,cfg,n_net", [
    ({"interval": 1}, dict(max_ticks=jtel.MAX_SAMPLES * 2), False),
    ({"probes": ["net_sends"]}, {}, False),
    ({"probes": ["net_sendz"]}, {}, False),
    ({"interval": 0}, {}, False),
    ({"samples": 3, "interval": 10}, dict(max_ticks=100), False),
    ({"probes": ["wheel_occ"]}, {}, True),
])
def test_compile_errors_match_jax(table, cfg, n_net):
    def build(b):
        if n_net:
            b.enable_net()
        b.end_ok()

    cfg = dict(dict(max_ticks=20000), **cfg)
    with pytest.raises(jtel.TelemetryError) as want:
        run_pair(build, build, groups(2), telemetry=table, **cfg)
    with pytest.raises(ttel.TelemetryError) as got:
        t_build(build, groups(2), telemetry=table, **cfg)
    assert str(got.value) == str(want.value)


def test_capability_gated_probes_elide_without_faults():
    jplan, tplan = faultsdemo()
    table = {"interval": 20,
             "probes": ["net_sends", "net_drops", "net_drops_partition"]}
    kw = dict(case="chaos", quantum_ms=1.0, max_ticks=400, telemetry=table)
    pair = run_pair(jplan, tplan, CHAOS_GROUPS, **kw)
    assert_planes_equal(*pair)
    assert pair[1][0].faults is None
    assert pair[1][0].telemetry.counters == ("net_sends", "net_drops")
    ex2 = t_build(tplan, CHAOS_GROUPS, faults=CHAOS_TIMELINE, **kw)
    assert "net_drops_partition" in ex2.telemetry.counters


def test_bucket_thresholds_are_jax_exp2():
    for B in (2, 4, 24, 32):
        want = np.asarray(jnp.exp2(jnp.arange(1, B, dtype=jnp.float32)))
        got = ttel.bucket_thresholds(B)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # ...and they are not all powers of two
    assert not np.array_equal(ttel.bucket_thresholds(32),
                              2.0 ** np.arange(1, 32))
    for b in (0, 3, 17):
        assert ttel.hist_bounds(b) == jtel.hist_bounds(b)


class TestRecordsDemux:
    def test_lane_records_carry_group_and_interval_end_time(self):
        pair = chaos_pair({"interval": 20})
        assert_planes_equal(*pair)
        res = pair[1][1]
        lane, glob = res.telemetry_records()
        part = [r for r in lane if r["name"] == "telemetry.net_drops_partition"]
        assert part and all(r["virtual_time_s"] == 0.02 for r in part)
        assert {r["group"] for r in lane} <= {"left", "right"}
        live = [r for r in glob if r["name"] == "telemetry.live_lanes"]
        assert len(live) == res.telemetry_samples()
        assert live[0]["value"] == 6.0
        assert {r["instance"] for r in glob} == {""}

    def test_zero_cells_are_elided_deterministically(self):
        pair = chaos_pair({"interval": 20})
        lane, _ = pair[1][1].telemetry_records()
        assert all(r["value"] != 0.0 for r in lane)
        assert pair[1][1].telemetry_records() == (lane, _)


class TestEventSkipIdentity:
    @pytest.mark.parametrize("fused", [True, False])
    def test_chaos_timeline_skip_matches_dense(self, fused):
        dense = chaos_pair({"interval": 20}, event_skip=False, fused=fused)
        skip = chaos_pair({"interval": 20}, event_skip=True, fused=fused)
        assert_planes_equal(*dense)
        assert_planes_equal(*skip)
        for k, v in telem(dense).items():
            np.testing.assert_array_equal(telem(skip)[k], v, err_msg=k)
        assert dense[1][1].telemetry_samples() > 0

    def test_idle_plan_executes_every_boundary(self):
        def build(b):
            b.sleep_ms(195)
            b.end_ok()

        kw = dict(quantum_ms=1.0, max_ticks=300)
        bare = t_build(build, groups(2), event_skip=True, **kw).run()
        rs = pair_of(build, 2, {"interval": 10}, event_skip=True, **kw)
        rd = pair_of(build, 2, {"interval": 10}, event_skip=False, **kw)
        assert_planes_equal(*rs)
        assert_planes_equal(*rd)
        s, d = rs[1][1], rd[1][1]
        assert s.telemetry_samples() == d.telemetry_samples() >= 19
        assert s.ticks_executed >= s.telemetry_samples()
        assert bare.ticks_executed < s.ticks_executed


class TestRestartContinuity:
    def test_first_life_samples_survive_the_rejoin(self):
        pair = chaos_pair({"interval": 20})
        assert_planes_equal(*pair)
        (_, _), (ex, res) = pair
        assert res.outcomes() == {"left": (3, 3), "right": (3, 3)}
        (victims,) = np.nonzero(res.state["restarts"].numpy())
        assert len(victims) == 1
        v = int(victims[0])
        spec = ex.telemetry
        buf = telem(pair)["lane_buf"]
        assert buf[v, 0, spec.lane_probes.index("net_sends")] > 0
        assert buf[:, 2, spec.lane_probes.index("net_drops_churn")].sum() > 0
        assert res.telemetry_clipped() == 0 and res.telemetry_samples() >= 3


# ------------------------------------------------------------- the table


@pytest.mark.parametrize("d", [
    {"intervall": 9},
    {"interval": 0},
    {"samples": -1},
    {"probes": ["net_sendz"]},
    {"probes": "net_sends"},
    {"histograms": [{"name": "x", "bucket": 8}]},
    {"histograms": [{"buckets": 8}]},
    {"histograms": [{"name": "a", "buckets": 1}]},
    {"histograms": [{"name": "a"}, {"name": "a"}]},
    {"histograms": [{"name": f"h{i}"} for i in range(9)]},
    {"histograms": {"name": "a"}},
])
def test_telemetry_table_errors_match_jax(d):
    def text(cls, err):
        with pytest.raises(err) as e:
            cls.from_dict(d).validate()
        return str(e.value)

    assert text(tables.Telemetry, tables.CompositionError) == text(
        JTelemetry, JCompositionError)


def test_telemetry_table_parse_matches_jax():
    d = {"interval": 250, "probes": ["sync_signals", "live_lanes"],
         "histograms": [{"name": "lat", "buckets": 16}], "samples": 7,
         "drain": True, "enabled": False}
    t, j = tables.Telemetry.from_dict(d), JTelemetry.from_dict(d)
    assert {k: v for k, v in vars(t).items() if k != "histograms"} == {
        k: v for k, v in vars(j).items() if k != "histograms"}
    assert [vars(h) for h in t.histograms] == [vars(h) for h in j.histograms]
    assert vars(tables.TelemetryHistogram()) == vars(JHist())


def test_disabled_telemetry_builds_the_plain_program():
    jplan, tplan = faultsdemo()
    kw = dict(case="chaos", faults=CHAOS_TIMELINE, quantum_ms=1.0,
              max_ticks=400)
    plain = t_build(tplan, CHAOS_GROUPS, **kw)
    off = t_build(tplan, CHAOS_GROUPS,
                  telemetry={"enabled": False, "interval": 5}, **kw)
    assert off.telemetry is None
    ops_a, leaves_a = tick_op_log(plain)
    ops_b, leaves_b = tick_op_log(off)
    assert leaves_a == leaves_b and ops_a == ops_b
    on = t_build(tplan, CHAOS_GROUPS, telemetry={"interval": 5}, **kw)
    ops_c, leaves_c = tick_op_log(on)
    assert "telem/lane_buf" in leaves_c and len(ops_c) > len(ops_a)
