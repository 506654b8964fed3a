"""The trace plane of the port (testground_tpu_torch/sim/trace.py, the
emission sites of sim/core.py and sim/net.py, the [trace] table of
sim/tables.py) against the JAX package, on the CPU: the mirrors of
tests/test_trace.py's TestEventLog, TestDropAttribution,
TestRestartLanes, TestEventSkipIdentity and TestChromeDemux, each run
through both packages with every state leaf, the demuxed events and the
Chrome trace JSON text equal, under both ``fused_observers`` settings;
``net.deliver``'s and ``advance_wheel``'s hooks on random states (entry
mode with and without the egress queue, duplicates, count mode under a
fault overlay), with the telemetry accumulator beside the emitter; the
table's errors; and a disabled [trace] table, which builds the plain
program (the same leaves and ops a tick)."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import importlib
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _plane_parity import assert_planes_equal, run_pair, t_build, tick_op_log

from testground_tpu.api import CompositionError as JCompositionError
from testground_tpu.api import Trace as JTrace
from testground_tpu.sim import BuildContext as JCtx
from testground_tpu.sim import net as jn
from testground_tpu.sim import telemetry as jtel
from testground_tpu.sim import trace as jtr
from testground_tpu.sim.context import GroupSpec as JGroup
from testground_tpu_torch.sim import BuildContext as TCtx
from testground_tpu_torch.sim import GroupSpec as TGroup
from testground_tpu_torch.sim import net as tn
from testground_tpu_torch.sim import prng, tables
from testground_tpu_torch.sim import telemetry as ttel
from testground_tpu_torch.sim import trace as ttr
from testground_tpu_torch.sim.program import TAG_SYN

REPO = Path(__file__).resolve().parent.parent


def faultsdemo():
    spec = importlib.util.spec_from_file_location(
        "faultsdemo_reference", REPO / "plans" / "faultsdemo" / "sim.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return (mod.testcases["chaos"],
            importlib.import_module(
                "testground_tpu_torch.plans.faultsdemo").testcases["chaos"])


CHAOS_GROUPS = [("left", 0, 3, {"pump_ms": "60"}),
                ("right", 1, 3, {"pump_ms": "60"})]
CHAOS_TIMELINE = {"events": [
    {"kind": "partition", "at_ms": 10, "a": "left", "b": "right"},
    {"kind": "heal", "at_ms": 20, "a": "left", "b": "right"},
    {"kind": "degrade", "at_ms": 25, "until_ms": 40, "a": "left",
     "b": "right", "loss_pct": 50},
    {"kind": "kill", "at_ms": 45, "group": "left", "count": 1},
    {"kind": "restart", "at_ms": 55, "group": "left"},
]}


def chaos_pair(trace, event_skip=None, fused=True, **tables_kw):
    jplan, tplan = faultsdemo()
    return run_pair(jplan, tplan, CHAOS_GROUPS, case="chaos",
                    faults=CHAOS_TIMELINE, trace=trace, quantum_ms=1.0,
                    max_ticks=400, event_skip=event_skip,
                    fused_observers=fused, **tables_kw)


def events(pair):
    return ttr.trace_events(pair[1][1].state)


def ctx_groups(n):
    return [("single", 0, n, {})]


CFG = dict(max_ticks=20000)


class TestEventLog:
    @pytest.mark.parametrize("fused", [True, False])
    def test_lane_sync_and_user_events(self, fused):
        def build(b):
            b.sleep_ms(5)
            b.trace(9, a0=lambda env, mem: env.instance, a1=4)
            b.signal_and_wait("all")
            b.end_ok()

        pair = run_pair(build, build, ctx_groups(4), quantum_ms=1.0,
                        trace={"capacity": 32}, fused_observers=fused, **CFG)
        assert_planes_equal(*pair)
        res = pair[1][1]
        assert res.outcomes() == {"single": (4, 4)}
        assert res.trace_dropped_total() == 0
        ev = events(pair)
        lane0 = ev[ev["lane"] == 0]
        blocks = lane0[(lane0["cat"] == ttr.CAT_LANE)
                       & (lane0["code"] == ttr.EV_BLOCK)]
        assert len(blocks) == 1
        assert int(blocks[0]["arg0"]) == int(blocks[0]["tick"]) + 6
        user = ev[ev["cat"] == ttr.CAT_USER]
        assert sorted(int(r["arg0"]) for r in user) == [0, 1, 2, 3]
        assert {int(r["code"]) for r in user} == {9}
        assert {int(r["arg1"]) for r in user} == {4}
        sig = ev[(ev["cat"] == ttr.CAT_SYNC) & (ev["code"] == ttr.EV_SIGNAL)]
        assert sorted(int(r["arg1"]) for r in sig) == [1, 2, 3, 4]
        done = ev[(ev["cat"] == ttr.CAT_LANE) & (ev["code"] == ttr.EV_DONE)]
        assert len(done) == 4 and {int(r["arg0"]) for r in done} == {1}

    def test_capacity_overflow_counts_dropped(self):
        def build(b):
            h = b.loop_begin(20)
            b.trace(1)
            b.loop_end(h)
            b.end_ok()

        pair = run_pair(build, build, ctx_groups(2),
                        trace={"capacity": 4, "categories": ["user"]}, **CFG)
        assert_planes_equal(*pair)
        res = pair[1][1]
        assert res.trace_events_total() == 2 * 4
        assert res.trace_dropped_total() == 2 * 16
        assert all(int(r["code"]) == 1 for r in events(pair))

    def test_category_filter_drops_other_categories(self):
        def build(b):
            b.sleep_ms(3)
            b.trace(5)
            b.signal_and_wait("all")
            b.end_ok()

        pair = run_pair(build, build, ctx_groups(2),
                        trace={"categories": ["user"]}, **CFG)
        assert_planes_equal(*pair)
        ev = events(pair)
        assert len(ev) == 2 and {int(r["cat"]) for r in ev} == {ttr.CAT_USER}

    def test_group_filter_records_only_selected_lanes(self):
        def build(b):
            b.trace(3)
            b.signal_and_wait("all")
            b.end_ok()

        pair = run_pair(build, build, [("a", 0, 2, {}), ("b", 1, 2, {})],
                        trace={"groups": ["b"]}, **CFG)
        assert_planes_equal(*pair)
        ev = events(pair)
        assert len(ev) > 0 and {int(r["lane"]) for r in ev} == {2, 3}


class TestDropAttribution:
    @pytest.mark.parametrize("fused", [True, False])
    def test_partition_loss_churn_causes(self, fused):
        pair = chaos_pair({"capacity": 256}, fused=fused)
        assert_planes_equal(*pair)
        res = pair[1][1]
        assert res.outcomes() == {"left": (3, 3), "right": (3, 3)}
        ev = events(pair)
        drops = ev[(ev["cat"] == ttr.CAT_NET) & (ev["code"] == ttr.EV_DROP)]
        causes = {int(c) for c in drops["arg0"]}
        assert {ttr.DROP_PARTITION, ttr.DROP_LOSS, ttr.DROP_CHURN} <= causes
        part = drops[drops["arg0"] == ttr.DROP_PARTITION]
        assert (part["tick"] >= 10).all() and (part["tick"] < 20).all()
        churn = drops[drops["arg0"] == ttr.DROP_CHURN]
        assert (churn["tick"] >= 45).all() and (churn["tick"] < 55).all()
        deliv = ev[(ev["cat"] == ttr.CAT_NET) & (ev["code"] == ttr.EV_DELIVER)]
        assert len(deliv) > 0

    def test_sends_match_drops_plus_deliveries_era(self):
        pair = chaos_pair({"capacity": 256})
        assert_planes_equal(*pair)
        ev = events(pair)
        net = ev[ev["cat"] == ttr.CAT_NET]
        win = net[(net["tick"] >= 10) & (net["tick"] < 20)]
        sends = win[win["code"] == ttr.EV_SEND]
        pdrops = win[(win["code"] == ttr.EV_DROP)
                     & (win["arg0"] == ttr.DROP_PARTITION)]
        assert len(sends) == len(pdrops) > 0
        assert sorted(zip(sends["lane"], sends["tick"])) == sorted(
            zip(pdrops["lane"], pdrops["tick"]))


class TestRestartLanes:
    @pytest.mark.parametrize("fused", [True, False])
    def test_first_life_events_keep_lane_id(self, fused):
        pair = chaos_pair({"capacity": 256}, fused=fused)
        assert_planes_equal(*pair)
        ev = events(pair)
        fault_ev = ev[ev["cat"] == ttr.CAT_FAULT]
        kills = fault_ev[fault_ev["code"] == ttr.EV_KILL]
        restarts = fault_ev[fault_ev["code"] == ttr.EV_RESTART]
        assert len(kills) == 1 and len(restarts) == 1
        lane = int(kills[0]["lane"])
        assert int(restarts[0]["lane"]) == lane
        assert int(restarts[0]["arg0"]) == 1
        lane_ev = ev[ev["lane"] == lane]
        assert (lane_ev["tick"] < 45).any() and (lane_ev["tick"] >= 55).any()
        assert int(kills[0]["tick"]) == 45 and int(restarts[0]["tick"]) == 55


class TestEventSkipIdentity:
    def test_skip_and_dense_logs_are_bit_identical(self):
        dense = chaos_pair({"capacity": 256}, event_skip=False)
        skip = chaos_pair({"capacity": 256}, event_skip=True)
        assert_planes_equal(*dense)
        assert_planes_equal(*skip)
        np.testing.assert_array_equal(events(dense), events(skip))
        for k in ("trace_buf", "trace_cnt", "trace_dropped"):
            np.testing.assert_array_equal(
                dense[1][1].state["trace"][k].numpy(),
                skip[1][1].state["trace"][k].numpy(), err_msg=k)


class TestChromeDemux:
    def test_chrome_trace_structure(self):
        pair = chaos_pair({"capacity": 256})
        assert_planes_equal(*pair)  # the JSON text too
        evs = pair[1][1].chrome_trace()["traceEvents"]
        names = {e["name"] for e in evs}
        assert {"drop:partition", "drop:loss", "drop:churn"} <= names
        tn_ = [e for e in evs if e["name"] == "thread_name"]
        assert any("left/" in e["args"]["name"] for e in tn_)
        fault_track = [e for e in evs
                       if e.get("pid") == 1 and e.get("ph") == "X"]
        assert {e["name"].split(" ")[0] for e in fault_track} == {
            "partition", "degrade"}
        part = [e for e in fault_track if e["name"].startswith("partition")]
        assert part[0]["ts"] == 10 * 1000.0

    def test_blocked_windows_render_as_spans(self):
        def build(b):
            b.sleep_ms(8)
            b.signal_and_wait("all")
            b.end_ok()

        pair = run_pair(build, build, ctx_groups(2), quantum_ms=1.0,
                        trace={"capacity": 32}, **CFG)
        assert_planes_equal(*pair)
        spans = [e for e in pair[1][1].chrome_trace()["traceEvents"]
                 if e.get("ph") == "X" and e["name"] == "blocked"]
        assert len(spans) == 2 and all(e["dur"] == 9 * 1000.0 for e in spans)


# ------------------------------------------------ the net hooks, unit level

N = 96
TICK = 50


def _net_state(rng, spec):
    """A random net state whose sends overflow: a third of the lanes
    send to one of 4 hot receivers."""
    net = {k: v.numpy() for k, v in tn.init_net_state(N, spec, "cpu").items()}
    net["net_enabled"] = (rng.random(N) > 0.08).astype(np.int32)
    for k in ("eg_latency", "eg_jitter", "eg_loss", "eg_duplicate"):
        if k in net:
            net[k] = (rng.random(N) * (3 if k in ("eg_latency", "eg_jitter")
                                       else 0.3)).astype(np.float32)
    if "hs" in net:
        net["hs"] = np.stack([TICK + rng.random(N) * 9,
                              rng.integers(-1, N, N), rng.integers(0, 3, N),
                              rng.integers(2, 4, N)], -1).astype(np.float32)
    if spec.store_entries:
        cap = spec.inbox_capacity
        r = rng.integers(0, 100, N).astype(np.int32)
        net["inbox"] = (rng.random((N, cap, spec.width)) * 9).astype(np.float32)
        net["inbox_r"] = r
        net["inbox_w"] = (r + rng.integers(0, cap, N)).astype(np.int32)
    else:
        net["avail"] = rng.integers(0, 9, N).astype(np.int32)
        net["bytes_in"] = (rng.random(N) * 100).astype(np.float32)
        buf = "staging" if "staging" in net else "wheel"
        net[buf] = np.floor(rng.random(net[buf].shape) * 3).astype(np.float32)
    if "pend_dest" in net:
        net["pend_dest"] = np.where(rng.random(N) < 0.5,
                                    rng.integers(0, N, N), -1).astype(np.int32)
        net["pend_tick"] = (TICK - rng.integers(0, 5, N)).astype(np.int32)
        net["pend_size"] = (rng.random(N) * 9).astype(np.float32)
        net["pend_pay"] = rng.random(net["pend_pay"].shape).astype(np.float32)
    hot = rng.integers(0, 4, N)
    dest = np.where(rng.random(N) < 0.35, hot, rng.integers(0, N, N))
    send = (
        np.where(rng.random(N) < 0.85, dest, -1).astype(np.int32),
        np.where(rng.random(N) < 0.3, TAG_SYN, 0).astype(np.int32),
        rng.integers(0, 3, N).astype(np.int32),
        (rng.random(N) * 100).astype(np.float32),
        rng.random((N, spec.payload_len)).astype(np.float32),
    )
    return net, send, rng.random(N) > 0.1


ENTRY = dict(uses_latency=False, uses_jitter=False, uses_rate=False,
             uses_loss=True, inbox_capacity=6, payload_len=2, head_k=1,
             arrival_slots=3)
HOOK_CASES = [
    ("entry_unbounded_dup", dict(ENTRY, uses_duplicate=True), False),
    ("entry_queue", dict(ENTRY, send_slots=30, uses_dials=True), False),
    ("entry_queue_dup", dict(ENTRY, send_slots=30, uses_duplicate=True),
     False),
    ("count_wheel_faults", dict(ENTRY, store_entries=False, payload_len=1,
                                uses_latency=True, uses_jitter=True,
                                uses_dials=True, horizon=32), True),
    ("count_staging", dict(ENTRY, store_entries=False, payload_len=1),
     False),
]


def _fault_overlay(rng):
    """A random per-lane overlay (the keys net.deliver reads)."""
    return {
        "block": rng.random(N) < 0.15,
        "lat": np.floor(rng.random(N) * 3).astype(np.float32),
        "jit": (rng.random(N) * 2).astype(np.float32),
        "loss": (rng.random(N) * 0.4).astype(np.float32),
        "rev_lat": np.floor(rng.random(N) * 4).astype(np.float32),
    }


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("name,kw,with_fault", HOOK_CASES,
                         ids=[c[0] for c in HOOK_CASES])
def test_net_hooks_match_jax(name, kw, with_fault, fused):
    rng = np.random.default_rng([c[0] for c in HOOK_CASES].index(name))
    jspec, tspec = jn.NetSpec(**kw), tn.NetSpec(**kw)
    net, send, running = _net_state(rng, tspec)
    fault = _fault_overlay(rng) if with_fault else None
    tspec_tr = ttr.TraceSpec(capacity=12)
    counters = tuple(ttel.LANE_COUNTERS)
    tspec_tel = ttel.TelemetrySpec(interval=5, s_cap=4, counters=counters)
    jspec_tr = jtr.TraceSpec(capacity=12)
    jspec_tel = jtel.TelemetrySpec(interval=5, s_cap=4, counters=counters)
    tr0 = {k: v.numpy() for k, v in ttr.init_trace_state(N, tspec_tr,
                                                          "cpu").items()}
    tel0 = {k: v.numpy() for k, v in ttel.init_telemetry_state(
        N, tspec_tel, "cpu").items()}

    def j_step(st, tr, tel, key, fault, *send_run):
        em = jtr.TraceEmitter(jspec_tr, tr, jnp.int32(TICK), N, fused=fused)
        acc = jtel.TelemetryAccum(jspec_tel, tel, N, fused=fused)
        if not jspec.store_entries:
            st = jn.advance_wheel(st, jspec, jnp.int32(TICK), trace=em,
                                  telem=acc)
        st = jn.deliver(st, jspec, jnp.int32(TICK), key, *send_run,
                        fault=fault, trace=em, telem=acc)
        return st, em.state, acc.state

    def j(d):
        return None if d is None else {k: jnp.asarray(v) for k, v in d.items()}

    want = jax.jit(j_step)(j(net), j(tr0), j(tel0), jax.random.PRNGKey(7),
                           j(fault), *map(jnp.asarray, send),
                           jnp.asarray(running))

    def t(d):
        return None if d is None else {k: torch.as_tensor(v)
                                       for k, v in d.items()}

    tick = torch.tensor(TICK, dtype=torch.int32)
    em = ttr.TraceEmitter(tspec_tr, t(tr0), tick, N, fused=fused)
    acc = ttel.TelemetryAccum(tspec_tel, t(tel0), N, fused=fused)
    st = t(net)
    if not tspec.store_entries:
        st = tn.advance_wheel(st, tspec, tick, trace=em, telem=acc)
    st = tn.deliver(st, tspec, tick, prng.PRNGKey(7),
                    *map(torch.as_tensor, send), torch.as_tensor(running),
                    fault=t(fault), trace=em, telem=acc)
    got = (st, em.state, acc.state)
    for g, w, what in zip(got, want, ("net", "trace", "telem")):
        assert set(g) == set(w), what
        for k in sorted(w):
            a, b = g[k].numpy(), np.asarray(w[k])
            assert a.dtype == b.dtype and a.shape == b.shape, (what, k)
            if a.dtype.kind == "f":
                a, b = a.view(np.int32), b.view(np.int32)
            np.testing.assert_array_equal(a, b, err_msg=f"{what}/{k}")
    # the case reached what it tests
    ev = ttr.trace_events(em.state)
    drops = ev[ev["code"] == ttr.EV_DROP]
    causes = {int(c) for c in drops["arg0"]}
    assert causes & {ttr.DROP_CHURN, ttr.DROP_DISABLED}
    if tspec.store_entries:
        assert ttr.DROP_QUEUE_FULL in causes
        assert (ev["code"] == ttr.EV_DELIVER).any()
    if with_fault:
        assert ttr.DROP_PARTITION in causes
    assert acc.state["acc_net_drops"].sum() > 0


# ------------------------------------------------------------ the table


@pytest.mark.parametrize("d,group_ids", [
    ({"capactiy": 9}, None),
    ({"capacity": 0}, None),
    ({"capacity": 70_000}, None),
    ({"categories": ["netz"]}, None),
    ({"groups": ["nope"]}, {"g"}),
    ({"categories": "net"}, None),
    ({"groups": "g"}, None),
])
def test_trace_table_errors_match_jax(d, group_ids):
    def text(cls, err):
        with pytest.raises(err) as e:
            cls.from_dict(d).validate(group_ids=group_ids)
        return str(e.value)

    assert text(tables.Trace, tables.CompositionError) == text(
        JTrace, JCompositionError)


def test_trace_table_parse_and_compile():
    d = {"capacity": 64, "categories": ["net", "fault"], "groups": ["b"],
         "drain": True}
    assert vars(tables.Trace.from_dict(d)) == vars(JTrace.from_dict(d))
    groups = [("a", 0, 2, {}), ("b", 1, 3, {})]
    jctx = JCtx([JGroup(*g) for g in groups])
    tctx = TCtx([TGroup(*g) for g in groups])
    got = ttr.compile_trace(d, tctx)
    want = jtr.compile_trace(JTrace.from_dict(d), jctx)
    assert (got.capacity, got.categories, got.group_mask) == (
        want.capacity, want.categories, want.group_mask)
    assert ttr.compile_trace({"enabled": False}, tctx) is None
    for bad in ({"categories": ["netz"]}, {"groups": ["zz"]}):
        with pytest.raises(jtr.TraceError) as w:
            jtr.compile_trace(JTrace.from_dict(bad), jctx)
        with pytest.raises(ttr.TraceError) as g:
            ttr.compile_trace(bad, tctx)
        assert str(g.value) == str(w.value)


def test_disabled_trace_builds_the_plain_program():
    jplan, tplan = faultsdemo()
    kw = dict(case="chaos", faults=CHAOS_TIMELINE, quantum_ms=1.0,
              max_ticks=400)
    plain = t_build(tplan, CHAOS_GROUPS, **kw)
    off = t_build(tplan, CHAOS_GROUPS, trace={"enabled": False}, **kw)
    assert off.trace is None
    ops_a, leaves_a = tick_op_log(plain)
    ops_b, leaves_b = tick_op_log(off)
    assert leaves_a == leaves_b and ops_a == ops_b
    on = t_build(tplan, CHAOS_GROUPS, trace={"capacity": 8}, **kw)
    ops_c, leaves_c = tick_op_log(on)
    assert "trace/trace_buf" in leaves_c and len(ops_c) > len(ops_a)
