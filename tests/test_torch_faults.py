"""The fault plane of the port (testground_tpu_torch/sim/faults.py, the
rejoin and overlay hooks of sim/core.py and sim/net.py, the [faults]
table of sim/tables.py) against the JAX package, on the CPU: the
table's parse and validation errors, message for message; the compiled
schedule (window rows, seed-keyed victims, restart stamps, shaping
needs) field for field; the overlay on random inputs, with three and
more overlapping loss windows (the product of the keep factors in row
order); the event-horizon boundary term; and the mirrors of
tests/test_faults.py's TestOverlaySemantics, TestKillRestart and
TestChurnWindowValidation, each program run through both packages with
every state leaf bit-equal. An empty or disabled [faults] table builds
the plain program: the same leaves and the same ops a tick."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _plane_parity import assert_planes_equal, run_pair, t_build, tick_op_log

from testground_tpu.api import CompositionError as JCompositionError
from testground_tpu.api import Faults as JFaults
from testground_tpu.sim import BuildContext as JCtx
from testground_tpu.sim import PhaseCtrl as JCtrl
from testground_tpu.sim import SimConfig as JConfig
from testground_tpu.sim import faults as jf
from testground_tpu.sim.context import GroupSpec as JGroup
from testground_tpu_torch.sim import BuildContext as TCtx
from testground_tpu_torch.sim import GroupSpec as TGroup
from testground_tpu_torch.sim import PhaseCtrl as TCtrl
from testground_tpu_torch.sim import SimConfig as TConfig
from testground_tpu_torch.sim import faults as tf
from testground_tpu_torch.sim import tables


class J:
    """The JAX side of a mirrored program."""

    Ctrl = JCtrl
    int32 = jnp.int32
    where = staticmethod(jnp.where)

    @staticmethod
    def i32(x):
        return jnp.asarray(x, jnp.int32)


class T:
    """The port's side."""

    Ctrl = TCtrl
    int32 = torch.int32
    where = staticmethod(torch.where)

    @staticmethod
    def i32(x):
        return x.to(torch.int32)


def _groups(params=None):
    p = {k: str(v) for k, v in (params or {}).items()}
    return [("L", 0, 2, p), ("R", 1, 2, p)]


CFG = dict(quantum_ms=1.0, max_ticks=300)


def _pump(L, b):
    """Group 0 sends 1 msg/tick to its group-1 counterpart for 40 ticks;
    group 1 counts arrivals (count-mode inbox)."""
    b.enable_net(count_only=True)
    b.declare("got", (), L.int32, 0)
    left_n = b.ctx.groups[0].instances

    def fn(env, mem):
        mem = dict(mem)
        mem["got"] = L.where(env.group == 1, mem["got"] + env.inbox_avail,
                             mem["got"])
        done = env.tick >= 40
        return mem, L.Ctrl(
            advance=L.i32(done),
            send_dest=L.where((env.group == 0) & ~done,
                              left_n + env.group_instance, -1),
            send_size=1.0,
            recv_count=env.inbox_avail,
        )

    b.phase(fn, "pump")


def pump_prog(L):
    def build(b):
        _pump(L, b)
        b.end_ok()

    return build


def pump_rv_prog(L):
    """pump_prog with a churn-tolerant rendezvous before the end."""

    def build(b):
        _pump(L, b)
        b.signal_and_wait("rv", churn_weight=1)
        b.end_ok()

    return build


def sleeper_prog(L):
    def build(b):
        b.sleep_ms(15)
        b.signal_and_wait("rv", churn_weight=1)
        b.end_ok()

    return build


def _pair(prog, faults=None, params=None, **cfg):
    return run_pair(prog(J), prog(T), _groups(params), faults=faults,
                    **dict(CFG, **cfg))


def _got(res):
    return np.asarray(res.state["mem"]["got"])[2:4]


# ------------------------------------------------------------- the table


def _ev(*events):
    return {"events": list(events)}


BAD_SCHEDULES = [
    ([{"kind": "meteor", "at_ms": 1}], "unknown kind"),
    ([{"kind": "partition", "at_ms": 1, "a": "left"}], "group pair"),
    ([{"kind": "heal", "at_ms": 1, "a": "left", "b": "right"}],
     "no matching open partition"),
    ([{"kind": "restart", "at_ms": 1, "group": "left"}], "no earlier kill"),
    ([{"kind": "degrade", "at_ms": 5, "until_ms": 5, "a": "left",
       "b": "right", "loss_pct": 1}], "empty or inverted"),
    ([{"kind": "degrade", "at_ms": 5, "until_ms": 9, "a": "left",
       "b": "right"}], "no-op"),
    ([{"kind": "degrade", "at_ms": 5, "until_ms": 9, "a": "left",
       "b": "right", "loss_pct": 200}], r"\[0, 100\]"),
    ([{"kind": "kill", "at_ms": 1, "group": "left"}], "fraction .*or a count"),
    ([{"kind": "kill", "at_ms": 1, "group": "left", "fraction": 0.5,
       "count": 1}], "XOR"),
    ([{"kind": "kill", "at_ms": 1, "group": "nope", "count": 1}],
     "unknown group"),
    ([{"kind": "partition", "at_ms": 10, "a": "left", "b": "right"},
      {"kind": "kill", "at_ms": 5, "group": "left", "count": 1}],
     "ordered by at_ms"),
    ([{"kind": "partition", "at_ms": 1, "a": "left", "b": "right"},
      {"kind": "partition", "at_ms": 2, "a": "right", "b": "left"}],
     "already open"),
    ([{"kind": "kill", "at_ms": 1, "group": "left", "count": 1,
       "bogus": 3}], "unknown fields"),
    ([{"kind": "kill", "at_ms": 1, "group": "*", "count": 1}],
     "concrete group"),
    ([{"kind": "kill", "at_ms": 1, "group": "left", "count": 1},
      {"kind": "restart", "at_ms": 5, "group": "left"},
      {"kind": "kill", "at_ms": 9, "group": "left", "count": 1}],
     "after its restart"),
    ([{"kind": "kill", "at_ms": 1, "group": "left", "count": 1},
      {"kind": "restart", "at_ms": 5, "group": "left", "fraction": 0.5}],
     "only valid on kill"),
    ([{"kind": "partition", "at_ms": 1, "a": "left", "b": "right",
       "latency_ms": 5}], "only valid on degrade"),
    ([{"kind": "partition", "at_ms": "$t", "a": "left", "b": "right"}],
     "must be a number"),
    ([{"kind": "kill", "at_ms": -1, "group": "left", "count": 1}], ">= 0"),
    ([{"kind": "heal", "at_ms": 1, "a": "left", "b": "right",
       "until_ms": 4}], "only valid on degrade"),
    ([{"kind": "kill", "at_ms": 1, "group": "left", "fraction": 1.5}],
     r"\(0, 1\]"),
    ([{"kind": "kill", "at_ms": 1, "a": "left", "group": "left",
       "count": 1}], "not 'a'/'b'"),
]


def _raise_text(faults_cls, err_cls, events):
    with pytest.raises(err_cls) as e:
        faults_cls.from_dict({"events": events}).validate(
            group_ids={"left", "right"})
    return str(e.value)


@pytest.mark.parametrize("events,msg", BAD_SCHEDULES,
                         ids=[m for _, m in BAD_SCHEDULES])
def test_table_rejects_bad_schedules_as_jax(events, msg):
    want = _raise_text(JFaults, JCompositionError, events)
    got = _raise_text(tables.Faults, tables.CompositionError, events)
    assert got == want
    import re

    assert re.search(msg, got)


def test_table_parse_matches_jax():
    d = _ev({"kind": "degrade", "at_ms": 1, "until_ms": "$end",
             "a": "left", "b": "right", "loss_pct": "$sev"},
            {"kind": "kill", "at_ms": 9, "group": "left",
             "fraction": "$frac"},
            {"kind": "restart", "at_ms": 20, "group": "left"})
    j, t = JFaults.from_dict(d), tables.Faults.from_dict(d)
    assert [vars(e) for e in t.events] == [vars(e) for e in j.events]
    assert t.disabled == j.disabled is False
    t.validate(group_ids={"left", "right"})
    with pytest.raises(tables.CompositionError, match="disable"):
        tables.Faults.from_dict({"events": [], "disable": True})
    assert tables.Faults.from_dict({"disabled": True}).disabled


# ------------------------------------------------------ compile_faults

SCHEDULES = {
    "windows": _ev(
        {"kind": "partition", "at_ms": 10, "a": "L", "b": "R"},
        {"kind": "degrade", "at_ms": 12, "until_ms": 30, "a": "L",
         "b": "*", "latency_ms": 7, "jitter_ms": 3, "loss_pct": 15},
        {"kind": "heal", "at_ms": 20, "a": "L", "b": "R"},
        {"kind": "partition", "at_ms": 25, "a": "R", "b": "R"},
    ),
    "kills": _ev(
        {"kind": "kill", "at_ms": 5, "group": "L", "fraction": 0.5},
        {"kind": "kill", "at_ms": 7, "group": "R", "count": 5},
        {"kind": "kill", "at_ms": 9, "group": "L", "count": 2},
        {"kind": "restart", "at_ms": 30, "group": "L"},
    ),
    "params": _ev(
        {"kind": "degrade", "at_ms": "$t0", "until_ms": "$t1", "a": "L",
         "b": "R", "loss_pct": "$sev"},
        {"kind": "kill", "at_ms": "$k", "group": "R", "fraction": "$f"},
        {"kind": "restart", "at_ms": 40, "group": "R"},
    ),
}
PARAMS = {"t0": "3", "t1": "17.5", "sev": "33", "k": "12", "f": "0.25"}


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_compile_faults_matches_jax(name, seed):
    groups = [("L", 0, 9, PARAMS), ("R", 1, 7, PARAMS)]
    jctx = JCtx([JGroup(*g) for g in groups], test_case="c")
    tctx = TCtx([TGroup(*g) for g in groups], test_case="c")
    want = jf.compile_faults(JFaults.from_dict(SCHEDULES[name]), jctx,
                             JConfig(quantum_ms=2.0, seed=seed))
    got = tf.compile_faults(SCHEDULES[name], tctx,
                            TConfig(quantum_ms=2.0, seed=seed))
    for f in ("win_kind", "win_src", "win_dst", "timeline", "shaping",
              "restart_events"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("win_start", "win_end", "win_lat", "win_jit", "win_loss",
              "kill_tick", "restart_tick"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert got.shaping_needs() == want.shaping_needs()
    assert (got.has_kills, got.has_restarts, got.has_windows) == (
        want.has_kills, want.has_restarts, want.has_windows)
    assert tf.compile_faults({"events": []}, tctx, TConfig()) is None


@pytest.mark.parametrize("events,params", [
    # an inverted kill/restart resolved from a $param
    (_ev({"kind": "kill", "at_ms": "$k", "group": "L", "count": 1},
         {"kind": "restart", "at_ms": 30, "group": "L"}), {"k": "50"}),
    # a missing or non-numeric param
    (_ev({"kind": "degrade", "at_ms": 1, "until_ms": 9, "a": "L",
          "b": "R", "loss_pct": "$sev"}), {}),
    (_ev({"kind": "degrade", "at_ms": 1, "until_ms": 9, "a": "L",
          "b": "R", "loss_pct": "$sev"}), {"sev": "lots"}),
    # a window resolved empty
    (_ev({"kind": "degrade", "at_ms": "$k", "until_ms": 9, "a": "L",
          "b": "R", "loss_pct": 1}), {"k": "20"}),
])
def test_compile_faults_errors_match_jax(events, params):
    groups = [("L", 0, 2, params), ("R", 1, 2, params)]
    with pytest.raises(jf.FaultError) as want:
        jf.compile_faults(JFaults.from_dict(events),
                          JCtx([JGroup(*g) for g in groups]), JConfig())
    with pytest.raises(tf.FaultError) as got:
        tf.compile_faults(events, TCtx([TGroup(*g) for g in groups]),
                          TConfig())
    assert str(got.value) == str(want.value)


# --------------------------------------------------------- the overlay

# groups a, b, c; rows of every kind, with a wildcard, and five degrade
# windows with loss over [20, 30)
OVERLAY_EVENTS = _ev(
    {"kind": "partition", "at_ms": 5, "a": "a", "b": "b"},
    {"kind": "degrade", "at_ms": 10, "until_ms": 40, "a": "a", "b": "*",
     "latency_ms": 4.5, "loss_pct": 13.7},
    {"kind": "degrade", "at_ms": 12, "until_ms": 35, "a": "b", "b": "c",
     "jitter_ms": 2.25, "loss_pct": 41.3},
    {"kind": "degrade", "at_ms": 15, "until_ms": 30, "a": "*", "b": "c",
     "latency_ms": 1.75, "loss_pct": 7.9},
    {"kind": "heal", "at_ms": 18, "a": "a", "b": "b"},
    {"kind": "degrade", "at_ms": 20, "until_ms": 31, "a": "a", "b": "a",
     "loss_pct": 66.6, "latency_ms": 9},
    {"kind": "degrade", "at_ms": 20, "until_ms": 50, "a": "*", "b": "*",
     "loss_pct": 23.1, "jitter_ms": 0.5},
)


@pytest.mark.parametrize("tick", [0, 7, 14, 19, 25, 30, 45])
@pytest.mark.parametrize("want_rev", [False, True])
def test_overlay_matches_jax(tick, want_rev):
    n = 300
    rng = np.random.default_rng(tick)
    groups = [("a", 0, 100, {}), ("b", 1, 100, {}), ("c", 2, 100, {})]
    plan = tf.compile_faults(OVERLAY_EVENTS,
                             TCtx([TGroup(*g) for g in groups]), TConfig())
    jplan = jf.compile_faults(JFaults.from_dict(OVERLAY_EVENTS),
                              JCtx([JGroup(*g) for g in groups]), JConfig())
    ft = plan.dynamic_leaves()
    gids = plan_gids = np.repeat(np.arange(3, dtype=np.int32), 100)
    dest = np.where(rng.random(n) < 0.9, rng.integers(0, n, n),
                    -1).astype(np.int32)
    want = jax.jit(lambda f, t, g, d: jf.overlay(
        jplan, f, t, g, d, n, want_rev=want_rev))(
        {k: jnp.asarray(v) for k, v in ft.items()}, jnp.int32(tick),
        jnp.asarray(plan_gids), jnp.asarray(dest))
    got = tf.Overlay(plan, "cpu", want_rev=want_rev)(
        {k: torch.as_tensor(v) for k, v in ft.items()},
        torch.tensor(tick, dtype=torch.int32), torch.as_tensor(gids),
        torch.as_tensor(dest))
    assert set(got) == set(want)
    for k in want:
        a, b = got[k].numpy(), np.asarray(want[k])
        assert a.dtype == b.dtype, k
        if a.dtype.kind == "f":
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=k)
    if tick == 25:
        # the case the product is for: lanes under three or more loss
        # windows at once
        active = ((ft["win_start"] <= tick) & (tick < ft["win_end"])
                  & (ft["win_loss"] > 0)).sum()
        assert active >= 5
        assert (got["loss"].numpy() > 0.8).any()


def test_next_boundary_matches_jax():
    rng = np.random.default_rng(5)
    for nt in (0, 3, 17, 40, 99, 200):
        ws = rng.integers(0, 100, 9).astype(np.int32)
        we = np.where(rng.random(9) < 0.3, tf.NEVER_ENDS,
                      ws + rng.integers(1, 50, 9)).astype(np.int32)
        want = jf.next_boundary(
            {"win_start": jnp.asarray(ws), "win_end": jnp.asarray(we)},
            jnp.int32(nt))
        got = tf.next_boundary(
            {"win_start": torch.as_tensor(ws), "win_end": torch.as_tensor(we)},
            torch.tensor(nt, dtype=torch.int32))
        assert int(got) == int(want) and got.dtype == torch.int32


# ------------------------------------------------------ overlay, whole runs


def _sched(*events):
    return _ev(*events)


class TestOverlaySemantics:
    def test_partition_blocks_and_heals(self):
        base = _got(_pair(pump_prog)[1][1])
        pair = _pair(pump_prog, faults=_sched(
            {"kind": "partition", "at_ms": 10, "a": "L", "b": "R"},
            {"kind": "heal", "at_ms": 20, "a": "L", "b": "R"}))
        assert_planes_equal(*pair)
        assert (_got(pair[1][1]) == base - 10).all()

    def test_unhealed_partition_lasts_forever(self):
        base = _got(_pair(pump_prog)[1][1])
        pair = _pair(pump_prog, faults=_sched(
            {"kind": "partition", "at_ms": 10, "a": "L", "b": "R"}))
        assert_planes_equal(*pair)
        assert (_got(pair[1][1]) < base - 25).all()

    def test_degrade_loss_100_is_partition_equivalent(self):
        base = _got(_pair(pump_prog)[1][1])
        pair = _pair(pump_prog, faults=_sched(
            {"kind": "degrade", "at_ms": 10, "until_ms": 20, "a": "L",
             "b": "R", "loss_pct": 100}))
        assert_planes_equal(*pair)
        assert pair[1][0].program.net_spec.uses_loss  # forced
        assert (_got(pair[1][1]) == base - 10).all()

    def test_degrade_latency_delays_but_delivers(self):
        base = _got(_pair(pump_prog)[1][1])
        pair = _pair(pump_prog, faults=_sched(
            {"kind": "degrade", "at_ms": 10, "until_ms": 20, "a": "L",
             "b": "R", "latency_ms": 5}))
        assert_planes_equal(*pair)
        spec = pair[1][0].program.net_spec
        assert spec.uses_latency and not spec.fixed_next_tick
        assert (_got(pair[1][1]) == base).all()

    def test_overlapping_loss_windows_and_jitter(self):
        # three loss windows at once on L->R, with latency and jitter
        pair = _pair(pump_prog, faults=_sched(
            {"kind": "degrade", "at_ms": 5, "until_ms": 30, "a": "L",
             "b": "R", "loss_pct": 17.3, "jitter_ms": 3},
            {"kind": "degrade", "at_ms": 8, "until_ms": 25, "a": "L",
             "b": "*", "loss_pct": 29.1, "latency_ms": 2},
            {"kind": "degrade", "at_ms": 10, "until_ms": 35, "a": "*",
             "b": "R", "loss_pct": 11.7}), seed=3)
        assert_planes_equal(*pair)

    def test_phase_gating_under_faults(self):
        faults = _sched(
            {"kind": "partition", "at_ms": 10, "a": "L", "b": "R"},
            {"kind": "heal", "at_ms": 20, "a": "L", "b": "R"},
            {"kind": "kill", "at_ms": 25, "group": "L", "count": 1},
            {"kind": "restart", "at_ms": 50, "group": "L"})
        pair = _pair(pump_rv_prog, faults=faults, phase_gating=True)
        assert_planes_equal(*pair)
        assert pair[1][1].restarts_total() == 1

    def test_windows_require_net_plane(self):
        faults = _sched({"kind": "partition", "at_ms": 1, "a": "L",
                         "b": "R"})
        with pytest.raises(ValueError) as want:
            run_pair(lambda b: b.end_ok(), lambda b: None, _groups(),
                     faults=faults, **CFG)
        with pytest.raises(ValueError) as got:
            t_build(lambda b: b.end_ok(), _groups(), faults=faults, **CFG)
        assert str(got.value) == str(want.value)
        assert "data plane" in str(got.value)

    def test_degrade_severity_resolves_param_ref(self):
        base = _got(_pair(pump_prog)[1][1])
        faults = _sched({"kind": "degrade", "at_ms": 10, "until_ms": 20,
                         "a": "L", "b": "R", "loss_pct": "$sev"})
        pair = _pair(pump_prog, faults=faults, params={"sev": 100})
        assert_planes_equal(*pair)
        assert (_got(pair[1][1]) == base - 10).all()
        with pytest.raises(tf.FaultError, match="sev"):
            t_build(pump_prog(T), _groups(), faults=faults, **CFG)


# -------------------------------------------------------- kill / restart

KILL_L = {"kind": "kill", "at_ms": 10, "group": "L", "count": 1}
RESTART_L = {"kind": "restart", "at_ms": 30, "group": "L"}


class TestKillRestart:
    def test_targeted_kill_is_deterministic(self):
        cfg = dict(CFG, max_ticks=60)
        pair = _pair(sleeper_prog, faults=_sched(KILL_L), **cfg)
        assert_planes_equal(*pair)
        (jex, _), (tex, res) = pair
        assert np.array_equal(tex.faults.kill_tick, jex.faults.kill_tick)
        victims = np.nonzero(tex.faults.kill_tick >= 0)[0]
        assert victims.size == 1 and victims[0] < 2
        st = res.statuses()[:4]
        assert st[victims[0]] == 3
        assert (np.delete(st, victims[0]) == 1).all()

    def test_kill_seed_changes_victims(self):
        kills = set()
        ctx = TCtx([TGroup(*g) for g in _groups()])
        jctx = JCtx([JGroup(*g) for g in _groups()])
        for seed in range(8):
            plan = tf.compile_faults(_sched(KILL_L), ctx, TConfig(seed=seed))
            want = jf.compile_faults(JFaults.from_dict(_sched(KILL_L)), jctx,
                                     JConfig(seed=seed))
            assert np.array_equal(plan.kill_tick, want.kill_tick)
            kills.add(tuple(np.nonzero(plan.kill_tick >= 0)[0]))
        assert len(kills) > 1

    @pytest.mark.parametrize("event_skip", [False, True])
    def test_restart_rejoins_and_completes(self, event_skip):
        pair = _pair(sleeper_prog, faults=_sched(KILL_L, RESTART_L),
                     event_skip=event_skip)
        assert_planes_equal(*pair)
        res = pair[1][1]
        assert (res.statuses()[:4] == 1).all()
        assert res.restarts_total() == 1
        assert not res.timed_out() and res.ticks >= 30

    def test_inverted_kill_restart_resolved_order_is_loud(self):
        faults = _sched(dict(KILL_L, at_ms="$k"), RESTART_L)
        ok = TCtx([TGroup(*g) for g in _groups({"k": 10})])
        assert tf.compile_faults(faults, ok, TConfig()).has_restarts
        bad = TCtx([TGroup(*g) for g in _groups({"k": 50})])
        with pytest.raises(tf.FaultError, match="inverted kill/restart"):
            tf.compile_faults(faults, bad, TConfig())

    def test_precompiled_plan_realigns_to_padding(self):
        ctx = TCtx([TGroup(*g) for g in _groups()])
        plan = tf.compile_faults(_sched(KILL_L, RESTART_L), ctx, TConfig())
        assert plan.kill_tick.shape == (4,)
        padded = TCtx([TGroup(*g) for g in _groups()], padded_n=8)
        from testground_tpu_torch.sim import compile_program

        ex = compile_program(sleeper_prog(T), padded, TConfig(**CFG),
                             device="cpu", faults=plan)
        assert ex.faults.kill_tick.shape == (8,)
        assert (ex.faults.kill_tick[4:] == -1).all()
        res = ex.run()
        assert (res.statuses()[:4] == 1).all() and res.restarts_total() == 1
        with pytest.raises(ValueError, match="cannot shrink"):
            ex.faults.padded_to(4)

    def test_restart_env_counter_visible_to_plan(self):
        def prog(L):
            def build(b):
                b.declare("lives", (), L.int32, -1)

                def snap(env, mem):
                    return {**mem, "lives": env.restarts}, L.Ctrl(advance=1)

                b.phase(snap, "snap")
                sleeper_prog(L)(b)

            return build

        pair = _pair(prog, faults=_sched(KILL_L, RESTART_L))
        assert_planes_equal(*pair)
        (_, _), (tex, res) = pair
        victims = tex.faults.kill_tick[:4] >= 0
        lives = res.state["mem"]["lives"].numpy()[:4]
        assert (lives[victims] == 1).all() and (lives[~victims] == 0).all()

    def test_restart_republish_does_not_deadlock_wait_topic(self):
        def prog(L):
            def build(b):
                b.publish("peers", capacity=4,
                          payload_fn=lambda env, mem: [1.0])
                b.sleep_ms(15)
                b.wait_topic("peers", capacity=4, count=4, churn_weight=1)
                b.signal_and_wait("rv", churn_weight=1)
                b.end_ok()

            return build

        pair = _pair(prog, faults=_sched(KILL_L, RESTART_L))
        assert_planes_equal(*pair)
        res = pair[1][1]
        assert not res.timed_out() and (res.statuses()[:4] == 1).all()
        assert res.restarts_total() == 1

    def test_restart_gets_fresh_memory_and_empty_inbox(self):
        def prog(L):
            def build(b):
                b.enable_net(count_only=True)
                b.declare("seen", (), L.int32, 0)

                def fn(env, mem):
                    mem = dict(mem)
                    mem["seen"] = mem["seen"] + env.inbox_avail
                    done = env.tick >= 40
                    return mem, L.Ctrl(
                        advance=L.i32(done),
                        send_dest=L.where((env.group == 1) & ~done,
                                          env.group_instance, -1),
                        send_size=1.0,
                        recv_count=0,  # never consume: the count grows
                    )

                b.phase(fn, "recv")
                b.signal_and_wait("rv", churn_weight=1)
                b.end_ok()

            return build

        pair = _pair(prog, faults=_sched(dict(KILL_L, count=2), RESTART_L))
        assert_planes_equal(*pair)
        res = pair[1][1]
        assert (res.statuses()[:4] == 1).all()
        seen = res.state["mem"]["seen"].numpy()[:2]
        assert (seen > 0).all() and (seen < 200).all(), seen

    def test_restart_resets_links_filters_and_dials(self):
        """A restarted lane of an entry-mode program with class rules,
        shaping, dials and an egress queue comes back with the default
        link, no filter rows or class, a cleared handshake register and
        nothing queued; the run is bit-equal to JAX."""

        def prog(L):
            arange = jnp.arange if L is J else torch.arange

            def build(b):
                n = b.ctx.n_instances
                b.enable_net(class_rules=True, n_classes=3, payload_len=2,
                             head_k=1, send_slots=2)
                b.set_net_class(lambda env, mem: env.instance % 3)

                def rules(env, mem):
                    # class 0 drops class 2
                    me = env.instance % 3
                    return L.i32(L.where((me == 0) & (arange(3) == 2), 2,
                                         -1))

                b.configure_network(latency_ms=3.0, loss=10.0,
                                    class_rules_fn=rules,
                                    callback_state="cfg")
                b.dial(lambda env, mem: (env.instance + 1) % n, 7,
                       result_slot="r", timeout_ms=20.0)
                b.sleep_ms(25)
                b.signal_and_wait("done", churn_weight=1)
                b.end_ok()

            return build

        faults = _sched({"kind": "kill", "at_ms": 4, "group": "L",
                         "count": 2},
                        {"kind": "restart", "at_ms": 12, "group": "L"})
        pair = _pair(prog, faults=faults, max_ticks=400)
        assert_planes_equal(*pair)
        assert pair[1][1].restarts_total() == 2


class TestChurnWindowValidation:
    def test_executor_rejects_inverted_window(self):
        for start, end in ((100.0, 50.0), (100.0, 100.0)):
            cfg = dict(churn_fraction=0.1, churn_start_ms=start,
                       churn_end_ms=end)
            with pytest.raises(ValueError) as want:
                run_pair(lambda b: b.end_ok(), lambda b: None,
                         [("g", 0, 2, {})], **cfg)
            with pytest.raises(ValueError) as got:
                t_build(lambda b: b.end_ok(), [("g", 0, 2, {})], **cfg)
            assert str(got.value) == str(want.value)
            assert "empty or inverted" in str(got.value)

    def test_zero_fraction_window_still_fine(self):
        pair = run_pair(lambda b: b.end_ok(), lambda b: b.end_ok(),
                        [("g", 0, 2, {})], max_ticks=10, churn_fraction=0.0,
                        churn_start_ms=5.0, churn_end_ms=5.0)
        assert_planes_equal(*pair)
        assert pair[1][1].outcomes()["g"] == (2, 2)


# ---------------------------------------------------------- zero overhead


@pytest.mark.parametrize("off", [{"events": []},
                                 {"events": [KILL_L], "disabled": True}])
def test_empty_or_disabled_faults_build_the_plain_program(off):
    plain = t_build(pump_rv_prog(T), _groups(), **CFG)
    other = t_build(pump_rv_prog(T), _groups(), faults=off, **CFG)
    assert other.faults is None
    ops_a, leaves_a = tick_op_log(plain)
    ops_b, leaves_b = tick_op_log(other)
    assert leaves_a == leaves_b
    assert ops_a == ops_b and len(ops_a) > 100
    # and an active schedule does add state and ops
    on = t_build(pump_rv_prog(T), _groups(),
                 faults=_sched(KILL_L, RESTART_L), **CFG)
    ops_c, leaves_c = tick_op_log(on)
    assert "faults/restart_tick" in leaves_c and len(ops_c) > len(ops_a)
