"""The replay plane of the port (testground_tpu_torch/sim/replay.py, the
[replay] table of sim/tables.py, the DSL's on_arrival, replay_consume
and arrival helpers, the tick's head view, cursor advance and
event-horizon term in sim/core.py) against the JAX package, on the CPU:
the mirrors of tests/test_replay.py's TestComposition, TestCompile,
TestRunSemantics and TestTrace2Replay, each compiled or run through both
packages with the same tensors, errors, state leaves and ticks; the
churn merge into the fault plane; ``inbox_entry`` with a traced index
and at static depths past the head cache; and a disabled [replay]
table, which builds the replay-free program (the same leaves and ops a
tick)."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import dataclasses
import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _plane_parity import (
    assert_planes_equal, j_build, run_pair, t_build, tick_op_log,
)
from _storm_parity import assert_leaves_equal

from testground_tpu.api import Faults as JFaults
from testground_tpu.api import Replay as JReplay
from testground_tpu.sim import BuildContext as JCtx
from testground_tpu.sim import PhaseCtrl as JPhaseCtrl
from testground_tpu.sim import SimConfig as JConfig
from testground_tpu.sim import faults as jfaults
from testground_tpu.sim import replay as jreplay
from testground_tpu.sim.context import GroupSpec as JGroup
from testground_tpu.sim.program import TickEnv as JTickEnv
from testground_tpu_torch.bench import OpLog
from testground_tpu_torch.sim import BuildContext as TCtx
from testground_tpu_torch.sim import GroupSpec as TGroup
from testground_tpu_torch.sim import PhaseCtrl as TPhaseCtrl
from testground_tpu_torch.sim import SimConfig as TConfig
from testground_tpu_torch.sim import faults as tfaults
from testground_tpu_torch.sim import replay as treplay
from testground_tpu_torch.sim import tables
from testground_tpu_torch.sim.core import EVENT_SKIP_STATE_LEAVES
from testground_tpu_torch.sim.program import TickEnv as TTickEnv
from testground_tpu_torch.sim.state_io import (
    compare_leaves, flatten, state_to_numpy,
)

REPO = Path(__file__).resolve().parent.parent


def _write_trace(tmp_path, rows, name="workload.jsonl"):
    p = tmp_path / name
    p.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return str(p)


def _basic_rows():
    """Two lanes, sparse arrivals, a kill and restart of lane 0."""
    return [
        {"replay_version": 1},
        {"lane": 0, "tick": 5, "op": 1, "arg": 2.0},
        {"lane": 0, "tick": 90, "op": 1, "arg": 3.0},
        {"lane": 1, "tick": 10, "op": 2, "arg": 1.0},
        {"lane": 1, "tick": 200, "op": 2, "arg": 1.0},
        {"kind": "kill", "lane": 0, "tick": 30},
        {"kind": "restart", "lane": 0, "tick": 60},
    ]


# ------------------------------------------------------- plans, both ways


def _echo(np_mod):
    """tests/test_replay.py's arrival consumer (counts the requests and
    sums their args), in ``jnp`` or ``torch``."""
    tor = np_mod is torch

    def build(b):
        got = b.declare("got", (), np_mod.int32, 0)
        argsum = b.declare("argsum", (), np_mod.float32, 0.0)

        def handler(env, mem, due):
            mem = dict(mem)
            op, arg = env.next_arrival()
            one = due.to(torch.int32) if tor else jnp.where(due, 1, 0)
            mem[got] = mem[got] + one
            mem[argsum] = mem[argsum] + np_mod.where(due, arg, 0.0)
            return mem, (TPhaseCtrl() if tor else JPhaseCtrl())

        b.on_arrival(handler)
        b.record_point("got", lambda env, mem: mem[got])
        b.signal_and_wait("done", churn_weight=1)
        b.end_ok()

    return build


def _counter(np_mod):
    """The barrier-free consumer of the skip case."""
    tor = np_mod is torch

    def build(b):
        got = b.declare("got", (), np_mod.int32, 0)

        def handler(env, mem, due):
            mem = dict(mem)
            one = due.to(torch.int32) if tor else jnp.where(due, 1, 0)
            mem[got] = mem[got] + one
            return mem, (TPhaseCtrl() if tor else JPhaseCtrl())

        b.on_arrival(handler)
        b.end_ok()

    return build


def _popper(np_mod):
    """A hand-written consumer of PhaseCtrl(replay_consume=...): it asks
    for 3 arrivals every 7th tick, -1 on others (both clamped to the due
    count), records the head op, tick and rows left through the helpers,
    and ends once its schedule is exhausted."""
    tor = np_mod is torch
    PC = TPhaseCtrl if tor else JPhaseCtrl

    def build(b):
        seen = b.declare("seen", (), np_mod.int32, 0)
        last_tick = b.declare("last_tick", (), np_mod.int32, -1)
        left = b.declare("left", (), np_mod.int32, -1)

        def fn(env, mem):
            mem = dict(mem)
            pend = env.arrivals_pending()
            op, arg = env.next_arrival()
            mem[seen] = mem[seen] + np_mod.where(pend > 0, op, 0)
            mem[last_tick] = np_mod.where(pend > 0, env.next_arrival_tick(),
                                          mem[last_tick])
            mem[left] = env.arr_left
            ask = np_mod.where(np_mod.remainder(env.tick, 7) == 0, 3, -1)
            done = env.arrivals_exhausted()
            return mem, PC(
                advance=done.to(torch.int32) if tor else jnp.int32(done),
                replay_consume=ask.to(torch.int32) if tor else ask,
            )

        b.phase(fn, "pop")
        b.end_ok()

    return build


def _groups(n=2):
    return [("g", 0, n, {})]


CFG = dict(quantum_ms=1.0, max_ticks=2_000, metrics_capacity=8)


def _pair(tmp_path, plan, rows, replay=None, n=2, **cfg):
    tf = _write_trace(tmp_path, rows)
    kw = dict(CFG, **cfg)
    return run_pair(plan(jnp), plan(torch), _groups(n), replay=dict(
        replay or {}, trace=tf), chunk_ticks=100, **kw)


# -------------------------------------------------------------- the table


def _both_raise(jfn, tfn):
    with pytest.raises(Exception) as je:
        jfn()
    with pytest.raises(Exception) as te:
        tfn()
    assert str(te.value) == str(je.value)
    return te.value


def test_table_round_trip():
    d = {"trace": "w.jsonl", "scale": 2.5, "time_scale": "$squeeze",
         "capacity": 64}
    j, t = JReplay.from_dict(d), tables.Replay.from_dict(d)
    t.validate()
    for k in ("trace", "scale", "time_scale", "capacity", "enabled"):
        assert getattr(t, k) == getattr(j, k), k
    assert t.param_refs() == j.param_refs() == {"squeeze"}


def test_table_unknown_key_did_you_mean():
    e = _both_raise(
        lambda: JReplay.from_dict({"trace": "w", "time_scal": 2}),
        lambda: tables.Replay.from_dict({"trace": "w", "time_scal": 2}))
    assert isinstance(e, tables.CompositionError)
    assert "time_scale" in str(e)


@pytest.mark.parametrize("kw", [
    {"scale": 0}, {"scale": -1}, {"scale": True}, {"scale": "x"},
    {"time_scale": 0}, {"capacity": -1}, {"capacity": 1_000_000},
    {"trace": ""},
])
def test_table_validation_errors(kw):
    base = dict(trace="w")
    base.update(kw)
    e = _both_raise(lambda: JReplay(**base).validate(),
                    lambda: tables.Replay(**base).validate())
    assert isinstance(e, tables.CompositionError)


def test_capacity_bound_is_jax_s():
    from testground_tpu.api.composition import MAX_REPLAY_CAPACITY

    assert tables.MAX_REPLAY_CAPACITY == MAX_REPLAY_CAPACITY


# ------------------------------------------------------------ compilation


def _compile_both(tmp_path, rows, replay=None, n=2, params=None,
                  padded_n=0, name="workload.jsonl", **cfg):
    tf = rows if isinstance(rows, str) else _write_trace(tmp_path, rows,
                                                         name)
    d = dict(replay or {}, trace=tf)
    p = dict(params or {})
    jctx = JCtx([JGroup("g", 0, n, p)], test_case="t", padded_n=padded_n)
    tctx = TCtx([TGroup("g", 0, n, p)], test_case="t", padded_n=padded_n)
    return (
        lambda: jreplay.compile_replay(JReplay.from_dict(d), jctx,
                                       JConfig(**cfg)),
        lambda: treplay.compile_replay(tables.Replay.from_dict(d), tctx,
                                       TConfig(**cfg)),
    )


def _assert_plans_equal(jp, tp):
    for k in ("arr_tick", "arr_op", "arr_arg", "arr_cnt", "kill_tick",
              "restart_tick"):
        a, b = getattr(jp, k), getattr(tp, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(b.view(np.int32), a.view(np.int32),
                                      err_msg=k)
    for k in ("capacity", "kill_rows", "restart_rows", "has_churn"):
        assert getattr(tp, k) == getattr(jp, k), k
    assert tp.journal() == jp.journal()
    assert tp.structure() == jp.structure()
    assert tp.model_bytes() == jp.model_bytes()


COMPILE_CASES = {
    # name: (rows, replay table, n, params, cfg)
    "schedule_tensors": (_basic_rows(), {}, 2, None, {}),
    "rows_sorted_per_lane": ([{"lane": 0, "tick": 50, "op": 2},
                              {"lane": 0, "tick": 5, "op": 1}], {}, 2, None,
                             {}),
    "ties_keep_file_order": ([{"lane": 1, "tick": 9, "op": k, "arg": k / 3}
                              for k in range(5)], {}, 3, None, {}),
    "padding_is_never": ([{"lane": 0, "tick": 5}], {"capacity": 4}, 2, None,
                         {}),
    "integral_floats": ([{"lane": 1.0, "tick": 30.0}], {}, 2, None, {}),
    "churn_in_tick_order": ([{"kind": "restart", "lane": 0, "tick": 60},
                             {"kind": "kill", "lane": 0, "tick": 30},
                             {"lane": 0, "tick": 5}], {}, 2, None, {}),
    "churn_only": ([{"kind": "kill", "lane": 1, "tick": 40},
                    {"kind": "kill", "lane": 1, "tick": 20}], {}, 2, None,
                   {}),
    "integer_scale": ([{"lane": 0, "tick": 5}], {"scale": 3}, 2, None, {}),
    "fractional_scale_seed_7": ([{"lane": t % 3, "tick": t}
                                 for t in range(40)], {"scale": 1.5}, 3,
                                None, {"seed": 7}),
    "fractional_scale_seed_0": ([{"lane": t % 3, "tick": t}
                                 for t in range(40)], {"scale": 0.4}, 3,
                                None, {"seed": 0}),
    "time_scale": ([{"lane": 0, "tick": 10},
                    {"kind": "kill", "lane": 0, "tick": 40},
                    {"kind": "restart", "lane": 0, "tick": 60}],
                   {"time_scale": 2}, 2, None, {}),
    "time_scale_rounds": ([{"lane": 0, "tick": t} for t in (1, 3, 5, 7)],
                          {"time_scale": 0.5}, 2, None, {}),
    "param_ref": ([{"lane": 0, "tick": 10}], {"scale": "$load"}, 2,
                  {"load": "2"}, {}),
    "padded_context": (_basic_rows(), {}, 2, None, {}),
}


@pytest.mark.parametrize("name", sorted(COMPILE_CASES))
def test_compile_matches_jax(tmp_path, name):
    rows, rp, n, params, cfg = COMPILE_CASES[name]
    jf, tf = _compile_both(tmp_path, rows, rp, n, params,
                           padded_n=8 if name == "padded_context" else 0,
                           **cfg)
    jp, tp = jf(), tf()
    _assert_plans_equal(jp, tp)
    if name == "schedule_tensors":
        np.testing.assert_array_equal(tp.arr_tick[0], [5, 90])
        assert tp.kill_tick[0] == 30 and tp.restart_tick[0] == 60
    if name == "padding_is_never":
        assert (tp.arr_tick[0, 1:] == treplay.REPLAY_NEVER).all()
    if name.startswith("fractional"):
        assert 0 < tp.n_events
    # padded to more lanes, both packages pad alike
    _assert_plans_equal(jp.padded_to(11), tp.padded_to(11))


ERROR_CASES = {
    "capacity_overflow": ([{"lane": 0, "tick": t} for t in range(5)],
                          {"capacity": 3}, None),
    "lane_out_of_range": ([{"lane": 7, "tick": 5}], {}, None),
    "churn_lane_out_of_range": ([{"kind": "kill", "lane": 2, "tick": 5}],
                                {}, None),
    "fractional_lane": ([{"lane": 1.9, "tick": 30}], {}, None),
    "fractional_tick": ([{"lane": 1, "tick": 30.5}], {}, None),
    "negative_tick": ([{"lane": 1, "tick": -3}], {}, None),
    "bool_lane": ([{"lane": True, "tick": 3}], {}, None),
    "unknown_kind": ([{"kind": "pause", "lane": 0, "tick": 3}], {}, None),
    "not_an_object": ([[1, 2]], {}, None),
    "restart_without_kill": ([{"kind": "restart", "lane": 0, "tick": 10}],
                             {}, None),
    "restart_must_follow_kill": ([{"kind": "kill", "lane": 0, "tick": 50},
                                  {"kind": "restart", "lane": 0,
                                   "tick": 50}], {}, None),
    "empty_trace": ([{"replay_version": 1}], {}, None),
    "missing_param": ([{"lane": 0, "tick": 10}], {"scale": "$load"}, None),
    "non_numeric_param": ([{"lane": 0, "tick": 10}], {"scale": "$load"},
                          {"load": "many"}),
    "missing_file": ("/no/such/dir/trace.jsonl", {}, None),
}


@pytest.mark.parametrize("name", sorted(ERROR_CASES))
def test_compile_errors_match_jax(tmp_path, name):
    rows, rp, params = ERROR_CASES[name]
    jf, tf = _compile_both(tmp_path, rows, rp, 2, params)
    e = _both_raise(jf, tf)
    assert isinstance(e, (treplay.ReplayError, tables.CompositionError))


def test_malformed_line_names_the_line(tmp_path):
    p = tmp_path / "bad.jsonl"
    p.write_text('{"lane": 0, "tick": 1}\nnot-json\n')
    jf, tf = _compile_both(tmp_path, str(p))
    e = _both_raise(jf, tf)
    assert "bad.jsonl:2" in str(e)


def test_params_that_differ_across_groups(tmp_path):
    tf = _write_trace(tmp_path, [{"lane": 0, "tick": 1}])
    d = {"trace": tf, "scale": "$load"}
    jctx = JCtx([JGroup("a", 0, 1, {"load": "1"}),
                 JGroup("b", 1, 1, {"load": "2"})], test_case="t")
    tctx = TCtx([TGroup("a", 0, 1, {"load": "1"}),
                 TGroup("b", 1, 1, {"load": "2"})], test_case="t")
    _both_raise(
        lambda: jreplay.compile_replay(JReplay.from_dict(d), jctx,
                                       JConfig()),
        lambda: treplay.compile_replay(tables.Replay.from_dict(d), tctx,
                                       TConfig()))


def test_disabled_never_reads_the_file():
    d = {"trace": "/no/such/file.jsonl", "enabled": False}
    assert treplay.compile_replay(
        tables.Replay.from_dict(d), TCtx([TGroup("g", 0, 2, {})]),
        TConfig()) is None
    assert treplay.compile_replay(d, TCtx([TGroup("g", 0, 2, {})]),
                                  TConfig()) is None
    assert treplay.compile_replay(None, None, None) is None


def test_load_trace_rows_match_jax(tmp_path):
    tf = _write_trace(tmp_path, _basic_rows() + [{"lane": 1, "tick": 4}])
    assert treplay.load_trace(tf) == jreplay.load_trace(tf)
    # the parse is kept per (path, mtime, size) and is read-only
    assert treplay.load_trace(tf) is treplay.load_trace(tf)


# ----------------------------------------------- churn into the fault plane


def _timeline(plan):
    return json.loads(json.dumps(plan.timeline))


@pytest.mark.parametrize("with_faults", [False, True])
def test_merge_into_faults_matches_jax(tmp_path, with_faults):
    rows = _basic_rows() + [{"kind": "kill", "lane": 2, "tick": 70}]
    jf, tf = _compile_both(tmp_path, rows, n=4)
    jp, tp = jf(), tf()
    jfp = tfp = None
    if with_faults:
        sched = {"events": [
            {"kind": "partition", "at_ms": 5, "a": "g", "b": "g"},
            {"kind": "heal", "at_ms": 9, "a": "g", "b": "g"},
            {"kind": "kill", "at_ms": 20, "group": "g", "count": 1},
            {"kind": "restart", "at_ms": 40, "group": "g"},
        ]}
        jctx = JCtx([JGroup("g", 0, 4, {})], test_case="t")
        tctx = TCtx([TGroup("g", 0, 4, {})], test_case="t")
        jfp = jfaults.compile_faults(JFaults.from_dict(sched), jctx,
                                     JConfig())
        tfp = tfaults.compile_faults(tables.Faults.from_dict(sched), tctx,
                                     TConfig())
    jm = jreplay.merge_into_faults(jp, jfp)
    tm = treplay.merge_into_faults(tp, tfp)
    np.testing.assert_array_equal(tm.kill_tick, jm.kill_tick)
    np.testing.assert_array_equal(tm.restart_tick, jm.restart_tick)
    assert tm.restart_events == jm.restart_events
    assert tm.has_windows == jm.has_windows
    assert _timeline(tm) == _timeline(jm)
    assert ("kill", "replay") in {(e["kind"], e.get("source"))
                                  for e in tm.timeline}
    # idempotent: a second merge adds nothing
    again = treplay.merge_into_faults(tp, tm)
    assert _timeline(again) == _timeline(tm)
    np.testing.assert_array_equal(again.kill_tick, tm.kill_tick)
    # a churn-free plan leaves the fault plan as it was
    free = dataclasses.replace(tp, kill_rows=False, restart_rows=False)
    assert treplay.merge_into_faults(free, tfp) is tfp


# ------------------------------------------------------- run semantics


@pytest.mark.parametrize("event_skip", [False, True])
def test_consume_and_cursor(tmp_path, event_skip):
    pair = _pair(tmp_path, _echo, _basic_rows(), event_skip=event_skip)
    assert_planes_equal(*pair)
    (_, _), (ex, res) = pair
    assert (res.statuses()[:2] == 1).all()
    np.testing.assert_array_equal(res.replay_consumed_per_lane()[:2], [2, 2])
    assert res.replay_consumed() == 4
    assert res.restarts_total() == 1  # the recorded churn replayed
    # lane 0's fresh-memory restart counts from 0 again: one arrival
    # (tick 90) lands after the rejoin; the cursor covers both
    np.testing.assert_array_equal(res.state["mem"]["got"].numpy()[:2],
                                  [1, 2])
    assert float(res.state["mem"]["argsum"][1]) == 2.0
    # the replayed churn rides a windowless fault plan
    assert ex.faults is not None and not ex.faults.has_windows


def test_same_tick_burst_drains_one_per_tick(tmp_path):
    pair = _pair(tmp_path, _echo, [{"lane": 0, "tick": 10, "arg": a}
                                   for a in (1.5, -0.0, 2.25)])
    assert_planes_equal(*pair)
    (_, _), (_, res) = pair
    assert res.replay_consumed_per_lane()[0] == 3
    assert int(res.state["mem"]["got"][0]) == 3


@pytest.mark.parametrize("event_skip", [False, True])
def test_replay_consume_clamps_to_due(tmp_path, event_skip):
    rows = [{"lane": lane, "tick": t, "op": 1 + t % 5}
            for lane in range(3) for t in (3, 3, 8, 20, 21, 22, 50)]
    pair = _pair(tmp_path, _popper, rows, n=3, event_skip=event_skip,
                 replay={"capacity": 9})
    assert_planes_equal(*pair)
    (_, _), (_, res) = pair
    np.testing.assert_array_equal(res.replay_consumed_per_lane()[:3],
                                  [7, 7, 7])
    assert (res.statuses()[:3] == 1).all()


def test_helpers_require_a_replay_table():
    from testground_tpu_torch.sim import compile_program

    ex = compile_program(_echo(torch), TCtx([TGroup("g", 0, 2, {})]),
                         TConfig(**CFG), device="cpu")
    with pytest.raises(RuntimeError, match=r"\[replay\] table"):
        ex.guarded_tick(ex.init_state())


def test_skip_equals_dense(tmp_path):
    runs = {}
    for skip in (False, True):
        pair = _pair(tmp_path, _counter, _basic_rows(), event_skip=skip)
        assert_planes_equal(*pair)
        runs[skip] = pair[1][1]
    dense, skipped = runs[False], runs[True]
    # a sparse trace pays per event, not per tick
    assert skipped.skip_ratio < 0.5
    compare_leaves(flatten(state_to_numpy(dense.state)),
                   flatten(state_to_numpy(skipped.state)),
                   "skipped vs dense", skip=EVENT_SKIP_STATE_LEAVES)


def test_disabled_table_builds_the_replay_free_program():
    def build(b):
        b.sleep_ms(3)
        b.end_ok()

    plain = t_build(build, _groups(), **CFG)
    off = t_build(build, _groups(), replay={"trace": "never-read.jsonl",
                                            "enabled": False}, **CFG)
    assert off.replay is None and off.faults is None
    assert tick_op_log(off) == tick_op_log(plain)


def test_replay_leaves_and_their_bytes(tmp_path):
    (jex, jr), (tex, tr) = _pair(tmp_path, _echo, _basic_rows())
    st = tex.init_state()
    assert sorted(st["replay"]) == ["arr_arg", "arr_cnt", "arr_op",
                                    "arr_tick", "cursor"]
    assert sum(v.numel() * v.element_size()
               for v in st["replay"].values()) == tex.replay.model_bytes()


# ------------------------------------------------------ inbox_entry reads


def _inbox_reader(np_mod, traced, head_k):
    """A ring of sends whose payloads carry -0.0 among other values; each
    lane reads a record at a traced index (``(tick // 3) % 6``) or at
    every static index 0..5, and folds its fields into mem."""
    tor = np_mod is torch
    PC = TPhaseCtrl if tor else JPhaseCtrl

    def build(b):
        n = b.ctx.n_instances
        b.enable_net(inbox_capacity=8, payload_len=2, head_k=head_k)
        acc = b.declare("acc", (6,), np_mod.float32, 0.0)
        bits = b.declare("neg_zero", (), np_mod.int32, 0)

        def fn(env, mem):
            mem = dict(mem)
            rows = []
            if traced:
                k = np_mod.remainder(env.tick // 3, 6)
                rows = [(k, env.inbox_entry(k))]
            else:
                rows = [(k, env.inbox_entry(k)) for k in range(6)]
            a = mem[acc]
            neg = mem[bits]
            for k, e in rows:
                ok = k < env.inbox_avail
                a = a + np_mod.where(ok, e[:6], 0.0)
                pay = e[5]
                is_neg0 = (pay == 0.0) & (np_mod.signbit(pay))
                hit = ok & is_neg0
                neg = neg + (hit.to(torch.int32) if tor
                             else hit.astype(jnp.int32))
            mem[acc], mem[bits] = a, neg
            sel = np_mod.remainder(env.tick + env.instance, 3)
            payv = np_mod.where(sel == 0, -0.0,
                                np_mod.where(sel == 1, 1.5, -2.0))
            pay = (torch.stack([payv, payv * 0.0]) if tor
                   else jnp.stack([payv, payv * 0.0]))
            done = env.tick >= 40
            return mem, PC(
                advance=done.to(torch.int32) if tor else jnp.int32(done),
                send_dest=np_mod.where(
                    done | (np_mod.remainder(env.tick, 4) == 3), -1,
                    np_mod.remainder(env.instance + 1, n)),
                send_size=4.0, send_payload=pay,
                recv_count=np_mod.where(
                    np_mod.remainder(env.tick, 5) == 0, 2, 0),
            )

        b.phase(fn, "read")
        b.end_ok()

    return build


@pytest.mark.parametrize("traced,head_k", [(True, 2), (False, 2),
                                           (True, 8), (False, 1)])
def test_inbox_entry_matches_jax(traced, head_k):
    pair = run_pair(_inbox_reader(jnp, traced, head_k),
                    _inbox_reader(torch, traced, head_k), _groups(4),
                    **dict(CFG, max_ticks=200))
    assert_planes_equal(*pair)


def test_traced_inbox_entry_reads_nothing_back_to_the_host():
    ex = t_build(_inbox_reader(torch, True, 2), _groups(4),
                 **dict(CFG, max_ticks=200))
    st = ex.init_state()
    ex.tick_fn()
    with torch.no_grad(), OpLog() as log:
        for _ in range(3):
            st = ex.guarded_tick(st)
    assert not [op for op in log.ops if "_local_scalar_dense" in op]


def _env_pair(inbox, r, head, k_jax, k_torch):
    """One lane's TickEnv in each package over the same ring, and the
    record each reads at k."""
    je = JTickEnv(tick=0, instance=0, group=0, group_instance=0,
                  last_seq=0, rng=None, counters=None, topic_len=None,
                  topic_buf=None, params={}, inbox=jnp.asarray(inbox),
                  inbox_r=jnp.int32(r),
                  inbox_head=None if head is None else jnp.asarray(head))
    te = TTickEnv(tick=0, instance=0, group=0, group_instance=0,
                  last_seq=0, rng=None, counters=None, topic_len=None,
                  topic_buf=None, params={}, inbox=torch.as_tensor(inbox),
                  inbox_r=torch.tensor(r, dtype=torch.int32),
                  inbox_head=None if head is None else torch.as_tensor(head))
    return (np.asarray(je.inbox_entry(k_jax)),
            te.inbox_entry(k_torch).numpy())


@pytest.mark.parametrize("head_k", [None, 2])
@pytest.mark.parametrize("k", [0, 2, 3, 5, 7, 9])
def test_deep_inbox_entry_keeps_negative_zero(head_k, k):
    """A record field of -0.0 read at a static k (past head_k, or with no
    head cache) and at the same k traced: the JAX package gathers the
    row, which keeps the sign of zero."""
    rng = np.random.default_rng(k)
    inbox = rng.normal(size=(8, 7)).astype(np.float32)
    inbox[:, 5] = -0.0
    inbox[::3, 2] = -0.0
    r = 6
    head = None
    if head_k is not None:
        pos = (r + np.arange(head_k)) % 8
        head = inbox[pos].copy()
    for kj, kt in ((k, k), (jnp.int32(k), torch.tensor(k,
                                                      dtype=torch.int32))):
        want, got = _env_pair(inbox, r, head, kj, kt)
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
        assert np.signbit(got[5])


# ------------------------------------------------ trace2replay round trip


def test_trace2replay_round_trip(tmp_path):
    """A traced port run's Chrome trace, converted by tools/trace2replay.py
    (loaded by path), replays through the echo consumer with each lane's
    send and user event count consumed, in both packages alike."""
    spec = importlib.util.spec_from_file_location(
        "tg_trace2replay", REPO / "tools" / "trace2replay.py")
    t2r = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(t2r)
    n = 3

    def source(b):
        b.enable_net(count_only=True)
        b.wait_network_initialized()
        h = b.loop_begin(3)
        b.sleep_ms(5)

        def ping(env, mem):
            return mem, TPhaseCtrl(
                advance=1,
                send_dest=torch.remainder(env.instance + 1, n),
                send_size=8.0, trace_code=7, trace_a0=env.instance,
            )

        b.phase(ping, "ping")
        b.loop_end(h)
        b.end_ok()

    src = t_build(source, _groups(n), trace={"capacity": 64}, **CFG).run()
    assert (src.statuses()[:n] == 1).all()
    tj = tmp_path / "trace.json"
    tj.write_text(json.dumps(src.chrome_trace()))
    from testground_tpu_torch.sim import trace as ttrace

    ev = ttrace.trace_events(src.state, n)
    work = ev[((ev["cat"] == 1) & (ev["code"] == 0)) | (ev["cat"] == 4)]
    src_counts = np.bincount(work["lane"], minlength=n)
    rows = t2r.convert(t2r.load_chrome_events(tj), 1.0,
                       {"send", "user", "kill", "restart"})
    pair = _pair(tmp_path, _echo, rows, n=n)
    assert_planes_equal(*pair)
    (_, _), (_, res) = pair
    np.testing.assert_array_equal(res.replay_consumed_per_lane()[:n],
                                  src_counts)
    np.testing.assert_array_equal(res.state["mem"]["got"].numpy()[:n],
                                  src_counts)


def test_precompiled_plan_pads_to_the_context(tmp_path):
    """A ReplayPlan compiled against the unpadded context re-aligns to a
    padded one in compile_program, as in the JAX package."""
    from testground_tpu_torch.sim import compile_program

    tf = _write_trace(tmp_path, _basic_rows())
    plan = treplay.compile_replay({"trace": tf},
                                  TCtx([TGroup("g", 0, 2, {})]), TConfig())
    ex = compile_program(_echo(torch),
                         TCtx([TGroup("g", 0, 2, {})], padded_n=4),
                         TConfig(**CFG), device="cpu", replay=plan)
    assert ex.replay.arr_cnt.shape == (4,)
    res = ex.run()
    np.testing.assert_array_equal(res.replay_consumed_per_lane(),
                                  [2, 2, 0, 0])
    jex = j_build(_echo(jnp), _groups(), replay={"trace": tf}, **CFG)
    assert_leaves_equal(jex.run().state,
                        t_build(_echo(torch), _groups(),
                                replay={"trace": tf}, **CFG).run().state)


def test_bench_replay_leg_on_the_cpu():
    """``bench --replay``'s legs at n = 64 on the CPU: the disabled table
    keeps storm's leaves and ops, every echo lane counts its 32
    requests, the sparse trace is consumed whole under half its ticks,
    and no kernel runs (the echo has no data plane)."""
    from testground_tpu_torch import bench

    line = bench.replay_leg(64, "cpu")
    runs = line.pop("results")
    assert line["arrivals"] == 64 * bench.REPLAY_K
    assert line["skip_ratio_sparse"] < 0.5
    assert runs["sparse"].ticks > bench.REPLAY_K * bench.REPLAY_SPARSE
    assert set(line["launches"]) == {"self", "replayed", "sparse"}
    json.dumps(line)  # the printed line is plain JSON
