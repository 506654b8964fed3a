"""The storm slice of the port against the JAX package, on the CPU:
mirrors of tests/test_storm.py (all ok and byte conservation, dial
latencies and rendezvous counters, dials failing under 100% loss) and
of tests/test_event_skip.py's ``TestStormShapedBitExact``, each also
held leaf for leaf to the JAX run; the DSL pieces storm uses (loops,
publish / wait_topic with a clamped topic, fail_if, churn-tolerant
barriers and topic waits, their build-time checks); and ``entry``, one
storm tick at 64 instances, against ``__graft_entry__.entry``. The
storm legs at n = 64 and 200 are tests/test_torch_storm_legs.py and
tests/test_torch_storm_200.py."""

import jax
import jax.numpy as jnp
import pytest
import torch

from _storm_parity import assert_leaves_equal, jax_plan, jax_run, torch_run
from testground_tpu_torch.plans import benchmarks as tbench
from testground_tpu_torch.sim import ProgramBuilder
from testground_tpu_torch.sim import BuildContext as TCtx
from testground_tpu_torch.sim import GroupSpec as TGroup
from testground_tpu_torch.sim.core import EVENT_SKIP_STATE_LEAVES
from testground_tpu_torch.sim.program import DONE_FAIL, DONE_OK

# tests/test_storm.py's PARAMS (1 ms quantum: SimConfig's default)
PARAMS = {
    "conn_count": 2,
    "conn_outgoing": 3,
    "conn_delay_ms": 64,
    "data_size_kb": 8,  # 2 chunks of 4 KiB
    "storm_quiet_ms": 32,
}


def _groups(n, **extra):
    return [("single", 0, n, {k: str(v) for k, v in
                              {**PARAMS, **extra}.items()})]


def _pair(n, cfg, jplan=None, tplan=None, **extra):
    groups = _groups(n, **extra)
    jr = jax_run(jplan or jax_plan(), groups, cfg)
    tr = torch_run(tplan or tbench.storm, groups, cfg)
    assert (tr.ticks, tr.ticks_executed) == (jr.ticks, jr.ticks_executed)
    assert_leaves_equal(jr.state, tr.state)
    return tr


@pytest.fixture(scope="module")
def storm8():
    """storm at n = 8, tests/test_storm.py's run, held to the JAX run."""
    return _pair(8, dict(max_ticks=60_000))


def test_all_ok_and_byte_conservation(storm8):
    n, res = 8, storm8
    assert not res.timed_out()
    assert (res.statuses()[:n] == DONE_OK).all()
    recs = res.metrics_records()
    sent = sum(r["value"] for r in recs if r["name"] == "bytes.sent")
    read = sum(r["value"] for r in recs if r["name"] == "bytes.read")
    assert sent == n * 3 * 8 * 1024
    assert read == sent
    assert res.net_dropped() == 0


def test_dial_latencies_and_counters(storm8):
    n, res = 8, storm8
    recs = res.metrics_records()
    ok = [r for r in recs if r["name"] == "dial.ok"]
    fail = [r for r in recs if r["name"] == "dial.fail"]
    assert len(ok) == n * 3 and not fail
    # a SYN -> ACK round trip: >= 1 virtual ms on unshaped links
    assert all(1.0 <= r["value"] <= 100.0 for r in ok)
    assert res.counter("listening") == n
    assert res.counter("got-other-addrs") == n
    assert res.counter("outgoing-dials-done") == n * 3
    assert res.counter("done writing") == n
    with pytest.raises(KeyError):
        res.counter("no-such-state")


def _with_loss(storm, b):
    b.enable_net(inbox_capacity=256, payload_len=1)
    b.configure_network(loss=100.0, callback_state="lossy")
    storm(b)


def test_storm_under_loss_fails_dials():
    # 100% loss: every dial times out, dial.fail is recorded and the
    # instances fail, but the run completes
    n = 4
    jplan = jax_plan()
    res = _pair(n, dict(max_ticks=400_000),
                jplan=lambda b: _with_loss(jplan, b),
                tplan=lambda b: _with_loss(tbench.storm, b),
                conn_delay_ms=16, dial_timeout_ms=200)
    assert not res.timed_out()
    assert (res.statuses()[:n] == DONE_FAIL).all()
    fails = [r for r in res.metrics_records() if r["name"] == "dial.fail"]
    assert len(fails) == n * 3


def test_shaped_skip_matches_dense():
    """TestStormShapedBitExact's case: shaped delays on the wheel, SYN
    retries; event skip equal to dense ticking (and both to JAX)."""
    extra = dict(conn_outgoing=2, conn_delay_ms=2000, storm_quiet_ms=200,
                 link_latency_ms=50, link_loss_pct=5, dial_retries=3,
                 dial_timeout_ms=1000)
    n = 8
    cfg = dict(quantum_ms=10.0, max_ticks=20_000, metrics_capacity=32)
    dense = torch_run(tbench.storm, _groups(n, **extra),
                      dict(cfg, event_skip=False))
    skip = _pair(n, dict(cfg, event_skip=True), **extra)
    assert not skip.executable.program.net_spec.fixed_next_tick
    assert (dense.statuses()[:n] == 1).all()
    assert dense.ticks == skip.ticks
    assert_leaves_equal(dense.state, skip.state, skip=EVENT_SKIP_STATE_LEAVES)
    assert skip.ticks_executed < skip.ticks


# ------------------------------------------------------------ DSL pieces

def _dsl_plan(to_f32):
    """Loops signalling a state, a publish into a topic that clamps
    (capacity n - 2) with its seq saved, a topic wait, a log, a fail_if
    on the seq: one plan body for both packages (``to_f32`` casts)."""

    def plan(b):
        n = b.ctx.n_instances
        lp = b.loop_begin(3)
        b.signal("tick-tock")
        b.loop_end(lp)
        b.barrier("tick-tock", 3 * n)
        b.publish("t", capacity=n - 2,
                  payload_fn=lambda env, mem: to_f32(env.instance) * 1.5
                  - 0.5, save_seq="pseq")
        b.wait_topic("t", capacity=n - 2, count=n - 2)
        b.log("published")
        b.fail_if(lambda env, mem: mem["pseq"] % 4 == 0, "every fourth")
        b.end_ok()

    return plan


def test_dsl_loops_topics_fail_if():
    n = 12
    jplan = _dsl_plan(lambda x: x.astype(jnp.float32))
    tplan = _dsl_plan(lambda x: x.to(torch.float32))
    groups = [("single", 0, n, {})]
    jr = jax_run(jplan, groups, dict(max_ticks=200))
    tr = torch_run(tplan, groups, dict(max_ticks=200), chunk_ticks=8)
    assert (tr.ticks, tr.ticks_executed) == (jr.ticks, jr.ticks_executed)
    assert_leaves_equal(jr.state, tr.state)
    assert int(tr.state["topic_len"][0]) == n - 2  # clamped
    assert tr.counter("tick-tock") == 3 * n
    st = tr.statuses()[:n]
    assert (st == DONE_FAIL).sum() == 3 and (st == DONE_OK).sum() == n - 3


def _churn_plan(b):
    n = b.ctx.n_instances
    b.signal_and_wait("ready", churn_weight=1)
    b.sleep_ms(30.0)
    b.publish("ids", capacity=n, payload_fn=lambda env, mem: 1.0)
    b.wait_topic("ids", capacity=n, count=n, churn_weight=1)
    b.signal("round")
    b.barrier("round", n, churn_weight=1)
    b.signal("round")
    b.barrier("round", 2 * n, churn_weight=2)
    b.end_ok()


def test_churn_tolerant_barriers_match_jax():
    n = 40
    cfg = dict(quantum_ms=10.0, max_ticks=400, churn_fraction=0.2,
               churn_start_ms=0.0, churn_end_ms=120.0)
    groups = [("single", 0, n, {})]
    jr = jax_run(_churn_plan, groups, cfg)
    tr = torch_run(_churn_plan, groups, cfg, chunk_ticks=8)
    assert (tr.ticks, tr.ticks_executed) == (jr.ticks, jr.ticks_executed)
    assert_leaves_equal(jr.state, tr.state)
    st = tr.statuses()[:n]
    assert (st == 3).sum() > 0 and not (st == 0).any()
    assert (st[st != 3] == DONE_OK).all()
    assert set(tr.state["churn_sig"].shape) == {n, 2}


def test_churn_weight_checks():
    ctx = TCtx([TGroup("single", 0, 4, {})], test_case="t", test_run="t")
    b = ProgramBuilder(ctx)
    with pytest.raises(ValueError, match="family"):
        b.barrier("f", 4, family_size=2, churn_weight=1)
    b.barrier("s", 4, churn_weight=1)
    with pytest.raises(ValueError, match="CUMULATIVE"):
        b.barrier("s", 8, churn_weight=1)


# ------------------------------------------------------------ entry

def test_entry_one_tick_matches_graft_entry():
    import __graft_entry__ as g
    import testground_tpu_torch

    jfn, (jst,) = g.entry()
    tfn, (tst,) = testground_tpu_torch.entry(device="cpu")
    assert_leaves_equal(jst, tst)
    for _ in range(3):
        jst, tst = jax.jit(jfn)(jst), tfn(tst)
    assert_leaves_equal(jst, tst)
    assert int(tst["tick"]) == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            testground_tpu_torch.entry()
