"""Filter rules and entry-mode dials in the port
(testground_tpu_torch/sim/net.py, core.py, program.py) against the JAX
package, on the CPU: ``apply_net_config``'s pair-rule, class and
class-rule writes with their two gates; the filter action in ``deliver``
in entry mode (with and without the egress queue) and in count mode
(staging row and delay wheel), with the handshake's ACK, the RST of a
REJECT rule and the reply blocked by the dialee's own filter; a filtered
lane that is also lossy (Markov) and rate-shaped, whose toxic register
and link clock must not move; and whole programs through both packages:
JAX's tests/test_sim_network.py builders (fast RST, a class DROP that
breaks both directions, a dial to a finished peer) and their pair-rule
twin, a class-rule program with dials behind the egress queue, the DSL
checks, and ``pallas_front=True`` on a filtering program. Numpy inputs
from a seed; exact equality on every leaf, floats by their bits."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _storm_parity import assert_leaves_equal

from testground_tpu.parallel import instance_mesh
from testground_tpu.sim import BuildContext as JCtx
from testground_tpu.sim import PhaseCtrl as JCtrl
from testground_tpu.sim import SimConfig as JConfig
from testground_tpu.sim import compile_program as j_compile
from testground_tpu.sim import net as jn
from testground_tpu.sim.context import GroupSpec as JGroup
from testground_tpu.sim.program import TopicRegistry as JTopics
from testground_tpu_torch.sim import BuildContext as TCtx
from testground_tpu_torch.sim import GroupSpec as TGroup
from testground_tpu_torch.sim import PhaseCtrl as TCtrl
from testground_tpu_torch.sim import SimConfig as TConfig
from testground_tpu_torch.sim import compile_program as t_compile
from testground_tpu_torch.sim import net as tn
from testground_tpu_torch.sim import prng
from testground_tpu_torch.sim.program import TAG_ACK, TAG_RST, TAG_SYN
from testground_tpu_torch.sim.program import onehot_get
from testground_tpu_torch.sim.program import TopicRegistry as TTopics

N = 128
C = 4
TICK = 100
ACCEPT, REJECT, DROP = tn.ACTION_ACCEPT, tn.ACTION_REJECT, tn.ACTION_DROP


def _eq(got, want, msg=""):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (msg, g.dtype, w.dtype,
                                                       g.shape, w.shape)
    if g.dtype.kind == "f":
        g, w = g.view(np.int32), w.view(np.int32)
    np.testing.assert_array_equal(g, w, err_msg=msg)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _actions(rng, shape):
    """Filter entries: mostly ACCEPT, some REJECT and DROP."""
    return rng.choice([ACCEPT, REJECT, DROP], size=shape,
                      p=[0.7, 0.15, 0.15]).astype(np.int8)


_SHAPING = {
    "eg_latency": lambda rng: rng.random(N) * 5,
    "eg_jitter": lambda rng: rng.random(N) * 3,
    "eg_rate": lambda rng: np.where(rng.random(N) < 0.2, 0.0,
                                    rng.random(N) * 900),
    "eg_busy": lambda rng: TICK - 2 + rng.random(N) * 5,
    "eg_loss": lambda rng: rng.random(N) * 0.3,
    "eg_loss_corr": lambda rng: rng.random(N),
    "ar_loss": lambda rng: (rng.random(N) < 0.4) * 1.0,
    "eg_duplicate": lambda rng: rng.random(N) * 0.5,
}


def _state(seed, spec_kw):
    """A random net state of either mode with filter rules, and one
    tick's sends (40% of them SYNs), running mask and hs_clear
    (numpy)."""
    rng = np.random.default_rng(seed)
    spec = tn.NetSpec(**spec_kw)
    net = {k: v.numpy() for k, v in tn.init_net_state(N, spec, "cpu").items()}
    net["net_enabled"] = (rng.random(N) > 0.05).astype(np.int32)
    if "pair_filter" in net:
        net["pair_filter"] = _actions(rng, (N, N))
    if "class_rules" in net:
        # classes past the last one clamp onto it
        net["class_of"] = rng.integers(0, C + 2, N).astype(np.int32)
        net["class_rules"] = _actions(rng, (N, C))
    for k, gen in _SHAPING.items():
        if k in net:
            net[k] = gen(rng).astype(np.float32)
    if "hs" in net:
        net["hs"] = np.stack([
            TICK + rng.random(N) * 9, rng.integers(-1, N, N),
            rng.integers(0, 3, N), rng.integers(2, 4, N),
        ], axis=-1).astype(np.float32)
    P = spec.payload_len
    if spec.store_entries:
        cap = spec.inbox_capacity
        r = rng.integers(0, 1000, N).astype(np.int32)
        net["inbox"] = (rng.random((N, cap, spec.width)) * 50).astype(
            np.float32)
        net["inbox_r"] = r
        net["inbox_w"] = (r + rng.integers(0, cap // 2, N)).astype(np.int32)
    else:
        net["avail"] = rng.integers(0, 9, N).astype(np.int32)
        net["bytes_in"] = (rng.random(N) * 1e4).astype(np.float32)
        buf = "staging" if "staging" in net else "wheel"
        net[buf] = (rng.random(net[buf].shape) * 7.3).astype(np.float32)
    if "pend_dest" in net:
        net["pend_dest"] = np.where(rng.random(N) < 0.3,
                                    rng.integers(0, N, N), -1).astype(np.int32)
        net["pend_tick"] = (TICK - rng.integers(0, 7, N)).astype(np.int32)
        net["pend_tag"] = np.where(rng.random(N) < 0.3, TAG_SYN,
                                   0).astype(np.int32)
        net["pend_port"] = rng.integers(0, 5, N).astype(np.int32)
        net["pend_size"] = (rng.random(N) * 64).astype(np.float32)
        net["pend_pay"] = rng.random((N, P)).astype(np.float32)
    send = (
        np.where(rng.random(N) < 0.8, rng.integers(0, N, N),
                 -1).astype(np.int32),
        np.where(rng.random(N) < 0.4, TAG_SYN, 0).astype(np.int32),
        rng.integers(0, 5, N).astype(np.int32),
        (rng.random(N) * 1000 + rng.random(N)).astype(np.float32),
        rng.random((N, P)).astype(np.float32),
    )
    running = rng.random(N) > 0.1
    hs_clear = (rng.random(N) < 0.3).astype(np.int32)
    return net, send, running, hs_clear


def _rules_kw(rules):
    return dict(use_pair_rules="pair" in rules,
                use_class_rules="class" in rules, n_classes=C)


FLAGS = dict(uses_latency=False, uses_jitter=False, uses_rate=False,
             uses_loss=False)
ENTRY = dict(FLAGS, inbox_capacity=8, payload_len=2, head_k=1)
COUNT = dict(FLAGS, store_entries=False, payload_len=1, horizon=16)
LOSSY_RATE = dict(uses_latency=True, uses_rate=True, uses_loss=True,
                  uses_loss_corr=True)

# (name, rules, spec fields)
DELIVER_CASES = [
    ("entry_pair", "pair", dict(ENTRY, uses_dials=True)),
    ("entry_class_queue", "class",
     dict(ENTRY, uses_dials=True, send_slots=N // 4, uses_latency=True)),
    ("entry_both_lossy_rate", "pair+class",
     dict(ENTRY, uses_dials=True, **LOSSY_RATE)),
    ("entry_class_queue_lossy_rate_duplicate", "class",
     dict(ENTRY, uses_dials=True, send_slots=N // 4, uses_duplicate=True,
          **LOSSY_RATE)),
    ("entry_pair_no_dials", "pair", dict(ENTRY, uses_jitter=True)),
    ("count_staging_class", "class", dict(COUNT, uses_dials=True)),
    ("count_wheel_pair_lossy_rate", "pair",
     dict(COUNT, uses_dials=True, **LOSSY_RATE)),
    ("count_wheel_both", "pair+class",
     dict(COUNT, uses_dials=True, uses_latency=True, send_slots=N // 16)),
]


def _action(net, dest):
    """The test's own filter action of each lane's send (numpy)."""
    d = np.clip(dest, 0, N - 1)
    act = np.zeros(N, np.int8)
    if "pair_filter" in net:
        act = np.maximum(act, net["pair_filter"][np.arange(N), d])
    if "class_rules" in net:
        cls = np.clip(net["class_of"][d], 0, C - 1)
        act = np.maximum(act, net["class_rules"][np.arange(N), cls])
    return act


@pytest.mark.parametrize("name,rules,kw", DELIVER_CASES,
                         ids=[c[0] for c in DELIVER_CASES])
def test_deliver_filter_action(name, rules, kw):
    spec_kw = dict(kw, **_rules_kw(rules))
    seed = [c[0] for c in DELIVER_CASES].index(name)
    net, send, running, hs_clear = _state(seed, spec_kw)
    jspec, tspec = jn.NetSpec(**spec_kw), tn.NetSpec(**spec_kw)
    assert set(jn.init_net_state(N, jspec)) == set(net)

    def j_deliver(st, key, *args):
        return jn.deliver(st, jspec, jnp.int32(TICK), key, *args[:-1],
                          hs_clear=args[-1])

    want = jax.jit(j_deliver)(
        _j(net), jax.random.PRNGKey(seed), *map(jnp.asarray, send),
        jnp.asarray(running), jnp.asarray(hs_clear))
    got = tn.deliver(
        {k: _t(v) for k, v in net.items()}, tspec,
        torch.tensor(TICK, dtype=torch.int32), prng.PRNGKey(seed),
        *map(_t, send), _t(running), hs_clear=_t(hs_clear))
    assert set(got) == set(want)
    for k in sorted(want):
        _eq(got[k], want[k], k)

    # the case reached what it tests: filtered sends (without a queue,
    # whose admission moves the lanes, the test's own action applies)
    if "pend_dest" in net:
        return
    dest = send[0]
    dc = np.clip(dest, 0, N - 1)
    live = running & (net["net_enabled"] > 0)
    up = (dest >= 0) & live & live[dc]
    filtered = up & (_action(net, dest) != ACCEPT)
    assert filtered.sum() > 5
    # a filtered lane's send never reaches the link: its Markov loss
    # register and its link clock stay as they were
    for k in ("ar_loss", "eg_busy"):
        if k in net:
            _eq(got[k][filtered], net[k][filtered], k)
            assert not np.array_equal(got[k].numpy(), net[k]), k
    if "hs" in net:
        tag = got["hs"].numpy()[:, tn.HS_TAG]
        syn = send[1] == TAG_SYN
        rejected = up & syn & (_action(net, dest) == REJECT)
        assert rejected.any()
        np.testing.assert_array_equal(tag[rejected], TAG_RST)
        acked = tag == TAG_ACK
        changed = (got["hs"].numpy() != net["hs"]).any(axis=1)
        assert (acked & changed).any()


@pytest.mark.parametrize("rules", ["pair", "class", "pair+class"])
def test_apply_net_config_filter_writes(rules):
    """``class_of`` takes every ``net_class >= 0`` whatever ``set_flag``
    says; ``pair_filter`` and ``class_rules`` take the entries >= 0 of
    the rows of lanes that set their shaping."""
    rng = np.random.default_rng(len(rules))
    spec_kw = dict(ENTRY, uses_latency=True, uses_loss=True,
                   **_rules_kw(rules))
    net, *_ = _state(7, spec_kw)
    set_flag = (rng.random(N) < 0.5).astype(np.int32)
    lat = (rng.random(N) * 50).astype(np.float32)
    loss = (rng.random(N) * 10).astype(np.float32)
    enabled = (rng.random(N) > 0.1).astype(np.int32)
    rows = rng.integers(-1, 3, (N, N)).astype(np.int32)
    ncls = np.where(rng.random(N) < 0.5, rng.integers(0, C, N),
                    -1).astype(np.int32)
    crows = rng.integers(-1, 3, (N, C)).astype(np.int32)
    pair, cls = "pair" in rules, "class" in rules
    args = (set_flag, lat, np.float32(0.0), np.float32(0.0), loss, enabled,
            rows if pair else None)
    kw = dict(net_class=ncls if cls else None,
              class_rule_rows=crows if cls else None)
    # jitted, as in the tick (XLA divides by the quantum as a reciprocal
    # multiply only under jit)
    want = jax.jit(lambda st, a, k: jn.apply_net_config(st, 10.0, *a, **k))(
        _j(net), [None if a is None else jnp.asarray(a) for a in args],
        {k: None if v is None else jnp.asarray(v) for k, v in kw.items()})
    got = tn.apply_net_config(
        {k: _t(v) for k, v in net.items()}, 10.0,
        *(None if a is None else _t(a) for a in args),
        **{k: None if v is None else _t(v) for k, v in kw.items()})
    for k in sorted(want):
        _eq(got[k], want[k], k)
    off = set_flag == 0
    if pair:
        _eq(got["pair_filter"][off], net["pair_filter"][off], "gate")
        assert not np.array_equal(got["pair_filter"].numpy(),
                                  net["pair_filter"])
    if cls:
        moved = off & (ncls >= 0) & (ncls != net["class_of"])
        assert moved.any()
        _eq(got["class_of"][moved], ncls[moved], "class_of")
        _eq(got["class_rules"][off], net["class_rules"][off], "gate")


# ------------------------------------------------------ whole programs


def _ctx(pkg, n):
    Ctx, Group = (JCtx, JGroup) if pkg == "jax" else (TCtx, TGroup)
    return Ctx([Group("single", 0, n, {})], test_case="t", test_run="t")


def compile_in(pkg, build, n, **cfg):
    """``build(b, pkg)`` compiled by package ``pkg`` ("jax" or "torch")
    at ``n`` instances, on the CPU (JAX on a one-device mesh)."""
    if pkg == "jax":
        return j_compile(lambda b: build(b, "jax"), _ctx("jax", n),
                         JConfig(chunk_ticks=100_000, **cfg),
                         mesh=instance_mesh(jax.devices()[:1]))
    return t_compile(lambda b: build(b, "torch"), _ctx("torch", n),
                     TConfig(chunk_ticks=64, **cfg), device="cpu")


def run_both(build, n, **cfg):
    """``build(b, pkg)`` through both packages: (JAX result, port
    result), every leaf and ``ticks`` equal."""
    cfg.setdefault("max_ticks", 100_000)
    jr = compile_in("jax", build, n, **cfg).run()
    tr = compile_in("torch", build, n, **cfg).run()
    assert tr.ticks == jr.ticks
    assert assert_leaves_equal(jr.state, tr.state) > 0
    assert tr.outcomes() == jr.outcomes()
    return jr, tr


def _metric(res, name):
    return {r["instance"]: r["value"] for r in res.metrics_records()
            if r["name"] == name}


def _where(pkg):
    return jnp.where if pkg == "jax" else torch.where


def _i32(pkg, x):
    return jnp.int32(x) if pkg == "jax" else x.to(torch.int32)


def _row(pkg, n, at, action):
    """An [n] rule row: ``action`` at index ``at``, -1 elsewhere."""
    if pkg == "jax":
        return jnp.full((n,), -1, jnp.int32).at[at].set(action)
    return torch.where(torch.arange(n) == at, action, -1).to(torch.int32)


def test_reject_gives_fast_rst():
    """tests/test_sim_network.py's builder: 0 dials 1 through a REJECT
    pair rule and gets a refusal fast, not a timeout."""

    def build(b, pkg):
        b.enable_net(pair_rules=True)
        b.configure_network(
            latency_ms=5.0,
            rules_fn=lambda env, mem: _row(pkg, b.ctx.padded_n, 1, REJECT),
            callback_state="cfg")
        b.dial(lambda env, mem: _where(pkg)(env.instance == 0, 1, -1), 80,
               result_slot="r", timeout_ms=5000.0, elapsed_slot="e")
        b.fail_if(lambda env, mem: (env.instance == 0) & (mem["r"] != -1),
                  "expected refused")
        b.fail_if(lambda env, mem: (env.instance == 0) & (mem["e"] > 50),
                  "RST too slow")
        b.end_ok()

    jr, tr = run_both(build, 2)
    assert tr.outcomes() == {"single": (2, 2)}


@pytest.mark.parametrize("rules", ["class", "pair"])
def test_dial_to_dropped_peer_times_out_both_ways(rules):
    """tests/test_sim_network.py's class-rule builder, and its pair-rule
    twin: instance 0 drops traffic toward 1. 0 -> 1 dies on 0's egress;
    1 -> 0 reaches 0, but 0's ACK toward 1 is dropped by 0's own rule."""

    def build(b, pkg):
        wh = _where(pkg)
        if rules == "class":
            b.enable_net(class_rules=True, n_classes=2)
            b.set_net_class(lambda env, mem: env.instance % 2)

            def class_rules(env, mem):
                ar = (jnp.arange(2) if pkg == "jax"
                      else torch.arange(2, dtype=torch.int32))
                out = wh((env.instance % 2 == 0) & (ar == 1), DROP, -1)
                return (out.astype(jnp.int32) if pkg == "jax"
                        else out.to(torch.int32))

            b.configure_network(class_rules_fn=class_rules,
                                callback_state="cfg")
        else:
            b.enable_net(pair_rules=True)

            def rules_fn(env, mem):
                row = _row(pkg, b.ctx.padded_n, 1, DROP)
                return wh(env.instance == 0, row, -1)

            b.configure_network(rules_fn=rules_fn, callback_state="cfg")
        b.dial(lambda env, mem: wh(env.instance == 0, 1, -1), 80,
               result_slot="r", timeout_ms=200.0)
        b.dial(lambda env, mem: wh(env.instance == 1, 0, -1), 81,
               result_slot="r2", timeout_ms=200.0)
        b.record_point("dial_r", lambda env, mem: mem["r"])
        b.record_point("dial_r2", lambda env, mem: mem["r2"])
        b.end_ok()

    jr, tr = run_both(build, 2)
    assert _metric(tr, "dial_r")[0] == -2  # 0 -> 1 dropped on egress
    assert _metric(tr, "dial_r2")[1] == -2  # the ACK from 0 dropped


def test_dial_to_finished_instance_times_out():
    """tests/test_sim_network.py's builder: a dial in entry mode to an
    instance that has finished gets no ACK."""

    def build(b, pkg):
        wh = _where(pkg)
        b.enable_net()

        def maybe_exit(env, mem):
            Ctrl = JCtrl if pkg == "jax" else TCtrl
            return mem, Ctrl(advance=_i32(pkg, env.instance != 1),
                             status=wh(env.instance == 1, 1, 0))

        b.phase(maybe_exit, name="exit_1")
        b.sleep_ms(50)
        b.dial(lambda env, mem: wh(env.instance == 0, 1, -1), 80,
               result_slot="r", timeout_ms=200.0)
        b.record_point("dial_r", lambda env, mem: mem["r"])
        b.end_ok()

    jr, tr = run_both(build, 3)
    assert _metric(tr, "dial_r")[0] == -2


def _queued_class_dials(b, pkg, send_slots):
    """Every instance dials two peers through class rules behind an
    egress queue of ``send_slots``: class 0 rejects class 1, class 1
    drops class 2, class 2 accepts all."""
    wh = _where(pkg)
    n = b.ctx.n_instances
    b.enable_net(class_rules=True, n_classes=3, payload_len=2, head_k=1,
                 send_slots=send_slots)
    b.set_net_class(lambda env, mem: env.instance % 3)

    def class_rules(env, mem):
        me = env.instance % 3
        ar = jnp.arange(3) if pkg == "jax" else torch.arange(3)
        out = wh((me == 0) & (ar == 1), REJECT,
                 wh((me == 1) & (ar == 2), DROP, -1))
        return out.astype(jnp.int32) if pkg == "jax" else out.to(torch.int32)

    b.configure_network(latency_ms=3.0, loss=5.0,
                        class_rules_fn=class_rules, callback_state="cfg")
    for k, step in enumerate((1, 5)):
        b.dial(lambda env, mem, step=step: (env.instance + step) % n,
               90 + k, result_slot=f"r{k}", timeout_ms=60.0,
               elapsed_slot=f"e{k}")
        b.record_point(f"dial_r{k}", lambda env, mem, k=k: mem[f"r{k}"])
    b.signal_and_wait("done")
    b.end_ok()


def test_class_rule_dials_behind_egress_queue():
    """24 instances dial through class rules behind a 4-slot egress
    queue: ACKs, RSTs and timeouts all occur, and the queue defers."""
    jr, tr = run_both(lambda b, pkg: _queued_class_dials(b, pkg, 4), 24)
    results = set(_metric(tr, "dial_r0").values()) | set(
        _metric(tr, "dial_r1").values())
    assert results == {1.0, -1.0, -2.0}
    assert tr.net_egress_deferred() > 0 and tr.net_egress_overflow() == 0


def _filtered_ring(b, pkg, rules=True):
    """A dial-free program the fused front could run but for its class
    rules: each instance sends one message to its right neighbour behind
    a 4-slot egress queue, over 3 ms lossy links; class 0 drops class 1,
    class 1 rejects class 2; a receiver waits 40 ticks at most."""
    wh = _where(pkg)
    n = b.ctx.n_instances
    b.enable_net(class_rules=rules, n_classes=3, payload_len=2, head_k=1,
                 send_slots=4)
    if rules:
        b.set_net_class(lambda env, mem: env.instance % 3)

    def class_rules(env, mem):
        me = env.instance % 3
        ar = jnp.arange(3) if pkg == "jax" else torch.arange(3)
        out = wh((me == 0) & (ar == 1), DROP,
                 wh((me == 1) & (ar == 2), REJECT, -1))
        return out.astype(jnp.int32) if pkg == "jax" else out.to(torch.int32)

    b.configure_network(latency_ms=3.0, loss=5.0,
                        class_rules_fn=class_rules if rules else None,
                        callback_state="cfg")
    b.send_message(lambda env, mem: (env.instance + 1) % n, 70, 8.0)

    def wait(env, mem):
        Ctrl = JCtrl if pkg == "jax" else TCtrl
        got = env.inbox_avail > 0
        return mem, Ctrl(advance=_i32(pkg, got | (env.tick > 40)),
                         recv_count=_i32(pkg, got),
                         metric_id=wh(got, 0, -1), metric_value=1.0)

    b.metrics.metric("got")
    b.phase(wait, name="wait")
    b.end_ok()


def test_pallas_front_with_filters():
    """``pallas_front=True`` refuses a filtering program in both packages
    (the fused front has no filter stage; without the rules the same
    program is eligible); by default it takes the default lowering,
    equal to JAX."""
    for pkg in ("jax", "torch"):
        with pytest.raises(ValueError, match="ineligible"):
            compile_in(pkg, _filtered_ring, 24, pallas_front=True)
        compile_in(pkg, lambda b, p: _filtered_ring(b, p, rules=False), 24,
                   pallas_front=True)
    jr, tr = run_both(_filtered_ring, 24)
    got = _metric(tr, "got")
    assert 8 <= len(got) < 24  # class 0's and 1's sends are filtered


# ------------------------------------------------------------- the DSL


@pytest.mark.parametrize("which", ["rules_fn", "class_rules_fn"])
def test_configure_network_row_shape_raises(which):
    def build(b, pkg):
        if pkg == "jax":
            row = lambda env, mem: jnp.zeros(5, jnp.int32)  # noqa: E731
        else:
            row = lambda env, mem: torch.zeros(5, dtype=torch.int32)  # noqa
        b.configure_network(callback_state="cfg", **{which: row})
        b.end_ok()

    for pkg in ("jax", "torch"):
        with pytest.raises(ValueError, match=f"{which} must return"):
            compile_in(pkg, build, 3, max_ticks=50).run()


@pytest.mark.parametrize("field", ["rule_row", "class_rule_row",
                                   "net_class"])
def test_filter_ctrl_without_its_plane_raises(field):
    """A hand-written phase that sets a filter field the program never
    allocated state for is refused at build, in both packages."""

    def build(b, pkg):
        b.enable_net()
        val = 0 if field == "net_class" else (
            jnp.zeros(3, jnp.int32) if pkg == "jax"
            else torch.zeros(3, dtype=torch.int32))
        Ctrl = JCtrl if pkg == "jax" else TCtrl
        b.phase(lambda env, mem: (mem, Ctrl(advance=1, **{field: val})))
        b.end_ok()

    for pkg in ("jax", "torch"):
        with pytest.raises(ValueError, match=f"PhaseCtrl\\({field}="):
            compile_in(pkg, build, 3, max_ticks=50).run()


def test_filter_row_and_reclassing():
    """A phase reads its own pair-filter row (``env.filter_row``), and a
    lane re-classes itself twice without re-shaping its link."""

    def build(b, pkg):
        wh = _where(pkg)
        n = b.ctx.padded_n
        b.enable_net(pair_rules=True, class_rules=True, n_classes=3)
        b.set_net_class(lambda env, mem: env.instance % 3)
        b.configure_network(
            rules_fn=lambda env, mem: _row(pkg, n, (env.instance + 1) % n,
                                           DROP),
            callback_state="cfg")
        b.set_net_class(lambda env, mem: wh(env.instance == 2, -1,
                                            (env.instance + 1) % 3))
        b.record_point(
            "to_next",
            lambda env, mem: (env.filter_row[(env.instance + 1) % n] * 1.0
                              if pkg == "jax" else onehot_get(
                                  env.filter_row.to(torch.float32),
                                  (env.instance + 1) % n)))
        b.end_ok()

    jr, tr = run_both(build, 5)
    assert set(_metric(tr, "to_next").values()) == {float(DROP)}
    np.testing.assert_array_equal(tr.state["net"]["class_of"].numpy(),
                                  [1, 2, 2, 1, 2])


def test_topic_registry_capacity():
    regs = (JTopics(), TTopics())
    for r in regs:
        assert r.capacity == 1
        r.topic("a", 7)
        r.topic("b", 30, payload_len=2)
        r.topic("c", 12, stream=True)
    assert regs[0].capacity == regs[1].capacity == 30
