"""The port's default entry-mode deliver (testground_tpu_torch/sim/net.py)
against the JAX package's ``net.deliver`` on random entry-mode states,
one case per feature: with and without the egress queue, iid and
Markov-correlated loss, jitter, rate, reorder, duplicate and corrupt;
and its two pieces alone, the unbounded ranked-scatter append and the
toxic event. The JAX side runs jitted, as in the tick. Exact equality
on every returned leaf, floats by their bits."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from testground_tpu.sim import net as jn
from testground_tpu_torch.sim import net as tn
from testground_tpu_torch.sim import prng

N = 256
TICK = 100


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


def _ring(rng, n, cap, width):
    r = rng.integers(0, 1000, n).astype(np.int32)
    return {
        "inbox": (rng.random((n, cap, width)) * 50).astype(np.float32),
        "inbox_r": r,
        "inbox_w": (r + rng.integers(0, cap + 1, n)).astype(np.int32),
        "inbox_dropped": rng.integers(0, 3, n).astype(np.int32),
    }


def _dests(rng, n, p, hi=None):
    """Sends to a few hot destinations and to random ones (fan-in past
    the ring space and the arrival slots)."""
    hi = n if hi is None else hi
    hot = rng.integers(0, n, 5)
    d = np.where(rng.random(n) < 0.4, hot[rng.integers(0, 5, n)],
                 rng.integers(0, hi, n))
    return np.where(rng.random(n) < p, d, -1).astype(np.int32)


_SHAPING = {
    "eg_latency": lambda rng: rng.random(N) * 5,
    "eg_jitter": lambda rng: rng.random(N) * 3,
    "eg_rate": lambda rng: np.where(rng.random(N) < 0.2, 0.0,
                                    rng.random(N) * 900),
    "eg_busy": lambda rng: TICK - 2 + rng.random(N) * 5,
    "eg_loss": lambda rng: rng.random(N) * 0.3,
    "eg_corrupt": lambda rng: rng.random(N) * 0.6,
    "eg_reorder": lambda rng: rng.random(N) * 0.5,
    "eg_duplicate": lambda rng: rng.random(N) * 0.5,
}


def _state(seed, spec_kw, weird_pay=False):
    """A random entry-mode net state and one tick's sends (numpy)."""
    rng = np.random.default_rng(seed)
    spec = tn.NetSpec(**spec_kw)
    net = {k: v.numpy() for k, v in tn.init_net_state(N, spec, "cpu").items()}
    net.update(_ring(rng, N, spec.inbox_capacity, spec.width))
    net["net_enabled"] = (rng.random(N) > 0.05).astype(np.int32)
    for k, gen in _SHAPING.items():
        if k in net:
            net[k] = gen(rng).astype(np.float32)
    for name in ("loss", "corrupt", "reorder", "duplicate"):
        if f"ar_{name}" in net:
            net[f"eg_{name}_corr"] = rng.random(N).astype(np.float32)
            net[f"ar_{name}"] = (rng.random(N) < 0.4).astype(np.float32)
    P = spec.payload_len
    if "pend_dest" in net:
        net["pend_dest"] = np.where(rng.random(N) < 0.3,
                                    rng.integers(0, N, N), -1).astype(np.int32)
        net["pend_tick"] = (TICK - rng.integers(0, 7, N)).astype(np.int32)
        net["pend_tag"] = np.zeros(N, np.int32)
        net["pend_port"] = rng.integers(0, 5, N).astype(np.int32)
        net["pend_size"] = (rng.random(N) * 64).astype(np.float32)
        net["pend_pay"] = rng.random((N, P)).astype(np.float32)
    pay = rng.random((N, P)).astype(np.float32)
    if weird_pay:
        pay[rng.random((N, P)) < 0.1] = 0.0
        pay[rng.random((N, P)) < 0.1] = 1e-40  # denormal
        pay[rng.random((N, P)) < 0.05] = np.nan
        pay[rng.random((N, P)) < 0.05] = -np.inf
    send = (
        _dests(rng, N, 0.6),
        # a few SYN-tagged lanes: transmitted, never stored as data
        np.where(rng.random(N) < 0.05, 1, 0).astype(np.int32),
        rng.integers(0, 5, N).astype(np.int32),
        (rng.random(N) * 1000).astype(np.float32),
        pay,
    )
    running = rng.random(N) > 0.1
    return spec_kw, net, send, running


ALL = dict(uses_latency=True, uses_jitter=True, uses_rate=True,
           uses_loss=True, uses_corrupt=True, uses_reorder=True,
           uses_duplicate=True, uses_loss_corr=True, uses_corrupt_corr=True,
           uses_reorder_corr=True, uses_duplicate_corr=True)
NONE = {k: False for k in ALL}

CASES = [
    ("latency_loss", dict(uses_latency=True, uses_loss=True), False),
    ("queue_latency_loss", dict(uses_latency=True, uses_loss=True), True),
    ("loss_correlated", dict(uses_loss=True, uses_loss_corr=True), True),
    ("jitter_rate", dict(uses_latency=True, uses_jitter=True,
                         uses_rate=True), False),
    ("reorder", dict(uses_latency=True, uses_reorder=True,
                     uses_reorder_corr=True), False),
    ("duplicate", dict(uses_duplicate=True), False),
    ("duplicate_queue", dict(uses_duplicate=True, uses_duplicate_corr=True,
                             uses_latency=True), True),
    ("corrupt", dict(uses_corrupt=True, uses_corrupt_corr=True), False),
    ("everything", ALL, True),
    ("featureless", {}, False),
]


@pytest.mark.parametrize("name,flags,queue", CASES)
def test_deliver_default_front(name, flags, queue):
    spec_kw = dict(NONE, inbox_capacity=8, payload_len=3, head_k=1,
                   send_slots=N // 4 if queue else None, **flags)
    seed = CASES.index((name, flags, queue))
    spec_kw, net, send, running = _state(seed, spec_kw,
                                         weird_pay=name in ("corrupt",
                                                            "everything"))
    jspec, tspec = jn.NetSpec(**spec_kw), tn.NetSpec(**spec_kw)
    assert set(jn.init_net_state(N, jspec)) == set(net)
    assert ("pend_dest" in net) == queue

    def j_deliver(st, key, *args):
        return jn.deliver(st, jspec, jnp.int32(TICK), key, *args)

    want = jax.jit(j_deliver)(
        {k: jnp.asarray(v) for k, v in net.items()},
        jax.random.PRNGKey(seed), *map(jnp.asarray, send),
        jnp.asarray(running))
    got = tn.deliver(
        {k: _t(v) for k, v in net.items()}, tspec,
        torch.tensor(TICK, dtype=torch.int32), prng.PRNGKey(seed),
        *map(_t, send), _t(running))
    assert set(got) == set(want)
    for k in sorted(want):
        _eq(got[k], want[k], k)
    # the case moved what it tests
    assert int(got["inbox_w"].sum()) > int(net["inbox_w"].sum())


def test_filter_rules_raise():
    """Filter rules run now (tests/test_torch_filters.py holds them to
    JAX); the one data-plane feature the deliver still refuses is
    destination-sharded delivery, filters or not."""
    spec = tn.NetSpec(inbox_capacity=8, payload_len=2, use_pair_rules=True,
                      dest_sharded=True)
    _, net, send, running = _state(0, dict(inbox_capacity=8, payload_len=2))
    net["pair_filter"] = np.zeros((N, N), np.int8)
    with pytest.raises(NotImplementedError, match="dest_sharded"):
        tn.deliver({k: _t(v) for k, v in net.items()}, spec,
                   torch.tensor(TICK, dtype=torch.int32), prng.PRNGKey(0),
                   *map(_t, send), _t(running))
    spec.dest_sharded = False
    got = tn.deliver({k: _t(v) for k, v in net.items()}, spec,
                     torch.tensor(TICK, dtype=torch.int32), prng.PRNGKey(0),
                     *map(_t, send), _t(running))
    assert got["pair_filter"].dtype == torch.int8


@pytest.mark.parametrize(
    "seed,lanes,cap,p",
    [
        (0, N, 8, 0.5),        # one lane per instance
        (1, N, 4, 0.9),        # full rings: ring-space drops
        (2, 2 * N, 8, 0.6),    # the duplicate-doubled lane domain
        (3, 2 * N, 16, 0.3),   # with dests past the N receivers
    ],
)
def test_append_messages_unbounded(seed, lanes, cap, p):
    rng = np.random.default_rng(seed)
    spec_kw = dict(inbox_capacity=cap, payload_len=2, head_k=1)
    jspec, tspec = jn.NetSpec(**spec_kw), tn.NetSpec(**spec_kw)
    st = _ring(rng, N, cap, tspec.width)
    dest = _dests(rng, lanes, p, hi=N + (N // 2 if seed == 3 else 0))
    rec = (rng.random((lanes, tspec.width)) * 9).astype(np.float32)
    want = jax.jit(lambda net, d, r: jn._append_messages(net, jspec, d, r))(
        {k: jnp.asarray(v) for k, v in st.items()}, jnp.asarray(dest),
        jnp.asarray(rec))
    got = tn._append_messages({k: _t(v) for k, v in st.items()}, tspec,
                              _t(dest), _t(rec))
    for k in st:
        _eq(got[k], want[k], k)
    assert int(got["inbox_dropped"].sum()) > int(st["inbox_dropped"].sum())


@pytest.mark.parametrize("correlated", [False, True])
def test_toxic_event(correlated):
    rng = np.random.default_rng(int(correlated))
    n = 1000
    net = {}
    if correlated:
        net["eg_loss_corr"] = rng.random(n).astype(np.float32)
        net["ar_loss"] = (rng.random(n) < 0.5).astype(np.float32)
    sending = rng.random(n) < 0.7
    rate = (rng.random(n) * 0.6).astype(np.float32)

    def j_event(st, key, s, r):
        st = dict(st)
        ev = jn._toxic_event(st, key, "loss", n, s, r)
        return ev, st

    want_ev, want_net = jax.jit(j_event)(
        {k: jnp.asarray(v) for k, v in net.items()}, jax.random.PRNGKey(9),
        jnp.asarray(sending), jnp.asarray(rate))
    tnet = {k: _t(v) for k, v in net.items()}
    got_ev = tn._toxic_event(tnet, prng.PRNGKey(9), "loss", n, _t(sending),
                             _t(rate))
    _eq(got_ev, want_ev, "event")
    for k in net:
        _eq(tnet[k], want_net[k], k)
