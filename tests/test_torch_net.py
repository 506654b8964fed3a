"""The port's entry-mode data plane (testground_tpu_torch/sim/net.py)
against the JAX package's sim/net.py on random states: the FIFO egress
admitter, the bounded two-level append, the record sanitizer, the head
cache / visible prefix / consume reads and the ConfigureNetwork writes.
The JAX side runs jitted, as in the tick. Exact equality."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from testground_tpu.sim import net as jn
from testground_tpu_torch.sim import net as tn


def _eq(got, want, msg=""):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (msg, g.dtype, w.dtype)
    if g.dtype.kind == "f":
        g, w = g.view(np.int32), w.view(np.int32)
    np.testing.assert_array_equal(g, w, err_msg=msg)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize(
    "seed,n,M,wait_span,wants_p",
    [
        (0, 500, 60, 10, 0.5),      # one-level counting regime
        (1, 777, 100, 800, 0.7),    # two-level regime
        (2, 300, 37, 9000, 0.9),    # past 4095: the JAX sort path
        (3, 256, 300, 50, 0.4),     # everyone fits
        (4, 1000, 1, 3, 1.0),       # one slot, heavy ties
    ],
)
def test_egress_admit(seed, n, M, wait_span, wants_p):
    rng = np.random.default_rng(seed)
    tick = 10_000
    age = (tick - rng.integers(0, wait_span, n)).astype(np.int32)
    wants = rng.random(n) < wants_p
    want = jax.jit(
        lambda t, a, w: jn._egress_admit(t, a, w, M, n)
    )(jnp.int32(tick), jnp.asarray(age), jnp.asarray(wants))
    got = tn._egress_admit(torch.tensor(tick, dtype=torch.int32), _t(age),
                           _t(wants), M, n)
    _eq(got, want)


def _ring_state(rng, N, spec):
    cap, W = spec.inbox_capacity, spec.width
    r = rng.integers(0, 1000, N).astype(np.int32)
    w = (r + rng.integers(0, cap + 1, N)).astype(np.int32)
    inbox = (rng.random((N, cap, W)) * 50).astype(np.float32)
    inbox[rng.random((N, cap, W)) < 0.2] = 0.0
    return {
        "inbox": inbox,
        "inbox_r": r,
        "inbox_w": w,
        "inbox_dropped": rng.integers(0, 3, N).astype(np.int32),
    }


@pytest.mark.parametrize(
    "seed,N,send_p,cap,arrival_slots",
    [
        (0, 200, 0.3, 8, 8),    # light traffic
        (1, 300, 0.9, 4, 2),    # fan-in past arrival_slots, full rings
        (2, 150, 0.05, 16, 8),  # sparse
    ],
)
def test_append_messages_bounded(seed, N, send_p, cap, arrival_slots):
    rng = np.random.default_rng(seed)
    spec_kw = dict(inbox_capacity=cap, payload_len=2, head_k=1,
                   send_slots=N // 4, arrival_slots=arrival_slots)
    jspec, tspec = jn.NetSpec(**spec_kw), tn.NetSpec(**spec_kw)
    st = _ring_state(rng, N, tspec)
    # a few hot destinations so same-dest ranks and drops occur
    hot = rng.integers(0, N, 5)
    dest = np.where(rng.random(N) < 0.5, hot[rng.integers(0, 5, N)],
                    rng.integers(0, N, N))
    dest = np.where(rng.random(N) < send_p, dest, -1).astype(np.int32)
    rec = (rng.random((N, tspec.width)) * 9).astype(np.float32)
    M = spec_kw["send_slots"]  # more valid lanes than M truncate (nonzero)
    want = jax.jit(
        lambda net, d, r: jn._append_messages_bounded(net, jspec, d, r, M)
    )({k: jnp.asarray(v) for k, v in st.items()}, jnp.asarray(dest),
      jnp.asarray(rec))
    got = tn._append_messages_bounded(
        {k: _t(v) for k, v in st.items()}, tspec, _t(dest), _t(rec), M)
    for k in st:
        _eq(got[k], want[k], k)


def test_sanitize_records():
    x = np.array(
        [[1e-40, -1e-40, 0.0, -0.0, np.nan],
         [np.inf, -np.inf, 1.0, 1.2e-38, 1e-45],
         [3.4e38, -2.5, 1.17549435e-38, -1.17549421e-38, 7.0]], np.float32)
    want = jax.jit(jn.sanitize_records)(jnp.asarray(x))
    got = tn.sanitize_records(_t(x))
    _eq(got[0], want[0], "rec")
    _eq(got[1], want[1], "clean")


@pytest.mark.parametrize("seed,head_k", [(0, 1), (1, 3), (2, 8)])
def test_head_cache_visible_prefix_consume(seed, head_k):
    rng = np.random.default_rng(seed)
    N = 257
    spec_kw = dict(inbox_capacity=8, payload_len=2, head_k=head_k)
    jspec, tspec = jn.NetSpec(**spec_kw), tn.NetSpec(**spec_kw)
    st = _ring_state(rng, N, tspec)
    tick = 40
    st["inbox"][:, :, jn.F_VISIBLE] = rng.integers(
        30, 50, (N, tspec.inbox_capacity)).astype(np.float32)
    recv = rng.integers(-1, 4, N).astype(np.int32)
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    tst = {k: _t(v) for k, v in st.items()}
    tt = torch.tensor(tick, dtype=torch.int32)
    _eq(tn.head_cache(tst, tspec),
        jax.jit(lambda s: jn.head_cache(s, jspec))(jst), "head_cache")
    vp_want = jax.jit(lambda s: jn.visible_prefix(s, jspec, jnp.int32(tick))
                      )(jst)
    vp_got = tn.visible_prefix(tst, tspec, tt)
    _eq(vp_got, vp_want, "visible_prefix")
    want = jax.jit(
        lambda s, r: jn.consume(s, jspec, jnp.int32(tick), r, prefix=None)
    )(jst, jnp.asarray(recv))
    got = tn.consume(tst, tspec, tt, _t(recv))
    _eq(got["inbox_r"], want["inbox_r"], "inbox_r")


@pytest.mark.parametrize("quantum_ms", [1.0, 10.0, 3.0])
def test_apply_net_config(quantum_ms):
    """Division by a constant under jit is XLA's float32 reciprocal
    multiply; the port's writes must land on the same bits."""
    rng = np.random.default_rng(int(quantum_ms))
    N = 400
    spec_kw = dict(uses_latency=True, uses_jitter=True, uses_rate=True,
                   uses_loss=True, send_slots=None, head_k=1,
                   payload_len=2, inbox_capacity=4)
    jspec, tspec = jn.NetSpec(**spec_kw), tn.NetSpec(**spec_kw)
    jst = dict(jn.init_net_state(N, jspec))
    tst = tn.init_net_state(N, tspec, "cpu")
    assert set(jst) == set(tst)
    flag = rng.integers(0, 2, N).astype(np.int32)
    lat = (rng.random(N) * 200).astype(np.float32)
    jit_ = (rng.random(N) * 30).astype(np.float32)
    bw = (rng.random(N) * 1e9).astype(np.float32)
    loss = (rng.random(N) * 100).astype(np.float32)
    en = rng.integers(0, 2, N).astype(np.int32)
    want = jax.jit(
        lambda s, f, a, b, c, d, e: jn.apply_net_config(
            s, quantum_ms, f, a, b, c, d, e, None)
    )(jst, *map(jnp.asarray, (flag, lat, jit_, bw, loss, en)))
    got = tn.apply_net_config(tst, quantum_ms, *map(_t, (flag, lat, jit_,
                                                        bw, loss, en)))
    for k in ("eg_latency", "eg_jitter", "eg_rate", "eg_loss",
              "net_enabled"):
        _eq(got[k], want[k], k)
