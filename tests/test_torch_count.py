"""The port's count-mode data plane (testground_tpu_torch/sim/net.py)
against the JAX package's on random count-mode states: ``init_net_state``
(staging row or delay wheel, occupancy, handshake registers, the
compact-fallback counter), ``deliver``'s count branch with the handshake
(staging and wheel, loss, Markov loss, duplicate, jitter, rate, horizon
clamping, ``send_slots`` below n), ``advance_wheel``, ``visible_prefix``
and ``consume``; the topic append; and the plain ordered scatter-add
against a sequential loop on fractional values. The JAX side runs
jitted, as in the tick. Exact equality on every leaf, floats by their
bits. The scatter-add kernel itself runs only on the card
(tests/test_torch_cuda.py)."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from testground_tpu.sim import net as jn
from testground_tpu_torch.sim import core as tcore
from testground_tpu_torch.sim import count_scatter as cs
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


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


FLAGS = ("uses_latency", "uses_jitter", "uses_rate", "uses_loss",
         "uses_loss_corr", "uses_duplicate", "uses_dials",
         "track_occupancy")


def _spec_kw(**kw):
    base = {f: False for f in FLAGS}
    base.update(store_entries=False, payload_len=1, horizon=16)
    base.update(kw)
    return base


@pytest.mark.parametrize("kw", [
    dict(),
    dict(track_occupancy=True),
    dict(uses_latency=True),
    dict(uses_latency=True, track_occupancy=True, uses_dials=True),
    dict(uses_jitter=True, uses_loss=True, uses_loss_corr=True,
         send_slots=N // 16),
    dict(uses_dials=True, send_slots=N),  # slots >= n: counter, no moves
])
def test_init_net_state(kw):
    spec_kw = _spec_kw(**kw)
    want = jn.init_net_state(N, jn.NetSpec(**spec_kw))
    got = tn.init_net_state(N, tn.NetSpec(**spec_kw), "cpu")
    assert set(got) == set(want)
    for k in want:
        _eq(got[k], want[k], k)


def _state(seed, spec_kw, syn_p=0.2):
    """A random count-mode net state (fractional buffers) and one tick's
    sends (numpy), with hs_clear."""
    rng = np.random.default_rng(seed)
    spec = tn.NetSpec(**spec_kw)
    net = {k: v.numpy() for k, v in tn.init_net_state(N, spec, "cpu").items()}
    net["net_enabled"] = (rng.random(N) > 0.05).astype(np.int32)
    net["avail"] = rng.integers(0, 9, N).astype(np.int32)
    net["bytes_in"] = (rng.random(N) * 1e4).astype(np.float32)
    if "staging" in net:
        net["staging"] = (rng.random((N, 2)) * 7.3).astype(np.float32)
        if "staging_cnt" in net:
            net["staging_cnt"] = np.int32(rng.integers(0, 50))
    else:
        W = spec.horizon
        net["wheel"] = (rng.random((W, N, 2)) * 7.3).astype(np.float32)
        net["horizon_clamped"] = rng.integers(0, 3, N).astype(np.int32)
        if "wheel_occ" in net:
            net["wheel_occ"] = rng.integers(0, 9, W).astype(np.int32)
    if "hs" in net:
        net["hs"] = np.stack([
            TICK + rng.random(N).astype(np.float32) * 9,
            rng.integers(-1, N, N).astype(np.float32),
            rng.integers(0, 3, N).astype(np.float32),
            rng.integers(2, 4, N).astype(np.float32),
        ], axis=-1).astype(np.float32)
    for k, gen in (
        ("eg_latency", lambda: rng.random(N) * 25),
        ("eg_jitter", lambda: rng.random(N) * 3),
        ("eg_rate", lambda: np.where(rng.random(N) < 0.2, 0.0,
                                     rng.random(N) * 9000)),
        ("eg_busy", lambda: TICK - 2 + rng.random(N) * 5),
        ("eg_loss", lambda: rng.random(N) * 0.3),
        ("eg_duplicate", lambda: rng.random(N) * 0.5),
        ("eg_loss_corr", lambda: rng.random(N)),
        ("ar_loss", lambda: (rng.random(N) < 0.4) * 1.0),
    ):
        if k in net:
            net[k] = gen().astype(np.float32)
    # a few hot destinations and random ones; fractional sizes, so the
    # order of the float adds shows
    hot = rng.integers(0, N, 7)
    d = np.where(rng.random(N) < 0.5, hot[rng.integers(0, 7, N)],
                 rng.integers(0, N, N))
    send = (
        np.where(rng.random(N) < 0.7, d, -1).astype(np.int32),
        np.where(rng.random(N) < syn_p, 1, 0).astype(np.int32),
        rng.integers(0, 5, N).astype(np.int32),
        (rng.random(N) * 4096 + rng.random(N)).astype(np.float32),
        np.zeros((N, 1), np.float32),
    )
    running = rng.random(N) > 0.1
    hs_clear = (rng.random(N) < 0.3).astype(np.int32)
    return net, send, running, hs_clear


CASES = [
    ("staging", dict()),
    ("staging_dials_occupancy", dict(uses_dials=True, track_occupancy=True)),
    ("staging_loss_duplicate", dict(uses_loss=True, uses_duplicate=True,
                                    uses_dials=True)),
    ("staging_slots_fallback", dict(send_slots=N // 16, uses_dials=True)),
    ("staging_slots_fit", dict(send_slots=N - 1)),
    ("wheel_latency", dict(uses_latency=True, uses_dials=True,
                           track_occupancy=True)),
    ("wheel_clamped", dict(uses_latency=True, horizon=8,
                           track_occupancy=True)),
    ("wheel_loss_corr_duplicate", dict(uses_latency=True, uses_loss=True,
                                       uses_loss_corr=True,
                                       uses_duplicate=True,
                                       uses_dials=True)),
    ("wheel_jitter_rate_slots", dict(uses_jitter=True, uses_rate=True,
                                     uses_dials=True, send_slots=N // 16,
                                     track_occupancy=True)),
]


@pytest.mark.parametrize("name,kw", CASES)
def test_deliver_count_mode(name, kw):
    spec_kw = _spec_kw(**kw)
    seed = [c[0] for c in CASES].index(name)
    net, send, running, hs_clear = _state(
        seed, spec_kw, syn_p=0.0 if name == "staging_slots_fit" else 0.2)
    if name == "staging_slots_fit":
        send = (np.where(np.arange(N) % 3 == 0, send[0], -1), *send[1:])
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
    # the case moved what it tests
    buf = "staging" if "staging" in net else "wheel"
    assert not np.array_equal(got[buf].numpy(), net[buf])
    if "hs" in net:
        assert not np.array_equal(got["hs"].numpy(), net["hs"])
    if name == "wheel_clamped":
        assert int(got["horizon_clamped"].sum()) > int(
            net["horizon_clamped"].sum())
    if name.endswith("fallback"):
        assert int(got["send_compact_fallback"]) == 1
    if name.endswith("fit"):
        assert int(got["send_compact_fallback"]) == 0


@pytest.mark.parametrize("kw,tick", [
    (dict(track_occupancy=True), 7),
    (dict(), 7),
    (dict(uses_latency=True, track_occupancy=True), 3),
    (dict(uses_latency=True, track_occupancy=True), 2**20 + 5),
    (dict(uses_latency=True), 40),
])
def test_advance_wheel_and_consume(kw, tick):
    spec_kw = _spec_kw(**kw)
    net, _, _, _ = _state(tick, spec_kw)
    jspec, tspec = jn.NetSpec(**spec_kw), tn.NetSpec(**spec_kw)
    rng = np.random.default_rng(tick)
    recv = rng.integers(-2, 12, N).astype(np.int32)

    def j_step(st, t, r):
        st = jn.advance_wheel(st, jspec, t)
        avail = jn.visible_prefix(st, jspec, t)
        return jn.consume(st, jspec, t, r), avail

    want, want_avail = jax.jit(j_step)(_j(net), jnp.int32(tick),
                                       jnp.asarray(recv))
    t = torch.tensor(tick, dtype=torch.int32)
    st = tn.advance_wheel({k: _t(v) for k, v in net.items()}, tspec, t)
    avail = tn.visible_prefix(st, tspec, t)
    got = tn.consume(st, tspec, t, _t(recv))
    _eq(avail, want_avail, "avail")
    assert set(got) == set(want)
    for k in sorted(want):
        _eq(got[k], want[k], k)


def _sequential(buf, idx, upd):
    """The reference order: one lane at a time, float32 adds."""
    out = buf.copy()
    for i in range(idx.shape[0]):
        if idx[i] < out.shape[0]:
            out[idx[i]] = (out[idx[i]] + upd[i]).astype(np.float32)
    return out


@pytest.mark.parametrize("case", ["seven_rows", "uniform", "all_dropped",
                                  "wheel", "storm", "long_segment"])
def test_scatter_add_plain_matches_sequential_loop(case):
    rng = np.random.default_rng(3)
    rows, L = (64 * 50, 500) if case == "wheel" else (50, 5000)
    buf = (rng.standard_normal((rows, 2)) * 1e3).astype(np.float32)
    upd = (rng.standard_normal((L, 2)) * rng.random((L, 1)) * 1e4).astype(
        np.float32)
    if case == "seven_rows":
        idx = rng.choice(rng.integers(0, rows, 7), L)
    elif case == "long_segment":  # one row takes every kept lane
        idx = np.full(L, rng.integers(0, rows))
    else:
        idx = rng.integers(0, rows, L)
    idx = np.where(rng.random(L) < 0.3, rows, idx)  # ~30% dropped
    if case == "all_dropped":
        idx = np.full(L, rows)
    if case == "storm":  # a storm tick: ~5% of lanes kept, integer updates
        buf = rng.integers(0, 64, (rows, 2)).astype(np.float32)
        upd = np.tile(np.float32([1, 4096]), (L, 1))
        upd[rng.random(L) < 0.05] = [2, 8192]
        idx = np.where(rng.random(L) < 0.05, rng.integers(0, rows, L), rows)
    idx = idx.astype(np.int32)
    want = _sequential(buf, idx, upd)
    got = cs.scatter_add_plain(_t(buf), _t(idx), _t(upd))
    _eq(got, want, case)
    # the JAX package's scatter gives the same bits
    _eq(got, jnp.asarray(buf).at[idx].add(jnp.asarray(upd), mode="drop"),
        case)
    # a summation order that differs gives other bits: the order is
    # what the test holds
    if case in ("seven_rows", "long_segment"):
        assert not np.array_equal(
            _sequential(buf, idx[::-1], upd[::-1]).view(np.int32),
            want.view(np.int32))
    # the dispatch takes the plain version on CPU tensors, out of place
    b = _t(buf)
    _eq(cs.scatter_add(b, _t(idx), _t(upd)), want, case)
    _eq(b, buf, "input untouched")


def test_topic_append_matches_jax():
    rng = np.random.default_rng(5)
    n, cap, pay = 300, 256, 3
    buf = np.zeros((cap, pay), np.float32)
    buf[:40] = rng.random((40, pay))
    pos0 = (40 + rng.permutation(n)).astype(np.int32)  # distinct slots
    mask = (rng.random(n) < 0.6) & (pos0 < cap)
    payloads = rng.standard_normal((n, 4)).astype(np.float32)
    payloads[rng.random((n, 4)) < 0.2] = -0.0
    safe = np.where(mask, pos0, cap)
    want = jnp.asarray(buf).at[safe].add(
        jnp.where(jnp.asarray(mask)[:, None], payloads[:, :pay], 0.0),
        mode="drop")
    got = tcore._topic_append(_t(buf), _t(mask), _t(pos0), _t(payloads), pay)
    _eq(got, want)


def test_count_scatter_plan_is_a_function_of_shapes():
    """The wrapper picks its plan from (L, R) alone, with the kernel's own
    constants, and the card-only tests take both plans on both sides of
    the threshold."""
    import re
    import sys
    from pathlib import Path

    from testground_tpu_torch.kernels import build
    from testground_tpu_torch.kernels import count_scatter as kcs

    src = (build.CSRC / "count_scatter.cu").read_text()
    assert int(re.search(r"kSmallMax = (\d+);", src)[1]) == kcs.SMALL_MAX
    assert int(re.search(r"kShort = (\d+);", src)[1]) == kcs.SHORT
    for rows in (1, 10_000, 640_000, 1_000_003):
        assert kcs.plan(kcs.SMALL_MAX, rows) == "small"
        assert kcs.plan(kcs.SMALL_MAX + 1, rows) == "large"
        assert kcs.scratch_ints(kcs.SMALL_MAX, rows) == 0
        assert kcs.scratch_ints(kcs.SMALL_MAX + 1, rows) > 2 * rows
    assert kcs.plan(10_000, 10_000) == kcs.plan(10_000, 640_000) == "small"
    assert kcs.plan(1_000_003, 1_000_003) == "large"
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import test_torch_cuda as tc

    lanes = {c[2] for c in tc.SCATTER_TEST_CASES}
    assert {kcs.SMALL_MAX, kcs.SMALL_MAX + 1} <= lanes
    assert {kcs.plan(c[2], c[1]) for c in tc.SCATTER_TEST_CASES} == {
        "small", "large"}
