"""The port's deliver front (testground_tpu_torch/sim/deliver_front.py)
against the JAX package's fused Pallas front (sim/pallas_front.py, its
kernel run in interpret mode on the CPU): the seven randomized regimes
and the starvation state of tests/test_pallas_front.py, the eligibility
gate over a grid of NetSpecs. Exact equality on every output, floats
by their bits. (The CUDA kernel against its plain version is
tests/test_torch_cuda.py, on a card.)"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from testground_tpu.sim import pallas_front as pf
from testground_tpu.sim.net import NetSpec as JNetSpec
from testground_tpu.sim.net import init_net_state as j_init_net_state
from testground_tpu_torch.sim import deliver_front as df
from testground_tpu_torch.sim import prng
from testground_tpu_torch.sim.net import NetSpec as TNetSpec
from testground_tpu_torch.sim.net import init_net_state as t_init_net_state


def _spec_kw(n, loss=True, lat=True):
    return dict(
        inbox_capacity=8, payload_len=2, head_k=1, send_slots=max(4, n // 8),
        uses_latency=lat, uses_jitter=False, uses_rate=False, uses_loss=loss,
    )


def _rand_arrays(rng, n, P, pending_p=0.3, send_p=0.5, dead_p=0.1,
                 wait_span=5, weird_pay=False, loss=True, lat=True,
                 tick=100):
    """numpy front state: the generator of tests/test_pallas_front.py."""
    a = {}
    a["pend_dest"] = np.where(
        rng.random(n) < pending_p, rng.integers(0, n, n), -1
    ).astype(np.int32)
    a["pend_tick"] = (tick - rng.integers(0, wait_span, n)).astype(np.int32)
    a["pend_tag"] = np.zeros(n, np.int32)
    a["pend_port"] = rng.integers(0, 5, n).astype(np.int32)
    a["pend_size"] = rng.random(n).astype(np.float32) * 64
    a["pend_pay"] = rng.random((n, P)).astype(np.float32)
    if lat:
        a["eg_latency"] = (rng.random(n) * 5).astype(np.float32)
    if loss:
        a["eg_loss"] = (rng.random(n) * 0.3).astype(np.float32)
    a["net_enabled"] = (rng.random(n) > 0.05).astype(np.int32)
    send_dest = np.where(
        rng.random(n) < send_p, rng.integers(0, n, n), -1
    ).astype(np.int32)
    spay = rng.random((n, P)).astype(np.float32)
    if weird_pay:
        spay[rng.random((n, P)) < 0.1] = np.nan
        spay[rng.random((n, P)) < 0.1] = np.inf
        spay[rng.random((n, P)) < 0.1] = 1e-40  # denormal
    send = (
        send_dest,
        np.zeros(n, np.int32),
        rng.integers(0, 5, n).astype(np.int32),
        (rng.random(n) * 64).astype(np.float32),
        spay,
    )
    running = rng.random(n) > dead_p
    return a, send, running


def _both(seed, n, loss=True, lat=True, tick=100, **kw):
    rng = np.random.default_rng(seed)
    jspec = JNetSpec(**_spec_kw(n, loss, lat))
    tspec = TNetSpec(**_spec_kw(n, loss, lat), pallas_front=True)
    arrs, send, running = _rand_arrays(rng, n, 2, loss=loss, lat=lat,
                                       tick=tick, **kw)
    jnet = dict(j_init_net_state(n, jspec))
    tnet = t_init_net_state(n, tspec, "cpu")
    for k, v in arrs.items():
        jnet[k] = jnp.asarray(v)
        tnet[k] = torch.from_numpy(v.copy())
    return (jspec, jnet, tuple(map(jnp.asarray, send)), jnp.asarray(running),
            tspec, tnet, tuple(torch.from_numpy(s.copy()) for s in send),
            torch.from_numpy(running))


def _assert_same(got, want):
    """got: the port's (pend dict, rec, dest_app, counters); want: JAX's."""
    gp, *grest = got
    wp, *wrest = want
    assert set(gp) == set(wp)
    pairs = [(gp[k], wp[k], k) for k in sorted(gp)] + [
        (g, w, name) for g, w, name in
        zip(grest, wrest, ("rec", "dest_app", "counters"))
    ]
    for g, w, name in pairs:
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if g.dtype.kind == "f":
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w, err_msg=name)


REGIMES = [
    (0, 1024, {}),                                 # mixed regime
    (1, 1024, {"send_p": 1.0, "pending_p": 0.8}),  # oversubscribed
    (2, 1024, {"send_p": 0.0}),                    # nothing fresh
    (3, 500, {"dead_p": 0.5}),                     # heavy abandonment
    (4, 1024, {"weird_pay": True}),                # sanitize counters
    (5, 1024, {"wait_span": 300}),                 # 2-level buckets
    (6, 256, {"loss": False, "lat": False}),       # featureless
]


@pytest.mark.parametrize("seed,n,kwargs", REGIMES)
def test_front_matches_jax(seed, n, kwargs):
    jspec, jnet, jsend, jrun, tspec, tnet, tsend, trun = _both(
        seed, n, **kwargs)
    assert pf.eligible(jspec, n) and df.eligible(tspec, n)
    want = jax.jit(
        lambda net, send, running: pf.front(
            net, jspec, jnp.int32(100), jax.random.PRNGKey(seed), send,
            running, n)
    )(jnet, jsend, jrun)
    before = df.front.kernel_ticks
    got = df.front(tnet, tspec, torch.tensor(100, dtype=torch.int32),
                   prng.PRNGKey(seed), tsend, trun, n)
    assert df.front.kernel_ticks == before + 1  # the kernel branch
    _assert_same(got, want)


@pytest.mark.parametrize("seed,n,kwargs", REGIMES[:3])
def test_reference_matches_jax_reference(seed, n, kwargs):
    """front_reference (the starvation branch) on the non-starved states,
    against the JAX package's _front_reference."""
    jspec, jnet, jsend, jrun, tspec, tnet, tsend, trun = _both(
        seed, n, **kwargs)
    key = jax.random.PRNGKey(seed)
    u = jax.random.uniform(key, (n,))
    pd0 = jnp.where((jnet["pend_dest"] >= 0) & ~jrun, -1, jnet["pend_dest"])
    eff = jnp.where(pd0 >= 0, pd0, jsend[0])
    ok = ((jnet["net_enabled"] > 0) & jrun).astype(jnp.int32)
    enab = (jnet["net_enabled"] > 0) & (ok[jnp.clip(eff, 0, n - 1)] > 0)
    jpend = {k: jnet[k] for k in df._PEND_KEYS}
    want = pf._front_reference(
        jspec, jnp.int32(100), u, jsend, jrun, jpend, jnet["eg_latency"],
        jnet["eg_loss"], enab)
    tpend = {k: tnet[k] for k in df._PEND_KEYS}
    got = df.front_reference(
        tspec, torch.tensor(100, dtype=torch.int32),
        torch.from_numpy(np.asarray(u).copy()), tsend, trun, tpend,
        tnet["eg_latency"], tnet["eg_loss"],
        torch.from_numpy(np.asarray(enab).copy()))
    _assert_same(got, want)


def test_front_starvation_takes_reference():
    n, seed = 512, 7
    jspec, jnet, jsend, jrun, tspec, tnet, tsend, trun = _both(seed, n)
    rng = np.random.default_rng(seed)
    pend_tick = (5000 - rng.integers(0, 4600, n)).astype(np.int32)
    jnet["pend_tick"] = jnp.asarray(pend_tick)
    tnet["pend_tick"] = torch.from_numpy(pend_tick.copy())
    want = pf.front(jnet, jspec, jnp.int32(5000), jax.random.PRNGKey(seed),
                    jsend, jrun, n)
    before = df.front.reference_ticks
    got = df.front(tnet, tspec, torch.tensor(5000, dtype=torch.int32),
                   prng.PRNGKey(seed), tsend, trun, n)
    assert df.front.reference_ticks == before + 1
    _assert_same(got, want)


_GRID_FLAGS = ("store_entries", "uses_dials", "use_pair_rules", "uses_rate",
               "uses_jitter", "uses_reorder", "uses_loss_corr")


@pytest.mark.parametrize("n", [64, 129, 300, 2**24])
def test_eligible_matches_jax(n):
    """The gate agrees with the JAX package's over a grid of NetSpecs
    (including dht's send_slots = max(128, n // 8), ineligible at n <=
    128, and the n < 2**24 limit)."""
    for send_slots in (None, 4, max(128, n // 8), n):
        for payload_len in (2, 8, 9):
            for flags in itertools.product((False, True),
                                           repeat=len(_GRID_FLAGS)):
                kw = dict(zip(_GRID_FLAGS, flags), send_slots=send_slots,
                          payload_len=payload_len)
                assert df.eligible(TNetSpec(**kw), n) == pf.eligible(
                    JNetSpec(**kw), n), (n, kw)
