"""The port's deliver front (testground_tpu_torch/sim/deliver_front.py)
against the JAX package's fused Pallas front (sim/pallas_front.py, its
kernel run in interpret mode on the CPU, its branch chosen by
``lax.cond`` under ``jax.jit``): the seven randomized regimes and the
starvation state of tests/test_pallas_front.py, the starvation and
branch-edge states of chip_smoke.STARVATION, the plain version against
``front_reference``, the eligibility gate over a grid of NetSpecs.
Exact equality on every output, floats by their bits. (The CUDA kernel
against its plain version is tests/test_torch_cuda.py, on a card.)"""

import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import itertools
import sys
from pathlib import Path

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

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402


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
    got = df.front(tnet, tspec, torch.tensor(100, dtype=torch.int32),
                   prng.PRNGKey(seed), tsend, trun, n)
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
    """Waits past 4095 ticks: the JAX front takes its reference branch
    (``lax.cond`` under ``jax.jit``); the port's front, which decides
    the branch on the device, equals it."""
    n, seed = 512, 7
    jspec, jnet, jsend, jrun, tspec, tnet, tsend, trun = _both(seed, n)
    rng = np.random.default_rng(seed)
    pend_tick = (5000 - rng.integers(0, 4600, n)).astype(np.int32)
    jnet["pend_tick"] = jnp.asarray(pend_tick)
    tnet["pend_tick"] = torch.from_numpy(pend_tick.copy())
    want = jax.jit(
        lambda net, send, running: pf.front(
            net, jspec, jnp.int32(5000), jax.random.PRNGKey(seed), send,
            running, n)
    )(jnet, jsend, jrun)
    got = df.front(tnet, tspec, torch.tensor(5000, dtype=torch.int32),
                   prng.PRNGKey(seed), tsend, trun, n)
    _assert_same(got, want)


def _case(n, seed, kw):
    """A chip_smoke front state as both packages' inputs."""
    arrs, send, running, tick, slots = cs.front_arrays(np, n, seed, **kw)
    skw = cs.front_spec_kw(n, slots, kw.get("loss", True), kw.get("lat", True))
    jspec, tspec = JNetSpec(**skw), TNetSpec(**skw, pallas_front=True)
    jnet = dict(j_init_net_state(n, jspec))
    tnet = t_init_net_state(n, tspec, "cpu")
    for k, v in arrs.items():
        jnet[k] = jnp.asarray(v)
        tnet[k] = torch.from_numpy(v.copy())
    return (jspec, jnet, tuple(map(jnp.asarray, send)), jnp.asarray(running),
            tspec, tnet, tuple(torch.from_numpy(s.copy()) for s in send),
            torch.from_numpy(running.copy()), tick)


@pytest.mark.parametrize("name,seed,kwargs", cs.STARVATION)
def test_front_starvation_matches_jax(name, seed, kwargs):
    n = 512
    jspec, jnet, jsend, jrun, tspec, tnet, tsend, trun, tick = _case(
        n, seed, kwargs)
    assert pf.eligible(jspec, n) and df.eligible(tspec, n)
    want = jax.jit(
        lambda net, send, running: pf.front(
            net, jspec, jnp.int32(tick), jax.random.PRNGKey(seed), send,
            running, n)
    )(jnet, jsend, jrun)
    got = df.front(tnet, tspec, torch.tensor(tick, dtype=torch.int32),
                   prng.PRNGKey(seed), tsend, trun, n)
    _assert_same(got, want)


@pytest.mark.parametrize("name,seed,kwargs", cs.STARVATION)
def test_reference_matches_jax_reference_starved(name, seed, kwargs):
    """front_reference against the JAX package's _front_reference on the
    starvation and branch-edge states."""
    n = 512
    jspec, jnet, jsend, jrun, tspec, tnet, tsend, trun, tick = _case(
        n, seed, kwargs)
    key = jax.random.PRNGKey(seed)
    u = jax.random.uniform(key, (n,))
    pd0 = jnp.where((jnet["pend_dest"] >= 0) & ~jrun, -1, jnet["pend_dest"])
    eff = jnp.where(pd0 >= 0, pd0, jsend[0])
    ok = ((jnet["net_enabled"] > 0) & jrun).astype(jnp.int32)
    enab = (jnet["net_enabled"] > 0) & (ok[jnp.clip(eff, 0, n - 1)] > 0)
    jpend = {k: jnet[k] for k in df._PEND_KEYS}
    want = jax.jit(
        lambda pend, send, running, u, enab: pf._front_reference(
            jspec, jnp.int32(tick), u, send, running, pend,
            jnet["eg_latency"], jnet["eg_loss"], enab)
    )(jpend, jsend, jrun, u, enab)
    tpend = {k: tnet[k] for k in df._PEND_KEYS}
    t_enab = df.viability(tpend["pend_dest"], tsend[0], trun,
                          tnet["net_enabled"])
    np.testing.assert_array_equal(t_enab.numpy(), np.asarray(enab))
    got = df.front_reference(
        tspec, torch.tensor(tick, dtype=torch.int32),
        torch.from_numpy(np.asarray(u).copy()), tsend, trun, tpend,
        tnet["eg_latency"], tnet["eg_loss"], t_enab)
    _assert_same(got, want)


@pytest.mark.parametrize("name,seed,kwargs", cs.REGIMES + cs.STARVATION)
def test_plain_matches_reference(name, seed, kwargs):
    """front_lanes_plain (the kernel's plain version: the counting and
    sort admitters, chosen on the device) plus the record build, against
    front_reference (one stable sort, the egress queue of the default
    front)."""
    n = 700
    net, spec, send, running, tick, key = cs.front_case(
        torch, np, n, seed, "cpu", **kwargs)
    ins = cs.lane_inputs(torch, net, spec, send, running, tick, key, n)
    got = df.front(net, spec, tick, key, send, running, n)
    want = cs.reference_of(torch, net, spec, ins)
    same, _ = cs.bit_equal(torch, cs.flat_outputs(got),
                           cs.flat_outputs(want))
    assert same, name


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
