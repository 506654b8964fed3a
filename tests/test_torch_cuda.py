"""Card-only checks of the port (marked ``cuda``; they skip without a
GPU): the deliver-front, ring-merge and count-scatter CUDA kernels
against their plain torch versions on the same tensors, the whole front
dispatch captured in a CUDA graph against its eager call, and the dht
slice (fused front and default lowering), gossipsub and storm (unshaped
and shaped with churn) on the card against the port's CPU path (on
the card ``run`` replays a CUDA graph of the tick). This file imports no
jax, so it runs on the GPU machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from testground_tpu_torch.kernels import count_scatter as kcs  # noqa: E402
from testground_tpu_torch.sim import count_scatter as csc  # noqa: E402
from testground_tpu_torch.sim import deliver_front as df  # noqa: E402
from testground_tpu_torch.sim import ring_merge as rm  # noqa: E402
from testground_tpu_torch.sim.state_io import (  # noqa: E402
    compare_leaves,
    flatten,
    state_to_numpy,
)

pytestmark = pytest.mark.cuda


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [257, 10_000])
@pytest.mark.parametrize("name,seed,kwargs", cs.REGIMES + cs.STARVATION)
def test_kernel_matches_plain(name, seed, kwargs, n):
    dev = _cuda()
    net, spec, send, running, tick, key = cs.front_case(
        torch, np, n, seed, dev, **kwargs)
    ins = cs.lane_inputs(torch, net, spec, send, running, tick, key, n)
    launches = int(df.front_lanes.launches)
    got = df.front_lanes(*ins)
    assert int(df.front_lanes.launches) == launches + 1
    want = df.front_lanes_plain(*ins)
    torch.cuda.synchronize()
    same, err = cs.bit_equal(torch, cs.flat_outputs(got),
                             cs.flat_outputs(want))
    assert same, (name, n, err)


@pytest.mark.parametrize("name,seed,kwargs", [
    cs.REGIMES[1], cs.REGIMES[5], cs.STARVATION[0], cs.STARVATION[6]])
def test_kernel_large_plan_matches_plain(name, seed, kwargs):
    """More lanes than one a thread on a resident grid: the plan of large
    N (several tiles a block, lanes cached in shared memory, inputs read
    in pass D), at a size the card-only tests can afford."""
    from testground_tpu_torch.kernels import deliver_front as kern

    dev = _cuda()
    n = 300_007
    plan = kern.plan(n, device=dev)
    assert plan["cache"] and not plan["small"] and plan["tiles"] > 1, plan
    net, spec, send, running, tick, key = cs.front_case(
        torch, np, n, seed, dev, **kwargs)
    ins = cs.lane_inputs(torch, net, spec, send, running, tick, key, n)
    got = df.front_lanes(*ins)
    want = df.front_lanes_plain(*ins)
    torch.cuda.synchronize()
    same, err = cs.bit_equal(torch, cs.flat_outputs(got),
                             cs.flat_outputs(want))
    assert same, (name, err)


@pytest.mark.parametrize("name,seed,kwargs", [
    cs.REGIMES[1], cs.STARVATION[0], cs.STARVATION[4]])
def test_kernel_uncached_plan_matches_plain(name, seed, kwargs):
    """Blocks of 20,000 lanes: their classification no longer fits in
    shared memory, so the kernel's later passes read it again from device
    memory (the plan it takes past ~2M lanes)."""
    from testground_tpu_torch.kernels import deliver_front as kern

    dev = _cuda()
    n = 300_007
    assert not kern.plan(n, 20_000, dev)["cache"]
    net, spec, send, running, tick, key = cs.front_case(
        torch, np, n, seed, dev, **kwargs)
    ins = cs.lane_inputs(torch, net, spec, send, running, tick, key, n)
    got = kern.launch(*ins, lanes_per_block=20_000)
    want = df.front_lanes_plain(*ins)
    torch.cuda.synchronize()
    same, err = cs.bit_equal(torch, cs.flat_outputs(got),
                             cs.flat_outputs(want))
    assert same, (name, err)


@pytest.mark.parametrize("name,seed,kwargs", [
    cs.REGIMES[0], cs.STARVATION[0], cs.STARVATION[7]])
def test_front_graph_replay_matches_eager(name, seed, kwargs):
    """deliver_front.front captured in a CUDA graph (the capture fails
    on a host read) and replayed: bit-equal to the eager call."""
    dev = _cuda()
    n = 10_000
    net, spec, send, running, tick, key = cs.front_case(
        torch, np, n, seed, dev, **kwargs)

    def call():
        return df.front(net, spec, tick, key, send, running, n)

    want = call()
    g, got = cs.graph_of(torch, call)
    for buf in cs.flat_outputs(got):
        buf.zero_()
    g.replay()
    torch.cuda.synchronize()
    same, err = cs.bit_equal(torch, cs.flat_outputs(got),
                             cs.flat_outputs(want))
    assert same, (name, err)


def test_front_wrapper_refuses_bad_input():
    dev = _cuda()
    n = 300
    net, spec, send, running, tick, key = cs.front_case(
        torch, np, n, 0, dev)
    ins = list(cs.lane_inputs(torch, net, spec, send, running, tick, key, n))
    bad = dict(ins[0], pend_tick=ins[0]["pend_tick"].to(torch.int64))
    with pytest.raises(TypeError):
        df.front_lanes(bad, *ins[1:])
    bad = dict(ins[0], pend_dest=ins[0]["pend_dest"][:-1])
    with pytest.raises(ValueError):
        df.front_lanes(bad, *ins[1:])
    bad = dict(ins[0], pend_pay=ins[0]["pend_pay"].t().contiguous().t())
    with pytest.raises(ValueError):  # not contiguous
        df.front_lanes(bad, *ins[1:])
    with pytest.raises(ValueError):  # eg_loss without u_loss
        df.front_lanes(*ins[:6], None, *ins[7:])
    # a constant send field arrives expanded (stride 0): taken as it is
    send0 = list(ins[1])
    send0[1] = torch.zeros((), dtype=torch.int32, device=dev).expand(n)
    got = df.front_lanes(ins[0], tuple(send0), *ins[2:])
    want = df.front_lanes_plain(ins[0], tuple(send0), *ins[2:])
    torch.cuda.synchronize()
    assert cs.bit_equal(torch, cs.flat_outputs(got), cs.flat_outputs(want))[0]


def test_dht_gpu_matches_cpu():
    dev = _cuda()
    n = 200
    a = flatten(state_to_numpy(cs.dht_exec(n, dev).run().state))
    b = flatten(state_to_numpy(cs.dht_exec(n, "cpu").run().state))
    compare_leaves(a, b, "dht")


@pytest.mark.parametrize("label,n,case,cap,width,A", [
    (label, min(n, 20_011), case, cap, width, A)
    for label, n, case, cap, width, A in cs.MERGE_CASES
])
def test_ring_merge_kernel_matches_plain(label, n, case, cap, width, A):
    dev = _cuda()
    ring, w, k, arr = (torch.as_tensor(a, device=dev) for a in cs.merge_case(
        np, case, n, 11, cap, width, A))
    before = ring.clone()
    launches = int(rm.merge.launches)
    got = rm.merge(ring, w, k, arr)
    assert int(rm.merge.launches) == launches + 1
    want = rm.merge_plain(ring, w, k, arr)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(ring.view(torch.int32), before.view(torch.int32))


def test_ring_merge_wrapper_refuses_bad_input():
    dev = _cuda()
    ring, w, k, arr = (torch.as_tensor(a, device=dev) for a in cs.merge_case(
        np, "k_random", 64, 0))
    with pytest.raises(ValueError):
        rm.merge(ring, w, k, arr[1:])  # not [A*N, W]
    with pytest.raises(TypeError):
        rm.merge(ring, w.to(torch.int64), k, arr)
    with pytest.raises(ValueError):
        rm.merge(ring, w, k, arr.t().contiguous().t())  # not contiguous


@pytest.mark.parametrize("make", ["dht_default", "gossipsub"])
def test_default_lowering_gpu_matches_cpu(make):
    dev = _cuda()
    n = 200
    if make == "gossipsub":
        mk = cs.gossipsub_exec
    else:
        def mk(n, d):
            return cs.dht_exec(n, d, pallas_front=None)
    a = flatten(state_to_numpy(mk(n, dev).run().state))
    b = flatten(state_to_numpy(mk(n, "cpu").run().state))
    compare_leaves(a, b, make)


# chip_smoke's cases cut to 20,011 lanes (so the 1,000,003 cases take the
# large plan), both plans at the threshold and one lane above it, a row
# longer than one ordering block (the large plan's ordered scan), rows of
# every length around the one-thread limit, and small-plan grids whose
# last block owns fewer rows
SCATTER_TEST_CASES = [
    (label, min(rows, 64 * 2_003 if label == "wheel" else 20_011),
     min(lanes, 20_011), case)
    for label, rows, lanes, case in cs.SCATTER_CASES
] + [
    ("staging", 20_011, lanes, case)
    for lanes in (kcs.SMALL_MAX, kcs.SMALL_MAX + 1)
    for case in ("uniform", "seven_rows", "storm")
] + [
    ("wheel", 64 * 2_003, kcs.SMALL_MAX + 1, "storm"),
    ("staging", 20_011, 150_000, "seven_rows"),
    ("staging", 20_011, 20_011, "ladder"),
    # row counts where the small plan's last block is short, and tiny
    ("staging", 8_500, 8_500, "uniform"),
    ("staging", 100, 5_000, "seven_rows"),
]


@pytest.mark.parametrize("label,rows,lanes,case", SCATTER_TEST_CASES)
def test_count_scatter_kernel_matches_plain(label, rows, lanes, case):
    dev = _cuda()
    arrs = cs.scatter_case(np, rows, lanes, case, 7)
    buf, idx, upd = (torch.as_tensor(a, device=dev) for a in arrs)
    before = buf.clone()
    launches = int(csc.scatter_add.launches)
    got = csc.scatter_add(buf, idx, upd)
    assert int(csc.scatter_add.launches) == launches + 1
    want = csc.scatter_add_plain(*(torch.as_tensor(a) for a in arrs))
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    assert torch.equal(buf.view(torch.int32), before.view(torch.int32))


@pytest.mark.parametrize("rows,lanes", [(10_000, 10_000), (20_011, 20_011)])
def test_count_scatter_graph_replay_matches_eager(rows, lanes):
    """The wrapper reads nothing back to the host: it captures, under
    both plans."""
    dev = _cuda()
    buf, idx, upd = (torch.as_tensor(a, device=dev) for a in cs.scatter_case(
        np, rows, lanes, "uniform", 3))
    eager = csc.scatter_add(buf, idx, upd)
    g, captured = cs.graph_of(torch, lambda: csc.scatter_add(buf, idx, upd))
    captured.zero_()
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured.view(torch.int32), eager.view(torch.int32))


def test_count_scatter_wrapper_refuses_bad_input():
    dev = _cuda()
    buf, idx, upd = (torch.as_tensor(a, device=dev) for a in cs.scatter_case(
        np, 64, 64, "uniform", 0))
    with pytest.raises(TypeError):
        csc.scatter_add(buf, idx.to(torch.int64), upd)
    with pytest.raises(ValueError):
        csc.scatter_add(buf, idx, upd[1:])
    with pytest.raises(ValueError):
        csc.scatter_add(buf, idx, upd.t().contiguous().t())  # not contiguous
    with pytest.raises(TypeError):
        csc.scatter_add(buf.double(), idx, upd)


@pytest.mark.parametrize("shaped", [False, True])
def test_storm_gpu_matches_cpu(shaped):
    dev = _cuda()
    n = 100
    a = flatten(state_to_numpy(
        cs.graft_storm_exec(n, dev, shaped).run().state))
    b = flatten(state_to_numpy(
        cs.graft_storm_exec(n, "cpu", shaped).run().state))
    compare_leaves(a, b, f"storm shaped={shaped}")
