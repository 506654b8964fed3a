"""Card-only checks of the port (marked ``cuda``; they skip without a
GPU): the deliver-front, ring-merge and count-scatter CUDA kernels
against their plain torch versions on the same tensors, the whole front
dispatch captured in a CUDA graph against its eager call, and the dht
slice (fused front and default lowering), gossipsub, storm (unshaped
and shaped with churn) and the entry-mode plans with filter rules and
dials (network's rate-shaped ping-pong and DROP-filtered dial,
splitbrain reject-sampled, a class-rule dialing program behind the
egress queue), the fault and observer planes, the replay plane (the
echo workload dense and skipped, election at 5), a drained run (the
in-place cursor reset under the captured stepper, its streamed files
byte-equal), a shaped fault sweep and sweeps through the planes and
entry mode on the card against the port's CPU path (on the card ``run``
replays a CUDA graph of the tick); the count scatter's and the ring merge's vmap rules through the kernels (one
launch for S scenarios, bit-equal to S serial calls); a search's one
capture; and the runner (sim/runner.py) on the card against the CPU,
a resume that copies its checkpoint into the pooled capture, and a
[sweep] composition through the runner against the CPU, preempted
inside its second scenario chunk and resumed with no capture. This file imports no jax, so it runs on the GPU machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py
"""

import _torch_threads  # noqa: F401  (caps torch's CPU threads)
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
    ring, w, k, arr = cs.merge_case_on(torch, dev, case, n, 11, cap, width,
                                       A)
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
    ring, w, k, arr = cs.merge_case_on(torch, dev, "k_random", 64, 0)
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


@pytest.mark.parametrize("make", ["ping-pong", "traffic-blocked",
                                  "reject-sampled", "class-dials"])
def test_entry_plans_gpu_matches_cpu(make):
    """The captured tick of each program against the CPU path; ping-pong
    is rate-shaped, whose lowering once copied from the host inside the
    tick (which a capture refuses)."""
    from testground_tpu_torch import bench

    dev = _cuda()
    mk = {
        "ping-pong": lambda d: cs.plan_exec("network", "ping-pong", 2, d),
        "traffic-blocked": lambda d: cs.plan_exec("network",
                                                  "traffic-blocked", 2, d),
        "reject-sampled": lambda d: bench.splitbrain_executable(
            60, d, "reject-sampled"),
        "class-dials": lambda d: cs.queued_class_exec(60, d),
    }[make]
    launches = int(rm.merge.launches)
    a = flatten(state_to_numpy(mk(dev).run().state))
    if make == "class-dials":  # 60 lanes behind 32 slots: bounded append
        assert int(rm.merge.launches) > launches
    b = flatten(state_to_numpy(mk("cpu").run().state))
    compare_leaves(a, b, make)


@pytest.mark.parametrize("make", ["storm-planes", "faultsdemo"])
def test_fault_and_observer_planes_gpu_match_cpu(make):
    """Storm under the fault timeline, traced and sampled, and faultsdemo
    with its composition's tables: the captured tick (the rejoin, the
    overlay, the emission and sample sites) against the CPU path."""
    from testground_tpu_torch.plans import faultsdemo

    dev = _cuda()
    mk = {
        "storm-planes": lambda d: cs.planes_storm_exec(48, d),
        "faultsdemo": lambda d: faultsdemo.chaos_executable(
            24, d, chunk_ticks=32, max_ticks=2_000),
    }[make]
    a = flatten(state_to_numpy(mk(dev).run().state))
    b = flatten(state_to_numpy(mk("cpu").run().state))
    compare_leaves(a, b, make)


def test_drain_resets_in_place_under_the_captured_stepper(tmp_path):
    """A drained sparsetimer run on the card: the drain zeroes the ring
    and sample cursors inside the state the captured loop iteration
    replays into, so the card streams exactly what the CPU path streams
    (three files byte-equal, every state leaf bit-equal) with one capture
    for the whole run."""
    from testground_tpu_torch import bench
    from testground_tpu_torch.sim.drain import EVENTS_FILE, RESULTS_FILE

    dev = _cuda()
    states, stats = {}, {}
    for d in (dev, "cpu"):
        ex = bench.drain_executable(48, d, rounds=6, chunk_ticks=40)
        res, dr = bench.drained_run(ex, tmp_path / str(d))
        states[str(d)] = flatten(state_to_numpy(res.state))
        stats[str(d)] = dr.stats()
        if d is dev:
            assert ex.captures == 1
    assert stats[str(dev)] == stats["cpu"]
    assert stats["cpu"]["drain_batches"] > 5
    compare_leaves(states[str(dev)], states["cpu"], "drained sparsetimer")
    for f in (EVENTS_FILE, RESULTS_FILE, "trace.json"):
        assert (tmp_path / str(dev) / f).read_bytes() == \
            (tmp_path / "cpu" / f).read_bytes(), f


@pytest.mark.parametrize("make", ["echo-dense", "echo-skip", "election"])
def test_replay_gpu_matches_cpu(make, tmp_path):
    """The replay plane's captured tick (the head view, the cursor
    advance, the next-arrival term, the replayed churn) against the CPU
    path: the echo workload dense and skipped, and election at 5 under
    its composition."""
    from testground_tpu_torch import bench
    from testground_tpu_torch.plans import election

    dev = _cuda()
    trace = bench.write_echo_trace(tmp_path / "echo.jsonl", 48, K=6)
    mk = {
        "echo-dense": lambda d: bench.echo_executable(
            48, d, trace, K=6, event_skip=False),
        "echo-skip": lambda d: bench.echo_executable(48, d, trace, K=6),
        "election": lambda d: election.election_executable(5, d),
    }[make]
    a = flatten(state_to_numpy(mk(dev).run().state))
    b = flatten(state_to_numpy(mk("cpu").run().state))
    compare_leaves(a, b, make)


# ------------------------------------------------------- sweep and search


@pytest.mark.parametrize("S,R,L", [(4, 1_000, 1_000), (64, 10_000, 10_000),
                                   (3, 100, 20_011)])
def test_count_scatter_vmap_rule_through_the_kernel(S, R, L):
    """The vmap rule folds S scenarios into ONE kernel launch (the small
    plan at 4 x 1,000, the large plan past it), bit-equal to S serial
    kernel calls and to the plain version, dropped lanes included."""
    dev = _cuda()
    rng = np.random.default_rng(S)
    buf = torch.as_tensor((rng.standard_normal((S, R, 2)) * 1e3)
                          .astype(np.float32), device=dev)
    idx = torch.as_tensor(np.where(
        rng.random((S, L)) < 0.3, R + rng.integers(0, 3, (S, L)),
        rng.integers(0, R, (S, L))).astype(np.int32), device=dev)
    upd = torch.as_tensor((rng.standard_normal((S, L, 2)) * 1e3)
                          .astype(np.float32), device=dev)
    launches = int(csc.scatter_add.launches)
    got = torch.func.vmap(csc.scatter_add)(buf, idx, upd)
    assert int(csc.scatter_add.launches) == launches + 1
    serial = torch.stack([csc.scatter_add(buf[s], idx[s], upd[s])
                          for s in range(S)])
    plain = torch.stack([csc.scatter_add_plain(buf[s].cpu(), idx[s].cpu(),
                                               upd[s].cpu())
                         for s in range(S)])
    for other in (serial.cpu(), plain):
        assert torch.equal(got.cpu().view(torch.int32),
                           other.view(torch.int32))


def test_ring_merge_vmap_rule_through_the_kernel():
    dev = _cuda()
    rng = np.random.default_rng(5)
    S, N, cap, W, A = 4, 1_000, 32, 7, 8
    ring = torch.as_tensor(rng.standard_normal((S, N, cap, W))
                           .astype(np.float32), device=dev)
    w = torch.as_tensor(rng.integers(0, 1 << 20, (S, N)).astype(np.int32),
                        device=dev)
    k = torch.as_tensor(rng.integers(0, A + 1, (S, N)).astype(np.int32),
                        device=dev)
    arr = torch.as_tensor(rng.standard_normal((S, A * N, W))
                          .astype(np.float32), device=dev)
    launches = int(rm.merge.launches)
    got = torch.func.vmap(rm.merge)(ring, w, k, arr)
    assert int(rm.merge.launches) == launches + 1
    serial = torch.stack([rm.merge(ring[s], w[s], k[s], arr[s])
                          for s in range(S)])
    assert torch.equal(got.cpu().view(torch.int32),
                       serial.cpu().view(torch.int32))


def test_sweep_gpu_matches_cpu():
    """The shaped storm sweep under the fault timeline (chip_smoke [35])
    at 32 x 2 seeds: every scenario's every leaf, the card's one capture
    against the CPU."""
    dev = _cuda()
    states = {}
    for d in (dev, "cpu"):
        ex = cs.shaped_fault_sweep(32, d, seeds=2)
        res = ex.run()
        assert ex.captures == (1 if d == dev else 0)
        states[str(d)] = [flatten(state_to_numpy(res.scenario(s).state))
                          for s in range(2)]
    for s in range(2):
        compare_leaves(states[str(dev)][s], states["cpu"][s], f"sweep {s}")


def _plane_sweep(make, d, tmp_path):
    """A small sweep through one plane, on device ``d``: faultsdemo's
    chaos case over a ``$chaos_loss`` grid under its composition's
    tables, traced and sampled (dense or skipped); the echo over a replay
    ``$scale`` grid; dht's find-providers on the default lowering (entry
    mode: the ring merge's vmap rule behind the egress queue)."""
    from testground_tpu_torch import bench
    from testground_tpu_torch.plans import dht, faultsdemo
    from testground_tpu_torch.sim import GroupSpec, SimConfig
    from testground_tpu_torch.sim.sweep import compile_sweep
    from testground_tpu_torch.sim.tables import Replay

    if make.startswith("faultsdemo"):
        c = faultsdemo.COMPOSITION
        groups = [GroupSpec(g, i, 12, dict(c["test_params"]))
                  for i, g in enumerate(c["groups"])]
        scen = [{"seed": s, "params": {"chaos_loss": str(v)}}
                for v in (10, 90) for s in (0, 7)]
        cfg = SimConfig(chunk_ticks=32, max_ticks=2_000,
                        event_skip=make == "faultsdemo-skip")
        return compile_sweep(faultsdemo.chaos, groups, cfg, scen,
                             test_case="chaos", test_run="faultsdemo",
                             faults=c["faults"], trace=c["trace"],
                             telemetry=c["telemetry"], device=d)
    if make == "echo-scale":
        trace = bench.write_echo_trace(tmp_path / "echo.jsonl", 48, K=6)
        scen = [{"seed": s, "params": {"load": str(v)}}
                for v in (1, 2) for s in (0, 3)]
        cfg = SimConfig(quantum_ms=1.0, chunk_ticks=32, max_ticks=2_000,
                        metrics_capacity=8)
        return compile_sweep(bench.echo_replayed,
                             [GroupSpec("single", 0, 48, {})], cfg, scen,
                             test_case="echo", test_run="bench-replay",
                             replay=Replay(trace=trace, scale="$load",
                                           capacity=16), device=d)
    # 160 lanes behind dht's 128 send slots: the bounded append
    groups = [GroupSpec("single", 0, 160,
                        {k: str(v) for k, v in cs.DHT_PARAMS.items()})]
    cfg = SimConfig(quantum_ms=10.0, max_ticks=60_000, chunk_ticks=32,
                    metrics_capacity=8, churn_fraction=0.05,
                    churn_start_ms=100.0, churn_end_ms=5_000.0)
    return compile_sweep(dht.find_providers, groups, cfg,
                         [{"seed": s, "params": {}} for s in (0, 5)],
                         test_case="find-providers", test_run="t", device=d)


@pytest.mark.parametrize("make", ["faultsdemo-dense", "faultsdemo-skip",
                                  "echo-scale", "dht-entry"])
def test_plane_sweeps_gpu_match_cpu(make, tmp_path):
    """The sweeps through the fault, trace, telemetry and replay planes
    and through entry mode, captured once on the card with vmap's loop
    fallback off (torch on the card may lack a batching rule that the
    CPU's torch has: the capture then raises): every scenario's every
    leaf against the CPU."""
    dev = _cuda()
    states = {}
    for d in (dev, "cpu"):
        ex = _plane_sweep(make, d, tmp_path)
        merges = int(rm.merge.launches)
        res = ex.run()
        assert ex.captures == (1 if d == dev else 0)
        if make == "dht-entry" and d == dev:
            assert int(rm.merge.launches) > merges
        states[str(d)] = [flatten(state_to_numpy(res.scenario(s).state))
                          for s in range(ex.n_scenarios)]
    for s, a in enumerate(states[str(dev)]):
        compare_leaves(a, states["cpu"][s], f"{make} {s}")


def test_search_captures_once_on_the_card():
    from testground_tpu_torch.bench import search_leg

    _cuda()
    line = search_leg(n=64, device="cuda", grid_n=64)
    assert line["captures"] == 1 and line["batched_tick_builds"] == 1
    assert line["breaking_point"] == 0.671875


@pytest.mark.parametrize("make", ["storm", "faultsdemo-drained"])
def test_runner_gpu_matches_cpu(make, tmp_path, monkeypatch):
    """The runner (sim/runner.py) on the card against the CPU: storm with
    the compressed params at 48, and faultsdemo at 24 under its
    composition's tables, drained; every deterministic summary key,
    run.out, output file and progress row equal, one capture on the
    card."""
    import tomllib

    from testground_tpu_torch import graft
    from testground_tpu_torch.runner.outputs import assert_runs_equal
    from testground_tpu_torch.sim import runner
    from testground_tpu_torch.sim.tables import Faults, Telemetry, Trace

    dev = _cuda()
    monkeypatch.setenv("TG_DISPATCH_HEARTBEAT_S", "86400")
    with open(REPO / "plans" / "faultsdemo" / "composition.toml", "rb") as f:
        comp = tomllib.load(f)

    def rinput(side):
        if make == "storm":
            return cs.runner_input(
                "benchmarks", "storm", 48, graft.STORM_PARAMS,
                tmp_path / side, "r", cs.STORM_RUN_CONFIG)
        return cs.runner_input(
            "faultsdemo", "chaos", 24,
            dict(comp["global"]["run"]["test_params"], min_pings="0"),
            tmp_path / side, "r", {"max_ticks": 2_000, "chunk_ticks": 40},
            groups=("left", "right"),
            faults=Faults.from_dict(comp["faults"]),
            trace=Trace.from_dict(dict(comp["trace"], drain=True)),
            telemetry=Telemetry.from_dict(dict(comp["telemetry"],
                                               drain=True)))

    for d, side in ((dev, "gpu"), ("cpu", "cpu")):
        runner.clear_executor_pool()
        runner.run_composition(rinput(side), device=d)
        if side == "gpu":
            (ex, _), = runner._EX_CACHE.values()
            assert ex.captures == 1
    s = assert_runs_equal(tmp_path / "gpu", tmp_path / "cpu")
    assert s["outcome"] == "success"
    runner.clear_executor_pool()


def test_runner_resume_copies_into_the_capture(tmp_path, monkeypatch):
    """A run preempted at its second boundary on the card and resumed in
    the same process: the resumed leg reuses the pooled capture (the
    checkpoint is copied into the captured tensors, no capture) and ends
    with the uninterrupted run's results."""
    from testground_tpu_torch import graft
    from testground_tpu_torch.runner.outputs import output_files, summary
    from testground_tpu_torch.sim import runner

    dev = _cuda()
    monkeypatch.setattr(cs, "RESUME_CHUNK", 64)

    def rinput(name, run_id, resume=False):
        return cs.runner_input(
            "benchmarks", "storm", 48, graft.STORM_PARAMS, tmp_path / name,
            run_id, dict(cs.STORM_RUN_CONFIG, chunk_ticks=64),
            checkpoint={"interval": 0.0}, resume=resume)

    runner.clear_executor_pool()
    runner.run_composition(rinput("full", "full"), device=dev)
    with cs.preempt_at(2):
        out = runner.run_composition(rinput("cut", "cut"), device=dev)
    assert out.result.outcome == "preempted"
    caps = cs.pooled_captures()
    out = runner.run_composition(rinput("cut", "cut", resume=True),
                                 device=dev)
    assert out.result.outcome == "success"
    assert cs.pooled_captures() == caps
    assert summary(tmp_path / "cut")["resumed_from_tick"] == 128
    assert output_files(tmp_path / "cut") == output_files(tmp_path / "full")
    runner.clear_executor_pool()


def test_sweep_runner_gpu_matches_cpu_and_resumes(tmp_path, monkeypatch):
    """A [sweep] composition through the runner on the card against the
    CPU: storm (compressed params) at 48 over 4 seeds in scenario chunks
    of 2, every file, row and deterministic key equal, one capture; then
    on the card, preempted at the first boundary of chunk 1 and resumed
    in the same process: no capture, and every scenario's files and row
    equal to the uninterrupted run's."""
    import math

    from testground_tpu_torch import graft
    from testground_tpu_torch.runner.outputs import (
        assert_runs_equal, output_files, summary)
    from testground_tpu_torch.sim import runner
    from testground_tpu_torch.sim.tables import Sweep

    dev = _cuda()
    monkeypatch.setenv("TG_DISPATCH_HEARTBEAT_S", "86400")

    def rinput(name, run_id="r", **kw):
        return cs.runner_input(
            "benchmarks", "storm", 48, graft.STORM_PARAMS, tmp_path / name,
            run_id, dict(cs.STORM_RUN_CONFIG, chunk_ticks=32),
            sweep=Sweep(seeds=4, chunk=2), **kw)

    for d, side in ((dev, "gpu"), ("cpu", "cpu")):
        runner.clear_executor_pool()
        runner.run_composition(rinput(side), device=d)
        if side == "gpu":
            assert cs.pooled(runner).captures == 1
    s = assert_runs_equal(tmp_path / "gpu", tmp_path / "cpu")
    assert s["outcome"] == "success" and s["scenario_chunk"] == 2
    rows = cs.scenario_rows(tmp_path / "gpu")
    assert rows == cs.scenario_rows(tmp_path / "cpu")
    # chunk 0's boundaries, then the first of chunk 1
    stop = math.ceil(max(r["ticks_executed"] for r in rows[:2]) / 32) + 1
    runner.clear_executor_pool()
    ck = {"checkpoint": {"interval": 0.0}}
    with cs.preempt_at(stop):
        out = runner.run_composition(rinput("cut", "cut", **ck), device=dev)
    assert out.result.outcome == "preempted"
    caps = cs.pooled_captures()
    out = runner.run_composition(rinput("cut", "cut", resume=True, **ck),
                                 device=dev)
    assert out.result.outcome == "success"
    assert cs.pooled_captures() == caps
    assert summary(tmp_path / "cut")["resumed_from_chunk"] == 1
    assert cs.scenario_rows(tmp_path / "cut") == rows
    assert output_files(tmp_path / "cut") == output_files(tmp_path / "gpu")
    runner.clear_executor_pool()
