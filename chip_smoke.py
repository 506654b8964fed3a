#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``testground_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order (any failure raises and the exit code is not 0):

1. device report: the card's name, and its name and power limit as
   ``nvidia-smi`` gives them;
2. build: the three kernels from ``testground_tpu_torch/csrc``, the
   deliver-front kernel's -DFRONT_TRACE build and the count scatter's
   -DSCATTER_TRACE build, one nvcc per source, started together, with
   their build seconds;
3. deliver-front kernel vs plain on the card, bit-equal, and the whole
   dispatch bit-equal to ``front_reference``: the seven randomized
   front regimes of the deliver-front tests and the nine ``STARVATION``
   states (waits at and past 4,095 ticks, ages past the tick and near
   -2**31) at N = 10,000 and N = 1,000,003; the kernel's, the plain
   version's and the bound's times in each; then the whole front
   dispatch captured in a CUDA graph, replayed bit-equal to its eager
   call, and timed; 3a. the kernel's phases, from its -DFRONT_TRACE
   build;
3b. ring-merge kernel vs plain on the card, bit-equal: dht shapes at
   N = 10,000, gossipsub@1M's shape (N = 1,048,576, CAP 64, W 6), the
   microbenchmark's shapes at N = 100,000, 1,000,000 and 1,000,003,
   k_eff of 0 / random / A, k_eff = CAP on a full ring, w near 2**30 and
   A > CAP; kernel, plain, ``ring.clone()`` and bound times;
3c. the ported ring-merge microbenchmark
   (``testground_tpu_torch/tools/microbench_append.py``) at N = 100,000
   and 1,000,000: merge alone and staging + merge + read, plain vs
   kernel, and its exactness check;
4. dht find-providers at n = 10,000 (20 ms links, 5% loss, 5% churn over
   100-5,000 ms, 500 ms query timeout, 3 retries) through the fused
   deliver front (``pallas_front=True``), to termination, with zero
   egress overflow, zero net and metric drops; the deliver-front kernel
   and the ring-merge kernel launched once on every loop iteration;
4b. a torch.profiler window over the phase-4 tick;
5. the GPU path against the CPU path: dht at n = 300 through the fused
   front on both, every state leaf bit-equal;
6. gossipsub mesh-propagation at n = 4,096 on the default lowering
   (degree 8, 50 ms links, 0% loss, event skip): full coverage, zero
   overflow and drops; ticks, ticks executed, wall and p50/p99
   propagation; 6b. a profiler window over its tick;
7. dht find-providers at n = 10,000 on the default lowering (default
   deliver front, event skip): phase 4's assertions, the ring-merge
   kernel on every executed tick, the deliver-front kernel on none, and
   the final state equal to phase 4's but for ``ticks_executed``;
   7b. a profiler window over its tick;
8. gossipsub and dht at n = 300 on the default lowering, GPU path vs
   CPU path, every state leaf bit-equal;
9. gossipsub at n = 1,048,576 on the default lowering (the bounded
   append behind the egress queue, ``send_slots = n // 4``): phase 6's
   assertions, ticks, wall and ring-merge launches; 9b. a profiler
   window over its tick;
10. count-scatter kernel vs plain (on a CPU copy), bit-equal: storm's
   staging shape N = 10,000 (uniform, every lane to one of 7 rows, all
   dropped; ~30% of lanes dropped; a storm tick, ~4.7% kept),
   N = 1,000,003 (uniform, 7 rows) and the wheel shape 64 x 10,000
   (uniform, a storm tick, one bucket); the whole function under the
   plan it picks, the plain version, ``index_add_`` and the bound; where
   the time goes (small plan: the trace build's per-block phases; large
   plan at 1M uniform: time by kernel under ``torch.profiler``);
11. storm at n = 10,000 with bench.py's params and SimConfig, to
   termination (``testground_tpu_torch.bench``'s assertions: all ok,
   zero drops, clamps and metric drops, bytes read = bytes sent), the
   count-scatter kernel on every loop iteration; 11b. a profiler window
   over its tick;
12. storm at n = 10,000 shaped with churn (TG_BENCH_SHAPED's 50 ms
   links, 5% loss, SYN retries, churn-tolerant rendezvous, 2% churn):
   exactly the scheduled victims crashed, every survivor ok, zero drops
   and clamps; 12b. a profiler window over its tick;
13. storm at n = 300 with ``__graft_entry__``'s compressed params,
   unshaped and shaped with churn: GPU path vs CPU path, every state
   leaf bit-equal;
14. barrier at n = 10,000 x 50 iterations (tools/bench_barrier.py's
   SimConfig): every instance ok, zero metric drops; wall, ticks, ticks
   executed, ms/tick and barriers/s; 14b. a profiler window over its
   tick;
15. subtree at n = 10,000 x 2,000 iterations (tools/bench_subtree.py's
   full configuration: 7 stream topics of [2,000, size/4]): every
   instance ok, zero stream violations, zero in-loop verification
   faults, every topic row r equal to [r] * pay on the host; the same
   figures as 14; 15b. a profiler window over a pump tick, the device
   time of the loop's two whole-state passes (the guard's select and the
   stepper's copy) on subtree's state, and that of the publish_payload
   select chain, rebuilt from the ops the tick runs for it;
16. sparsetimer at n = 10,000 with TG_BENCH_SKIP's configuration, dense
   and then event-skipped: both all ok, the skipped state equal to the
   dense one but for the skip's own leaves; both walls, ticks executed
   against simulated, and the count-scatter launches of each run;
17. startup, netinit, netlinkshape and cliff at n = 10,000: all ok, and
   cliff with x above x_fail all failed;
18. barrier (3 iterations) and subtree (20 iterations) at n = 300, and
   sparsetimer at n = 300 dense and skipped (10 rounds): GPU path vs
   CPU path, every state leaf bit-equal.

The last lines are the card's nvidia-smi line, one JSON object with the
kernel measurements, and ``{"ok": true, "device": {...}}``. Everything
measured also goes to ``chiprun_out/chip_smoke.json``. Without CUDA, or
without the ``testground_tpu_torch`` package beside it, the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)

DHT_PARAMS = {
    "link_latency_ms": 20, "link_loss_pct": 5,
    "query_timeout_ms": 500, "max_retries": 3,
}
KERNELS = ("deliver_front", "ring_merge", "count_scatter")
# (source, -D defines): built beside the kernels, for phase 3a only — the
# deliver-front kernel with its phase timestamps
TRACE_BUILD = ("deliver_front", ("FRONT_TRACE",))
# the count scatter with block 0's phase timestamps (small plan), for
# phase 10's breakdown
SCATTER_TRACE_BUILD = ("count_scatter", ("SCATTER_TRACE",))
SCATTER_PHASES = ("copy_compact", "sort", "gather", "fold")
BUILDS = [(k, ()) for k in KERNELS] + [TRACE_BUILD, SCATTER_TRACE_BUILD]
# gossipsub's large leg: BASELINE.md's 1M row (send_slots = n // 4)
GOSSIP_BIG_N = 1_048_576
GOSSIPSUB_PARAMS = {"degree": 8, "link_latency_ms": 50, "link_loss_pct": 0}
# (name, seed, kwargs) — the regimes of the deliver-front tests
REGIMES = [
    ("mixed", 0, {}),
    ("oversubscribed", 1, {"send_p": 1.0, "pending_p": 0.8}),
    ("nothing_fresh", 2, {"send_p": 0.0}),
    ("heavy_abandonment", 3, {"dead_p": 0.5}),
    ("weird_payloads", 4, {"weird_pay": True}),
    ("two_level_buckets", 5, {"wait_span": 300}),
    ("featureless", 6, {"loss": False, "lat": False}),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


# ------------------------------------------------------------ front inputs

INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1
# (name, seed, kwargs) — front states past the counting admitter's reach
# (max wait >= 4095, where the JAX package sorts by age) and at its
# edges; every one is bit-equal to the JAX package on the CPU
# (tests/test_torch_front.py) and kernel vs plain on the card
STARVATION = [
    # waits 3,000-5,199: the boundary falls inside the starved set
    ("straddle_4095", 11, {"ages": "straddle", "pending_p": 0.8}),
    # every wanting lane pends, starved, three distinct ages
    ("all_starved_ties", 12, {"ages": "all_starved", "pending_p": 1.0}),
    # the branch edge: the largest wait exactly 4,094 / 4,095
    ("max_wait_4094", 13, {"ages": "edge_4094", "pending_p": 0.8}),
    ("max_wait_4095", 14, {"ages": "edge_4095", "pending_p": 0.8}),
    # send_slots = n - 1 >= the wanting lanes
    ("slots_cover_wanting", 15, {"ages": "straddle", "slots_frac": 1.0}),
    # starved, the boundary among ages at and past the tick
    ("ages_past_tick", 16, {"ages": "past_tick", "pending_p": 0.8,
                            "slots_frac": 0.5}),
    # ... and among ages INT32_MAX, tied with the lanes that do not want
    ("ages_at_int32_max", 17, {"ages": "past_tick", "pending_p": 0.8,
                               "slots_frac": 0.8}),
    # ages near -2**31: the wraparound wait is 0 (counting branch) ...
    ("ages_near_int32_min", 18, {"ages": "int32_min", "pending_p": 0.8}),
    # ... but the raw age is the oldest (sort branch)
    ("ages_near_int32_min_starved", 19, {"ages": "int32_min_starved",
                                         "pending_p": 0.8}),
]


def _starve_ages(np, rng, mode, n, tick, arrs, running):
    """Rewrite the pend_tick lane (and for the edge modes lane 0) of a
    front state for one of the STARVATION modes."""
    r = rng.random(n)
    if mode == "straddle":
        pt = tick - rng.integers(3000, 5200, n)
    elif mode == "all_starved":
        pt = tick - 4100 - rng.integers(0, 3, n)
    elif mode in ("edge_4094", "edge_4095"):
        w = int(mode[-4:])
        pt = tick - rng.integers(0, w + 1, n)
        pt[0] = tick - w  # lane 0 pends, runs, and waits exactly w
        arrs["pend_dest"][0] = 1
        running[0] = True
    elif mode == "past_tick":
        pt = np.where(r < 0.3, tick - 4200 - rng.integers(0, 5, n),
                      np.where(r < 0.8, tick + rng.integers(0, 3, n),
                               INT32_MAX))
    elif mode == "int32_min":
        pt = np.where(r < 0.2, INT32_MIN + rng.integers(0, 10, n),
                      tick - rng.integers(0, 50, n))
    elif mode == "int32_min_starved":
        pt = np.where(r < 0.2, INT32_MIN + rng.integers(0, 10, n),
                      np.where(r < 0.3, tick - 4500,
                               tick - rng.integers(0, 50, n)))
    else:
        raise ValueError(mode)
    arrs["pend_tick"] = np.asarray(pt, np.int64).astype(np.int32)


def front_arrays(np, n, seed, pending_p=0.3, send_p=0.5, dead_p=0.1,
                 wait_span=5, weird_pay=False, loss=True, lat=True,
                 tick=None, ages=None, slots_frac=None):
    """A randomized deliver-front state in numpy, from ``seed`` (the
    generator of the deliver-front tests): the net lanes it sets, the
    send lanes, running, the tick and send_slots. ``ages`` picks a
    STARVATION mode (tick 5,000), ``slots_frac`` sets send_slots to that
    share of n (at most n - 1)."""
    P = 2
    if tick is None:
        tick = 5000 if ages else 100
    rng = np.random.default_rng(seed)
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
    if ages:
        _starve_ages(np, rng, ages, n, tick, a, running)
    send_slots = max(4, n // 8)
    if slots_frac is not None:
        send_slots = min(n - 1, max(4, int(n * slots_frac)))
    return a, send, running, tick, send_slots


def front_spec_kw(n, send_slots, loss=True, lat=True):
    """The NetSpec fields of a front state (both packages take them)."""
    return dict(
        inbox_capacity=8, payload_len=2, head_k=1, send_slots=send_slots,
        uses_latency=lat, uses_jitter=False, uses_rate=False, uses_loss=loss,
    )


def front_case(torch, np, n, seed, dev, **kw):
    """``front_arrays`` as the port's net state and inputs on ``dev``:
    (net, spec, send, running, tick, key)."""
    from testground_tpu_torch.sim import prng
    from testground_tpu_torch.sim.net import NetSpec, init_net_state

    arrs, send, running, tick, send_slots = front_arrays(np, n, seed, **kw)
    spec = NetSpec(**front_spec_kw(n, send_slots, kw.get("loss", True),
                                   kw.get("lat", True)), pallas_front=True)
    net = init_net_state(n, spec, dev)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    for k, v in arrs.items():
        net[k] = t(v)
    key = prng.PRNGKey(seed, device=dev)
    return (net, spec, tuple(t(s) for s in send), t(running),
            torch.tensor(tick, dtype=torch.int32, device=dev), key)


def lane_inputs(torch, net, spec, send, running, tick, key, n):
    """The kernel's inputs, built as ``deliver_front.front`` builds them."""
    from testground_tpu_torch.sim import deliver_front as df
    from testground_tpu_torch.sim import prng

    pend = {k: net[k] for k in df._PEND_KEYS}
    eg_loss = net.get("eg_loss")
    u = prng.uniform(key, (n,)) if eg_loss is not None else None
    return (pend, send, running, net["net_enabled"], net.get("eg_latency"),
            eg_loss, u, tick, spec.send_slots)


def reference_of(torch, net, spec, ins):
    """``front_reference`` on the kernel's inputs ``ins``."""
    from testground_tpu_torch.sim import deliver_front as df

    pend, send, running, net_enabled, lat, loss, u, tick, _ = ins
    enab = df.viability(pend["pend_dest"], send[0], running, net_enabled)
    return df.front_reference(spec, tick, u, send, running, pend, lat, loss,
                              enab)


def flat_outputs(res):
    pend, *rest = res
    return [pend[k] for k in sorted(pend)] + list(rest)


# ------------------------------------------------------------ merge inputs

# (label, n, case, cap, width, arrival slots) — the ring-merge checks on
# the card; the first rows are the main paths' shapes (dht@10k, then
# gossipsub@1M)
MERGE_CASES = [
    ("dht", 10_000, "k_random", 32, 7, 8),
    ("gossipsub", GOSSIP_BIG_N, "k_random", 64, 6, 8),
    ("dht", 10_000, "k_zero", 32, 7, 8),
    ("dht", 10_000, "k_all", 32, 7, 8),
    ("dht", 10_000, "w_near_2_30", 32, 7, 8),
    ("tool", 100_000, "k_random", 64, 8, 8),
    ("tool", 1_000_000, "k_random", 64, 8, 8),
    ("tool_ragged", 1_000_003, "k_random", 64, 8, 8),
    ("tool_ragged", 1_000_003, "w_near_2_30", 64, 8, 8),
    ("full_ring", 10_000, "full_ring", 4, 7, 8),
    ("a_over_cap", 10_000, "a_over_cap", 4, 8, 8),
]


def merge_case(np, name, n, seed, cap=32, width=7, A=8):
    """Ring-merge inputs (numpy, from ``seed``): ring f32 [n, cap, width],
    w and k_eff int32 [n], staging f32 [A*n, width]. ``name`` picks the
    counts: k_zero (nothing lands), k_random, k_all (A per row),
    full_ring (k_eff = cap: every slot written), w_near_2_30, a_over_cap
    (random counts; with A > cap later passes overwrite earlier ones)."""
    rng = np.random.default_rng(seed)
    ring = (rng.random((n, cap, width)) * 100).astype(np.float32)
    arr = (rng.random((A * n, width)) * 100 + 200).astype(np.float32)
    w = rng.integers(0, 10_000, n).astype(np.int32)
    if name == "k_zero":
        k = np.zeros(n, np.int32)
    elif name in ("k_random", "a_over_cap"):
        k = rng.integers(0, A + 1, n).astype(np.int32)
    elif name == "k_all":
        k = np.full(n, A, np.int32)
    elif name == "full_ring":
        k = np.full(n, cap, np.int32)
    elif name == "w_near_2_30":
        w = (2**30 - rng.integers(0, 3 * cap, n)).astype(np.int32)
        k = rng.integers(0, A + 1, n).astype(np.int32)
    else:
        raise ValueError(name)
    return ring, w, k, arr


def bit_equal(torch, a, b):
    """Exact equality (floats compared by their bits); returns the max
    absolute difference over float leaves as the second value."""
    same, err = True, 0.0
    for x, y in zip(a, b):
        if x.dtype != y.dtype or x.shape != y.shape:
            return False, float("inf")
        if x.dtype.is_floating_point:
            same &= bool(torch.equal(x.view(torch.int32), y.view(torch.int32)))
            d = (x - y).abs()
            d = d[~torch.isnan(d)]
            if d.numel():
                err = max(err, float(d.max()))
        else:
            same &= bool(torch.equal(x, y))
    return same, err


def _warm(torch, fn):
    """Three calls on a side stream, as CUDA-graph capture wants."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()


def graph_of(torch, fn, calls=1):
    """``fn()`` captured ``calls`` times in one CUDA graph (a host read
    inside fails the capture); returns (graph, the last captured call's
    output tensors)."""
    _warm(torch, fn)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            out = fn()
    return g, out


def device_ms(torch, fn, reps, calls=1):
    """Device time of one ``fn()`` call: ``calls`` calls captured in one
    CUDA graph, replayed ``reps`` times between two CUDA events. A replay
    costs the host ~7 us whatever the graph holds, so a call shorter than
    that needs ``calls`` > 1 to be timed on the device and not on the
    host; consecutive calls in a graph still pay the gap between kernels.
    Returns (ms, how)."""
    g, _ = graph_of(torch, fn, calls)
    g.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        g.replay()
    e1.record()
    torch.cuda.synchronize()
    return (e0.elapsed_time(e1) / (reps * calls),
            f"cuda-graph replay, {calls} calls a graph")


def calls_for(n):
    """Calls a graph for a shape of n lanes (rows): 20 at 10k and below,
    where a call takes less than the replay's host cost."""
    return 20 if n <= 10_000 else 1


def eager_ms(torch, fn, reps):
    """Wall time of one eager ``fn()`` call, host overhead included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def nbytes(ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def front_bytes(ins, out):
    """The bytes the front must move: each input read once, each output
    written once."""
    pend, send, *rest = ins
    return nbytes(list(pend.values()) + list(send)
                  + [t for t in rest[:-1]] + flat_outputs(out))


def kernel_phase(torch, np, dev, report, sizes=(10_000, 1_000_003)):
    """[3] the deliver-front kernel against its plain version on every
    regime and starvation state at N = 10,000 and 1,000,003, the whole
    dispatch against ``front_reference``, times against the bound; then
    the whole dispatch captured in a CUDA graph (bit-equal to its eager
    call) and timed, captured and eager."""
    from testground_tpu_torch.kernels import deliver_front as kern
    from testground_tpu_torch.sim import deliver_front as df

    starved_names = {name for name, _, _ in STARVATION}
    rows, dispatch = [], []
    max_err = 0.0
    for n in sizes:
        plan = kern.plan(n, device=dev)
        log(f"  plan n={n:,d}: {plan}")
        reps = 50
        calls = calls_for(n)
        for name, seed, kw in REGIMES + STARVATION:
            net, spec, send, running, tick, key = front_case(
                torch, np, n, seed, dev, **kw)
            ins = lane_inputs(torch, net, spec, send, running, tick, key, n)
            launches = int(df.front_lanes.launches)
            got = df.front_lanes(*ins)
            assert int(df.front_lanes.launches) == launches + 1, "no launch"
            want = df.front_lanes_plain(*ins)
            ok, err = bit_equal(torch, flat_outputs(got), flat_outputs(want))
            max_err = max(max_err, err)
            if not ok:
                raise AssertionError(f"kernel != plain: {name} @ {n}")
            # the whole dispatch (kernel + record build) against the
            # reference transcription of net.deliver's front
            disp = df.front(net, spec, tick, key, send, running, n)
            ref = reference_of(torch, net, spec, ins)
            ok, _ = bit_equal(torch, flat_outputs(disp), flat_outputs(ref))
            if not ok:
                raise AssertionError(f"front != reference: {name} @ {n}")
            k_ms, how = device_ms(torch, lambda: df.front_lanes(*ins), reps,
                                  calls)
            p_ms, _ = device_ms(torch, lambda: df.front_lanes_plain(*ins),
                                reps, calls)
            k_eager = eager_ms(torch, lambda: df.front_lanes(*ins), reps)
            moved = front_bytes(ins, got)
            bound_ms = moved / HBM_BYTES_PER_S * 1e3
            rows.append({
                "regime": name, "n": n, "starved_case": name in starved_names,
                "bit_equal": True, "kernel_ms": k_ms, "plain_ms": p_ms,
                "kernel_eager_ms": k_eager, "bound_ms": bound_ms,
                "bound_share": bound_ms / k_ms, "bytes": moved,
                "timing": how,
            })
            log(f"  front {name:27s} n={n:>9,d}: kernel {k_ms:.4f} ms "
                f"(eager {k_eager:.4f}), plain {p_ms:.4f} ms, bound "
                f"{bound_ms:.5f} ms ({100 * bound_ms / k_ms:.0f}%), "
                "bit-equal to plain and reference")
            del net, send, running, ins, got, want, disp, ref

        # the whole front dispatch: captured in a CUDA graph (so no host
        # read), replayed bit-equal to its eager call
        net, spec, send, running, tick, key = front_case(
            torch, np, n, 0, dev)

        def new():
            return df.front(net, spec, tick, key, send, running, n)

        eager_out = new()
        g, captured = graph_of(torch, new)
        for buf in flat_outputs(captured):
            buf.zero_()
        g.replay()
        torch.cuda.synchronize()
        ok, _ = bit_equal(torch, flat_outputs(captured),
                          flat_outputs(eager_out))
        assert ok, f"graph replay != eager front @ {n}"
        new_a, _ = device_ms(torch, new, reps, calls)
        new_e = eager_ms(torch, new, reps)
        drow = {"n": n, "graph_replay_bit_equal": True,
                "graph_ms": new_a, "eager_ms": new_e}
        dispatch.append(drow)
        log(f"  dispatch n={n:>9,d}: captured and replayed bit-equal; "
            f"graph {new_a:.4f} ms, eager {new_e:.4f} ms")
        del net, send, running, g, captured, eager_out
    report["front"] = rows
    report["front_dispatch"] = dispatch
    report["front_max_abs_err"] = max_err
    return rows, max_err


FRONT_PHASES = ("start", "A: lanes loaded", "A: histogram published",
                "grid barrier", "B: boundary found", "C: rank base",
                "D: lanes written", "end")


def front_trace_phase(torch, np, dev, report):
    """[3a] where the deliver-front kernel's time goes: the build with
    -DFRONT_TRACE, in which each block stamps %globaltimer at its phase
    boundaries (after a block barrier) into the scratch; per phase the
    median and the latest block, in us from the first block's start."""
    import ctypes

    from testground_tpu_torch.kernels import build as kbuild
    from testground_tpu_torch.kernels import deliver_front as kern

    lib = kern.bind(ctypes.CDLL(str(kbuild.build(*TRACE_BUILD)[0])))
    # the scratch ends with trace[kMaxGrid = 1024][8] (csrc/deliver_front.cu)
    off = lib.deliver_front_scratch_bytes() - 1024 * 8 * 8
    rows = []
    for n, case in ((10_000, "oversubscribed"), (10_000, "nothing_fresh"),
                    (1_000_003, "mixed"), (1_000_003, "straddle_4095")):
        name, seed, kw = next(c for c in REGIMES + STARVATION if c[0] == case)
        net, spec, send, running, tick, key = front_case(
            torch, np, n, seed, dev, **kw)
        ins = lane_inputs(torch, net, spec, send, running, tick, key, n)
        grid = kern.plan(n, device=dev)["grid"]
        for _ in range(5):
            kern.launch(*ins, lib=lib)
        torch.cuda.synchronize()
        buf = kern._scratch[(lib._name, dev.index)]
        tr = (buf[off:off + grid * 64].cpu().numpy().view(np.uint64)
              .reshape(grid, 8).astype(np.int64))
        rel = (tr - tr[:, 0].min()) / 1e3
        row = {"case": case, "n": n, "grid": grid,
               "median_us": [float(np.median(rel[:, k])) for k in range(8)],
               "latest_us": [float(rel[:, k].max()) for k in range(8)]}
        rows.append(row)
        log(f"  phases {case} n={n:,d} ({grid} blocks): " + "; ".join(
            f"{p} {m:.2f}/{x:.2f}" for p, m, x in zip(
                FRONT_PHASES, row["median_us"], row["latest_us"])))
    report["front_phases"] = rows


def merge_phase(torch, np, dev, report):
    """[3b] the ring-merge kernel against ``merge_plain`` on the card."""
    from testground_tpu_torch.sim import ring_merge as rm

    rows = []
    max_err = 0.0
    for seed, (label, n, case, cap, width, A) in enumerate(MERGE_CASES):
        ring, w, k, arr = (
            torch.as_tensor(a, device=dev)
            for a in merge_case(np, case, n, seed, cap, width, A))
        got = rm.merge(ring, w, k, arr)
        want = rm.merge_plain(ring, w, k, arr)
        ok, err = bit_equal(torch, [got], [want])
        max_err = max(max_err, err)
        if not ok:
            raise AssertionError(f"ring merge kernel != plain: {label} "
                                 f"{case} @ {n}")
        reps = 200 if n <= 10_000 else 20
        calls = calls_for(n)
        k_ms, how = device_ms(torch, lambda: rm.merge(ring, w, k, arr), reps,
                              calls)
        p_ms, _ = device_ms(torch, lambda: rm.merge_plain(ring, w, k, arr),
                            reps, calls)
        c_ms, _ = device_ms(torch, ring.clone, reps, calls)
        # each output cell is read from the staging if a record lands
        # there, else from the ring, so the reads of both together are
        # one ring's worth whatever k_eff holds; plus the ring written
        # and w and k_eff read
        moved = nbytes([ring, w, k, got])
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        rows.append({
            "shape": label, "case": case, "n": n, "cap": cap, "width": width,
            "arrival_slots": A, "bit_equal": True, "kernel_ms": k_ms,
            "plain_ms": p_ms, "clone_ms": c_ms, "bound_ms": bound_ms,
            "bytes": moved, "timing": how,
        })
        log(f"  merge {label:11s} {case:12s} n={n:>9,d} cap={cap:2d} "
            f"W={width} A={A}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"clone {c_ms:.4f} ms, bound {bound_ms:.4f} ms, bit-equal")
        del ring, w, k, arr, got, want
    report["merge"] = rows
    report["merge_max_abs_err"] = max_err
    return rows, max_err


def microbench_phase(report):
    """[3c] the ported microbenchmark at the tool's own N."""
    from testground_tpu_torch.tools import microbench_append as mb

    report["microbench_append"] = [
        mb.bench(n, log=log) for n in (100_000, 1_000_000)
    ]


# ------------------------------------------------------------------ dht

def dht_exec(n, device, chunk_ticks=32, pallas_front=True):
    """dht find-providers with the bench's parameters; ``pallas_front``
    True runs the fused deliver front, None the default lowering."""
    from testground_tpu_torch.plans import dht
    from testground_tpu_torch.sim import (
        BuildContext, GroupSpec, SimConfig, compile_program,
    )

    ctx = BuildContext(
        [GroupSpec("single", 0, n,
                   {k: str(v) for k, v in DHT_PARAMS.items()})],
        test_case="find-providers", test_run="chip-smoke",
    )
    cfg = SimConfig(
        quantum_ms=10.0, max_ticks=60_000, chunk_ticks=chunk_ticks,
        metrics_capacity=8, churn_fraction=0.05, churn_start_ms=100.0,
        churn_end_ms=5_000.0, pallas_front=pallas_front,
    )
    return compile_program(dht.find_providers, ctx, cfg, device=device)


def gossipsub_exec(n, device, chunk_ticks=32):
    """gossipsub mesh-propagation with the bench's parameters
    (tools/bench_driver_configs.py: degree 8, 50 ms links, 0% loss,
    10 ms quantum, max_ticks 20,000, metrics capacity 8) on the default
    lowering."""
    from testground_tpu_torch.plans import gossipsub
    from testground_tpu_torch.sim import (
        BuildContext, GroupSpec, SimConfig, compile_program,
    )

    ctx = BuildContext(
        [GroupSpec("single", 0, n,
                   {k: str(v) for k, v in GOSSIPSUB_PARAMS.items()})],
        test_case="mesh-propagation", test_run="chip-smoke",
    )
    cfg = SimConfig(quantum_ms=10.0, max_ticks=20_000,
                    chunk_ticks=chunk_ticks, metrics_capacity=8)
    return compile_program(gossipsub.mesh_propagation, ctx, cfg,
                           device=device)


def storm_exec(n, device, shaped, chunk_ticks=32):
    """bench.py's storm executable (``shaped``: TG_BENCH_SHAPED's)."""
    from testground_tpu_torch import bench

    return bench.storm_executable(n, device, shaped, chunk_ticks)


def graft_storm_exec(n, device, shaped=False):
    """storm with ``__graft_entry__``'s compressed params; shaped adds
    its shaped links, churn-tolerant rendezvous and 5% churn."""
    from testground_tpu_torch import graft

    return graft.storm_executable(
        n, device=device, shaped=shaped, tolerant=shaped,
        churn_fraction=0.05 if shaped else 0.0, phase_gating=True)


def launch_bounds(executed, chunk_ticks, launches) -> bool:
    """A kernel run once a loop iteration: the executed ticks, the
    identity iterations to the end of the last chunk, and the stepper's
    eager warm-up iterations before its CUDA-graph capture."""
    from testground_tpu_torch.sim.core import STEPPER_WARMUP

    lo = executed + STEPPER_WARMUP
    return lo <= launches < lo + chunk_ticks


def reset_launch_counts() -> None:
    """Every kernel wrapper's launch count to 0, just before a main-path
    run."""
    from testground_tpu_torch.sim import count_scatter as csc
    from testground_tpu_torch.sim import deliver_front as df
    from testground_tpu_torch.sim import ring_merge as rm

    df.reset_counters()
    rm.merge.launches.reset()
    csc.scatter_add.launches.reset()


def other_launches():
    """Launches of the three kernels since the last reset."""
    from testground_tpu_torch.sim import count_scatter as csc
    from testground_tpu_torch.sim import deliver_front as df
    from testground_tpu_torch.sim import ring_merge as rm

    return {"deliver_front": int(df.front_lanes.launches),
            "ring_merge": int(rm.merge.launches),
            "count_scatter": int(csc.scatter_add.launches)}


def case_run(torch, dev, report, key, ex, check):
    """Run the executor ``ex`` to the end with the launch counts reset
    just before; ``check(res)`` gives the case's own summary (and
    asserts). Returns (the report row, the result)."""
    t0 = time.monotonic()
    ex.tick_fn()
    build_s = time.monotonic() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    res = ex.run()
    launches = other_launches()
    out = {
        "ticks": res.ticks, "ticks_executed": res.ticks_executed,
        "event_skip": ex.event_skip, "wall_seconds": res.wall_seconds,
        "ms_per_tick": res.wall_seconds / max(res.ticks, 1) * 1e3,
        "ms_per_executed_tick": (res.wall_seconds
                                 / max(res.ticks_executed, 1) * 1e3),
        "build_seconds": build_s, "launches": launches,
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
        **check(res),
    }
    report[key] = out
    return out, res


def dht_phase(torch, dev, report, key, pallas_front, chunk_ticks=32,
              n=10_000):
    """dht find-providers @ 10k to termination, through the fused front
    (``pallas_front=True``, phase 4) or the default lowering (None,
    phase 7); the launch counts are read right after the run."""

    def check(res):
        st = res.statuses()[:n]
        return {
            "n": n, "pallas_front": bool(pallas_front),
            "ok": int((st == 1).sum()), "failed": int((st == 2).sum()),
            "crashed": int((st == 3).sum()),
            "egress_overflow": res.net_egress_overflow(),
            "net_dropped": res.net_dropped(),
            "metrics_dropped": res.metrics_dropped(),
            "egress_deferred": res.net_egress_deferred(),
            "payload_sanitized": res.net_payload_sanitized(),
        }

    out, res = case_run(torch, dev, report, key,
                        dht_exec(n, dev, chunk_ticks,
                                 pallas_front=pallas_front), check)
    launches = out["launches"]["deliver_front"]
    merges = out["launches"]["ring_merge"]
    log(f"  dht@{n}: {out['ticks']} ticks ({out['ticks_executed']} "
        f"executed), {out['wall_seconds']:.3f} s wall "
        f"({out['ms_per_tick']:.2f} ms/tick); {out['ok']} ok / "
        f"{out['failed']} failed / {out['crashed']} churned; front "
        f"launches {launches}, merge launches {merges}")
    assert not res.timed_out(), f"timed out at tick {res.ticks}"
    assert out["egress_overflow"] == 0, "egress overflow"
    assert out["net_dropped"] == 0, "inbox drops"
    assert out["metrics_dropped"] == 0, "metric ring too small"
    assert out["ok"] > 0
    # every loop iteration runs the front (fused front only) and the
    # bounded append, so the ring merge, once each; iterations past the
    # end of the run (the rest of the last chunk) are identities but
    # launch all the same, and so do the stepper's warm-up iterations
    assert launch_bounds(out["ticks_executed"], chunk_ticks, merges), (
        merges, out["ticks_executed"])
    if pallas_front:
        assert launches == merges, (launches, merges)
    else:
        assert launches == 0, launches
    assert out["launches"]["count_scatter"] == 0, out["launches"]
    return out, res.state


def gossipsub_phase(torch, dev, report, key, n, chunk_ticks=32):
    """gossipsub mesh-propagation @ n on the default lowering, to full
    coverage; the ring-merge launches are read right after the run."""
    ex = gossipsub_exec(n, dev, chunk_ticks)

    def check(res):
        lat = sorted(r["value"] for r in res.metrics_records()
                     if r["name"] == "propagation_ms")
        return {
            "n": n, "send_slots": ex.program.net_spec.send_slots,
            "covered": int((res.statuses()[:n] == 1).sum()),
            "p50_propagation_ms": lat[len(lat) // 2] if lat else None,
            "p99_propagation_ms": lat[int(len(lat) * 0.99)] if lat else None,
            "egress_overflow": res.net_egress_overflow(),
            "egress_deferred": res.net_egress_deferred(),
            "net_dropped": res.net_dropped(),
            "metrics_dropped": res.metrics_dropped(),
        }

    out, res = case_run(torch, dev, report, key, ex, check)
    merges = out["launches"]["ring_merge"]
    log(f"  gossipsub@{n:,d}: {out['covered']:,d}/{n:,d} covered in "
        f"{out['ticks']} ticks ({out['ticks_executed']} executed), "
        f"{out['wall_seconds']:.3f} s wall ({out['ms_per_tick']:.2f} "
        f"ms/tick); p50 propagation {out['p50_propagation_ms']} ms, p99 "
        f"{out['p99_propagation_ms']} ms; merge launches {merges}; peak "
        f"{out['max_memory_allocated'] / 1e9:.2f} GB")
    assert not res.timed_out(), f"stalled at tick {res.ticks}"
    assert out["covered"] == n, "coverage"
    assert out["metrics_dropped"] == 0, "metric ring too small"
    assert out["egress_overflow"] == 0, "egress overflow"
    assert out["net_dropped"] == 0, "inbox drops"
    assert (out["launches"]["deliver_front"],
            out["launches"]["count_scatter"]) == (0, 0), out["launches"]
    if out["send_slots"] is not None:  # the bounded append
        assert launch_bounds(out["ticks_executed"], chunk_ticks, merges), (
            merges, out["ticks_executed"])
    else:
        assert merges == 0
    return out


def profile_phase(torch, report, key, ex, wall_ms_per_tick, warm_ticks=100,
                  window=20):
    """Where a composition's tick's device time goes: ``window`` loop
    iterations of the executor ``ex`` after ``warm_ticks`` under
    torch.profiler (CUPTI). Device busy time is the sum of the kernels'
    (and copies') own durations; its share is taken against the
    unprofiled wall per tick of the main run, since the profiler slows
    the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    st = ex.init_state()
    step = ex.stepper(st)  # as run() steps: CUDA-graph replays
    for _ in range(warm_ticks):
        st = step(st)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(window):
            st = step(st)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_name: dict = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us, calls = per_name.get(e.name, (0.0, 0))
        per_name[e.name] = (us + e.time_range.elapsed_us(), calls + 1)
    busy_us = sum(us for us, _ in per_name.values())
    ops = sum(c for _, c in per_name.values())
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:12]
    busy_ms = busy_us / window / 1e3
    out = {
        "window_ticks": window, "from_tick": warm_ticks,
        "profiled_wall_ms_per_tick": wall / window * 1e3,
        "wall_ms_per_tick": wall_ms_per_tick,
        "device_busy_ms_per_tick": busy_ms,
        "device_busy_share": busy_ms / wall_ms_per_tick,
        "device_ops_per_tick": ops / window,
        "top": [{"name": k[:100], "device_ms_per_tick": us / window / 1e3,
                 "calls_per_tick": c / window} for k, (us, c) in top],
    }
    report[key] = out
    if busy_us == 0:
        log("  profile: torch.profiler saw no device activity "
            "(device busy share not measured)")
        return out
    log(f"  profile (ticks {warm_ticks}..{warm_ticks + window}): device "
        f"busy {busy_ms:.3f} ms/tick = {100 * out['device_busy_share']:.1f}%"
        f" of the {wall_ms_per_tick:.2f} ms/tick wall; "
        f"{out['device_ops_per_tick']:.0f} device ops/tick "
        f"(profiled wall {out['profiled_wall_ms_per_tick']:.2f} ms/tick)")
    for r in out["top"][:8]:
        log(f"    {r['device_ms_per_tick']:.4f} ms/tick "
            f"x{r['calls_per_tick']:.0f}  {r['name'][:70]}")
    return out


# --------------------------------------------------------- count scatter

# (label, rows, lanes, case): the count-scatter checks on the card; the
# first row is storm@10k's staging shape. "storm" is a tick of
# storm@10k's own traffic: 6,553,600,000 B in 4 KiB chunks over 3,401
# ticks is ~470 data lanes of 10,000 (the rest dropped)
SCATTER_CASES = [
    ("staging", 10_000, 10_000, "uniform"),
    ("staging", 10_000, 10_000, "seven_rows"),
    ("staging", 10_000, 10_000, "all_dropped"),
    ("staging", 10_000, 10_000, "storm"),
    ("staging", 1_000_003, 1_000_003, "uniform"),
    ("staging", 1_000_003, 1_000_003, "seven_rows"),
    ("wheel", 64 * 10_000, 10_000, "uniform"),
    ("wheel", 64 * 10_000, 10_000, "storm"),
    ("wheel", 64 * 10_000, 10_000, "bucket"),
    # sparsetimer's beat tick: every lane pings the next one, all kept
    ("staging", 10_000, 10_000, "ring"),
]
STORM_KEPT = 470 / 10_000  # storm@10k's data lanes a tick


def scatter_case(np, rows, lanes, case, seed):
    """Count-scatter inputs (numpy, from ``seed``): buf f32 [rows, 2],
    idx int32 [lanes] (about 30% dropped, idx = rows), upd f32 [lanes, 2]
    with fractional values. ``case``: uniform over the rows, seven_rows
    (every kept lane to one of 7 rows), bucket (every kept lane into the
    rows of one wheel bucket: a tick of a fixed link delay), all_dropped,
    ladder (row r takes
    r % 48 + 1 lanes, none dropped), ring (lane i to row i + 1 mod rows,
    none dropped: sparsetimer's beat), or storm: ~4.7% of
    lanes kept, updates [1, 4096] and one in twenty [2, 8192] (a
    duplicate), onto the nodes (the wheel's rows of a few buckets when
    ``rows`` is a wheel's W x lanes)."""
    rng = np.random.default_rng(seed)
    buf = (rng.standard_normal((rows, 2)) * 1e3).astype(np.float32)
    if case == "storm":
        buf = rng.integers(0, 64, (rows, 2)).astype(np.float32) * [1, 4096]
        buf = buf.astype(np.float32)
        upd = np.tile(np.float32([1, 4096]), (lanes, 1))
        upd[rng.random(lanes) < 0.05] = [2, 8192]
        nodes = min(rows, lanes)
        idx = rng.integers(0, nodes, lanes)
        if rows > nodes:  # bucket b of the wheel's rows b * nodes + dest
            idx = idx + rng.integers(5, 8, lanes) * nodes
        idx = np.where(rng.random(lanes) < STORM_KEPT, idx, rows)
        return buf, idx.astype(np.int32), upd
    upd = (rng.standard_normal((lanes, 2)) * rng.random((lanes, 1))
           * 1e4).astype(np.float32)
    if case == "seven_rows":
        idx = rng.choice(rng.integers(0, rows, 7), lanes)
    elif case == "bucket":  # every kept lane into one wheel bucket (5)
        idx = rng.integers(0, lanes, lanes) + 5 * lanes
    else:
        idx = rng.integers(0, rows, lanes)
    idx = np.where(rng.random(lanes) < 0.3, rows, idx)
    if case == "all_dropped":
        idx = np.full(lanes, rows)
    if case == "ring":
        idx = (np.arange(lanes) + 1) % rows
    if case == "ladder":  # row r takes r % 48 + 1 lanes, in shuffled order
        rep = np.repeat(np.arange(rows), np.arange(rows) % 48 + 1)[:lanes]
        idx = rng.permutation(np.pad(rep, (0, lanes - rep.size),
                                     constant_values=rows))
    return buf, idx.astype(np.int32), upd


def kernel_breakdown(torch, fn, calls=20):
    """Device ms of each kernel of one eager ``fn()`` call, by name, from
    ``torch.profiler`` over ``calls`` calls (after a warm-up call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name[:60]
            per_name[name] = (per_name.get(name, 0.0)
                              + e.time_range.elapsed_us() / calls / 1e3)
    return per_name


def scatter_trace(torch, np, kern, buf, idx, upd, reps=5):
    """Where a small-plan call's time goes: the -DSCATTER_TRACE build
    stamps %globaltimer at each block's phase boundaries (after a block
    barrier). Returns, for the block with the most lanes, its lanes and
    per phase (SCATTER_PHASES) the median over ``reps`` calls in us, and
    the median span from the first block's start to the last one's end."""
    import ctypes

    from testground_tpu_torch.kernels import build as kbuild

    lib = kern.bind(ctypes.CDLL(str(kbuild.build(*SCATTER_TRACE_BUILD)[0])))
    grid = lib.count_scatter_small_grid(buf.shape[0])
    st = kern.TRACE_STAMPS
    trace = torch.zeros(grid * st, dtype=torch.int64, device=buf.device)
    runs = []
    for _ in range(reps + 1):
        kern.launch(buf, idx, upd, lib=lib, trace=trace)
        torch.cuda.synchronize()
        runs.append(trace.cpu().numpy().reshape(grid, st).copy())
    runs = np.stack(runs[1:])  # [reps, grid, stamps]
    top = int(np.argmax(runs[0, :, st - 1]))
    d = np.diff(runs[:, top, :len(SCATTER_PHASES) + 1], axis=1) / 1e3
    span = (runs[:, :, len(SCATTER_PHASES)].max(1)
            - runs[:, :, 0].min(1)) / 1e3
    return {"blocks": grid, "top_block_lanes": int(runs[0, top, st - 1]),
            "span_us": float(np.median(span)),
            **{p: float(np.median(d[:, i]))
               for i, p in enumerate(SCATTER_PHASES)}}


def scatter_phase(torch, np, dev, report):
    """[10] the count-scatter kernel against its plain version (run on a
    CPU copy of the same inputs), bit-equal; the whole function (the
    plan that ``kernels.count_scatter.plan`` picks), the plain version
    and ``index_add_`` timed on the card, and the bound."""
    from testground_tpu_torch.kernels import count_scatter as kern
    from testground_tpu_torch.sim import count_scatter as csc

    rows_out = []
    for seed, (label, rows, lanes, case) in enumerate(SCATTER_CASES):
        arrs = scatter_case(np, rows, lanes, case, seed)
        buf, idx, upd = (torch.as_tensor(a, device=dev) for a in arrs)
        launches = int(csc.scatter_add.launches)
        got = csc.scatter_add(buf, idx, upd)
        assert int(csc.scatter_add.launches) == launches + 1, "no launch"
        want = csc.scatter_add_plain(*(torch.as_tensor(a) for a in arrs))
        ok, err = bit_equal(torch, [got.cpu()], [want])
        if not ok:
            raise AssertionError(f"count scatter kernel != plain: {label} "
                                 f"{case} @ {rows}")
        calls = calls_for(lanes)
        reps = 50 if lanes <= 10_000 else 10
        # the library call adds dropped lanes into one spare row
        lib_out = torch.cat([buf, buf.new_zeros(1, 2)])
        lib_idx = torch.clamp(idx, max=rows)
        kept = idx[idx < rows]
        touched = int(torch.unique(kept).numel())
        # every index read once, each kept lane's update read once, each
        # touched row read and written once
        moved = lanes * 4 + kept.numel() * 8 + touched * 16
        row = {"shape": label, "case": case, "rows": rows, "lanes": lanes,
               "plan": kern.plan(lanes, rows), "kept": int(kept.numel()),
               "bit_equal": True, "max_abs_err": err,
               "wrapper_ms": device_ms(
                   torch, lambda: csc.scatter_add(buf, idx, upd), reps,
                   calls)[0],
               "plain_ms": device_ms(
                   torch, lambda: csc.scatter_add_plain(buf, idx, upd),
                   reps, calls)[0],
               # one library call on the same inputs (it adds in atomic
               # order, which changes from run to run)
               "library_ms": device_ms(
                   torch, lambda: lib_out.index_add_(0, lib_idx, upd), reps,
                   calls)[0],
               "bytes": moved, "touched_rows": touched,
               "bound_ms": moved / HBM_BYTES_PER_S * 1e3}
        row["vs_library"] = row["wrapper_ms"] / row["library_ms"]
        if row["plan"] == "small":
            row["phases_us"] = scatter_trace(torch, np, kern, buf, idx, upd)
        elif case == "uniform":
            row["by_kernel"] = kernel_breakdown(
                torch, lambda: csc.scatter_add(buf, idx, upd))
        log(f"  scatter {label:7s} {case:11s} rows={rows:>9,d} "
            f"lanes={lanes:>9,d} kept={row['kept']:>7,d} ({row['plan']}): "
            f"{row['wrapper_ms']:.4f} ms, plain {row['plain_ms']:.4f}, "
            f"index_add_ {row['library_ms']:.4f} "
            f"({row['vs_library']:.2f}x), bound {row['bound_ms']:.6f} ms, "
            "bit-equal")
        for name, ms in row.get("by_kernel", {}).items():
            log(f"    {ms:.4f} ms  {name}")
        if "phases_us" in row:
            log("    busiest block, us: " + "; ".join(
                f"{p} {v:.2f}" if isinstance(v, float) else f"{p} {v}"
                for p, v in row["phases_us"].items()))
        rows_out.append(row)
        del buf, idx, upd, got, want, lib_out, lib_idx, kept
    report["count_scatter"] = rows_out
    return rows_out, max(r["max_abs_err"] for r in rows_out)


# ------------------------------------------------------------------ storm

def storm_phase(torch, dev, report, key, shaped, chunk_ticks=32,
                n=10_000):
    """storm @ 10k with bench.py's params (``--shaped``: with its shaped
    scenario and churn) to termination, asserting what bench.py asserts;
    the count-scatter launches are read right after the run."""
    from testground_tpu_torch import bench

    def check(res):
        return {"n": n, "shaped": shaped,
                "send_compact_fallbacks": res.net_send_compact_fallbacks(),
                **bench.check(res, n, shaped)}

    out, _ = case_run(torch, dev, report, key,
                      bench.storm_executable(n, dev, shaped, chunk_ticks),
                      check)
    launches = out["launches"]["count_scatter"]
    log(f"  storm@{n:,d}{' shaped' if shaped else ''}: {out['ticks']} ticks "
        f"({out['ticks_executed']} executed), {out['wall_seconds']:.3f} s "
        f"wall ({out['ms_per_executed_tick']:.2f} ms/executed tick); "
        f"{out['ok']} ok" + (f", {out['victims']} victims crashed"
                             if shaped else "")
        + f"; drops {out['net_dropped']}, clamps "
        f"{out['horizon_clamped']}, metric drops "
        f"{out['metrics_dropped']}; bytes sent "
        f"{out['bytes_sent']:.0f}, read {out['bytes_read']:.0f}; "
        f"count-scatter launches {launches}")
    # one count-mode add on every loop iteration
    assert launch_bounds(out["ticks_executed"], chunk_ticks, launches), (
        launches, out["ticks_executed"])
    assert (out["launches"]["deliver_front"], out["launches"]["ring_merge"]
            ) == (0, 0), out["launches"]
    return out


def parity_phase(np, dev, report, key, make, n=300):
    """One composition at ``n`` on the card and on the CPU: every state
    leaf bit-equal."""
    from testground_tpu_torch.sim.state_io import (
        compare_leaves, flatten, state_to_numpy,
    )

    states, walls = {}, {}
    for d in (dev, "cpu"):
        res = make(n, d).run()
        states[str(d)] = flatten(state_to_numpy(res.state))
        walls[str(d)] = (res.ticks, res.wall_seconds)
    leaves = compare_leaves(states[str(dev)], states["cpu"],
                            f"{key}: GPU vs CPU")
    report[key] = {
        "leaves": leaves, "bit_equal": True,
        "gpu": walls[str(dev)], "cpu": walls["cpu"],
    }
    log(f"  {key}: GPU vs CPU bit-equal over {leaves} leaves "
        f"(ticks {walls[str(dev)][0]}, GPU {walls[str(dev)][1]:.2f} s, "
        f"CPU {walls['cpu'][1]:.2f} s)")


# ------------------------------------------------ the rest of the plan

BARRIER_ITERS = 50  # tools/bench_barrier.py 10000 50
SUBTREE_ITERS = 2_000  # tools/bench_subtree.py's default, the full run


def barrier_phase(torch, dev, report, n=10_000, iters=BARRIER_ITERS):
    """[14] barrier @ n x iters with tools/bench_barrier.py's config."""
    from testground_tpu_torch import bench
    from testground_tpu_torch.tools import bench_barrier

    out, _ = case_run(torch, dev, report, "barrier10k",
                      bench.barrier_executable(n, iters, dev),
                      lambda r: bench_barrier.check(r, n, iters))
    log(f"  barrier@{n:,d} x {iters}: {out['ok']:,d} ok, "
        f"{out['barriers']} barriers in {out['ticks']} ticks "
        f"({out['ticks_executed']} executed), {out['wall_seconds']:.3f} s "
        f"wall ({out['ms_per_executed_tick']:.2f} ms/executed tick), "
        f"{out['barriers_per_s']:.1f} barriers/s; metric drops 0")
    assert all(v == 0 for v in out["launches"].values()), out["launches"]
    return out


def subtree_phase(torch, dev, report, n=10_000, iters=SUBTREE_ITERS):
    """[15] subtree @ n x iters with tools/bench_subtree.py's config."""
    from testground_tpu_torch import bench
    from testground_tpu_torch.tools import bench_subtree

    out, _ = case_run(torch, dev, report, "subtree10k",
                      bench.subtree_executable(n, iters, dev),
                      lambda r: bench_subtree.check(r, n, iters))
    log(f"  subtree@{n:,d} x {iters}: {out['ok']:,d} ok in {out['ticks']} "
        f"ticks ({out['ticks_executed']} executed), "
        f"{out['wall_seconds']:.3f} s wall ({out['ms_per_executed_tick']:.2f}"
        f" ms/executed tick); stream violations 0, sub_bad 0, "
        f"sub_unverified 0, {out['topics_checked']} topics verified on the "
        f"host; peak {out['max_memory_allocated'] / 1e9:.2f} GB")
    log("  virtual seconds a size class: " + ", ".join(
        f"{k.split('_')[2]} B {v:.3f}"
        for k, v in sorted(out["virtual_secs"].items(),
                           key=lambda kv: int(kv[0].split("_")[2]))))
    assert all(v == 0 for v in out["launches"].values()), out["launches"]
    return out


def state_pass_phase(torch, report, key, ex, reps=50):
    """The device time of the loop's two whole-state passes on ``ex``'s
    initial state: ``guarded_tick``'s select of every leaf and the
    captured stepper's copy of every leaf back, captured in a CUDA graph
    (``core._tree_where`` and ``copy_``, as the stepper runs them)."""
    from testground_tpu_torch.sim import core

    st = ex.init_state()
    leaves = list(core._leaves(st))
    go = torch.ones((), dtype=torch.bool, device=leaves[0].device)

    def passes():
        out = core._tree_where(go, st, st)
        for dst, src in zip(leaves, core._leaves(out)):
            dst.copy_(src)

    ms, _ = device_ms(torch, passes, reps)
    state_bytes = nbytes(leaves)
    report[key] = {"state_bytes": state_bytes, "leaves": len(leaves),
                   "select_and_copy_ms": ms}
    log(f"  whole-state passes: {len(leaves)} leaves, "
        f"{state_bytes / 1e6:.1f} MB; select + copy {ms:.4f} ms a loop "
        "iteration")
    return ms


def payload_select_phase(torch, report, key, dev, n=10_000, reps=20):
    """subtree's ``publish_payload`` select, rebuilt from the ops the tick
    runs for it: each pump phase's item (one value a lane) expanded to
    its topic's width and padded to the widest topic's 1,024 lanes, the
    instances publish's padded row, and the chain of 8 ``torch.where``
    by pc. Its device time, captured in a CUDA graph."""
    from testground_tpu_torch.plans.benchmarks import SIZES

    width = max(SIZES) // 4
    pc = torch.randint(0, 40, (n,), dtype=torch.int32, device=dev)
    item = torch.rand(n, device=dev)
    inst = torch.arange(n, dtype=torch.float32, device=dev)

    def chain():
        acc = torch.cat([inst[:, None], inst.new_zeros(n, width - 1)], 1)
        for k, size in enumerate(SIZES):
            pay = size // 4
            row = torch.cat([item[:, None].expand(n, pay),
                             item.new_zeros(n, width - pay)], 1)
            acc = torch.where((pc == 3 + 2 * k)[:, None], row, acc)
        return acc

    ms, _ = device_ms(torch, chain, reps)
    report[key] = {"n": n, "width": width, "phases": len(SIZES) + 1,
                   "select_ms": ms}
    log(f"  publish_payload select (rebuilt): {len(SIZES) + 1} phases x "
        f"[{n:,d}, {width}] f32, {ms:.4f} ms a tick")
    return ms


def sparsetimer_phase(torch, dev, report, n=10_000):
    """[16] sparsetimer @ n, TG_BENCH_SKIP's config, dense then skipped:
    the skipped state equal to the dense one but for the skip's leaves;
    the count scatter runs once every loop iteration of both."""
    from testground_tpu_torch import bench

    outs, results = {}, {}
    for skip in (False, True):
        key = "sparsetimer10k_" + ("skip" if skip else "dense")
        outs[skip], results[skip] = case_run(
            torch, dev, report, key,
            bench.sparsetimer_executable(n, skip, dev),
            lambda r: {"ok": int((r.statuses()[:n] == 1).sum())})
        o = outs[skip]
        log(f"  sparsetimer@{n:,d} {'skipped' if skip else 'dense'}: "
            f"{o['ok']:,d} ok, {o['ticks']} ticks ({o['ticks_executed']} "
            f"executed), {o['wall_seconds']:.3f} s wall "
            f"({o['ms_per_executed_tick']:.2f} ms/executed tick); "
            f"count-scatter launches {o['launches']['count_scatter']}")
        assert launch_bounds(o["ticks_executed"], bench.CHUNK_TICKS,
                             o["launches"]["count_scatter"]), o["launches"]
        assert (o["launches"]["deliver_front"], o["launches"]["ring_merge"]
                ) == (0, 0), o["launches"]
    leaves = bench.check_skip(results[False], results[True], n)
    dense, skipped = outs[False], outs[True]
    report["sparsetimer10k_skip"].update(
        equal_to_dense_leaves=leaves,
        skip_ratio=results[True].skip_ratio,
        speedup=dense["wall_seconds"] / skipped["wall_seconds"])
    log(f"  skipped state equal to the dense one on {leaves} leaves; "
        f"executed/simulated {results[True].skip_ratio:.4f}; wall "
        f"{dense['wall_seconds']:.3f} s dense, "
        f"{skipped['wall_seconds']:.3f} s skipped")
    return outs


def small_cases_phase(torch, dev, report, n=10_000):
    """[17] startup, netinit, netlinkshape and cliff (x on both sides of
    x_fail) @ n, to the end."""
    from testground_tpu_torch.plans import benchmarks
    from testground_tpu_torch.sim import (
        BuildContext, GroupSpec, SimConfig, compile_program,
    )

    runs = [("startup", {}, 1), ("netinit", {}, 1), ("netlinkshape", {}, 1),
            ("cliff", {"x": "0.25", "x_fail": "0.5"}, 1),
            ("cliff", {"x": "0.75", "x_fail": "0.5"}, 2)]
    rows = []
    for case, params, status in runs:
        ctx = BuildContext([GroupSpec("single", 0, n, params)],
                           test_case=case, test_run="chip-smoke")
        ex = compile_program(benchmarks.testcases[case], ctx,
                             SimConfig(quantum_ms=10.0, max_ticks=10_000),
                             device=dev)
        key = f"{case}10k" + (f"_x{params['x']}" if params else "")

        def check(r, status=status):
            st = r.statuses()[:n]
            assert (st == status).all(), (case, params, st)
            assert r.metrics_dropped() == 0
            return {"status": status, "count": n}

        out, res = case_run(torch, dev, report, key, ex, check)
        recs = res.metrics_records()
        if recs:
            vals = sorted({r["value"] for r in recs})
            out["metric"] = {"name": recs[0]["name"], "values": vals[:4]}
        rows.append(out)
        log(f"  {case}@{n:,d} {params or ''}: all "
            f"{'ok' if status == 1 else 'failed'} in {out['ticks']} ticks, "
            f"{out['wall_seconds']:.3f} s wall"
            + (f"; {out['metric']['name']} {out['metric']['values']}"
               if "metric" in out else ""))
        assert all(v == 0 for v in out["launches"].values()), out["launches"]
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        import testground_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 1
    pkg_dir = os.path.dirname(os.path.abspath(testground_tpu_torch.__file__))
    if os.path.dirname(pkg_dir) != ROOT:
        print(f"chip_smoke: the port found at {pkg_dir} is not the one "
              "beside this script", file=sys.stderr)
        return 1
    import numpy as np

    from concurrent.futures import ThreadPoolExecutor

    from testground_tpu_torch.kernels import build as kbuild

    t_start = time.monotonic()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    report = {"device": name, "nvidia_smi": smi,
              "torch": torch.__version__, "cuda": torch.version.cuda}
    log(f"[1] device: {name} | nvidia-smi: {smi} | torch {torch.__version__}"
        f" cuda {torch.version.cuda}")

    # one nvcc per source, started together
    with ThreadPoolExecutor(len(BUILDS)) as pool:
        built = dict(zip(
            [name + "".join(f" -D{d}" for d in defs) for name, defs in BUILDS],
            pool.map(lambda b: kbuild.build(*b), BUILDS)))
    report["build_seconds"] = {k: b[1] for k, b in built.items()}
    for kname, (path, build_s) in built.items():
        log(f"[2] built {kname}: {build_s:.2f} s -> {path.name}")
        ptxas = path.parent / f"{path.stem}.ptxas.txt"
        if ptxas.exists():
            for line in ptxas.read_text().splitlines():
                if "registers" in line or "Compiling" in line:
                    log(f"    {line.strip()}")

    log("[3] deliver-front kernel vs plain on the card")
    rows, max_err = kernel_phase(torch, np, dev, report)
    log("[3a] deliver-front kernel phases (-DFRONT_TRACE build)")
    front_trace_phase(torch, np, dev, report)
    log("[3b] ring-merge kernel vs plain on the card")
    merge_rows, merge_err = merge_phase(torch, np, dev, report)
    log("[3c] ring-merge microbenchmark (plain vs kernel)")
    microbench_phase(report)
    log("[4] dht find-providers @ 10,000 through the fused front")
    dht, fused_state = dht_phase(torch, dev, report, "dht10k", True)
    log("[4b] dht@10k tick under torch.profiler")
    profile_phase(torch, report, "dht10k_profile", dht_exec(10_000, dev),
                  dht["ms_per_tick"])
    log("[5] dht @ 300 through the fused front: GPU vs CPU")
    parity_phase(np, dev, report, "dht300_parity", dht_exec)
    log("[6] gossipsub mesh-propagation @ 4,096, default lowering")
    gossip = gossipsub_phase(torch, dev, report, "gossipsub4096", 4096)
    log("[6b] gossipsub@4,096 tick under torch.profiler")
    profile_phase(torch, report, "gossipsub4096_profile",
                  gossipsub_exec(4096, dev), gossip["ms_per_tick"],
                  warm_ticks=20)
    log("[7] dht find-providers @ 10,000, default lowering")
    dht_default, state = dht_phase(torch, dev, report, "dht10k_default",
                                   None)
    from testground_tpu_torch.sim.state_io import (
        compare_leaves, flatten, state_to_numpy,
    )

    leaves = compare_leaves(
        flatten(state_to_numpy(state)),
        flatten(state_to_numpy(fused_state)),
        "dht@10k default vs fused front", skip=("ticks_executed",))
    report["dht10k_default"]["equal_to_fused_leaves"] = leaves
    log(f"  final state equal to phase 4's on {leaves} leaves "
        "(all but ticks_executed)")
    del state, fused_state
    log("[7b] dht@10k default-lowering tick under torch.profiler")
    profile_phase(torch, report, "dht10k_default_profile",
                  dht_exec(10_000, dev, pallas_front=None),
                  dht_default["ms_per_tick"])
    log("[8] gossipsub @ 300 and dht @ 300, default lowering: GPU vs CPU")
    parity_phase(np, dev, report, "gossipsub300_parity", gossipsub_exec)
    parity_phase(np, dev, report, "dht300_default_parity",
                 lambda n, d: dht_exec(n, d, pallas_front=None))
    log(f"[9] gossipsub mesh-propagation @ {GOSSIP_BIG_N:,d}, default "
        "lowering (bounded append)")
    gossip_big = gossipsub_phase(torch, dev, report, "gossipsub_big",
                                 GOSSIP_BIG_N)
    log(f"[9b] gossipsub@{GOSSIP_BIG_N:,d} tick under torch.profiler")
    profile_phase(torch, report, "gossipsub_big_profile",
                  gossipsub_exec(GOSSIP_BIG_N, dev),
                  gossip_big["ms_per_tick"], warm_ticks=40, window=10)

    log("[10] count-scatter kernel vs plain on the card")
    scatter_rows, scatter_err = scatter_phase(torch, np, dev, report)
    log("[11] storm @ 10,000, unshaped (bench.py's params)")
    storm = storm_phase(torch, dev, report, "storm10k", False)
    log("[11b] storm@10k tick under torch.profiler")
    profile_phase(torch, report, "storm10k_profile",
                  storm_exec(10_000, dev, False),
                  storm["ms_per_executed_tick"])
    log("[12] storm @ 10,000, shaped with churn (TG_BENCH_SHAPED's)")
    storm_shaped = storm_phase(torch, dev, report, "storm10k_shaped", True)
    log("[12b] shaped storm@10k tick under torch.profiler")
    profile_phase(torch, report, "storm10k_shaped_profile",
                  storm_exec(10_000, dev, True),
                  storm_shaped["ms_per_executed_tick"])
    log("[13] storm @ 300, compressed params, unshaped and shaped with "
        "churn: GPU vs CPU")
    parity_phase(np, dev, report, "storm300_parity", graft_storm_exec)
    parity_phase(np, dev, report, "storm300_shaped_parity",
                 lambda n, d: graft_storm_exec(n, d, shaped=True))

    from testground_tpu_torch import bench as tbench

    log(f"[14] barrier @ 10,000 x {BARRIER_ITERS} iterations")
    barrier = barrier_phase(torch, dev, report)
    log("[14b] barrier@10k tick under torch.profiler")
    profile_phase(torch, report, "barrier10k_profile",
                  tbench.barrier_executable(10_000, BARRIER_ITERS, dev),
                  barrier["ms_per_executed_tick"])
    log(f"[15] subtree @ 10,000 x {SUBTREE_ITERS:,d} iterations")
    subtree = subtree_phase(torch, dev, report)
    log("[15b] subtree@10k pump tick under torch.profiler")
    sub_ex = tbench.subtree_executable(10_000, SUBTREE_ITERS, dev)
    profile_phase(torch, report, "subtree10k_profile", sub_ex,
                  subtree["ms_per_executed_tick"])
    state_pass_phase(torch, report, "subtree10k_state_passes", sub_ex)
    payload_select_phase(torch, report, "subtree10k_payload_select", dev)
    del sub_ex
    log("[16] sparsetimer @ 10,000 (TG_BENCH_SKIP's config), dense and "
        "skipped")
    sparse = sparsetimer_phase(torch, dev, report)
    log("[17] startup, netinit, netlinkshape and cliff @ 10,000")
    small_cases_phase(torch, dev, report)
    log("[18] barrier, subtree and sparsetimer (dense and skipped) @ 300: "
        "GPU vs CPU")
    parity_phase(np, dev, report, "barrier300_parity",
                 lambda n, d: tbench.barrier_executable(n, 3, d))
    parity_phase(np, dev, report, "subtree300_parity",
                 lambda n, d: tbench.subtree_executable(n, 20, d))
    for skip in (False, True):
        parity_phase(np, dev, report,
                     f"sparsetimer300_{'skip' if skip else 'dense'}_parity",
                     lambda n, d, skip=skip: tbench.sparsetimer_executable(
                         n, skip, d, rounds=10))
    report["sparsetimer_count_scatter_launches"] = {
        k: v["launches"]["count_scatter"] for k, v in
        (("dense", sparse[False]), ("skip", sparse[True]))}

    front_row = next(r for r in rows if r["n"] == 10_000
                     and r["regime"] == "mixed")
    merge_row = merge_rows[0]  # dht@10k's shape
    scatter_row = scatter_rows[0]  # storm@10k's staging shape
    kernels = {"kernels": [
        {
            "name": "deliver_front",
            "route": "cuda",
            "source": "testground_tpu_torch/csrc/deliver_front.cu",
            "replaces": "testground_tpu/sim/pallas_front.py:214",
            "launches": dht["launches"]["deliver_front"],
            "max_abs_err": max_err,
            "ms": front_row["kernel_ms"],
            "plain_ms": front_row["plain_ms"],
            "bound_ms": front_row["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
        },
        {
            "name": "ring_merge",
            "route": "cuda",
            "source": "testground_tpu_torch/csrc/ring_merge.cu",
            "replaces": "tools/microbench_pallas_append.py:76",
            "launches": dht_default["launches"]["ring_merge"],
            "max_abs_err": merge_err,
            "ms": merge_row["kernel_ms"],
            "plain_ms": merge_row["plain_ms"],
            "bound_ms": merge_row["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
        },
        {
            "name": "count_scatter",
            "route": "cuda",
            "source": "testground_tpu_torch/csrc/count_scatter.cu",
            # no TPU kernel: XLA's scatter-add of count mode
            "replaces": "testground_tpu/sim/net.py:1313",
            "launches": storm["launches"]["count_scatter"],
            "max_abs_err": scatter_err,
            "ms": scatter_row["wrapper_ms"],
            "plain_ms": scatter_row["plain_ms"],
            "bound_ms": scatter_row["bound_ms"],
            "bound_by": "bytes",
            "library_ms": scatter_row["library_ms"],
        },
    ]}
    report["kernels"] = kernels["kernels"]
    report["seconds"] = time.monotonic() - t_start
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(f"done in {report['seconds']:.1f} s")
    print(smi)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
