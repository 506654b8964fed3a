#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``testground_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order (any failure raises and the exit code is not 0):

1. device report: the card's name, and its name and power limit as
   ``nvidia-smi`` gives them;
2. build: the deliver-front kernel from ``testground_tpu_torch/csrc``
   (nvcc, at first use), with its build seconds;
3. kernel vs plain on the card, bit-equal: the seven randomized front
   regimes of the deliver-front tests at N = 10,000 and N = 1,000,003,
   plus a starvation state that must take the reference branch; the
   kernel's, the plain version's and the bound's times for each;
4. the slice at full size: dht find-providers at n = 10,000 (20 ms
   links, 5% loss, 5% churn over 100-5,000 ms, 500 ms query timeout,
   3 retries) through the kernel, to termination, with zero egress
   overflow, zero net and metric drops, and kernel launches equal to
   the ticks that took the kernel branch;
5. the GPU path against the CPU path: dht at n = 300 on both, every
   state leaf bit-equal.

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

def front_case(torch, np, n, seed, dev, pending_p=0.3, send_p=0.5,
               dead_p=0.1, wait_span=5, weird_pay=False, loss=True,
               lat=True, tick=100):
    """A randomized deliver-front state (numpy, from ``seed``): the
    generator of the deliver-front tests, on ``dev``."""
    from testground_tpu_torch.sim import prng
    from testground_tpu_torch.sim.net import NetSpec, init_net_state

    rng = np.random.default_rng(seed)
    spec = NetSpec(
        inbox_capacity=8, payload_len=2, head_k=1, send_slots=max(4, n // 8),
        uses_latency=lat, uses_jitter=False, uses_rate=False, uses_loss=loss,
        pallas_front=True,
    )
    P = spec.payload_len
    net = init_net_state(n, spec, dev)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    net["pend_dest"] = t(np.where(
        rng.random(n) < pending_p, rng.integers(0, n, n), -1
    ).astype(np.int32))
    net["pend_tick"] = t(
        (tick - rng.integers(0, wait_span, n)).astype(np.int32))
    net["pend_tag"] = t(np.zeros(n, np.int32))
    net["pend_port"] = t(rng.integers(0, 5, n).astype(np.int32))
    net["pend_size"] = t(rng.random(n).astype(np.float32) * 64)
    net["pend_pay"] = t(rng.random((n, P)).astype(np.float32))
    if lat:
        net["eg_latency"] = t((rng.random(n) * 5).astype(np.float32))
    if loss:
        net["eg_loss"] = t((rng.random(n) * 0.3).astype(np.float32))
    net["net_enabled"] = t((rng.random(n) > 0.05).astype(np.int32))
    send_dest = np.where(
        rng.random(n) < send_p, rng.integers(0, n, n), -1
    ).astype(np.int32)
    spay = rng.random((n, P)).astype(np.float32)
    if weird_pay:
        spay[rng.random((n, P)) < 0.1] = np.nan
        spay[rng.random((n, P)) < 0.1] = np.inf
        spay[rng.random((n, P)) < 0.1] = 1e-40  # denormal
    send = (
        t(send_dest),
        t(np.zeros(n, np.int32)),
        t(rng.integers(0, 5, n).astype(np.int32)),
        t((rng.random(n) * 64).astype(np.float32)),
        t(spay),
    )
    running = t(rng.random(n) > dead_p)
    key = prng.PRNGKey(seed, device=dev)
    return net, spec, send, running, torch.tensor(tick, dtype=torch.int32,
                                                   device=dev), key


def lane_inputs(torch, net, spec, send, running, tick, key, n):
    """The kernel's inputs, built as ``deliver_front.front`` builds them."""
    from testground_tpu_torch.sim import deliver_front as df
    from testground_tpu_torch.sim import prng

    pend = {k: net[k] for k in df._PEND_KEYS}
    pd0 = torch.where((pend["pend_dest"] >= 0) & ~running, -1,
                      pend["pend_dest"])
    eff_dest = torch.where(pd0 >= 0, pd0, send[0])
    dest_ok = ((net["net_enabled"] > 0) & running).to(torch.int32)
    enab_ok = (net["net_enabled"] > 0) & (
        dest_ok[torch.clamp(eff_dest, 0, n - 1)] > 0)
    wants = (eff_dest >= 0) & running
    age = torch.where(pd0 >= 0, net["pend_tick"], tick)
    wait = torch.clamp(tick - age, min=0)
    eg_loss = net.get("eg_loss")
    u = prng.uniform(key, (n,)) if eg_loss is not None else None
    adm = df.admission_scalars(tick, wants, wait, spec.send_slots)
    return (pend, send, running, enab_ok, net.get("eg_latency"), eg_loss, u,
            adm)


def flat_outputs(res):
    pend, *rest = res
    return [pend[k] for k in sorted(pend)] + list(rest)


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


def device_ms(torch, fn, reps):
    """Device time of one ``fn()`` call: captured once in a CUDA graph and
    replayed ``reps`` times between two CUDA events (host overhead out).
    Returns (ms, how)."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    g.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        g.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps, "cuda-graph replay"


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


def kernel_phase(torch, np, dev, report):
    from testground_tpu_torch.sim import deliver_front as df

    rows = []
    max_err = 0.0
    for n in (10_000, 1_000_003):
        for name, seed, kw in REGIMES:
            net, spec, send, running, tick, key = front_case(
                torch, np, n, seed, dev, **kw)
            ins = lane_inputs(torch, net, spec, send, running, tick, key, n)
            got = df.front_lanes(*ins)
            want = df.front_lanes_plain(*ins)
            ok, err = bit_equal(torch, flat_outputs(got), flat_outputs(want))
            max_err = max(max_err, err)
            if not ok:
                raise AssertionError(f"kernel != plain: {name} @ {n}")
            # the whole dispatch (glue + kernel + record build) against
            # the reference transcription of net.deliver's front
            before = df.front.kernel_ticks
            disp = df.front(net, spec, tick, key, send, running, n)
            assert df.front.kernel_ticks == before + 1, "took the reference"
            ref = df.front_reference(
                spec, tick, ins[6], send, running, ins[0], ins[4], ins[5],
                ins[3])
            ok, _ = bit_equal(torch, flat_outputs(disp), flat_outputs(ref))
            if not ok:
                raise AssertionError(f"front != reference: {name} @ {n}")
            reps = 200 if n <= 10_000 else 50
            k_ms, how = device_ms(torch, lambda: df.front_lanes(*ins), reps)
            p_ms, _ = device_ms(torch, lambda: df.front_lanes_plain(*ins),
                                reps)
            k_eager = eager_ms(torch, lambda: df.front_lanes(*ins), reps)
            moved = nbytes(
                [t for t in ins if not isinstance(t, (dict, tuple))]
                + list(ins[0].values()) + list(ins[1])
                + flat_outputs(got)
            )
            bound_ms = moved / HBM_BYTES_PER_S * 1e3
            row = {
                "regime": name, "n": n, "bit_equal": True,
                "kernel_ms": k_ms, "plain_ms": p_ms,
                "kernel_eager_ms": k_eager, "bound_ms": bound_ms,
                "bytes": moved, "timing": how,
            }
            rows.append(row)
            log(f"  front {name:18s} n={n:>9,d}: kernel {k_ms:.4f} ms "
                f"(eager {k_eager:.4f}), plain {p_ms:.4f} ms, bound "
                f"{bound_ms:.5f} ms ({moved:,d} B), bit-equal")

    # starvation: waits past 4095 ticks must take the reference branch
    n = 10_000
    net, spec, send, running, tick, key = front_case(
        torch, np, n, 7, dev, tick=5000)
    rng = np.random.default_rng(7)
    net["pend_tick"] = torch.as_tensor(
        (5000 - rng.integers(0, 4600, n)).astype(np.int32), device=dev)
    launches, refs = df.front_lanes.launches, df.front.reference_ticks
    disp = df.front(net, spec, tick, key, send, running, n)
    assert df.front.reference_ticks == refs + 1, "starvation took the kernel"
    assert df.front_lanes.launches == launches
    ins = lane_inputs(torch, net, spec, send, running, tick, key, n)
    ref = df.front_reference(spec, tick, ins[6], send, running, ins[0],
                             ins[4], ins[5], ins[3])
    ok, _ = bit_equal(torch, flat_outputs(disp), flat_outputs(ref))
    assert ok, "starvation branch != reference"
    log("  starvation state: reference branch taken, bit-equal")
    report["front"] = rows
    report["front_max_abs_err"] = max_err
    return rows, max_err


# ------------------------------------------------------------------ dht

def dht_exec(n, device, chunk_ticks=32):
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
        churn_end_ms=5_000.0, pallas_front=True,
    )
    return compile_program(dht.find_providers, ctx, cfg, device=device)


def dht_phase(torch, np, dev, report):
    from testground_tpu_torch.sim import deliver_front as df

    n = 10_000
    t0 = time.monotonic()
    ex = dht_exec(n, dev)
    ex.tick_fn()
    build_s = time.monotonic() - t0
    df.reset_counters()
    res = ex.run()
    launches = df.front_lanes.launches
    st = res.statuses()[:n]
    out = {
        "n": n, "ticks": res.ticks, "wall_seconds": res.wall_seconds,
        "ms_per_tick": res.wall_seconds / max(res.ticks, 1) * 1e3,
        "build_seconds": build_s,
        "ok": int((st == 1).sum()), "failed": int((st == 2).sum()),
        "crashed": int((st == 3).sum()),
        "launches": launches, "kernel_ticks": df.front.kernel_ticks,
        "reference_ticks": df.front.reference_ticks,
        "host_reads": df.front.host_reads,
        "host_read_seconds": df.front.host_read_seconds,
        "egress_overflow": res.net_egress_overflow(),
        "net_dropped": res.net_dropped(),
        "metrics_dropped": res.metrics_dropped(),
        "egress_deferred": res.net_egress_deferred(),
        "payload_sanitized": res.net_payload_sanitized(),
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
    }
    report["dht10k"] = out
    log(f"  dht@{n}: {out['ticks']} ticks, {out['wall_seconds']:.3f} s wall "
        f"({out['ms_per_tick']:.2f} ms/tick); {out['ok']} ok / "
        f"{out['failed']} failed / {out['crashed']} churned; kernel "
        f"launches {launches}, reference ticks {out['reference_ticks']}, "
        f"host reads {out['host_reads']} ({out['host_read_seconds']:.3f} s)")
    assert not res.timed_out(), f"timed out at tick {res.ticks}"
    assert out["egress_overflow"] == 0, "egress overflow"
    assert out["net_dropped"] == 0, "inbox drops"
    assert out["metrics_dropped"] == 0, "metric ring too small"
    assert launches > 0 and launches == out["kernel_ticks"], (
        launches, out["kernel_ticks"])
    assert out["ok"] > 0
    return out


def profile_phase(torch, dev, report, wall_ms_per_tick, warm_ticks=100,
                  window=20):
    """Where the dht@10k tick's device time goes: ``window`` ticks after
    ``warm_ticks`` under torch.profiler (CUPTI). Device busy time is the
    sum of the kernels' (and copies') own durations; its share is taken
    against the unprofiled wall per tick of the main run, since the
    profiler slows the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ex = dht_exec(10_000, dev)
    st = ex.init_state()
    for _ in range(warm_ticks):
        st = ex.guarded_tick(st)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(window):
            st = ex.guarded_tick(st)
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
    report["dht10k_profile"] = out
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


def parity_phase(torch, np, dev, report):
    from testground_tpu_torch.sim.state_io import flatten, state_to_numpy

    n = 300
    states, walls = {}, {}
    for d in (dev, "cpu"):
        res = dht_exec(n, d).run()
        states[str(d)] = flatten(state_to_numpy(res.state))
        walls[str(d)] = (res.ticks, res.wall_seconds)
    a, b = states[str(dev)], states["cpu"]
    assert set(a) == set(b), set(a) ^ set(b)
    for k in sorted(a):
        x, y = a[k], b[k]
        assert x.dtype == y.dtype and x.shape == y.shape, k
        if x.dtype.kind == "f":
            x, y = x.view(np.int32), y.view(np.int32)
        assert np.array_equal(x, y), f"GPU != CPU at leaf {k}"
    report["dht300_parity"] = {
        "leaves": len(a), "bit_equal": True,
        "gpu": walls[str(dev)], "cpu": walls["cpu"],
    }
    log(f"  dht@{n}: GPU vs CPU bit-equal over {len(a)} leaves "
        f"(ticks {walls[str(dev)][0]}, GPU {walls[str(dev)][1]:.2f} s, "
        f"CPU {walls['cpu'][1]:.2f} s)")


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

    from testground_tpu_torch.kernels import build as kbuild
    from testground_tpu_torch.sim import deliver_front as df

    t_start = time.monotonic()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    report = {"device": name, "nvidia_smi": smi,
              "torch": torch.__version__, "cuda": torch.version.cuda}
    log(f"[1] device: {name} | nvidia-smi: {smi} | torch {torch.__version__}"
        f" cuda {torch.version.cuda}")

    path, build_s = kbuild.build("deliver_front")
    report["build_seconds"] = build_s
    ptxas = path.parent / f"{path.stem}.ptxas.txt"
    log(f"[2] built deliver_front: {build_s:.2f} s -> {path.name}")
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "Compiling" in line:
                log(f"    {line.strip()}")

    log("[3] deliver-front kernel vs plain on the card")
    rows, max_err = kernel_phase(torch, np, dev, report)

    log("[4] dht find-providers @ 10,000 through the kernel")
    dht = dht_phase(torch, np, dev, report)

    log("[4b] dht@10k tick under torch.profiler")
    profile_phase(torch, dev, report, dht["ms_per_tick"])

    log("[5] dht @ 300: GPU path vs CPU path")
    parity_phase(torch, np, dev, report)

    main_row = next(r for r in rows if r["n"] == 10_000
                    and r["regime"] == "mixed")
    kernels = {"kernels": [{
        "name": "deliver_front",
        "route": "cuda",
        "source": "testground_tpu_torch/csrc/deliver_front.cu",
        "replaces": "testground_tpu/sim/pallas_front.py:214",
        "launches": dht["launches"],
        "max_abs_err": max_err,
        "ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }]}
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
