#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``testground_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order (any failure raises and the exit code is not 0). The CPU
side of every GPU-vs-CPU phase (5, 8, 13, 18, 23, 28, 32, 35, 40, 47) runs
in one child process (multiprocessing, spawn) started before phase 1,
its torch threads capped at half the host's cores; it hands each phase
its final CPU state (or, for 40 and 47, its run directory), and a
failure there fails the phase.

1. device report: the card's name, and its name and power limit as
   ``nvidia-smi`` gives them;
2. build: the three kernels from ``testground_tpu_torch/csrc``, the
   deliver-front kernel's -DFRONT_TRACE build and the count scatter's
   -DSCATTER_TRACE build, one nvcc per source, started together, with
   their build seconds; then each kernel's ``torch.library`` custom op
   dispatched once on tiny CPU tensors, with its seconds (a process's
   first custom-op dispatch imports much of torch, once);
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
   N = 10,000, gossipsub@1M's shape (N = 1,048,576, CAP 64, W 6),
   splitbrain-sampled@100k's (N = 100,000, CAP 64, W 7), the
   microbenchmark's shapes at N = 100,000, 1,000,000 and 1,000,003,
   k_eff of 0 / random / A, k_eff = CAP on a full ring, w near 2**30 and
   A > CAP, the inputs made on the card from a ``torch.Generator``;
   kernel, plain (3 repetitions at the ~1M-row shapes), ``ring.clone()``
   and bound times;
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
   N = 1,000,003 (uniform, 7 rows), the wheel shape 64 x 10,000
   (uniform, a storm tick, one bucket), sparsetimer's beat, and the
   64-seed sweep's folded call (64 storm ticks, 640,000 rows and lanes);
   the whole function under the
   plan it picks, the plain version, ``index_add_`` and the bound; where
   the time goes (small plan: the trace build's per-block phases; large
   plan at 1M uniform and at the sweep's folded call: time by kernel
   under ``torch.profiler``);
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
   CPU path, every state leaf bit-equal;
19. the network plan's ping-pong, traffic-allowed and traffic-blocked at
   n = 2: all ok (the plan asserts ping-pong's RTT windows, 200-215 ms
   and 20-35 ms, and the dial's outcome with and without a DROP pair
   rule), with the RTTs measured;
20. splitbrain's all-pairs drop, reject and accept at n =
   ``SPLITBRAIN_ALL_N``: every instance ok (each asserts its probes'
   outcomes against the policy), errors on {A, B} pairs only;
21. splitbrain's drop-sampled, reject-sampled and accept-sampled at
   n = 100,000 x 8 probes (class rules, dials behind the egress queue of
   12,500 slots, the bounded append): every instance ok, errors > 0 but
   for accept, zero inbox drops, overflow and abandoned sends; ticks,
   wall, ms/tick, peak memory, deferred sends, and the ring-merge kernel
   once every loop iteration; 21b. a profiler window over drop-sampled's
   tick;
22. every case of the example, placebo and verify plans at its
   manifest's largest instance count, with the outcome the case gives;
23. splitbrain drop-sampled, and a class-rule dialing program behind an
   egress queue of 32 slots (so the ring-merge kernel runs on the card
   and the plain merge on the CPU), at n = 300: GPU path vs CPU path,
   every state leaf bit-equal;
24. storm at n = 10,000 under ``bench.py``'s fault timeline (three
   degrade windows, a partition and its heal, two 1% kills, one
   restart; churn-tolerant rendezvous, 3 SYN retries at 1 s): no
   timeout, a restart, the still-dead victims crashed and every
   survivor ok; the degrade windows force latency, so the count scatter
   runs on the delay wheel once a loop iteration; 24b. a profiler
   window inside the degrade windows;
25. storm at n = 10,000 traced (64-slot rings): all ok, events
   recorded; 25b. a profiler window;
26. storm at n = 10,000 sampled (interval 100, every probe storm can
   record, 1,000 sample rows): all ok, samples taken; 26b. a profiler
   window, and the loop's whole-state passes on the sampled state and
   on phase 11's; 26c. storm with an empty [faults] and a disabled
   [trace] and [telemetry]: phase 11's state leaves, and the same
   device ops (kernels, copies, fills) in the CUDA graph of its loop
   iteration, counted by node type in the kept graphs;
   each of 24-26 reports ms per tick, ticks and ticks executed, victims
   and restarts, trace events and drops, telemetry samples and clipped
   rows, peak memory and count-scatter launches;
27. faultsdemo's chaos case at n = 4 and 1,024 (its manifest's largest)
   with its composition's [faults], [trace] and [telemetry] tables:
   every instance ok (PASS), the victim restarted;
28. storm at n = 300 with the compressed params under all three planes
   (the timeline compressed with the dial window), and faultsdemo at
   n = 300: GPU path vs CPU path, every state leaf bit-equal;
29. ``bench --replay``'s legs at n = 10,000: storm with a disabled
   [replay] table builds phase 11's state leaves, runs its ops a tick
   and captures the same graph nodes as [26c]'s storm; the echo
   workload (32 requests a lane, every 50 ticks) self-driven and
   replayed, and a sparse trace (every 1,000 ticks) that consumes all
   320,000 arrivals under half its ticks; ms per executed tick,
   arrivals/s, and no kernel launched (the echo has no data plane);
30. ``bench --drain``'s legs at n = 10,000: sparsetimer (24 of its 40
   rounds of 50 ms, dense, 100-tick chunks) traced
   and sampled; the drain flag
   changes no leaf, no tick op and no captured graph node; the drained
   runs (16 slots a lane, 3 sample rows) drop and clip nothing, stream
   what an undrained 1,024-slot run demuxes, and capture the loop
   iteration once a run; overhead, cost a batch, and the count scatter
   once a loop iteration of the drained run;
31. the election plan's quorum case with its composition's [replay] and
   [faults] at n = 5 and at 1,024 (its manifest's largest, with the
   sized timeout and run length): PASS, with the JAX package's tick
   count, fewest leader changes, requests served and arrivals
   consumed (``election.JAX_OUTCOMES``);
32. GPU vs CPU at n = 300, every state leaf bit-equal: the replayed
   echo dense and skipped, a drained sparsetimer (and its three streamed
   files byte-equal), and election at 5 under its composition;
33. ``bench --sweep``'s legs at n = 10,000: storm with bench.py's params
   over 64 seeds as one scenario-batched run (the loop iteration vmapped
   over the scenario axis, captured once in a CUDA graph): every
   scenario all ok with no drop, one capture, the count scatter once a
   batched iteration (its vmap rule folds the 64 scenarios into one
   launch of 640,000 rows and lanes); a serial sample of 1 seed (bench
   --sweep takes 2), its own executable and capture; scenarios/s
   batched and serial; and scenarios 0, 31 and 63 equal to their serial
   runs on every leaf;
   33b. a profiler window over the batched iteration;
34. ``bench --search``: cliff's edge at n = 10,000 by bisection over a
   257-value grid, 8 scenarios a round through one sweep executable
   rebound every round: one capture, at most ceil(log2 257) + 1 = 10
   rounds (as JAX's search_main counts its grid), the edge at the
   first grid value above x_fail = 0.663;
35. storm at n = 300 shaped with churn under the compressed fault
   timeline, swept over 4 seeds (600 ticks), on the card and on the CPU:
   every scenario's every state leaf bit-equal;
36. bench.py's storm at n = 10,000 as a composition through the runner
   (``run_composition``, its chunk the watchdog tier of 8,192 ticks):
   success, phase 11's ticks and count-scatter launches, the combined
   results.out and every summary key; its host spans, and its dispatch
   wall within 10% of the direct run's (phase 11's executor, built again
   and run right after it, so that both meet the card and the host in
   the same state; phase 11's own wall is reported beside it);
37. phase 4's dht at n = 10,000 with the fused front through the runner:
   phase 4's ticks, outcomes and front and merge launches;
38. prewarm, then the storm composition: memory_hit, compiles 0, no
   capture, [36]'s summary; storm in 512-tick chunks checkpointed at
   every boundary, preempted at boundary 3 and resumed with no capture:
   summary, run.out and results.out equal to the uninterrupted run's; a
   terminated run;
39. the memory model: the peak above the memory allocated before the run
   against the state model, of the runner's storm and dht at 10,000
   ([36], [37]), sampled storm at 10,000 ([26]) and gossipsub at
   1,048,576 ([9]), the worst ratio at least the runner's fraction; a
   traced storm (400 ticks) through the runner under a forced
   ``TESTGROUND_HBM_BYTES`` that shrinks its ring, its peak under the
   forced budget;
40. storm (compressed params) and faultsdemo's composition (traced and
   sampled) at n = 300 through the runner on the card and on the CPU:
   every deterministic summary key, run.out, output file and progress
   row equal;
41. ``python -m testground_tpu_torch healthcheck --fix`` and ``run
   composition plans/faultsdemo/composition.toml`` as subprocesses: exit
   0, PASS;
42. storm at n = 10,000 (phase 11's) swept over 16 seeds as a [sweep]
   composition through the runner, its chunk left to it: every scenario
   ok, one capture, one folded count-scatter launch a batched
   iteration, scenario 0's results.out and row equal to [36]'s run of
   seed 0; scenarios/s, its dispatch wall against the direct batched
   run of the same 16 seeds, the host spans and the demux seconds a
   scenario;
43. the same sweep under a forced ``TESTGROUND_HBM_BYTES`` that holds 8
   of its scenarios: 2 scenario chunks, preempted inside chunk 1 and
   resumed with no capture; every scenario's files and row equal to
   [42]'s;
44. phase 7's dht at n = 10,000 (default lowering) swept over 8 seeds
   through the runner: one capture, the ring merge's folded launch once
   a batched iteration, every scenario's ticks and outcome equal to
   phase 7's executable built with its seed;
45. searches through the runner: phase 34's cliff bisect as a [search]
   composition (its rounds and edge, one capture); faultsdemo's
   composition at 1,024 with its own [search] enabled (rounds,
   breaking_point, one capture); that search preempted after round 0
   and resumed, its roll-up, run.out and probe files equal to the
   uninterrupted one's;
46. device leases: two runner runs on threads (storm@10k cut at 300
   ticks), granted together under the card's budget, one at a time
   under a forced lease budget that holds one; both journals carry
   ``lease``;
47. a storm sweep at n = 300 over 4 seeds in chunks of 2, and a cliff
   bisect at 64, through the runner on the card and on the CPU: every
   deterministic key, run.out, scenario and probe file and progress row
   equal;
48. the daemon as users start it: ``python -m testground_tpu_torch
   daemon --listen 127.0.0.1:0`` (on the card) with its own
   ``TESTGROUND_HOME`` and a bearer token; through its client, [36]'s
   storm@10k and [37]'s fused dht@10k compositions submitted at once
   (two scheduler workers, device leases): each collected tarball's
   results.out, run.out and deterministic summary keys equal to the
   in-process run's; each task's queue wait, dispatch and
   submit-to-complete;
49. the serving surface: storm cut at 300 ticks twice (the second a pool
   hit: memory_hit, compiles 0, no capture; ``/cache`` lists it),
   ``/metrics``' lease and pool counters, ``/progress`` snapshots while
   two storm@10k runs (512-tick chunks) run, ``kill`` of a task queued
   behind them, ``kill`` terminating one at a chunk boundary (outcome
   terminated), SIGTERM to the daemon preempting the other, and the
   daemon restarted on the same home resuming it (``/resume``) to
   [36]'s results.out;
50. [28]'s storm at 300 under its three planes, and a 2-seed [sweep] of
   it, as compositions through the card daemon and a ``--device cpu``
   daemon (started with the card's, its runs submitted before [48]):
   every deterministic key, run.out, output file, scenario and progress
   row equal;
51. ``bench --live`` at n = 10,000 (``bench.live_leg``; sparsetimer dense
   in 128-tick chunks, 24 of its 50 timer rounds, one run plain and one
   streaming progress rows through ``boundary_callback``): the loop
   iteration's ops and graph nodes equal with and without the sink,
   before and after the streamed run; one row a boundary, ticks sorted,
   every instance ok; the overhead against the 5% target, reported;
52. ``bench --metrics`` at 10,000 (three pairs of runs, plain and
   instrumented, in turns; the median pair's overhead): the same identity, the
   profiler's chunks equal to its journal's, ``tg_run_chunk_seconds`` and
   ``tg_bench_chunks_total`` in the exposition, and the overhead under
   5% (asserted: the plain runs take more than bench.py's 2 s floor);
53. ``bench --ckpt`` at 10,000: the same identity, a snapshot at every
   boundary, and a run resumed from the last one bit-equal to the
   uninterrupted run; the overhead, reported;
54. ``bench --compile``: the faultsdemo chaos ladder's six combos built
   and captured on the card, each one's ops (its CPU build's) and graph
   nodes within ``testground_tpu_torch/tools/op_budgets.json``;
55. ``check_contracts`` on the card: every ported contract holds (ops and
   graph nodes), warmstart and prewarm shown as not ported;
56. the command line in this process (``cli.main``, what ``python -m
   testground_tpu_torch`` calls): ``run single --plan benchmarks
   --testcase storm --instances 10000 --runner sim:jax --builder
   sim:module`` with bench.py's params and [36]'s run config: exit 0,
   outcome success, [36]'s count-scatter launches, every summary counter,
   run.out and results.out equal to [36]'s (the journal's checkpoint,
   live and host-span entries aside), its dispatch beside [36]'s;
57. faultsdemo @ 4 through ``run composition`` in 50-tick chunks
   checkpointed at every boundary: whole (exit 0), preempted at boundary
   3 (exit 3, the JAX command's code for ``preempted``), then ``run
   --resume TASK_ID`` (exit 0) with the whole run's files;
58. at 200 instances or fewer, each run held to the same composition
   written out by hand: a templated faultsdemo (``{{ .Env.X }}``
   counts), ``--drain`` on faultsdemo (traced and sampled), ``--replay
   plans/election/replay.jsonl --replay-scale 2`` on election, ``--runner
   sim:jax`` on a local:exec placebo; then ``build composition`` and
   ``build purge``;
59. the fleet comes up: a coordinator and two worker daemons on the card
   (``python -m testground_tpu_torch daemon``, the coordinator with a
   ``--peer`` for each worker; each worker's ``/metrics`` also carries
   its kernels' launch counts), each its own process and home: the
   seconds until ``/federation`` shows both workers alive, each one's
   fingerprint naming the card;
60. compile-on-upload: dht @ 10,000 with the fused front prewarmed
   through the coordinator (``miss`` on the worker it routes to), then
   run once that worker's heartbeat names its affinity digest: routed to
   the same worker, ``memory_hit``, ``compiles: 0``, the worker's front
   and merge launches across prewarm and run equal to [37]'s, and
   results.out, run.out and the summary (collected through the
   coordinator) equal to [37]'s; submit-to-complete of both tasks;
61. dht @ 10,000 (to its warm worker) and storm @ 10,000 cut at 1,000
   ticks (to the other; an in-process run of the same cut, made just
   before [59], is its reference) submitted at once: each with its
   in-process run's outcome and files,
   ``tg_fed_routes_total`` at least 3 under ``worker=`` labels and
   ``tg_tasks_queue_depth`` from 3 sources in the coordinator's merged
   ``/metrics``; the fleet's wall beside the two runs' serial sum;
62. storm @ 10,000 routed to the worker that holds it warm, SIGKILLed
   while it runs: the coordinator marks the worker lost and requeues the
   run on the survivor (``resume``), where it ends ``success`` with the
   attempt counted and [36]'s files; then the fleet is stopped.

The last lines are a table of the ten slowest phases, the card's
nvidia-smi line, one JSON object with the kernel measurements, and
``{"ok": true, "device": {...}}``; before them, this run's storm@10k
ms/tick [11], runner dispatch [36] and sweep scenarios/s [42] beside
R14f's. Everything
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


_T0 = time.monotonic()


# (phase label, start) of each phase header logged, in order
PHASE_STARTS: list = []


def log(msg: str) -> None:
    """Print a line; a phase's header (``[n] ...``) with the seconds since
    the script started, its start kept for the closing table."""
    if msg.startswith("["):
        t = time.monotonic()
        PHASE_STARTS.append((msg.split("]", 1)[0] + "]", t))
        msg = f"{msg}  (t = {t - _T0:.1f} s)"
    print(msg, flush=True)


def phase_seconds(end: float) -> dict:
    """Seconds by phase label, a phase running until the next header
    (the last until ``end``); a label's sub-phases (``[3a]``) apart."""
    out: dict = {}
    marks = PHASE_STARTS + [("end", end)]
    for (label, t0), (_, t1) in zip(marks, marks[1:]):
        out[label] = out.get(label, 0.0) + (t1 - t0)
    return out


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
# the card; the first rows are the main paths' shapes (dht@10k,
# gossipsub@1M, splitbrain-sampled@100k)
MERGE_CASES = [
    ("dht", 10_000, "k_random", 32, 7, 8),
    ("gossipsub", GOSSIP_BIG_N, "k_random", 64, 6, 8),
    ("splitbrain", 100_000, "k_random", 64, 7, 8),
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


# the plain merge's repetitions at the ~1M-row shapes of [3b]
MERGE_PLAIN_REPS_1M = 3


def first_dispatch(torch):
    """One call of each kernel's ``torch.library`` custom op on tiny CPU
    tensors: a process's first dispatch of a custom op imports much of
    torch (~2 s on a CPU host), a one-time cost that would otherwise
    land in whichever phase calls a kernel first ([3b])."""
    from testground_tpu_torch.sim import count_scatter as csc
    from testground_tpu_torch.sim import ring_merge as rm

    i32 = torch.int32
    rm.merge(torch.zeros(2, 4, 3), torch.zeros(2, dtype=i32),
             torch.zeros(2, dtype=i32), torch.zeros(4, 3))
    csc.scatter_add(torch.zeros(3, 2), torch.zeros(4, dtype=i32),
                    torch.ones(4, 2))


def merge_case_on(torch, dev, name, n, seed, cap=32, width=7, A=8):
    """Ring-merge inputs made on ``dev`` from an explicit
    ``torch.Generator`` seeded with ``seed`` (on the card for [3b]: a host
    build of the ~1M row cases took most of that phase): ring f32
    [n, cap, width], w and k_eff int32 [n], staging f32 [A*n, width].
    ``name`` picks the counts: k_zero (nothing lands), k_random, k_all
    (A per row), full_ring (k_eff = cap: every slot written), w_near_2_30,
    a_over_cap (random counts; with A > cap later passes overwrite
    earlier ones)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    f32, i32 = torch.float32, torch.int32

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev, dtype=f32)

    def ints(lo, hi):
        return torch.randint(lo, hi, (n,), generator=g, device=dev,
                             dtype=i32)

    ring = rand(n, cap, width) * 100
    arr = rand(A * n, width) * 100 + 200
    w = ints(0, 10_000)
    if name == "k_zero":
        k = torch.zeros(n, dtype=i32, device=dev)
    elif name in ("k_random", "a_over_cap"):
        k = ints(0, A + 1)
    elif name == "k_all":
        k = torch.full((n,), A, dtype=i32, device=dev)
    elif name == "full_ring":
        k = torch.full((n,), cap, dtype=i32, device=dev)
    elif name == "w_near_2_30":
        w = 2**30 - ints(0, 3 * cap)
        k = ints(0, A + 1)
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
        t_case = time.monotonic()
        ring, w, k, arr = merge_case_on(torch, dev, case, n, seed, cap,
                                        width, A)
        got = rm.merge(ring, w, k, arr)
        want = rm.merge_plain(ring, w, k, arr)
        ok, err = bit_equal(torch, [got], [want])
        max_err = max(max_err, err)
        if not ok:
            raise AssertionError(f"ring merge kernel != plain: {label} "
                                 f"{case} @ {n}")
        reps = 200 if n <= 10_000 else 20
        # the plain version is no yardstick (PERF.md §6): few repetitions
        # at the ~1M-row shapes
        plain_reps = reps if n < 1_000_000 else MERGE_PLAIN_REPS_1M
        calls = calls_for(n)
        k_ms, how = device_ms(torch, lambda: rm.merge(ring, w, k, arr), reps,
                              calls)
        p_ms, _ = device_ms(torch, lambda: rm.merge_plain(ring, w, k, arr),
                            plain_reps, calls)
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
            "plain_ms": p_ms, "plain_reps": plain_reps, "clone_ms": c_ms,
            "bound_ms": bound_ms, "bytes": moved, "timing": how,
            "case_seconds": time.monotonic() - t_case,
        })
        log(f"  merge {label:11s} {case:12s} n={n:>9,d} cap={cap:2d} "
            f"W={width} A={A}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"clone {c_ms:.4f} ms, bound {bound_ms:.4f} ms, bit-equal "
            f"({rows[-1]['case_seconds']:.2f} s)")
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

def dht_exec(n, device, chunk_ticks=32, pallas_front=True, seed=0):
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
        churn_end_ms=5_000.0, pallas_front=pallas_front, seed=seed,
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
    from testground_tpu_torch import bench

    bench.kernel_launches(reset=True)


def other_launches():
    """Launches of the three kernels since the last reset."""
    from testground_tpu_torch import bench

    return bench.kernel_launches()


def case_run(torch, dev, report, key, ex, check):
    """Run the executor ``ex`` to the end with the launch counts reset
    just before; ``check(res)`` gives the case's own summary (and
    asserts). Returns (the report row, the result)."""
    t0 = time.monotonic()
    ex.tick_fn()
    build_s = time.monotonic() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    reset_launch_counts()
    res = ex.run()
    launches = other_launches()
    out = {
        "ticks": res.ticks, "ticks_executed": res.ticks_executed,
        "event_skip": ex.event_skip, "wall_seconds": res.wall_seconds,
        "capture_seconds": res.capture_seconds,
        "ms_per_tick": res.wall_seconds / max(res.ticks, 1) * 1e3,
        "ms_per_executed_tick": (res.wall_seconds
                                 / max(res.ticks_executed, 1) * 1e3),
        "build_seconds": build_s, "launches": launches,
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
        # the run's own peak ([39]'s memory model): state and capture
        "peak_bytes": torch.cuda.max_memory_allocated(dev) - base,
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

    from testground_tpu_torch.sim.sweep import state_bytes

    out, res = case_run(torch, dev, report, key, ex, check)
    out["state_model_bytes"] = state_bytes(ex)  # for [39]
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
    the host. A sweep executable steps its batched iteration (every
    scenario's tick at once)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # as run() steps: CUDA-graph replays
    if hasattr(ex, "chunk_stepper"):
        st, step = ex.chunk_stepper(0)
    else:
        st = ex.init_state()
        step = ex.stepper(st)
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
    # the 64-seed storm@10k sweep's folded call (the vmap rule, [33]):
    # 64 scenarios' staging rows and their storm ticks, lane after lane
    ("sweep", 64 * 10_000, 64 * 10_000, "storm_sweep"),
]
STORM_KEPT = 470 / 10_000  # storm@10k's data lanes a tick
SWEEP_SEEDS = 64  # bench --sweep's scenarios (testground_tpu_torch.bench)


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
    if case == "storm_sweep":
        # SWEEP_SEEDS storm ticks folded as the vmap rule folds them:
        # scenario s's lanes and rows at s * R, its drops at rows
        per = rows // SWEEP_SEEDS
        b, i, u = zip(*(scatter_case(np, per, lanes // SWEEP_SEEDS, "storm",
                                     seed * 1_000 + s)
                        for s in range(SWEEP_SEEDS)))
        idx = [np.where(x < per, x + s * per, rows) for s, x in enumerate(i)]
        return (np.concatenate(b), np.concatenate(idx).astype(np.int32),
                np.concatenate(u))
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
        elif case in ("uniform", "storm_sweep"):
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


def parity_phase(np, dev, report, key, n=300):
    """One composition at ``n`` on the card, and its CPU side from the
    child (``cpu_side``): every state leaf bit-equal."""
    from testground_tpu_torch.sim.state_io import (
        compare_leaves, flatten, state_to_numpy,
    )

    states, walls = {}, {}
    res = parity_maker(key, CPU_DIR)(n, dev).run()
    states[str(dev)] = flatten(state_to_numpy(res.state))
    walls[str(dev)] = (res.ticks, res.wall_seconds)
    states["cpu"], walls["cpu"] = cpu_side(key)
    leaves = compare_leaves(states[str(dev)], states["cpu"],
                            f"{key}: GPU vs CPU")
    report[key] = {
        "leaves": leaves, "bit_equal": True,
        "gpu": walls[str(dev)], "cpu": walls["cpu"],
    }
    log(f"  {key}: GPU vs CPU bit-equal over {leaves} leaves "
        f"(ticks {walls[str(dev)][0]}, GPU {walls[str(dev)][1]:.2f} s, "
        f"CPU {walls['cpu'][1]:.2f} s)")



# ------------------------------------------- the CPU sides, in a child
#
# Every GPU-vs-CPU phase ([5], [8], [13], [18], [23], [28], [32], [35],
# [40], [47]) runs its CPU side in ONE child process (multiprocessing,
# spawn), started at the top of the script with its torch threads capped
# at half the host's cores: the child runs the CPU sides in the order the
# phases read them while the card runs the other phases, and hands each
# phase its final CPU state (every leaf, as numpy arrays) or, for the
# runner's phases, its run directory. A failure in the child fails the
# phase that reads it; nothing falls back to an in-line CPU run.

# the CPU sides' outputs (runner run directories, the drain's files)
CPU_DIR = ""
# key -> Future of the child's result
CPU_SIDES: dict = {}
# (key, n) of the state parity phases, in the order the phases read them
CPU_PARITY = (
    ("dht300_parity", 300), ("gossipsub300_parity", 300),
    ("dht300_default_parity", 300), ("storm300_parity", 300),
    ("storm300_shaped_parity", 300), ("barrier300_parity", 300),
    ("subtree300_parity", 300), ("sparsetimer300_dense_parity", 300),
    ("sparsetimer300_skip_parity", 300), ("splitbrain300_parity", 300),
    ("classdials300_parity", 300), ("storm300_planes_parity", 300),
    ("faultsdemo300_parity", 300), ("replay300_dense_parity", 300),
    ("replay300_skip_parity", 300),
)
CPU_RUNNER_KEYS = ("storm300", "faultsdemo300", "storm300_sweep",
                   "cliff64_search")


def cpu_threads() -> int:
    """The child's torch threads: half the host's cores."""
    return max(1, (os.cpu_count() or 2) // 2)


def _cpu_child_init(root: str, threads: int) -> None:
    sys.path.insert(0, root)
    import torch

    torch.set_num_threads(threads)
    try:
        torch.set_num_interop_threads(threads)
    except RuntimeError:
        pass
    # heartbeat rows count wall time: none in a parity pair
    os.environ["TG_DISPATCH_HEARTBEAT_S"] = "86400"


def parity_maker(key, tmp):
    """The executable maker ``make(n, device)`` of a state parity phase
    (``tmp``: where the echo trace is written)."""
    from testground_tpu_torch import bench as tb
    from testground_tpu_torch.plans import election as telection
    from testground_tpu_torch.plans import faultsdemo as tdemo

    def echo(skip):
        def make(n, d):
            path = os.path.join(tmp, f"echo-{os.getpid()}.jsonl")
            if not os.path.exists(path):
                tb.write_echo_trace(path, n)
            return tb.echo_executable(n, d, path, event_skip=skip)
        return make

    return {
        "dht300_parity": dht_exec,
        "gossipsub300_parity": gossipsub_exec,
        "dht300_default_parity":
            lambda n, d: dht_exec(n, d, pallas_front=None),
        "storm300_parity": graft_storm_exec,
        "storm300_shaped_parity":
            lambda n, d: graft_storm_exec(n, d, shaped=True),
        "barrier300_parity": lambda n, d: tb.barrier_executable(n, 3, d),
        "subtree300_parity": lambda n, d: tb.subtree_executable(n, 20, d),
        "sparsetimer300_dense_parity":
            lambda n, d: tb.sparsetimer_executable(n, False, d, rounds=10),
        "sparsetimer300_skip_parity":
            lambda n, d: tb.sparsetimer_executable(n, True, d, rounds=10),
        "splitbrain300_parity":
            lambda n, d: tb.splitbrain_executable(n, d, "drop-sampled"),
        "classdials300_parity": queued_class_exec,
        "storm300_planes_parity": planes_storm_exec,
        "faultsdemo300_parity": lambda n, d: tdemo.chaos_executable(
            n, d, chunk_ticks=32, max_ticks=2_000),
        "replay300_dense_parity": echo(False),
        "replay300_skip_parity": echo(True),
        "election5_parity": lambda n, d: telection.election_executable(n, d),
    }[key]


def cpu_state_job(key, n, tmp):
    """[child] a state parity phase's CPU side: (leaves, (ticks, wall))."""
    from testground_tpu_torch.sim.state_io import flatten, state_to_numpy

    res = parity_maker(key, tmp)(n, "cpu").run()
    return flatten(state_to_numpy(res.state)), (res.ticks, res.wall_seconds)


def cpu_drain_job(n, out_dir):
    """[child] [32]'s drained sparsetimer on the CPU into ``out_dir``:
    (leaves, the drain's stats)."""
    from pathlib import Path

    from testground_tpu_torch import bench
    from testground_tpu_torch.sim.state_io import flatten, state_to_numpy

    res, dr = bench.drained_run(bench.drain_executable(n, "cpu", rounds=10),
                                Path(out_dir))
    return flatten(state_to_numpy(res.state)), dr.stats()


def cpu_sweep_job(n, seeds):
    """[child] [35]'s shaped fault sweep on the CPU: (each scenario's
    leaves, (iterations, wall, captures))."""
    from testground_tpu_torch.sim.state_io import flatten, state_to_numpy

    ex = shaped_fault_sweep(n, "cpu", seeds)
    res = ex.run()
    return ([flatten(state_to_numpy(res.scenario(s).state))
             for s in range(seeds)],
            (res.ticks, res.wall_seconds, ex.captures))


def cpu_runner_job(key, cpu_dir):
    """[child] a runner parity phase's composition run on the CPU into
    ``cpu_dir``; its seconds."""
    from testground_tpu_torch.sim import runner

    runner.clear_executor_pool()
    t0 = time.monotonic()
    runner.run_composition(runner_parity_input(key, cpu_dir, "cpu"),
                           device="cpu")
    return time.monotonic() - t0


def start_cpu_sides(cpu_dir):
    """The child, with every CPU side submitted in the order the phases
    read them; returns the executor."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"),
        initializer=_cpu_child_init, initargs=(ROOT, cpu_threads()))
    for key, n in CPU_PARITY:
        CPU_SIDES[key] = pool.submit(cpu_state_job, key, n, cpu_dir)
    CPU_SIDES["drain300"] = pool.submit(
        cpu_drain_job, 300, os.path.join(cpu_dir, "drain_cpu"))
    CPU_SIDES["election5_parity"] = pool.submit(
        cpu_state_job, "election5_parity", 5, cpu_dir)
    CPU_SIDES["sweep300"] = pool.submit(cpu_sweep_job, 300, 4)
    for key in CPU_RUNNER_KEYS:
        CPU_SIDES[key] = pool.submit(cpu_runner_job, key, cpu_dir)
    return pool


# seconds the phases waited for the child, by key
CPU_WAITS: dict = {}


def cpu_side(key):
    """The child's result for ``key`` (raises what the child raised)."""
    t0 = time.monotonic()
    out = CPU_SIDES[key].result()
    CPU_WAITS[key] = time.monotonic() - t0
    return out


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


# ----------------------------------------------- the entry-mode plans

SPLITBRAIN_ALL_N = 256  # the reference's CI scale for the all-pairs cases
SPLITBRAIN_N = 100_000  # the sampled cases' full width, 8 probes a node
# each case at its manifest's largest instance count (plans/*/manifest.toml)
SMALL_PLAN_RUNS = (
    [("example", c, 200) for c in ("output", "failure", "panic", "params",
                                    "sync", "metrics", "artifact")]
    + [("placebo", "ok", 200)]
    + [("placebo", c, 250) for c in ("panic", "stall", "abort", "metrics")]
    + [("verify", "uses-data-network", 200)]
)


def plan_exec(plan, case, n, device):
    """A plan's case at ``n`` instances in one group, default SimConfig
    but the bench's chunk."""
    import importlib

    from testground_tpu_torch import bench
    from testground_tpu_torch.sim import (
        BuildContext, GroupSpec, SimConfig, compile_program,
    )

    mod = importlib.import_module(f"testground_tpu_torch.plans.{plan}")
    ctx = BuildContext([GroupSpec("single", 0, n, {})], test_case=case,
                       test_run="chip-smoke")
    return compile_program(mod.testcases[case], ctx,
                           SimConfig(chunk_ticks=bench.CHUNK_TICKS),
                           device=device)


def network_phase(torch, dev, report):
    """[19] the network plan's three cases at n = 2."""
    rows = []
    for case in ("ping-pong", "traffic-allowed", "traffic-blocked"):
        def check(res):
            st = res.statuses()[:2]
            assert (st == 1).all(), (case, st)
            return {"ok": 2, "rtt_ms": {
                f"{r['name']}/{r['instance']}": r["value"] * 1e3
                for r in res.metrics_records()
                if r["name"].startswith("ping_rtt")}}

        out, _ = case_run(torch, dev, report, f"network_{case}",
                          plan_exec("network", case, 2, dev), check)
        log(f"  network {case}@2: ok in {out['ticks']} ticks, "
            f"{out['wall_seconds']:.3f} s wall"
            + (f"; RTT ms {out['rtt_ms']}" if out["rtt_ms"] else ""))
        rows.append(out)
    return rows


def splitbrain_phase(torch, dev, report, cases, n):
    """[20]/[21] splitbrain ``cases`` at ``n`` to the end, with the plan's
    oracle (``bench.check_splitbrain``); the ring-merge launches are read
    right after each run."""
    from testground_tpu_torch import bench

    outs = {}
    for case in cases:
        ex = bench.splitbrain_executable(n, dev, case)
        slots = ex.program.net_spec.send_slots
        out, res = case_run(torch, dev, report, f"splitbrain_{case}_{n}", ex,
                            lambda r: bench.check_splitbrain(r, n))
        out["send_slots"] = slots
        merges = out["launches"]["ring_merge"]
        log(f"  splitbrain {case}@{n:,d}: {out['ok']:,d} ok, errors "
            f"{out['errors']:,d}, {out['ticks']} ticks "
            f"({out['ticks_executed']} executed), {out['wall_seconds']:.3f} "
            f"s wall ({out['ms_per_executed_tick']:.2f} ms/executed tick); "
            f"deferred {out['egress_deferred']:,d}, overflow "
            f"{out['egress_overflow']}, abandoned {out['egress_abandoned']},"
            f" inbox drops {out['net_dropped']}; merge launches {merges}; "
            f"peak {out['max_memory_allocated'] / 1e9:.2f} GB")
        assert (out["errors"] == 0) == case.startswith("accept"), out
        assert (out["launches"]["deliver_front"],
                out["launches"]["count_scatter"]) == (0, 0), out["launches"]
        if slots is not None:  # the bounded append: one merge an iteration
            assert merges > 0
            assert launch_bounds(out["ticks_executed"], bench.CHUNK_TICKS,
                                 merges), (merges, out["ticks_executed"])
        else:
            assert merges == 0, merges
        outs[case] = out
    return outs


def small_plans_phase(torch, dev, report):
    """[22] every case of example, placebo and verify at its manifest's
    largest instance count: the outcome each case gives (placebo's stall
    runs to max_ticks)."""
    status = {"failure": 2, "panic": 3, "abort": 2, "stall": 0}
    rows = []
    for plan, case, n in SMALL_PLAN_RUNS:
        want = status.get(case, 1)

        def check(res, n=n, want=want):
            st = res.statuses()[:n]
            assert (st == want).all(), (plan, case, st)
            return {"n": n, "status": want,
                    "metrics": len(res.metrics_records())}

        ex = plan_exec(plan, case, n, dev)
        out, _ = case_run(torch, dev, report, f"{plan}_{case}_{n}", ex, check)
        if case == "stall":
            assert out["ticks"] == ex.config.max_ticks, out["ticks"]
        assert all(v == 0 for v in out["launches"].values()), out["launches"]
        log(f"  {plan} {case}@{n}: status {want} for all in {out['ticks']} "
            f"ticks ({out['ticks_executed']} executed), "
            f"{out['wall_seconds']:.3f} s wall")
        rows.append(out)
    return rows


def queued_class_exec(n, device):
    """A class-rule dialing program behind an egress queue of 32 slots:
    class 0 rejects class 1, class 1 drops class 2; 3 ms lossy links;
    every instance dials its right neighbour and the one 5 to its right
    (60 ms timeouts), records both results, and waits for all."""
    from testground_tpu_torch.sim import (
        BuildContext, GroupSpec, SimConfig, compile_program,
    )
    from testground_tpu_torch.sim.net import ACTION_DROP, ACTION_REJECT

    def build(b):
        import torch

        b.enable_net(class_rules=True, n_classes=3, payload_len=2, head_k=1,
                     send_slots=32)
        b.set_net_class(lambda env, mem: env.instance % 3)

        def class_rules(env, mem):
            me = env.instance % 3
            ar = torch.arange(3, device=me.device)
            return torch.where(
                (me == 0) & (ar == 1), ACTION_REJECT,
                torch.where((me == 1) & (ar == 2), ACTION_DROP, -1),
            ).to(torch.int32)

        b.configure_network(latency_ms=3.0, loss=5.0,
                            class_rules_fn=class_rules, callback_state="cfg")
        for k, step in enumerate((1, 5)):
            b.dial(lambda env, mem, step=step: (env.instance + step) % n,
                   90 + k, result_slot=f"r{k}", timeout_ms=60.0)
            b.record_point(f"dial_r{k}", lambda env, mem, k=k: mem[f"r{k}"])
        b.signal_and_wait("done")
        b.end_ok()

    ctx = BuildContext([GroupSpec("single", 0, n, {})], test_case="classdials",
                       test_run="chip-smoke")
    return compile_program(build, ctx, SimConfig(chunk_ticks=32,
                                                 max_ticks=100_000),
                           device=device)


# ------------------------------------- the fault and observer planes

PLANE_KEYS = {"faults": "storm10k_faults", "trace": "storm10k_trace",
              "telem": "storm10k_telem"}
PLANE_TITLES = {
    "faults": "under bench.py's 8-event fault timeline",
    "trace": "traced (64 slots a lane)",
    "telem": "sampled (interval 100, every probe storm can record)",
}
# faultsdemo's chaos case ends near tick 206; max_ticks sizes the
# telemetry buffer (1,000 rows at interval 10)
FAULTSDEMO_MAX_TICKS = 10_000
FAULTSDEMO_BIG_N = 1_024  # plans/faultsdemo/manifest.toml's largest count


def plane_phase(torch, dev, report, plane, n=10_000, chunk_ticks=32):
    """[24]-[26] storm @ n under one plane with bench.py's table for it
    (``faults_main``, ``trace_main``, ``telem_main``) to termination,
    asserting what bench.py asserts; the count-scatter launches are read
    right after the run."""
    from testground_tpu_torch import bench

    def check(res):
        return {
            "n": n, "plane": plane, **bench.check_plane(res, n, plane),
            "restarts": res.restarts_total(),
            "trace_events": res.trace_events_total(),
            "trace_dropped": res.trace_dropped_total(),
            "telemetry_samples": res.telemetry_samples(),
            "telemetry_clipped": res.telemetry_clipped(),
            "horizon_clamped": res.net_horizon_clamped(),
            "metrics_dropped": res.metrics_dropped(),
            "net_dropped": res.net_dropped(),
        }

    ex = bench.storm_executable(n, dev, chunk_ticks=chunk_ticks,
                                planes=(plane,))
    from testground_tpu_torch.sim.sweep import state_bytes

    key = PLANE_KEYS[plane]
    out, _ = case_run(torch, dev, report, key, ex, check)
    out["state_model_bytes"] = state_bytes(ex)  # for [39]
    out["wheel"] = not ex.program.net_spec.fixed_next_tick
    launches = out["launches"]["count_scatter"]
    log(f"  storm@{n:,d} {PLANE_TITLES[plane]}: {out['ok']:,d} ok in "
        f"{out['ticks']} ticks ({out['ticks_executed']} executed), "
        f"{out['wall_seconds']:.3f} s wall ({out['ms_per_tick']:.2f} "
        f"ms/tick); victims {out.get('victims', 0)}, restarts "
        f"{out['restarts']}; trace events {out['trace_events']:,d}, dropped "
        f"{out['trace_dropped']:,d}; telemetry samples "
        f"{out['telemetry_samples']}, clipped {out['telemetry_clipped']}; "
        f"peak {out['max_memory_allocated'] / 1e9:.2f} GB; count-scatter "
        f"launches {launches} ({'wheel' if out['wheel'] else 'staging'})")
    assert launch_bounds(out["ticks_executed"], chunk_ticks, launches), (
        launches, out["ticks_executed"])
    assert (out["launches"]["deliver_front"], out["launches"]["ring_merge"]
            ) == (0, 0), out["launches"]
    assert out["horizon_clamped"] == 0 and out["metrics_dropped"] == 0
    assert out["wheel"] == (plane == "faults")
    return out


def faultsdemo_phase(torch, dev, report, n):
    """[27] faultsdemo's chaos case at ``n`` with its composition's
    [faults], [trace] and [telemetry] tables: grades PASS (every
    instance ok), the victim restarted, events and samples recorded."""
    from testground_tpu_torch.plans import faultsdemo

    def check(res):
        st = res.statuses()[:n]
        out = {"n": n, "ok": int((st == 1).sum()),
               "restarts": res.restarts_total(),
               "trace_events": res.trace_events_total(),
               "trace_dropped": res.trace_dropped_total(),
               "telemetry_samples": res.telemetry_samples(),
               "telemetry_clipped": res.telemetry_clipped()}
        assert out["ok"] == n, f"faultsdemo@{n}: {out['ok']} ok"
        assert out["restarts"] >= 1 and out["trace_events"] > 0
        assert out["telemetry_samples"] > 0
        return out

    out, _ = case_run(
        torch, dev, report, f"faultsdemo{n}",
        faultsdemo.chaos_executable(n, dev, chunk_ticks=32,
                                    max_ticks=FAULTSDEMO_MAX_TICKS), check)
    log(f"  faultsdemo chaos@{n:,d}: PASS, {out['ok']} ok in "
        f"{out['ticks']} ticks ({out['ticks_executed']} executed), "
        f"{out['wall_seconds']:.3f} s wall; restarts {out['restarts']}, "
        f"trace events {out['trace_events']:,d} (dropped "
        f"{out['trace_dropped']:,d}), samples {out['telemetry_samples']}; "
        f"launches {out['launches']}")
    return out


def planes_storm_exec(n, device):
    """storm with ``__graft_entry__``'s compressed params under all three
    planes: bench.py's fault timeline compressed with the dial window,
    64-slot rings, samples every 10 ticks (max 2,000 ticks)."""
    from testground_tpu_torch import bench, graft
    from testground_tpu_torch.plans import benchmarks
    from testground_tpu_torch.sim import (
        BuildContext, GroupSpec, SimConfig, compile_program,
    )

    params = dict(graft.STORM_PARAMS, **bench.FAULT_PARAMS)
    scale = graft.STORM_PARAMS["conn_delay_ms"] / bench.PARAMS["conn_delay_ms"]
    ctx = BuildContext(
        [GroupSpec("single", 0, n, {k: str(v) for k, v in params.items()})],
        test_case="storm", test_run="chip-smoke")
    cfg = SimConfig(quantum_ms=10.0, max_ticks=2_000, chunk_ticks=32,
                    phase_gating=True)
    return compile_program(benchmarks.storm, ctx, cfg, device=device,
                           faults=bench.fault_timeline(scale),
                           trace={"capacity": bench.TRACE_CAPACITY},
                           telemetry={"interval": 10})


def zero_overhead_phase(torch, report, dev, storm_ms):
    """The planes' zero-overhead promise on the card: storm @ 10k with an
    empty [faults], a disabled [trace] and a disabled [telemetry] builds
    phase 11's state leaves, and the loop iteration its stepper captures
    holds the same device ops (kernels, copies and fills, the nodes of
    its CUDA graph) as phase 11's; its profile window beside phase
    11b's."""
    from testground_tpu_torch import bench

    off = bench.storm_executable(10_000, dev, planes=bench.PLANES, off=True)
    plain = storm_exec(10_000, dev, False)
    assert (off.faults, off.trace, off.telemetry) == (None, None, None)
    assert bench.same_leaves(off, plain)
    counts = {k: bench.graph_node_counts(ex)
              for k, ex in (("storm10k", plain), ("planes_off", off))}
    report["planes_off_graph_nodes"] = counts
    log(f"  captured loop iteration: planes off {counts['planes_off']}, "
        f"phase 11's storm {counts['storm10k']}")
    assert counts["planes_off"] == counts["storm10k"], counts
    assert counts["storm10k"]["kernel"] > 1_000, counts
    prof = profile_phase(torch, report, "storm10k_planes_off_profile", off,
                         storm_ms)
    log(f"  profile window: {prof['device_ops_per_tick']:.1f} device "
        "ops/tick (phase 11b's count moves by a few ops a tick from run "
        "to run)")


# ------------------------------------- replay, drain and the election


def replay_phase(torch, dev, report, storm_nodes):
    """[29] bench --replay's legs at 10k, and the disabled table's
    captured graph against [26c]'s storm (``storm_nodes``)."""
    from testground_tpu_torch import bench

    off, _ = bench.replay_off_storm(10_000, dev)
    nodes = bench.graph_node_counts(off)
    del off
    log(f"  captured loop iteration: [replay] disabled {nodes}, phase "
        f"11's storm {storm_nodes}")
    assert nodes == storm_nodes, (nodes, storm_nodes)
    line = bench.replay_leg(10_000, dev)
    runs = line.pop("results")
    line["graph_nodes_off"] = nodes
    line["legs"] = {k: {"ticks": r.ticks, "ticks_executed": r.ticks_executed,
                        "wall_seconds": r.wall_seconds,
                        "capture_seconds": r.capture_seconds}
                    for k, r in runs.items()}
    report["replay10k"] = line
    for leg, counts in line["launches"].items():
        assert counts == {"deliver_front": 0, "ring_merge": 0,
                          "count_scatter": 0}, (leg, counts)
    log(f"  echo@10,000: self-driven {line['selfdriven_ms_per_tick']:.4f} "
        f"ms/executed tick, replayed {line['replayed_ms_per_tick']:.4f} "
        f"({line['value']:+.1f}%); sparse {line['arrivals']:,d} arrivals "
        f"at {line['arrivals_per_sec']:,.0f}/s, "
        f"{line['sparse_ticks_executed']} of "
        f"{line['sparse_ticks_simulated']} ticks executed; legs "
        f"{line['legs']}; launches {line['launches']}")
    return line


# [30]'s depth: 24 of bench --drain's 40 rounds (PERF.md §4: the cut
# that pays for [42]-[47])
DRAIN_SMOKE_ROUNDS = 24


def drain_phase(torch, dev, report):
    """[30] bench --drain's legs at 10k, the drain flag's captured graph,
    and the count scatter's launches in the drained run."""
    from testground_tpu_torch import bench
    from testground_tpu_torch.sim.core import STEPPER_WARMUP

    nodes = {k: bench.graph_node_counts(bench.drain_executable(
        10_000, dev, drain=k == "drain_on", samples=0))
        for k in ("drain_off", "drain_on")}
    log(f"  captured loop iteration: {nodes}")
    assert nodes["drain_on"] == nodes["drain_off"], nodes
    # one plain and one drained run (bench --drain takes two of each),
    # of DRAIN_SMOKE_ROUNDS rounds
    line = bench.drain_leg(10_000, dev, runs=1, rounds=DRAIN_SMOKE_ROUNDS)
    line["graph_nodes"] = nodes
    report["drain10k"] = line
    launches = line["launches"]
    log(f"  sparsetimer@10,000 drained: {line['ticks']} ticks, "
        f"{line['drain_batches']} batches, {line['drained_events']:,d} "
        f"events and {line['drained_samples']} samples streamed "
        f"(overflow x{line['overflow_factor']:.1f}), none dropped or "
        f"clipped; wall {line['undrained_wall_seconds']:.3f} s plain, "
        f"{line['drained_wall_seconds']:.3f} s drained "
        f"({line['value']:+.1f}%, {line['per_batch_ms']:.2f} ms a "
        f"batch); launches {launches}")
    lo = line["ticks_executed"] + STEPPER_WARMUP
    assert lo <= launches["count_scatter"] < lo + bench.DRAIN_CHUNK, (
        launches, line["ticks_executed"])
    assert (launches["deliver_front"], launches["ring_merge"]) == (0, 0)
    return line


ELECTION_BIG_N = 1_024  # plans/election/manifest.toml's largest count


def election_phase(torch, dev, report, n):
    """[31] election's quorum case at ``n`` with its composition's
    [replay] and [faults]: PASS, and the JAX package's outcomes."""
    from testground_tpu_torch.plans import election

    def check(res):
        g = election.grade(res, n)
        want = election.JAX_OUTCOMES[n]
        assert g["pass"], f"election@{n}: {g}"
        assert {k: g[k] for k in want} == want, (g, want)
        if n == 5:
            assert g["leaders"] == [0], g
        g["leaders"] = len(g["leaders"])
        return {"n": n, **g}

    out, _ = case_run(torch, dev, report, f"election{n}",
                      election.election_executable(n, dev), check)
    log(f"  election quorum@{n:,d}: PASS in {out['ticks']} ticks "
        f"({out['ticks_executed']} executed), {out['wall_seconds']:.3f} s "
        f"wall ({out['ms_per_executed_tick']:.2f} ms/executed tick); "
        f"fewest leader changes {out['min_changes']}, served "
        f"{out['served']}, consumed {out['consumed']}, restarts "
        f"{out['restarts']}, {out['leaders']} final leader(s); launches "
        f"{out['launches']}")
    return out


def drain_parity_phase(torch, np, dev, report, n=300):
    """[32] a drained sparsetimer at ``n`` on the card, and on the CPU in
    the child: every state leaf bit-equal and the three streamed files
    byte-equal."""
    import tempfile
    from pathlib import Path

    from testground_tpu_torch import bench
    from testground_tpu_torch.sim.drain import EVENTS_FILE, RESULTS_FILE
    from testground_tpu_torch.sim.state_io import (
        compare_leaves, flatten, state_to_numpy,
    )

    with tempfile.TemporaryDirectory(prefix="chip-smoke-drain-") as tmp:
        states, stats = {}, {}
        res, dr = bench.drained_run(
            bench.drain_executable(n, dev, rounds=10), Path(tmp) / str(dev))
        states[str(dev)] = flatten(state_to_numpy(res.state))
        stats[str(dev)] = dr.stats()
        states["cpu"], stats["cpu"] = cpu_side("drain300")
        leaves = compare_leaves(states[str(dev)], states["cpu"],
                                "drained sparsetimer: GPU vs CPU")
        sizes = {}
        for f in (EVENTS_FILE, RESULTS_FILE, "trace.json"):
            a = (Path(tmp) / str(dev) / f).read_bytes()
            assert a == (Path(CPU_DIR) / "drain_cpu" / f).read_bytes(), f
            sizes[f] = len(a)
    assert stats[str(dev)] == stats["cpu"], stats
    report["drain300_parity"] = {"leaves": leaves, "files": sizes,
                                 "stats": stats["cpu"]}
    log(f"  drained sparsetimer@{n}: GPU vs CPU bit-equal over {leaves} "
        f"leaves, streamed files byte-equal {sizes}, {stats['cpu']}")


# -------------------------------------------------------- sweep and search

SWEEP_HELD = (0, 31, 63)  # the sweep's scenarios held against serial runs
# [33]'s serial sample: 1 of bench --sweep's 2 seeds (PERF.md §4: the cut
# that pays for [42]-[47])
SWEEP_SERIAL_SMOKE = 1


def sweep_phase(torch, dev, report, n=10_000):
    """[33] bench --sweep's legs at ``n``: the SWEEP_SEEDS-seed storm
    sweep as one batched, once-captured run (every scenario asserted,
    the count scatter once a batched iteration: the folded call), the
    serial sample, and the scenarios ``SWEEP_HELD`` held leaf for leaf
    against their serial runs on the card. Returns (the report row, the
    sweep executable)."""
    from testground_tpu_torch import bench
    from testground_tpu_torch.sim.state_io import (
        compare_leaves, flatten, state_to_numpy,
    )

    torch.cuda.reset_peak_memory_stats(dev)
    # sweep_leg sets every launch count to 0 just before the batched run
    # and reads them just after it
    assert bench.SWEEP_SEEDS == SWEEP_SEEDS, bench.SWEEP_SEEDS
    line, res, serial = bench.sweep_leg(n, device=dev,
                                        serial_seeds=SWEEP_SERIAL_SMOKE)
    peak = torch.cuda.max_memory_allocated(dev)
    ex = res.executable
    executed = max(res.scenario(s).ticks_executed for s in range(SWEEP_SEEDS))
    assert launch_bounds(executed, ex.config.chunk_ticks,
                         line["launches"]["count_scatter"]), (
        line["launches"], executed)
    assert (line["launches"]["deliver_front"],
            line["launches"]["ring_merge"]) == (0, 0), line["launches"]
    held = {}
    for s in SWEEP_HELD:
        ref = (serial[s] if s < len(serial)
               else bench.storm_executable(n, dev, seed=s).run())
        got = flatten(state_to_numpy(res.scenario(s).state))
        got.pop("rng_key")
        held[s] = compare_leaves(got, flatten(state_to_numpy(ref.state)),
                                 f"sweep scenario {s} vs its serial run")
        del ref
    out = {**line, "executed_ticks_max": executed, "held_leaves": held,
           "max_memory_allocated": peak,
           "ms_per_batched_tick": res.wall_seconds / max(res.ticks, 1) * 1e3}
    report["sweep10k"] = out
    log(f"  {SWEEP_SEEDS}-seed storm@{n:,d} sweep: {line['value']:.3f} "
        f"scenarios/s batched ({line['batched_run_seconds']:.2f} s run, "
        f"{line['batched_wall_seconds']:.2f} s with the build and the "
        f"capture of {line['capture_seconds']:.2f} s; captures "
        f"{line['captures']}), serial {line['serial_scenarios_per_sec']:.4f}"
        f" scenarios/s ({', '.join(f'{x:.2f}' for x in line['serial_sample_seconds'])} s), "
        f"speedup {line['speedup_vs_serial']:.2f}x; {res.ticks} batched "
        f"iterations at {out['ms_per_batched_tick']:.3f} ms; count "
        f"scatter launches {line['launches']['count_scatter']}; peak "
        f"{peak / 1e9:.2f} GB")
    log(f"  scenarios {', '.join(map(str, SWEEP_HELD))} equal to their "
        f"serial runs on {', '.join(str(v) for v in held.values())} leaves")
    return out, ex


def search_phase(torch, dev, report, n=10_000):
    """[34] bench --search at ``n``: cliff's edge by bisection, one
    capture for every round."""
    from testground_tpu_torch import bench

    out = bench.search_leg(n, dev)
    report["search10k"] = out
    log(f"  search @{n:,d}: edge {out['breaking_point']} (last passing "
        f"{out['last_passing']}) in {out['rounds']} rounds (bound "
        f"{out['round_bound']}), {out['value']} of "
        f"{out['exhaustive_scenarios']} scenarios probed, captures "
        f"{out['captures']}, {out['wall_seconds']:.2f} s")
    return out


def shaped_fault_sweep(n, device, seeds=4):
    """storm with ``__graft_entry__``'s compressed shaped params (links,
    loss, SYN retries, churn-tolerant rendezvous, 5% churn) under
    bench.py's fault timeline compressed with the dial window, over
    ``seeds`` seeds as one sweep, cut at 600 ticks (past the whole
    timeline: its last event, the restart, is at tick 60)."""
    from testground_tpu_torch import bench, graft
    from testground_tpu_torch.plans import benchmarks
    from testground_tpu_torch.sim import GroupSpec, SimConfig
    from testground_tpu_torch.sim.sweep import compile_sweep

    params = {**graft.STORM_PARAMS, **graft.SHAPED_PARAMS,
              **bench.FAULT_PARAMS}
    scale = graft.STORM_PARAMS["conn_delay_ms"] / bench.PARAMS["conn_delay_ms"]
    groups = [GroupSpec("single", 0, n,
                        {k: str(v) for k, v in params.items()})]
    cfg = SimConfig(quantum_ms=10.0, max_ticks=600, chunk_ticks=32,
                    phase_gating=True, churn_fraction=0.05,
                    churn_start_ms=500.0, churn_end_ms=1_500.0)
    return compile_sweep(benchmarks.storm, groups, cfg,
                         [{"seed": s, "params": {}} for s in range(seeds)],
                         test_case="storm", test_run="chip-smoke",
                         faults=bench.fault_timeline(scale), device=device)


def sweep_parity_phase(np, dev, report, n=300, seeds=4):
    """[35] the shaped fault sweep at ``n`` x ``seeds`` on the card, and
    on the CPU in the child: every scenario's every state leaf
    bit-equal."""
    from testground_tpu_torch.sim.state_io import (
        compare_leaves, flatten, state_to_numpy,
    )

    states, walls = {}, {}
    ex = shaped_fault_sweep(n, dev, seeds)
    res = ex.run()
    states[str(dev)] = [flatten(state_to_numpy(res.scenario(s).state))
                        for s in range(seeds)]
    walls[str(dev)] = (res.ticks, res.wall_seconds, ex.captures)
    assert (n, seeds) == (300, 4), "the child runs the CPU side at 300 x 4"
    states["cpu"], walls["cpu"] = cpu_side("sweep300")
    leaves = [compare_leaves(states[str(dev)][s], states["cpu"][s],
                             f"sweep scenario {s}: GPU vs CPU")
              for s in range(seeds)]
    report["sweep300_parity"] = {
        "leaves": leaves, "bit_equal": True,
        "gpu": walls[str(dev)], "cpu": walls["cpu"],
    }
    log(f"  shaped fault sweep @{n} x {seeds}: GPU vs CPU bit-equal over "
        f"{leaves[0]} leaves a scenario (iterations {walls[str(dev)][0]}, "
        f"GPU {walls[str(dev)][1]:.2f} s with {walls[str(dev)][2]} "
        f"capture, CPU {walls['cpu'][1]:.2f} s)")



# ------------------------------------------------------- the runner ([36]-[41])

RUNNER_KEYS = (
    "outcome", "outcomes", "ticks", "ticks_simulated", "ticks_executed",
    "skip_ratio", "event_skip", "virtual_seconds", "wall_seconds",
    "compile_seconds", "compile_breakdown", "compiles", "timed_out",
    "metrics_dropped", "mesh", "hbm_preflight", "device_profile",
    "checkpoint", "host_spans", "live")
# the journal keys a resumed run adds or changes
RESUME_KEYS = ("checkpoint", "resume", "resumed_from_chunk",
               "resumed_from_tick", "compiles", "live")
STORM_RUN_CONFIG = {"quantum_ms": 10.0, "max_ticks": 100_000,
                    "metrics_capacity": 16, "phase_gating": True}
DHT_RUN_CONFIG = {"quantum_ms": 10.0, "max_ticks": 60_000,
                  "metrics_capacity": 8, "churn_fraction": 0.05,
                  "churn_start_ms": 100.0, "churn_end_ms": 5_000.0,
                  "pallas_front": True}
GOSSIP_RUN_CONFIG = {"quantum_ms": 10.0, "max_ticks": 20_000,
                     "metrics_capacity": 8}
RESUME_CHUNK = 512
RESUME_STOP_AT = 3


def runner_input(plan, case, n, params, run_dir, run_id, run_config,
                 groups=("single",), **tables):
    """A RunInput of ``n`` instances of ``plan``'s ``case`` split evenly
    over ``groups``, its artifact the repo's plans/<plan>."""
    from testground_tpu_torch.api.contracts import RunGroup, RunInput

    return RunInput(
        run_id=run_id, env_config=None, run_dir=str(run_dir),
        test_plan=plan, test_case=case, total_instances=n,
        groups=[RunGroup(id=g, instances=n // len(groups),
                         artifact_path=os.path.join(ROOT, "plans", plan),
                         parameters={k: str(v) for k, v in params.items()})
                for g in groups],
        run_config=dict(run_config), **tables)


def storm_input(run_dir, run_id="storm", n=10_000, run_config=None,
                **tables):
    """bench.py's storm @ n as a composition (its params and SimConfig,
    chunk_ticks left to the runner)."""
    from testground_tpu_torch import bench

    return runner_input("benchmarks", "storm", n, bench.PARAMS, run_dir,
                        run_id, dict(STORM_RUN_CONFIG, **(run_config or {})),
                        **tables)


def runner_run(torch, dev, rinput):
    """``run_composition`` on the card with the launch counts reset just
    before and read just after; (output, summary, launches)."""
    from testground_tpu_torch.runner.outputs import summary
    from testground_tpu_torch.sim import runner

    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    out = runner.run_composition(rinput, device=dev)
    launches = other_launches()
    out.peak_bytes = torch.cuda.max_memory_allocated(dev) - base
    return out, summary(rinput.run_dir), launches


class preempt_at:
    """The runner's should_stop hook preempting its run at boundary
    ``k`` (1-based), as a SIGTERM during that chunk would."""

    def __init__(self, k):
        from testground_tpu_torch.sim import runner

        self.runner, self.k, self.real = runner, k, runner._make_should_stop

    def __enter__(self):
        runner, k = self.runner, self.k

        def make(rinput):
            rid, calls = rinput.run_id, [0]
            ev = runner._term_event(rid)

            def should_stop():
                calls[0] += 1
                if calls[0] == k:
                    runner.request_preempt(rid)
                return ev.is_set()

            return should_stop

        runner._make_should_stop = make

    def __exit__(self, *exc):
        self.runner._make_should_stop = self.real


def pooled_captures():
    from testground_tpu_torch.sim import runner

    return {k: ex.captures for k, (ex, _) in runner._EX_CACHE.items()}


def runner_storm_phase(torch, dev, report, tmp, storm):
    """[36] bench.py's storm @ 10,000 as a composition through the
    runner: success, phase 11's ticks and count-scatter launches, the
    combined results.out, every summary key; the host spans, and the
    dispatch wall against the direct run's, made right after it: phase
    11's wall is taken ~500 s earlier, beside other work of the CPU
    child, and has varied by 13% between runs of this script."""
    from testground_tpu_torch import bench
    from testground_tpu_torch.sim import runner

    runner.clear_executor_pool()
    ri = storm_input(os.path.join(tmp, "storm"))
    out, s, launches = runner_run(torch, dev, ri)
    spans = {r["name"]: r["seconds"] for r in s["host_spans"]}
    direct = bench.storm_executable(10_000, dev, False, 32)
    direct.tick_fn()
    res = direct.run()
    del direct
    assert res.ticks == storm["ticks"], (res.ticks, storm["ticks"])
    ratio = s["wall_seconds"] / res.wall_seconds
    ratio11 = s["wall_seconds"] / storm["wall_seconds"]
    row = {"outcome": s["outcome"], "ticks": s["ticks"],
           "ticks_executed": s["ticks_executed"], "launches": launches,
           "wall_seconds": s["wall_seconds"],
           "direct_wall_seconds": res.wall_seconds,
           "wall_ratio": ratio,
           "phase11_wall_seconds": storm["wall_seconds"],
           "phase11_wall_ratio": ratio11,
           "compile_seconds": s["compile_seconds"],
           "compile_breakdown": s["compile_breakdown"],
           "host_spans": s["host_spans"],
           "device_profile": s["device_profile"],
           "state_model_bytes": s["hbm_preflight"][
               "state_model_bytes_per_device"],
           "peak_bytes": out.peak_bytes,
           "chunk_ticks": runner.watchdog_chunk_ticks(10_000)}
    report["runner_storm10k"] = row
    log(f"  runner storm@10k: {s['outcome']}, {s['ticks']} ticks "
        f"({s['ticks_executed']} executed), dispatch {s['wall_seconds']:.3f}"
        f" s against the direct run's {res.wall_seconds:.3f} s right "
        f"after it (x{ratio:.3f}; phase 11's {storm['wall_seconds']:.3f} s,"
        f" x{ratio11:.3f}); host spans "
        + ", ".join(f"{k} {v:.3f} s" for k, v in spans.items())
        + f"; count-scatter launches {launches['count_scatter']} "
        f"(phase 11: {storm['launches']['count_scatter']})")
    assert out.result.outcome == s["outcome"] == "success", s["outcome"]
    assert s["ticks"] == storm["ticks"], (s["ticks"], storm["ticks"])
    assert launches == storm["launches"], (launches, storm["launches"])
    missing = [k for k in RUNNER_KEYS if k not in s]
    assert not missing, missing
    assert os.path.exists(os.path.join(ri.run_dir, "results.out"))
    assert not os.path.exists(os.path.join(ri.run_dir, "single"))
    assert ratio <= 1.10, (
        f"runner dispatch wall x{ratio:.3f} of the direct run's")
    return row


def runner_dht_phase(torch, dev, report, tmp, dht):
    """[37] dht @ 10,000 with the fused front as a composition through
    the runner: phase 4's ticks, outcome and front and merge launches."""
    ri = runner_input("dht", "find-providers", 10_000, DHT_PARAMS,
                      os.path.join(tmp, "dht"), "dht", DHT_RUN_CONFIG)
    out, s, launches = runner_run(torch, dev, ri)
    row = {"outcome": s["outcome"], "ticks": s["ticks"],
           "launches": launches, "wall_seconds": s["wall_seconds"],
           "direct_wall_seconds": dht["wall_seconds"],
           "compile_seconds": s["compile_seconds"],
           "ok": s["outcomes"]["single"]["ok"],
           "crashed_count": s.get("crashed_count", 0),
           "host_spans": s["host_spans"],
           "state_model_bytes": s["hbm_preflight"][
               "state_model_bytes_per_device"],
           "peak_bytes": out.peak_bytes}
    report["runner_dht10k"] = row
    log(f"  runner dht@10k (fused front): {s['outcome']}, {s['ticks']} "
        f"ticks, {row['ok']} ok, {row['crashed_count']} churned; "
        f"dispatch {s['wall_seconds']:.3f} s (phase 4: "
        f"{dht['wall_seconds']:.3f} s); launches {launches} (phase 4: "
        f"{dht['launches']})")
    assert s["ticks"] == dht["ticks"], (s["ticks"], dht["ticks"])
    assert row["ok"] == dht["ok"] and row["crashed_count"] == dht["crashed"]
    assert launches == dht["launches"], (launches, dht["launches"])
    assert launches["deliver_front"] == launches["ring_merge"] > 0
    return row


def _without(s, keys):
    return {k: v for k, v in s.items() if k not in keys}


def runner_pool_resume_phase(torch, dev, report, tmp, first):
    """[38] prewarm then run: memory_hit, compiles 0, no capture, the
    same summary as [36]; storm @ 10,000 in 512-tick chunks checkpointed
    at every boundary, preempted at boundary 3 and resumed: the same
    summary and results.out as [36]'s uninterrupted run, with no
    capture; a terminated run."""
    from testground_tpu_torch.runner.outputs import (
        deterministic, output_files, run_out_lines)
    from testground_tpu_torch.sim import runner

    runner.clear_executor_pool()
    pre = runner.prewarm_composition(storm_input(os.path.join(tmp, "p0")),
                                     device=dev)
    assert pre.result.journal["executor_cache"] == "miss"
    caps = pooled_captures()
    ri = storm_input(os.path.join(tmp, "p1"))
    _, s, launches = runner_run(torch, dev, ri)
    assert s["hbm_preflight"]["executor_cache"] == "memory_hit"
    assert s["compiles"] == 0 and s["compile_breakdown"] is None
    assert pooled_captures() == caps, "the pool hit captured again"
    a = deterministic(s, ri.run_dir)
    b = deterministic(first, os.path.join(tmp, "storm"))
    for d in (a, b):
        d.pop("compiles")
        d["hbm_preflight"].pop("executor_cache")
    assert a == b, ("the prewarmed run's summary differs from [36]'s",
                    {k: (a.get(k), b.get(k)) for k in set(a) | set(b)
                     if a.get(k) != b.get(k)})
    row = {"prewarm_compile_seconds": pre.result.journal["compile_seconds"],
           "hit_compile_seconds": s["compile_seconds"],
           "hit_wall_seconds": s["wall_seconds"],
           "hit_launches": launches}
    log(f"  prewarm {row['prewarm_compile_seconds']:.2f} s, then a "
        f"memory_hit run: compile {s['compile_seconds']:.3f} s, dispatch "
        f"{s['wall_seconds']:.3f} s, no capture, summary equal to [36]'s")

    # the uninterrupted run to hold the resumed one against is [36]'s
    # (its chunks are the watchdog tier's: chunking changes no state)
    ck = {"checkpoint": {"interval": 0.0}}
    rc = {"chunk_ticks": RESUME_CHUNK}
    full_dir = os.path.join(tmp, "storm")
    cut = storm_input(os.path.join(tmp, "cut"), "cut", run_config=rc, **ck)
    with preempt_at(RESUME_STOP_AT):
        out_b, s_b, _ = runner_run(torch, dev, cut)
    assert out_b.result.outcome == "preempted" and s_b["preempted"]
    assert s_b["ticks"] == RESUME_CHUNK * RESUME_STOP_AT, s_b["ticks"]
    caps = pooled_captures()
    resumed = storm_input(os.path.join(tmp, "cut"), "cut", run_config=rc,
                          resume=True, **ck)
    out_c, s_c, _ = runner_run(torch, dev, resumed)
    assert pooled_captures() == caps, "the resume captured again"
    assert s_c["resumed_from_tick"] == RESUME_CHUNK * RESUME_STOP_AT
    a = _without(deterministic(first, full_dir), RESUME_KEYS)
    c = _without(deterministic(s_c, resumed.run_dir), RESUME_KEYS)
    for d in (a, c):
        d["hbm_preflight"].pop("executor_cache")
    assert c == a, ("the resumed summary differs from the uninterrupted "
                    "one", {k: (a.get(k), c.get(k)) for k in set(a) | set(c)
                            if a.get(k) != c.get(k)})
    assert run_out_lines(resumed.run_dir) == run_out_lines(full_dir)
    files = output_files(full_dir)
    assert files and output_files(resumed.run_dir) == files
    row.update({"resume_chunk_ticks": RESUME_CHUNK,
                "preempted_at_tick": s_b["ticks"],
                "snapshots_before_preempt": s_b["checkpoint"]["snapshots"],
                "resumed_outcome": s_c["outcome"],
                "resumed_wall_seconds": s_c["wall_seconds"]})
    log(f"  preempted at tick {s_b['ticks']} ({s_b['checkpoint']['snapshots']}"
        f" snapshots), resumed to tick {s_c['ticks']}: summary, run.out "
        "and results.out equal to the uninterrupted run's, no capture")

    runner.request_terminate("killed")
    _, s_t, _ = runner_run(torch, dev, storm_input(
        os.path.join(tmp, "killed"), "killed", run_config=rc))
    assert s_t["outcome"] == "terminated" and s_t["terminated"]
    assert s_t["ticks"] == RESUME_CHUNK, s_t["ticks"]
    row["terminated_at_tick"] = s_t["ticks"]
    log(f"  terminated run: outcome terminated at tick {s_t['ticks']}")
    report["runner_pool_resume"] = row
    return row


def memory_model_phase(torch, dev, report, tmp):
    """[39] the pre-flight's memory model on the card: each run's peak
    above what was allocated before it (its state and the capture's
    private pool) against its state model, at storm and dht @ 10,000
    through the runner ([36], [37]), sampled storm @ 10,000 ([26]) and
    gossipsub @ 1,048,576 ([9]), and the fraction they give. Then a
    traced storm (400 ticks) through the runner under a forced
    ``TESTGROUND_HBM_BYTES`` that shrinks its trace ring, its peak under
    the forced budget. The kernels' scratch, allocated once a process at
    a kernel's first launch (the front's: ~17 MB at 10k, in phase 4), is
    not in these peaks."""
    from testground_tpu_torch import bench
    from testground_tpu_torch.sim import runner
    from testground_tpu_torch.sim.tables import Trace

    rows = {}
    for key, src in (("storm10k", "runner_storm10k"),
                     ("dht10k", "runner_dht10k"),
                     ("gossipsub1m", "gossipsub_big"),
                     ("storm10k_sampled", PLANE_KEYS["telem"])):
        model, peak = (report[src][k]
                       for k in ("state_model_bytes", "peak_bytes"))
        rows[key] = {"run": src, "state_model_bytes": model,
                     "peak_bytes": peak, "ratio": model / peak}
        log(f"  {key} ({src}): state model {model / 1e6:.1f} MB, peak "
            f"{peak / 1e6:.1f} MB, state/peak {model / peak:.3f}")
    worst = min(r["ratio"] for r in rows.values())
    runner.clear_executor_pool()
    # the forced budget admits the trace ring at half the requested
    # capacity (metrics_capacity left to the pre-flight: its ladder is
    # the outer one, its first rung the default 64)
    rc = {k: v for k, v in STORM_RUN_CONFIG.items()
          if k != "metrics_capacity"}
    rc["max_ticks"] = 400

    def traced(tag, cap=256):
        return runner_input("benchmarks", "storm", 10_000, bench.PARAMS,
                            os.path.join(tmp, tag), tag, rc,
                            trace=Trace(capacity=cap))

    probe_ri = traced("probe", 128)
    _, build_fn, cfg, ctx = runner._build(probe_ri, dev, log)
    _, probe = runner._preflight(probe_ri, build_fn, ctx, cfg, dev, log)
    budget = int(probe["state_model_bytes_per_device"]
                 / runner._HBM_FRACTION) + 1
    os.environ["TESTGROUND_HBM_BYTES"] = str(budget)
    try:
        out, s, _ = runner_run(torch, dev, traced("forced"))
    finally:
        del os.environ["TESTGROUND_HBM_BYTES"]
    hp = s["hbm_preflight"]
    forced = {"budget_bytes": budget, "peak_bytes": out.peak_bytes,
              "trace_capacity_requested": hp["trace_capacity_requested"],
              "trace_capacity": hp["trace_capacity"],
              "state_model_bytes": hp["state_model_bytes_per_device"],
              "ticks": s["ticks"]}
    report["memory_model"] = {"cases": rows, "worst_ratio": worst,
                              "fraction": runner._HBM_FRACTION,
                              "forced": forced}
    log(f"  worst state/peak {worst:.3f}; the runner admits "
        f"{runner._HBM_FRACTION} of the budget; forced budget "
        f"{budget / 1e6:.1f} MB: trace capacity "
        f"{hp['trace_capacity_requested']} -> {hp['trace_capacity']}, peak "
        f"{out.peak_bytes / 1e6:.1f} MB over {s['ticks']} ticks")
    assert runner._HBM_FRACTION <= worst, (runner._HBM_FRACTION, worst)
    assert hp["trace_capacity"] < hp["trace_capacity_requested"]
    assert s["ticks"] == rc["max_ticks"] and s["trace_events"] > 0
    assert out.peak_bytes <= budget, (out.peak_bytes, budget)
    runner.clear_executor_pool()
    return report["memory_model"]


def runner_parity_input(key, tmp, side):
    """The RunInput of a runner parity phase's composition ``key`` (at
    n = 300, the cliff search at 64), its run directory
    ``<tmp>/<key>_<side>``."""
    import tomllib

    from testground_tpu_torch import graft
    from testground_tpu_torch.sim.tables import (
        Faults, Search, Sweep, Telemetry, Trace,
    )

    run_dir = os.path.join(tmp, f"{key}_{side}")
    if key == "storm300":
        return runner_input("benchmarks", "storm", 300, graft.STORM_PARAMS,
                            run_dir, "par", STORM_RUN_CONFIG)
    if key == "faultsdemo300":
        with open(os.path.join(ROOT, "plans", "faultsdemo",
                               "composition.toml"), "rb") as f:
            comp = tomllib.load(f)
        params = dict(comp["global"]["run"]["test_params"], min_pings="0")
        return runner_input(
            "faultsdemo", "chaos", 300, params, run_dir, "par",
            {"max_ticks": 2_000}, groups=("left", "right"),
            faults=Faults.from_dict(comp["faults"]),
            trace=Trace.from_dict(comp["trace"]),
            telemetry=Telemetry.from_dict(comp["telemetry"]))
    if key == "storm300_sweep":
        params = dict(graft.STORM_PARAMS, conn_delay_ms=600, data_size_kb=8)
        return runner_input("benchmarks", "storm", 300, params, run_dir,
                            "bpar", STORM_RUN_CONFIG,
                            sweep=Sweep(seeds=4, chunk=2))
    if key == "cliff64_search":
        return runner_input("benchmarks", "cliff", 64, {"x_fail": CLIFF_AT},
                            run_dir, "bpar",
                            {"quantum_ms": 10.0, "max_ticks": 10_000,
                             "metrics_capacity": 8},
                            search=Search(param="x", lo=0.0, hi=1.0,
                                          step=1.0 / 16, width=4))
    raise ValueError(key)


def runner_parity_pair(dev, tmp, keys):
    """Each composition of ``keys`` through the runner on the card, its
    CPU run from the child: every deterministic summary key, run.out,
    output file and progress row equal; {key: row}."""
    from testground_tpu_torch.runner.outputs import assert_runs_equal
    from testground_tpu_torch.sim import runner

    out = {}
    hb = os.environ.get("TG_DISPATCH_HEARTBEAT_S")
    # heartbeat rows count wall time: none in a parity pair
    os.environ["TG_DISPATCH_HEARTBEAT_S"] = "86400"
    try:
        for key in keys:
            runner.clear_executor_pool()
            ri = runner_parity_input(key, tmp, "gpu")
            t0 = time.monotonic()
            runner.run_composition(ri, device=dev)
            gpu_s = time.monotonic() - t0
            cpu_s = cpu_side(key)
            gdir = ri.run_dir
            cdir = runner_parity_input(key, CPU_DIR, "cpu").run_dir
            s = assert_runs_equal(gdir, cdir)
            if key == "storm300_sweep":
                assert scenario_rows(gdir) == scenario_rows(cdir)
            out[key] = {"outcome": s["outcome"], "ticks": s["ticks"],
                        "gpu_seconds": gpu_s, "cpu_seconds": cpu_s}
            log(f"  {key}: GPU vs CPU through the runner equal (summary, "
                f"run.out, outputs, scenario and probe files, progress "
                f"rows): {s['outcome']}, {s['ticks']} ticks; GPU "
                f"{gpu_s:.2f} s, CPU {cpu_s:.2f} s")
            assert s["outcome"] == "success"
    finally:
        if hb is None:
            os.environ.pop("TG_DISPATCH_HEARTBEAT_S", None)
        else:
            os.environ["TG_DISPATCH_HEARTBEAT_S"] = hb
        runner.clear_executor_pool()
    return out


def runner_parity_phase(torch, dev, report, tmp):
    """[40] the card against the CPU through the runner at n = 300:
    storm with ``__graft_entry__``'s compressed params, and faultsdemo's
    composition traced and sampled (its [faults], [trace], [telemetry]);
    every deterministic summary key, run.out, every output file and the
    progress rows equal."""
    report["runner_parity"] = runner_parity_pair(
        dev, tmp, ("storm300", "faultsdemo300"))
    return report["runner_parity"]


def cli_phase(report, tmp):
    """[41] ``python -m testground_tpu_torch healthcheck`` and ``run
    composition plans/faultsdemo/composition.toml``, each a subprocess
    on the card: exit 0, and the run grades PASS."""
    env = dict(os.environ, TESTGROUND_HOME=os.path.join(tmp, "home"))
    out = {}
    for key, args in (
        ("healthcheck", ["healthcheck", "--fix"]),
        ("run", ["run", "composition", "plans/faultsdemo/composition.toml",
                 "--run-id", "smoke"]),
    ):
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-m", "testground_tpu_torch", *args],
            capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
        lines = proc.stdout.strip().splitlines()
        out[key] = {"returncode": proc.returncode,
                    "seconds": time.monotonic() - t0, "tail": lines[-3:]}
        if key == "healthcheck":
            # the card is visible and the three kernels built and loaded
            out[key]["cuda_backend_ok"] = any(
                line.startswith("- cuda-backend: ok") for line in lines)
        for line in proc.stdout.strip().splitlines()[-6:]:
            log(f"    {line}")
        assert proc.returncode == 0, (key, proc.stdout[-3000:],
                                      proc.stderr[-3000:])
    summary_path = os.path.join(tmp, "home", "data", "outputs", "faultsdemo",
                                "smoke", "sim_summary.json")
    with open(summary_path) as f:
        s = json.load(f)
    assert s["outcome"] == "success", s["outcome"]
    assert out["healthcheck"]["cuda_backend_ok"], out["healthcheck"]
    out["run"]["outcome"] = s["outcome"]
    report["cli"] = out
    log(f"  healthcheck exit 0 ({out['healthcheck']['seconds']:.1f} s); run "
        f"composition faultsdemo: {s['outcome']} (PASS) in "
        f"{out['run']['seconds']:.1f} s")
    return out


# ------------------------------------ the batched runner paths ([42]-[47])

SWEEP_RUNNER_SEEDS = 16  # [42]'s storm@10k sweep through the runner
# [43]: 1,024-tick chunks (a stop lands inside a scenario chunk), stopped
# at chunk 1's second boundary (chunk 0 ends at its fourth: storm's
# ~3,400 ticks)
SWEEP_RESUME_CHUNK = 1024
SWEEP_RESUME_STOP_AT = 6
DHT_SWEEP_SEEDS = 8  # [44]
CLIFF_AT = "0.663"  # bench.CLIFF_AT: cliff's x_fail in [34]
# [45]: faultsdemo's search at 1,024 in 50-tick chunks (a stop lands
# inside a round)
DEMO_SEARCH_RUN_CONFIG = {"max_ticks": 10_000, "chunk_ticks": 50}
LEASE_RUN_CONFIG = {"max_ticks": 300}  # [46]'s storm@10k, cut short
# the journal keys a resumed sweep or search adds or changes
BATCHED_RESUME_KEYS = ("checkpoint", "resume", "resumed_from_chunk",
                       "resumed_from_tick", "resumed_from_round", "compiles",
                       "live", "hbm_preflight", "scenario_chunk")


def sweep_input(run_dir, run_id, seeds=SWEEP_RUNNER_SEEDS, n=10_000,
                run_config=None, **tables):
    """bench.py's storm @ n swept over ``seeds`` seeds as a composition."""
    from testground_tpu_torch.sim.tables import Sweep

    return storm_input(run_dir, run_id, n=n, run_config=run_config,
                       sweep=Sweep(seeds=seeds), **tables)


def scenario_rows(run_dir):
    """Every scenario's own sim_summary.json, by scenario."""
    root = os.path.join(run_dir, "scenario")
    rows = []
    for s in sorted(int(d) for d in os.listdir(root)):
        with open(os.path.join(root, str(s), "sim_summary.json")) as f:
            rows.append(json.load(f))
    return rows


def pooled(runner):
    """The only executor in the runner's pool."""
    (ex, _), = runner._EX_CACHE.values()
    return ex


def span_seconds(s, name):
    """(seconds, count) of the summary's host span ``name``."""
    for r in s["host_spans"]:
        if r["name"] == name:
            return r["seconds"], r.get("count", 1)
    return 0.0, 0


def runner_sweep_phase(torch, dev, report, tmp, plain):
    """[42] storm@10k over SWEEP_RUNNER_SEEDS seeds through the runner,
    chunk_ticks left to it: one capture, one folded count-scatter launch
    a batched iteration, every scenario ok, scenario 0's results.out and
    row equal to [36]'s plain run of seed 0; scenarios/s and the dispatch
    wall against the direct batched run of the same seeds (phase 33's
    executable), the host spans and the demux seconds a scenario."""
    from testground_tpu_torch import bench
    from testground_tpu_torch.sim import runner

    runner.clear_executor_pool()
    ri = sweep_input(os.path.join(tmp, "sweep"), "sweep")
    out, s, launches = runner_run(torch, dev, ri)
    ex = pooled(runner)
    rows = s["scenarios"]
    executed = max(r["ticks_executed"] for r in rows)
    assert out.result.outcome == s["outcome"] == "success", s["outcome"]
    assert all(r["outcome"] == "success" for r in rows)
    assert rows == scenario_rows(ri.run_dir)
    assert ex.captures == 1 and s["compiles"] == 1, (ex.captures,
                                                      s["compiles"])
    assert launch_bounds(executed, ex.config.chunk_ticks,
                         launches["count_scatter"]), (launches, executed)
    assert (launches["deliver_front"], launches["ring_merge"]) == (0, 0)
    # scenario 0 is [36]'s run of seed 0
    plain_dir = os.path.join(tmp, "storm")
    for k in ("ticks", "ticks_executed", "outcomes", "virtual_seconds",
              "metrics_dropped", "timed_out"):
        assert rows[0][k] == plain[k], (k, rows[0][k], plain[k])
    with open(os.path.join(ri.run_dir, "scenario", "0", "results.out"),
              "rb") as a, open(os.path.join(plain_dir, "results.out"),
                               "rb") as b:
        assert a.read() == b.read(), "scenario 0's results.out differs"
    # the direct batched run of the same seeds
    direct = bench.storm_sweep(10_000, SWEEP_RUNNER_SEEDS, dev)
    res = direct.run()
    d_wall = res.wall_seconds
    del direct, res
    demux_s, demux_n = span_seconds(s, "demux")
    row = {"seeds": SWEEP_RUNNER_SEEDS, "outcome": s["outcome"],
           "ticks": s["ticks"], "ticks_executed": executed,
           "chunk_ticks": ex.config.chunk_ticks,
           "scenario_chunk": s["scenario_chunk"], "launches": launches,
           "captures": ex.captures, "wall_seconds": s["wall_seconds"],
           "scenarios_per_sec": s["scenarios_per_sec"],
           "direct_wall_seconds": d_wall,
           "direct_scenarios_per_sec": SWEEP_RUNNER_SEEDS / d_wall,
           "wall_ratio": s["wall_seconds"] / d_wall,
           "compile_seconds": s["compile_seconds"],
           "compile_breakdown": s["compile_breakdown"],
           "host_spans": s["host_spans"],
           "demux_seconds_per_scenario": demux_s / max(demux_n, 1),
           "state_model_bytes": s["hbm_preflight"][
               "state_model_bytes_per_device"],
           "peak_bytes": out.peak_bytes}
    report["runner_sweep10k"] = row
    log(f"  {SWEEP_RUNNER_SEEDS}-seed storm@10k through the runner: "
        f"{s['outcome']}, {s['ticks']} batched iterations (chunk "
        f"{ex.config.chunk_ticks}), {s['scenarios_per_sec']} scenarios/s, "
        f"dispatch {s['wall_seconds']:.3f} s against the direct batched "
        f"run's {d_wall:.3f} s (x{row['wall_ratio']:.3f}); captures "
        f"{ex.captures}; count-scatter launches {launches['count_scatter']}"
        f" (folded, {executed} executed); demux "
        f"{row['demux_seconds_per_scenario']:.3f} s a scenario; host spans "
        + ", ".join(f"{r['name']} {r['seconds']:.3f} s"
                    for r in s["host_spans"])
        + "; scenario 0 equal to [36]'s run")
    return row


def runner_sweep_resume_phase(torch, dev, report, tmp, full_dir, first):
    """[43] [42]'s sweep under a forced budget that holds half its
    scenarios: the pre-flight splits it into 2 scenario chunks; preempted
    inside chunk 1 and resumed with no capture: every scenario's files
    and row equal to [42]'s."""
    from testground_tpu_torch.runner.outputs import (
        deterministic, output_files, run_out_lines)
    from testground_tpu_torch.sim import runner
    from testground_tpu_torch.sim.sweep import SWEEP_MEMORY_FRACTION

    runner.clear_executor_pool()
    # 0.75 of the whole sweep's state: 8 scenarios fit, 16 do not
    budget = int(0.75 * first["state_model_bytes"] / SWEEP_MEMORY_FRACTION)
    ck = {"checkpoint": {"interval": 0.0}}
    rc = {"chunk_ticks": SWEEP_RESUME_CHUNK}
    cut_dir = os.path.join(tmp, "sweep_cut")
    os.environ["TESTGROUND_HBM_BYTES"] = str(budget)
    try:
        with preempt_at(SWEEP_RESUME_STOP_AT):
            out_b, s_b, _ = runner_run(torch, dev, sweep_input(
                cut_dir, "sweep_cut", run_config=rc, **ck))
        caps = pooled_captures()
        out_c, s_c, launches = runner_run(torch, dev, sweep_input(
            cut_dir, "sweep_cut", run_config=rc, resume=True, **ck))
    finally:
        del os.environ["TESTGROUND_HBM_BYTES"]
    assert out_b.result.outcome == "preempted" and s_b["preempted"]
    assert s_b["scenario_chunk"] == SWEEP_RUNNER_SEEDS // 2, s_b[
        "scenario_chunk"]
    assert out_c.result.outcome == "success"
    assert pooled_captures() == caps, "the resume captured again"
    assert s_c["resumed_from_chunk"] == 1, s_c["resume"]
    assert s_c["compiles"] == 0
    assert scenario_rows(cut_dir) == scenario_rows(full_dir)
    assert run_out_lines(cut_dir) == run_out_lines(full_dir)
    files = output_files(full_dir)
    assert len(files) == SWEEP_RUNNER_SEEDS and output_files(cut_dir) == files
    a = _without(deterministic(s_c, cut_dir), BATCHED_RESUME_KEYS)
    b = _without(deterministic(first["summary"], full_dir),
                 BATCHED_RESUME_KEYS)
    assert a == b, {k: (a.get(k), b.get(k)) for k in set(a) | set(b)
                    if a.get(k) != b.get(k)}
    row = {"budget_bytes": budget, "scenario_chunk": s_b["scenario_chunk"],
           "chunk_ticks": SWEEP_RESUME_CHUNK,
           "preempted_at_tick": s_c["resumed_from_tick"],
           "snapshots_before_preempt": s_b["checkpoint"]["snapshots"],
           "resumed_from_chunk": s_c["resumed_from_chunk"],
           "resumed_from_tick": s_c["resumed_from_tick"],
           "resumed_wall_seconds": s_c["wall_seconds"],
           "resume_launches": launches}
    report["runner_sweep_resume"] = row
    log(f"  forced budget {budget / 1e6:.1f} MB: 2 chunks of "
        f"{s_b['scenario_chunk']}; preempted in chunk 1 "
        f"({s_b['checkpoint']['snapshots']} snapshots), resumed from chunk "
        f"{s_c['resumed_from_chunk']} at tick {s_c['resumed_from_tick']} "
        f"with no capture (dispatch {s_c['wall_seconds']:.3f} s): every "
        "scenario's files and row equal to [42]'s")
    return row


def runner_dht_sweep_phase(torch, dev, report, tmp, phase7):
    """[44] dht@10k on the default lowering swept over DHT_SWEEP_SEEDS
    seeds through the runner: one capture, the ring merge's folded
    launch once a batched iteration, and every scenario's outcome and
    ticks equal to phase 7's executable built with its seed (a plain
    build bakes its seed's key into the tick)."""
    from testground_tpu_torch.sim import runner
    from testground_tpu_torch.sim.program import CRASHED
    from testground_tpu_torch.sim.tables import Sweep

    runner.clear_executor_pool()
    rc = {k: v for k, v in DHT_RUN_CONFIG.items() if k != "pallas_front"}
    ri = runner_input("dht", "find-providers", 10_000, DHT_PARAMS,
                      os.path.join(tmp, "dht_sweep"), "dht_sweep", rc,
                      sweep=Sweep(seeds=DHT_SWEEP_SEEDS))
    out, s, launches = runner_run(torch, dev, ri)
    ex = pooled(runner)
    rows = s["scenarios"]
    executed = max(r["ticks_executed"] for r in rows)
    assert ex.captures == 1, ex.captures
    assert launch_bounds(executed, ex.config.chunk_ticks,
                         launches["ring_merge"]), (launches, executed)
    assert (launches["deliver_front"], launches["count_scatter"]) == (0, 0)
    runner.clear_executor_pool()
    # phase 7's run for seed 0, phase 7's executable for the others
    got = [(phase7["ticks"], phase7["ok"], 10_000, phase7["crashed"])]
    for r in rows[1:]:
        res = dht_exec(10_000, dev, pallas_front=None, seed=r["seed"]).run()
        ok, total = res.outcomes()["single"]
        got.append((res.ticks, ok, total,
                    int((res.statuses()[:10_000] == CRASHED).sum())))
        del res
    for r, want in zip(rows, got):
        assert (r["ticks"], r["outcomes"]["single"]["ok"],
                r["outcomes"]["single"]["total"],
                r.get("crashed_count", 0)) == want, (r, want)
    row = {"seeds": DHT_SWEEP_SEEDS, "outcome": s["outcome"],
           "ticks": s["ticks"], "ticks_executed": executed,
           "chunk_ticks": ex.config.chunk_ticks, "launches": launches,
           "captures": 1, "wall_seconds": s["wall_seconds"],
           "scenarios_per_sec": s["scenarios_per_sec"],
           "host_spans": s["host_spans"],
           "ok": [r["outcomes"]["single"]["ok"] for r in rows],
           "peak_bytes": out.peak_bytes}
    report["runner_dht_sweep10k"] = row
    log(f"  dht@10k (default lowering) over {DHT_SWEEP_SEEDS} seeds through "
        f"the runner: {s['ticks']} batched iterations, dispatch "
        f"{s['wall_seconds']:.3f} s ({s['scenarios_per_sec']} scenarios/s),"
        f" captures 1, ring-merge launches {launches['ring_merge']} "
        f"(folded, {executed} executed); ok {row['ok']}, each equal to "
        "phase 7's executable run with its seed")
    return row


class preempt_after_round:
    """The runner's should_stop hook preempting a search at its first
    boundary after the driver's first checkpoint (round 0 digested)."""

    def __init__(self):
        from testground_tpu_torch.sim import runner

        self.runner, self.real = runner, runner._make_should_stop

    def __enter__(self):
        runner = self.runner

        def make(rinput):
            rid = rinput.run_id
            ev = runner._term_event(rid)
            drv = os.path.join(rinput.run_dir, "checkpoint", "driver.pkl")

            def should_stop():
                if os.path.exists(drv):
                    runner.request_preempt(rid)
                return ev.is_set()

            return should_stop

        runner._make_should_stop = make

    def __exit__(self, *exc):
        self.runner._make_should_stop = self.real


def _without_compiles(lines):
    """A search's run.out without the last line's build count (a resumed
    search reuses the pooled build)."""
    return lines[:-1] + [lines[-1].split(" compiles=")[0]]


def demo_search_input(tmp, name, run_id, n=FAULTSDEMO_BIG_N, **kw):
    """plans/faultsdemo/composition.toml at ``n`` instances with its own
    [search] table enabled, prepared as the command line prepares it."""
    from testground_tpu_torch import cli
    from testground_tpu_torch.api.composition import Composition

    comp = Composition.load(os.path.join(ROOT, "plans", "faultsdemo",
                                         "composition.toml"))
    comp.global_.total_instances = n
    for g in comp.groups:
        g.instances.count = n // len(comp.groups)
    comp.search.enabled = True
    comp.global_.run_config.update(DEMO_SEARCH_RUN_CONFIG)
    comp.checkpoint = None
    ri = cli.prepare_run(comp, os.path.join(ROOT, "plans", "faultsdemo"),
                         run_id, os.path.join(tmp, name))
    for k, v in kw.items():
        setattr(ri, k, v)
    return ri


def runner_search_phase(torch, dev, report, tmp, phase34):
    """[45] searches through the runner: phase 34's cliff@10k bisect as a
    composition (its rounds and edge, one capture); faultsdemo's
    composition at 1,024 with its own [search] (rounds, breaking_point,
    one capture); that search preempted after a round and resumed, its
    roll-up equal to the uninterrupted one."""
    from testground_tpu_torch import bench
    from testground_tpu_torch.runner.outputs import (
        deterministic, output_files, run_out_lines)
    from testground_tpu_torch.api.composition import Checkpoint
    from testground_tpu_torch.sim import runner
    from testground_tpu_torch.sim.tables import Search

    runner.clear_executor_pool()
    ri = runner_input(
        "benchmarks", "cliff", 10_000, {"x_fail": CLIFF_AT},
        os.path.join(tmp, "cliff"), "cliff",
        {"quantum_ms": 10.0, "max_ticks": 10_000, "metrics_capacity": 8},
        search=Search(param="x", lo=0.0, hi=1.0,
                      step=1.0 / bench.SEARCH_GRID,
                      width=bench.SEARCH_WIDTH))
    _, s, _ = runner_run(torch, dev, ri)
    caps = pooled(runner).captures
    bp = s["breaking_point"]
    assert s["outcome"] == "success" and bp["resolved"], bp
    assert (s["rounds"], bp["first_failing"]) == (
        phase34["rounds"], phase34["breaking_point"]), (s["rounds"], bp)
    assert s["compiles"] == 1 and caps == 1, (s["compiles"], caps)
    cliff = {"rounds": s["rounds"], "breaking_point": bp["first_failing"],
             "scenarios_probed": s["scenarios_probed"],
             "wall_seconds": s["wall_seconds"], "captures": caps,
             "host_spans": s["host_spans"]}
    log(f"  cliff@10k through the runner: edge {bp['first_failing']} in "
        f"{s['rounds']} rounds (phase 34: {phase34['rounds']}), "
        f"{s['scenarios_probed']} probed, captures {caps}, dispatch "
        f"{s['wall_seconds']:.3f} s")
    runner.clear_executor_pool()
    full = demo_search_input(tmp, "demo", "demo")
    _, s_full, launches = runner_run(torch, dev, full)
    caps = pooled(runner).captures
    bp = s_full["breaking_point"]
    assert s_full["outcome"] == "success" and bp["resolved"], bp
    assert s_full["compiles"] == 1 and caps == 1, (s_full["compiles"], caps)
    assert launches["count_scatter"] > 0, launches
    runner.clear_executor_pool()
    ck = {"checkpoint": Checkpoint(interval=0.0)}
    with preempt_after_round():
        out_b, s_b, _ = runner_run(torch, dev, demo_search_input(
            tmp, "demo_cut", "demo_cut", **ck))
    caps = pooled_captures()
    resumed = demo_search_input(tmp, "demo_cut", "demo_cut", resume=True,
                                **ck)
    out_c, s_c, _ = runner_run(torch, dev, resumed)
    assert out_b.result.outcome == "preempted", out_b.result.outcome
    assert len(s_b["search_rounds"]) == 1
    assert out_c.result.outcome == "success"
    assert s_c["resumed_from_round"] == 1 and s_c["compiles"] == 0
    assert pooled_captures() == caps, "the resumed search captured again"
    a = _without(deterministic(s_c, resumed.run_dir), BATCHED_RESUME_KEYS)
    b = _without(deterministic(s_full, full.run_dir), BATCHED_RESUME_KEYS)
    assert a == b, {k: (a.get(k), b.get(k)) for k in set(a) | set(b)
                    if a.get(k) != b.get(k)}
    assert (_without_compiles(run_out_lines(resumed.run_dir))
            == _without_compiles(run_out_lines(full.run_dir)))
    assert output_files(resumed.run_dir) == output_files(full.run_dir)
    demo = {"n": FAULTSDEMO_BIG_N, "rounds": s_full["rounds"],
            "breaking_point": bp, "scenarios_probed":
            s_full["scenarios_probed"], "wall_seconds": s_full["wall_seconds"],
            "captures": 1, "launches": launches,
            "host_spans": s_full["host_spans"],
            "resumed_wall_seconds": s_c["wall_seconds"]}
    report["runner_search"] = {"cliff10k": cliff, "faultsdemo": demo}
    log(f"  faultsdemo@{FAULTSDEMO_BIG_N:,d} search: chaos_loss edge "
        f"{bp.get('first_failing')} (last passing {bp.get('last_passing')})"
        f" in {s_full['rounds']} rounds, {s_full['scenarios_probed']} "
        f"probed, captures 1, dispatch {s_full['wall_seconds']:.3f} s; "
        "preempted after round 0 and resumed from round 1 with no capture:"
        " roll-up, run.out and probe files equal to the uninterrupted one")
    runner.clear_executor_pool()
    return report["runner_search"]


def leases_phase(torch, dev, report, tmp):
    """[46] two runner runs on threads at once (storm@10k cut at 300
    ticks): under the card's budget they are granted together; under a
    forced lease budget that holds one, the second waits for the first's
    release. Both journals carry ``lease``."""
    import threading

    from testground_tpu_torch.sim import runner
    from testground_tpu_torch.sim.leases import LEASES

    def pair(tag):
        runner.clear_executor_pool()
        outs = {}

        def go(k):
            ri = storm_input(os.path.join(tmp, f"{tag}{k}"), f"{tag}{k}",
                             run_config=LEASE_RUN_CONFIG)
            outs[k] = runner.run_composition(ri, device=dev)

        threads = [threading.Thread(target=go, args=(k,)) for k in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert set(outs) == {0, 1}, "a concurrent run failed"
        for o in outs.values():
            assert o.result.journal["ticks"] == LEASE_RUN_CONFIG[
                "max_ticks"], o.result.journal["ticks"]
        return [outs[k].result.journal["lease"] for k in (0, 1)]

    together = pair("lease_a")
    assert max(r["concurrent_runs"] for r in together) == 1, together
    assert all(r["waited_s"] < 0.5 and "overcommitted" not in r
               for r in together), together
    need = together[0]["bytes_per_device"]
    LEASES._budget_fn = lambda: int(1.5 * need)
    try:
        serial = pair("lease_b")
    finally:
        LEASES._budget_fn = None
    waited = max(r["waited_s"] for r in serial)
    assert all(r["concurrent_runs"] == 0 for r in serial), serial
    assert waited > 0.5 and all("overcommitted" not in r for r in serial)
    row = {"bytes_per_device": need, "together": together,
           "forced_budget": int(1.5 * need), "one_at_a_time": serial}
    report["leases"] = row
    log(f"  two runs of {need / 1e6:.1f} MB: granted together under the "
        f"card's budget ({together}); under a forced budget of "
        f"{1.5 * need / 1e6:.1f} MB one at a time, the second waited "
        f"{waited:.3f} s for the first's release")
    runner.clear_executor_pool()
    return row


def batched_parity_phase(torch, dev, report, tmp):
    """[47] the card against the CPU through the batched runner paths:
    storm (compressed params, the dial window and data cut further, to
    600 ms and 8 KiB, as the CPU tests cut them) at 300 over 4 seeds
    in chunks of 2, and a cliff bisect at 64 over a 17-value grid; every
    deterministic key, run.out, scenario or probe file and progress row
    equal."""
    report["batched_parity"] = runner_parity_pair(
        dev, tmp, ("storm300_sweep", "cliff64_search"))
    return report["batched_parity"]


# ------------------------------------------------- the daemon ([48]-[50])

DAEMON_TOKEN = "chip-smoke-token"
# the daemons' dispatch heartbeat off: its progress rows count wall
# time, so that their summaries compare with [36]'s and [37]'s
DAEMON_ENV = {"TG_DISPATCH_HEARTBEAT_S": "86400"}
# [49]'s storm@10k runs watched, terminated and preempted: 512-tick
# chunks, a progress row and a checkpoint at every boundary
WATCH_TABLES = {"live": {"enabled": True, "interval": 0.0},
                "checkpoint": {"enabled": True, "interval": 0.0}}
# R14f's figures (PR 14's last chip run, NVIDIA H100 80GB HBM3, 700 W),
# printed beside this run's so that a perturbation by the CPU child shows
R14F = {"storm10k_ms_per_executed_tick": 3.4050105413113765,
        "runner_storm10k_dispatch_seconds": 11.482488762999992,
        "runner_sweep10k_scenarios_per_sec": 0.859}


def composition_of(plan, case, n, params, run_config, groups=("single",),
                   **tables) -> dict:
    """A composition in the form ``POST /run`` carries: ``n`` instances
    of ``plan``'s ``case`` split evenly over ``groups``, the sim:module
    builder, and ``tables``."""
    return {
        "metadata": {},
        "global": {"plan": plan, "case": case, "runner": "sim:jax",
                   "builder": "sim:module", "total_instances": n,
                   "run_config": dict(run_config)},
        "groups": [{"id": g, "instances": {"count": n // len(groups)},
                    "run": {"test_params": {k: str(v)
                                            for k, v in params.items()}}}
                   for g in groups],
        **tables,
    }


def daemon_proc(home, device="cuda", threads=None):
    """``python -m testground_tpu_torch daemon`` as users start it
    (``bench.DaemonProcess``): a home of its own whose ``.env.toml``
    requires a bearer token, its output to a log file in that home,
    ``threads`` torch threads."""
    from testground_tpu_torch import bench

    env = dict(DAEMON_ENV)
    if threads:
        env["OMP_NUM_THREADS"] = str(threads)
    return bench.DaemonProcess(home, device, env=env, token=DAEMON_TOKEN)


def task_timing(st) -> dict:
    """A finished task's queue wait, dispatch, compile and
    submit-to-complete seconds (the daemon's own state stamps)."""
    by = {}
    for rec in st["states"]:
        by.setdefault(rec["state"], rec["created"])
    j = (st.get("result") or {}).get("journal") or {}
    return {"queue_wait_seconds": by["processing"] - st["created"],
            "dispatch_seconds": j.get("wall_seconds"),
            "compile_seconds": j.get("compile_seconds"),
            "submit_to_complete_seconds":
                st["states"][-1]["created"] - st["created"]}


def assert_like_ref(st, got_dir, orig_dir, ref_dir, skip=(),
                    ref_orig=None):
    """A daemon run's collected files against an in-process run's:
    results.out byte for byte, run.out but its wall, and every
    deterministic summary key (but ``skip``); the summaries' paths are
    each run's own directory (``orig_dir``; ``ref_orig`` when
    ``ref_dir`` is a copy), written ``<run_dir>``."""
    from testground_tpu_torch.runner.outputs import (
        deterministic, output_files, run_out_lines, summary)

    a = _without(deterministic(summary(got_dir), orig_dir), skip)
    b = _without(deterministic(summary(ref_dir), ref_orig or ref_dir), skip)
    for d in (a, b):
        d.get("hbm_preflight", {}).pop("executor_cache", None)
    assert a == b, {k: (a.get(k), b.get(k)) for k in set(a) | set(b)
                    if a.get(k) != b.get(k)}
    assert run_out_lines(got_dir) == run_out_lines(ref_dir)
    files = output_files(ref_dir)
    assert files and output_files(got_dir) == files, sorted(files)
    return a


def daemon_phase(report, tmp, card, refs, comps):
    """[48] the card daemon's client submits ``comps`` (storm@10k as
    [36] ran it, dht@10k with the fused front as [37]) at once: two
    scheduler workers run them under device leases; each outputs
    tarball's results.out, run.out and deterministic summary keys equal
    the in-process run's (``refs``); queue wait, dispatch and
    submit-to-complete against [36]'s and [37]'s walls."""
    from testground_tpu_torch import bench
    from testground_tpu_torch.runner.outputs import summary

    c = card.client()
    log(f"  card daemon listening on {card.endpoint()} after "
        f"{card.ready_seconds:.1f} s")
    tids = {k: c.run(comp, plan_dir=os.path.join(
        ROOT, "plans", comp["global"]["plan"])) for k, comp in comps.items()}
    rows = {}
    for k, tid in tids.items():
        st = bench.wait_task(c, tid)
        # dht's churned instances crash: its outcome is [37]'s failure
        want = summary(refs[k][0])["outcome"]
        assert st["state"] == "complete" and st["outcome"] == want, (
            k, st["state"], st["outcome"], want, st.get("error"))
        plan = comps[k]["global"]["plan"]
        got = bench.collect(c, tid, os.path.join(tmp, "d48", k))
        # the live plane's snapshots count wall time (the dispatch
        # heartbeat's rows): the daemon's are not [36]'s
        assert_like_ref(st, got, card.run_dir(plan, tid), refs[k][0],
                        skip=("live",))
        j = st["result"]["journal"]
        rows[k] = {"task": tid, **task_timing(st), "lease": j.get("lease"),
                   "in_process_dispatch_seconds": refs[k][1],
                   "in_process_compile_seconds": refs[k][2]}
        log(f"  {k}: {st['outcome']}, results.out, run.out and summary "
            f"equal to the in-process run's; queue wait "
            f"{rows[k]['queue_wait_seconds']:.3f} s, build+capture "
            f"{rows[k]['compile_seconds']:.3f} s, dispatch "
            f"{rows[k]['dispatch_seconds']:.3f} s (in process: "
            f"{refs[k][1]:.3f} s), submit to complete "
            f"{rows[k]['submit_to_complete_seconds']:.3f} s; lease "
            f"{(j.get('lease') or {}).get('concurrent_runs')} concurrent")
        assert j.get("lease"), "no lease journaled"
    report["daemon_runs"] = rows
    return c


def serving_phase(report, tmp, card, c, ref_storm, storm10k):
    """[49] the serving surface: storm cut at 300 ticks submitted twice
    (the second a pool hit: memory_hit, compiles 0, no capture; /cache
    lists the pooled executor); /metrics' lease and pool counters; two
    storm@10k runs in 512-tick chunks, /progress serving snapshots while
    they run, a third task queued behind them and killed, one run
    terminated at a chunk boundary by kill, POST /terminate answering 0
    with the other still running (the sim runner's ``terminate_all``
    stops nothing, in JAX as in the port), that one preempted by SIGTERM
    to the daemon; the daemon restarted on the same home resumes it
    (POST /resume) to [36]'s results.out."""
    import urllib.request

    from testground_tpu_torch import bench

    row = {}
    short = dict(storm10k, **{"global": dict(
        storm10k["global"], run_config=dict(STORM_RUN_CONFIG,
                                            **LEASE_RUN_CONFIG))})
    plan_dir = os.path.join(ROOT, "plans", "benchmarks")
    sts = []
    for _ in range(2):
        sts.append(bench.wait_task(c, c.run(short, plan_dir=plan_dir)))
    j1, j2 = (st["result"]["journal"] for st in sts)
    assert j2["hbm_preflight"]["executor_cache"] == "memory_hit", j2
    assert j2["compiles"] == 0 and j2["compile_breakdown"] is None
    assert j2["ticks"] == j1["ticks"] == LEASE_RUN_CONFIG["max_ticks"]
    info = c.cache()
    assert info["enabled"] is False and info["memory"]["keys"] >= 1
    assert info["memory"]["memory_hits"] >= 1, info["memory"]
    row["pool"] = {"first": task_timing(sts[0]), "hit": task_timing(sts[1]),
                   "cache": info["memory"]}
    log(f"  storm@10k cut at 300 ticks twice: the second a memory_hit "
        f"with compiles 0 (build+capture {j1['compile_seconds']:.3f} s, "
        f"then {j2['compile_seconds']:.3f} s); /cache: "
        f"{info['memory']['keys']} pooled key(s), "
        f"{info['memory']['memory_hits']} hit(s)")
    req = urllib.request.Request(card.endpoint() + "/metrics", headers={
        "Authorization": f"Bearer {DAEMON_TOKEN}"})
    with urllib.request.urlopen(req, timeout=30) as r:
        text = r.read().decode()
    for want in ("tg_lease_bytes_admitted_total ",
                 'tg_excache_ops_total{op="hit",tier="memory"}',
                 "tg_run_chunk_seconds_count ",
                 'tg_task_transitions_total{state="complete"}'):
        assert want in text, want
    row["metrics_lines"] = len(text.splitlines())

    watched = dict(storm10k, **{"global": dict(
        storm10k["global"], run_config=dict(
            STORM_RUN_CONFIG, chunk_ticks=RESUME_CHUNK))}, **WATCH_TABLES)
    a = c.run(watched, plan_dir=plan_dir)
    b = c.run(watched, plan_dir=plan_dir)
    snaps = {}
    for tid in (a, b):
        bench.wait_task(c, tid, states=("processing",))
        deadline = time.monotonic() + 120
        while True:
            got = []
            c.progress(tid, on_snapshot=got.append)
            if got:
                break
            assert time.monotonic() < deadline, "no snapshot while running"
            time.sleep(0.05)
        assert c.status(tid)["state"] == "processing"
        snaps[tid] = len(got)
    q = c.run(short, plan_dir=plan_dir)
    assert c.status(q)["state"] == "scheduled"
    assert c.kill(q) == {"killed": q}
    assert bench.wait_task(c, q)["state"] == "canceled"
    assert c.kill(b) == {"killed": b}
    sb = bench.wait_task(c, b)
    jb = sb["result"]["journal"]
    assert sb["state"] == "canceled" and sb["result"]["outcome"] == \
        "terminated", (sb["state"], sb["result"]["outcome"])
    assert jb["ticks"] % RESUME_CHUNK == 0 and jb["terminated"]
    assert c.terminate("sim:jax") == 0
    assert c.status(a)["state"] == "processing", "the run ended too soon"
    t0 = time.monotonic()
    rc = card.stop()
    stop_s = time.monotonic() - t0
    assert rc == 0, (rc, open(card.log_path).read()[-3000:])
    card.start()
    c = card.client()
    sa = c.status(a)
    assert sa["state"] == "complete" and sa["outcome"] == "preempted", (
        sa["state"], sa["outcome"])
    assert sa["input"]["resume"] is True
    ja = sa["result"]["journal"]
    assert ja["ticks"] % RESUME_CHUNK == 0 and ja["checkpoint"][
        "snapshots"] >= 1
    assert c.resume(a) == {"resumed": a}
    sr = bench.wait_task(c, a)
    assert sr["outcome"] == "success", (sr["outcome"], sr.get("error"))
    jr = sr["result"]["journal"]
    assert jr["resumed_from_tick"] == ja["ticks"]
    got = bench.collect(c, a, os.path.join(tmp, "d49"))
    assert_like_ref(sr, got, card.run_dir("benchmarks", a), ref_storm,
                    skip=RESUME_KEYS)
    row.update({"snapshots_while_running": snaps,
                "terminated_at_tick": jb["ticks"],
                "preempted_at_tick": ja["ticks"],
                "sigterm_to_exit_seconds": stop_s,
                "restart_ready_seconds": card.ready_seconds,
                "resumed": task_timing(sr)})
    log(f"  /progress served {snaps[a]} and {snaps[b]} snapshot(s) while "
        f"running; a queued task killed; one run terminated at tick "
        f"{jb['ticks']}; SIGTERM preempted the other at tick {ja['ticks']}"
        f" (exit 0 in {stop_s:.1f} s); the restarted daemon (ready in "
        f"{card.ready_seconds:.1f} s) resumed it: results.out, run.out and "
        "summary equal to [36]'s")
    report["daemon_serving"] = row
    return c


def planes_composition(n=300, sweep=None) -> dict:
    """[28]'s storm under all three planes as a composition (bench.py's
    fault timeline compressed with the dial window, 64-slot rings,
    samples every 10 ticks, 2,000 ticks), checkpointed at every chunk
    boundary, optionally swept."""
    from testground_tpu_torch import bench, graft

    scale = graft.STORM_PARAMS["conn_delay_ms"] / bench.PARAMS["conn_delay_ms"]
    # a checkpoint at every chunk boundary: the default 60 s interval
    # would count wall time (the CPU run's snapshots, not the card's)
    tables = {"faults": bench.fault_timeline(scale),
              "trace": {"capacity": bench.TRACE_CAPACITY},
              "telemetry": {"interval": 10},
              "checkpoint": {"enabled": True, "interval": 0.0}}
    if sweep:
        tables["sweep"] = {"seeds": sweep}
    return composition_of(
        "benchmarks", "storm", n, dict(graft.STORM_PARAMS,
                                       **bench.FAULT_PARAMS),
        {"quantum_ms": 10.0, "max_ticks": 2_000, "chunk_ticks": 32,
         "phase_gating": True}, **tables)


def plane_comps() -> dict:
    """[50]'s two compositions, by key."""
    return {"storm300_planes": planes_composition(),
            "storm300_planes_sweep": planes_composition(sweep=2)}


def daemon_parity_phase(report, card, c, cpu, cpu_tids):
    """[50] storm @ 300 under its planes, and a 2-seed [sweep] of it,
    through the card daemon and the ``--device cpu`` daemon (submitted
    at [48]): every deterministic key, run.out, output file, scenario row
    and progress row equal."""
    from testground_tpu_torch import bench
    from testground_tpu_torch.runner.outputs import assert_runs_equal

    cc = cpu.client()
    plan_dir = os.path.join(ROOT, "plans", "benchmarks")
    rows = {}
    for k, comp in plane_comps().items():
        st = bench.wait_task(c, c.run(comp, plan_dir=plan_dir))
        sc = bench.wait_task(cc, cpu_tids[k])
        assert st["outcome"] == sc["outcome"] == "success", (
            k, st["outcome"], sc["outcome"], sc.get("error"))
        gdir = card.run_dir("benchmarks", st["id"])
        cdir = cpu.run_dir("benchmarks", sc["id"])
        s = assert_runs_equal(gdir, cdir)
        if "sweep" in k:
            assert scenario_rows(gdir) == scenario_rows(cdir)
        rows[k] = {"ticks": s["ticks"], "gpu": task_timing(st),
                   "cpu": task_timing(sc)}
        log(f"  {k}: card daemon == CPU daemon (summary, run.out, outputs,"
            f" scenario and progress rows), {s['ticks']} ticks; submit to "
            f"complete {rows[k]['gpu']['submit_to_complete_seconds']:.2f} s"
            f" on the card, {rows[k]['cpu']['submit_to_complete_seconds']:.2f}"
            " s on the CPU")
    report["daemon_parity"] = rows


def daemon_phases(report, tmp, refs):
    """[48]-[50] against the card daemon and a CPU daemon started
    together (the CPU daemon's runs for [50] submitted first, so that
    they overlap [48]-[49])."""
    from testground_tpu_torch import bench

    t0 = time.monotonic()
    storm10k = composition_of("benchmarks", "storm", 10_000, bench.PARAMS,
                              STORM_RUN_CONFIG)
    dht10k = composition_of("dht", "find-providers", 10_000, DHT_PARAMS,
                            DHT_RUN_CONFIG)
    card = daemon_proc(os.path.join(tmp, "card-home"))
    cpu = daemon_proc(os.path.join(tmp, "cpu-home"), device="cpu",
                     threads=cpu_threads())
    try:
        cc = cpu.client()
        plan_dir = os.path.join(ROOT, "plans", "benchmarks")
        cpu_tids = {k: cc.run(comp, plan_dir=plan_dir)
                    for k, comp in plane_comps().items()}
        log("[48] the daemon: storm @ 10,000 and dht @ 10,000 (fused front) "
            "submitted at once through its client")
        c = daemon_phase(report, tmp, card, refs,
                         {"storm10k": storm10k, "dht10k": dht10k})
        log("[49] the serving surface: a pool hit, /cache, /metrics, "
            "/progress, kill, terminate, SIGTERM and resume")
        c = serving_phase(report, tmp, card, c, refs["storm10k"][0],
                          storm10k)
        log("[50] storm @ 300 under its planes and a 2-seed [sweep] of it: "
            "card daemon vs CPU daemon")
        daemon_parity_phase(report, card, c, cpu, cpu_tids)
    finally:
        rcs = {"card": card.stop(), "cpu": cpu.stop()}
    assert rcs == {"card": 0, "cpu": 0}, rcs
    report["daemon_phases_seconds"] = time.monotonic() - t0
    log(f"  [48]-[50]: {report['daemon_phases_seconds']:.1f} s; both "
        "daemons stopped by SIGTERM, exit 0")



# ------------------------- the host planes, the ladder, the contracts

# [51]-[53]'s depth: 24 of the legs' 50 timer rounds (the cut [30] takes);
# the metrics leg's plain runs stay above bench.py's 2 s floor, so its
# 5% assertion is made
HOST_PLANE_ROUNDS = 24


def host_plane_phase(dev, report, plane, n=10_000):
    """[51]-[53] ``bench --live``, ``--metrics`` or ``--ckpt`` at ``n``,
    the legs' ``PLANE_RUNS`` pairs of runs, each overhead the median
    pair's: the leg's assertions (the loop iteration's ops and graph
    nodes equal under the plane, before and after its runs; the live
    rows, the metrics families and its 5% bound; the ckpt resume
    bit-equal)."""
    from testground_tpu_torch import bench

    bench.kernel_launches(reset=True)
    line = bench.HOST_PLANE_LEGS[plane](n, dev, rounds=HOST_PLANE_ROUNDS)
    line["launches"] = bench.kernel_launches()
    line.pop("states", None)
    rows = line.pop("rows", None)
    if rows is not None:
        line["row_ticks"] = [r["tick"] for r in rows]
    if plane == "metrics":
        assert line["overhead_asserted"], (
            f"the plain runs took {line['off_wall_seconds']:.3f} s: under "
            "bench.py's 2 s floor, the 5% bound was not asserted")
    assert line["launches"]["count_scatter"] > 0, line["launches"]
    report[f"{plane}10k"] = line
    walls = {k: v for k, v in line.items() if k.endswith("wall_seconds")}
    log(f"  sparsetimer@{n:,d} x {HOST_PLANE_ROUNDS} rounds, "
        f"{line['ticks']} ticks: {walls}; overhead {line['value']:+.2f}% "
        f"(target 5%); loop iteration {line['loop']} with and without the "
        f"plane; launches {line['launches']}"
        + (f"; {line['snapshots']} snapshots, resumed from tick "
           f"{line['resumed_from_tick']} bit-equal on "
           f"{line['leaves_compared']} leaves" if plane == "ckpt" else "")
        + (f"; {line['chunks']} chunks, dispatch mean "
           f"{line['dispatch_mean_s']} s" if plane == "metrics" else ""))
    return line


def ladder_phase(dev, report):
    """[54] the faultsdemo chaos ladder on the card: each combo's build
    and capture seconds, ops and graph nodes within op_budgets.json."""
    from testground_tpu_torch import bench

    line = bench.compile_leg(dev)
    report["compile_ladder"] = line
    for r in line["ladder"]:
        log(f"  {r['combo']:13s} build {r['build_seconds']:.3f} s, capture "
            f"{r['capture_seconds']:.3f} s, ops {r['ops']}, graph nodes "
            f"{r['graph_nodes']} {r['graph_nodes_by_type']}")
    return line


def contracts_phase(dev, report):
    """[55] ``check_contracts`` on the card: every ported contract holds
    (ops and graph nodes), warmstart and prewarm not ported."""
    from testground_tpu_torch.tools import check_contracts

    rows = check_contracts.run_contracts(check_contracts.N_DEFAULT, dev)
    report["contracts"] = [list(r) for r in rows]
    for name, status, detail in rows:
        log(f"  {name:13s} {status:18s} {detail}")
    log(f"  {check_contracts.summary(rows)}")
    bad = [r for r in rows if r[1] == "FAIL"]
    assert not bad, bad
    assert {r[0] for r in rows if r[1] != "PASS"} == set(
        check_contracts.NOT_PORTED), rows


# ------------------------------------------ the command line ([56]-[58])

class cli_run:
    """``cli.main(argv)`` in this process (what ``python -m
    testground_tpu_torch`` calls, without a second round of torch's
    one-time imports), ``TESTGROUND_HOME`` set to ``home``: its exit
    code, its stdout's lines and its stderr, and its seconds."""

    def __init__(self, home, *argv):
        import contextlib
        import io

        from testground_tpu_torch import cli

        out, err = io.StringIO(), io.StringIO()
        old = os.environ.get("TESTGROUND_HOME")
        os.environ["TESTGROUND_HOME"] = home
        t0 = time.monotonic()
        try:
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                self.rc = cli.main(list(argv))
        finally:
            self.seconds = time.monotonic() - t0
            if old is None:
                os.environ.pop("TESTGROUND_HOME", None)
            else:
                os.environ["TESTGROUND_HOME"] = old
        self.lines = out.getvalue().splitlines()
        self.err = err.getvalue()
        self.argv = argv
        # the task id: the first line's last word ("task queued: TID")
        self.tid = self.lines[0].split()[-1] if self.lines else ""

    def expect(self, rc, last):
        """Assert the exit code and the command's last line (``<tid>``
        standing for its task id)."""
        want = last.replace("<tid>", self.tid)
        assert (self.rc, self.lines[-1:]) == (rc, [want]), (
            self.argv, self.rc, self.lines[-8:], self.err[-3000:])
        return self


def cli_home(tmp, name, plans):
    """A fresh ``TESTGROUND_HOME`` holding the repository's ``plans``."""
    import shutil

    home = os.path.join(tmp, name)
    for p in plans:
        shutil.copytree(os.path.join(ROOT, "plans", p),
                        os.path.join(home, "plans", p))
    return home


def cli_outputs(home, plan, tid):
    return os.path.join(home, "data", "outputs", plan, tid)


def device_flags(dev):
    """The card is the commands' default; ``--device cpu`` elsewhere
    (a short iteration of these phases on the CPU)."""
    return () if dev.type == "cuda" else ("--device", "cpu")


# the journal keys a run of another task id or through another entry
# point may differ in: none of them is a counter
CLI_RUN_DIFFERS = ("checkpoint", "live", "host_spans")


def cli_single_phase(torch, dev, report, tmp, ref_dir, ref_launches,
                     n=10_000):
    """[56] ``run single --plan benchmarks --testcase storm --instances
    10000 --runner sim:jax --builder sim:module`` with bench.py's params
    and [36]'s run config: exit 0, outcome success, [36]'s count-scatter
    launches, and every summary counter and results.out equal to [36]'s
    run (its group id is ``single`` too)."""
    from testground_tpu_torch import bench
    from testground_tpu_torch.runner.outputs import (
        deterministic, output_files, run_out_lines, summary)
    from testground_tpu_torch.sim import runner

    home = cli_home(tmp, "cli56", ("benchmarks",))
    runner.clear_executor_pool()
    argv = ["run", "single", "--plan", "benchmarks", "--testcase", "storm",
            "--instances", str(n), "--runner", "sim:jax", "--builder",
            "sim:module", *device_flags(dev)]
    for k, v in bench.PARAMS.items():
        argv += ["--test-param", f"{k}={v}"]
    for k, v in STORM_RUN_CONFIG.items():
        argv += ["--run-cfg", f"{k}={json.dumps(v)}"]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    reset_launch_counts()
    r = cli_run(home, *argv)
    launches = other_launches()
    r.expect(0, "run <tid> outcome: success")
    run_dir = cli_outputs(home, "benchmarks", r.tid)
    s, ref = summary(run_dir), summary(ref_dir)
    a = _without(deterministic(s, run_dir), CLI_RUN_DIFFERS)
    b = _without(deterministic(ref, ref_dir), CLI_RUN_DIFFERS)
    assert a == b, ("run single's summary differs from [36]'s",
                    {k: (a.get(k), b.get(k)) for k in set(a) | set(b)
                     if a.get(k) != b.get(k)})
    assert run_out_lines(run_dir) == run_out_lines(ref_dir)
    files = output_files(ref_dir)
    assert files and output_files(run_dir) == files
    if dev.type == "cuda":
        assert launches == ref_launches, (launches, ref_launches)
    row = {"returncode": r.rc, "seconds": r.seconds, "outcome": s["outcome"],
           "ticks": s["ticks"], "launches": launches,
           "wall_seconds": s["wall_seconds"],
           "runner_wall_seconds": ref["wall_seconds"],
           "compile_seconds": s["compile_seconds"],
           "summary_keys_not_compared": list(CLI_RUN_DIFFERS)}
    report["cli_run_single"] = row
    log(f"  run single storm@{n:,d}: exit 0, {s['outcome']}, {s['ticks']} "
        f"ticks, count-scatter launches {launches['count_scatter']} "
        f"([36]: {ref_launches['count_scatter']}); dispatch "
        f"{s['wall_seconds']:.3f} s beside [36]'s {ref['wall_seconds']:.3f}"
        f" s; command {r.seconds:.1f} s; every counter, run.out and "
        "results.out equal to [36]'s but "
        + ", ".join(CLI_RUN_DIFFERS))
    return row


def _runs_equal(a_dir, b_dir, skip=()):
    """Two runs' deterministic summaries (but ``skip``, and whether the
    executor was captured or a pool hit), run.out and output files
    equal."""
    from testground_tpu_torch.runner.outputs import (
        deterministic, output_files, run_out_lines, summary)

    skip = (*skip, "compiles", "compile_breakdown")
    a = _without(deterministic(summary(a_dir), a_dir), skip)
    b = _without(deterministic(summary(b_dir), b_dir), skip)
    for d in (a, b):
        d.get("hbm_preflight", {}).pop("executor_cache", None)
    assert a == b, (a_dir, {k: (a.get(k), b.get(k))
                            for k in set(a) | set(b) if a.get(k) != b.get(k)})
    assert run_out_lines(a_dir) == run_out_lines(b_dir), (a_dir, b_dir)
    files = output_files(b_dir)
    assert files and output_files(a_dir) == files, (a_dir, b_dir)


CLI_CHUNK = 50  # [57]'s faultsdemo @ 4 in 50-tick chunks
CLI_STOP_AT = 3


def cli_resume_phase(dev, report, tmp):
    """[57] faultsdemo @ 4 through ``run composition`` in 50-tick chunks
    checkpointed at every boundary: whole, then preempted at boundary 3
    (exit 3, the JAX command's code for ``preempted``), then ``run
    --resume TASK_ID`` (exit 0): the resumed run's files equal to the
    whole run's."""
    home = cli_home(tmp, "cli57", ("faultsdemo",))
    comp = os.path.join(home, "plans", "faultsdemo", "composition.toml")
    flags = ["--run-cfg", f"chunk_ticks={CLI_CHUNK}",
             "--checkpoint-interval", "0", *device_flags(dev)]
    whole = cli_run(home, "run", "composition", comp, *flags).expect(
        0, "run <tid> outcome: success")
    with preempt_at(CLI_STOP_AT):
        cut = cli_run(home, "run", "composition", comp, *flags).expect(
            3, "run <tid> outcome: preempted")
    resumed = cli_run(home, "run", "--resume", cut.tid,
                      *device_flags(dev))
    assert resumed.lines[0] == f"task requeued for resume: {cut.tid}", (
        resumed.lines, resumed.err[-3000:])
    resumed.expect(0, "run <tid> outcome: success")
    from testground_tpu_torch.runner.outputs import summary

    cut_dir = cli_outputs(home, "faultsdemo", cut.tid)
    s = summary(cut_dir)
    assert s["resumed_from_tick"] == CLI_CHUNK * CLI_STOP_AT, s.get(
        "resumed_from_tick")
    _runs_equal(cut_dir, cli_outputs(home, "faultsdemo", whole.tid),
                RESUME_KEYS)
    row = {"returncodes": [whole.rc, cut.rc, resumed.rc],
           "seconds": [whole.seconds, cut.seconds, resumed.seconds],
           "resumed_from_tick": s["resumed_from_tick"], "ticks": s["ticks"]}
    report["cli_resume"] = row
    log(f"  faultsdemo@4: whole exit {whole.rc}, preempted at tick "
        f"{CLI_CHUNK * CLI_STOP_AT} exit {cut.rc}, run --resume exit "
        f"{resumed.rc}: files equal to the whole run's "
        f"({whole.seconds:.1f} + {cut.seconds:.1f} + {resumed.seconds:.1f}"
        " s)")
    return row


def _demo_text(**edits):
    """plans/faultsdemo/composition.toml with ``edits`` (old text ->
    new text)."""
    with open(os.path.join(ROOT, "plans", "faultsdemo",
                           "composition.toml")) as f:
        text = f.read()
    for old, new in edits.items():
        assert old in text, old
        text = text.replace(old, new)
    return text


def cli_rest_phase(dev, report, tmp):
    """[58] the rest of the command line at 300 instances or fewer, each
    run held to the same composition written out by hand: a templated
    faultsdemo (``{{ .Env.TG_SMOKE_COUNT }}`` instances a group),
    ``--drain`` on faultsdemo (traced and sampled), ``--replay
    plans/election/replay.jsonl --replay-scale 2`` on election @ 5,
    ``--runner sim:jax`` on a local:exec placebo @ 200; then ``build
    composition`` and ``build purge``."""
    home = cli_home(tmp, "cli58", ("faultsdemo", "election", "placebo"))
    comps = os.path.join(tmp, "cli58-comps")
    os.makedirs(comps)
    cap = ["--run-cfg", "max_ticks=2000"]  # faultsdemo cut short

    def write(name, text):
        path = os.path.join(comps, name)
        with open(path, "w") as f:
            f.write(text)
        return path

    group = "instances = { count = 2 }"
    cases = {
        "template": (
            write("t.toml", _demo_text(**{group: "instances = { count = "
                                          "{{ .Env.TG_SMOKE_COUNT }} }"})),
            write("t_hand.toml", _demo_text()), [], cap),
        "drain": (
            write("d.toml", _demo_text()),
            write("d_hand.toml", _demo_text(**{
                "[trace]\n": "[trace]\ndrain = true\n",
                "[telemetry]\n": "[telemetry]\ndrain = true\n"})),
            ["--drain"], cap),
    }
    with open(os.path.join(ROOT, "plans", "election",
                           "composition.toml")) as f:
        election = f.read()
    cases["replay"] = (
        write("e.toml", election),
        write("e_hand.toml", election.replace(
            'trace = "replay.jsonl"',
            'trace = "plans/election/replay.jsonl"\nscale = 2.0')),
        ["--replay", "plans/election/replay.jsonl", "--replay-scale", "2"],
        [])
    placebo = ('[global]\nplan = "placebo"\ncase = "ok"\nrunner = "{r}"\n'
               'builder = "sim:module"\ntotal_instances = 200\n[[groups]]\n'
               'id = "single"\ninstances = {{ count = 200 }}\n')
    cases["runner"] = (
        write("p.toml", placebo.format(r="local:exec")),
        write("p_hand.toml", placebo.format(r="sim:jax")),
        ["--runner", "sim:jax"], [])
    os.environ["TG_SMOKE_COUNT"] = "2"
    rows = {}
    try:
        for key, (path, hand, flags, extra) in cases.items():
            plan = "placebo" if key == "runner" else (
                "election" if key == "replay" else "faultsdemo")
            a = cli_run(home, "run", "composition", path, *flags, *extra,
                        *device_flags(dev)).expect(
                0, "run <tid> outcome: success")
            b = cli_run(home, "run", "composition", hand, *extra,
                        *device_flags(dev)).expect(
                0, "run <tid> outcome: success")
            _runs_equal(cli_outputs(home, plan, a.tid),
                        cli_outputs(home, plan, b.tid), ("host_spans",))
            rows[key] = {"seconds": [a.seconds, b.seconds]}
            log(f"  {key}: exit 0 both, files equal to the hand-written "
                f"composition's ({a.seconds:.1f} + {b.seconds:.1f} s)")
    finally:
        os.environ.pop("TG_SMOKE_COUNT")
    b = cli_run(home, "build", "composition", cases["drain"][0])
    staged = b.lines[-1].split(": ", 1)[-1]
    assert b.rc == 0 and b.lines[-3:] == [
        f"build {b.tid} outcome: success", f"  group left: {staged}",
        f"  group right: {staged}"], (b.lines, b.err[-3000:])
    assert os.path.isdir(staged), staged
    p = cli_run(home, "build", "purge", "--plan", "faultsdemo")
    # the runs above staged the plan once, the build reuses that stage
    p.expect(0, "purged 1 cached artifact(s) for plan faultsdemo")
    assert not os.path.exists(staged)
    rows["build"] = {"seconds": [b.seconds, p.seconds]}
    log(f"  build composition: {staged}; build purge: 1 purged "
        f"({b.seconds:.1f} + {p.seconds:.1f} s)")
    report["cli_rest"] = rows
    return rows


# ---------------------------------------------------- the fleet ([59]-[62])

FLEET_WORKER_ENTRY = (sys.executable, "-c",
                      "import sys, chip_smoke; "
                      "sys.exit(chip_smoke.fleet_worker())")
LAUNCH_FAMILY = "chip_smoke_kernel_launches"
# [61]'s storm@10k, cut (its outcome is a cut run's, failure): the phase
# holds it against an in-process run of the same cut, made before [59]
FLEET_STORM_CUT = {"max_ticks": 1_000}


def fleet_worker() -> int:
    """A fleet worker as users start one (``python -m testground_tpu_torch
    daemon ...``: ``cli.main`` with this process's arguments), with the
    three kernels' launch counts on its ``/metrics`` as
    ``chip_smoke_kernel_launches{kernel=...}``, so that [60] reads how
    often a run in this process launched each. A count read syncs the
    card, so the script scrapes a worker only while it runs nothing (a
    read during another thread's CUDA-graph capture would break the
    capture)."""
    sys.path.insert(0, ROOT)
    from testground_tpu_torch import cli, obs

    gauge = obs.gauge(LAUNCH_FAMILY,
                      "Kernel launches in this process, by kernel.")

    def collect():
        # the wrappers' modules load with the first run: before it, 0
        if "testground_tpu_torch.sim.deliver_front" in sys.modules:
            from testground_tpu_torch import bench

            for k, v in bench.kernel_launches().items():
                gauge.set(v, kernel=k)

    obs.REGISTRY.register_collector(collect)
    return cli.main(sys.argv[1:])


def scrape(endpoint) -> dict:
    """A daemon's ``/metrics``, parsed (the bearer token of [48]'s)."""
    import urllib.request

    from testground_tpu_torch import obs

    req = urllib.request.Request(endpoint.rstrip("/") + "/metrics")
    req.add_header("Authorization", f"Bearer {DAEMON_TOKEN}")
    with urllib.request.urlopen(req, timeout=30) as r:
        return obs.parse_exposition(r.read().decode())


def worker_launches(endpoint) -> dict:
    """A worker's launch counts, by kernel (0 before its first run)."""
    fams = scrape(endpoint)
    got = {k: 0 for k in KERNELS}
    for _, labels, value in fams.get(LAUNCH_FAMILY, {"samples": []})[
            "samples"]:
        got[labels["kernel"]] = int(value)
    return got


def fleet_up_phase(report, tmp, device="cuda"):
    """[59] a coordinator and two worker daemons on the card, each its own
    process and home: the seconds until ``/federation`` shows both
    alive, each worker's fingerprint naming the card."""
    from testground_tpu_torch import bench

    name = report["device"]
    fleet = bench.Fleet(os.path.join(tmp, "fleet"), 2, device, DAEMON_ENV,
                        DAEMON_TOKEN, worker_entry=FLEET_WORKER_ENTRY)
    alive_s = fleet.wait_alive()
    c = fleet.client()
    info = c.federation()
    workers = [w.endpoint() for w in fleet.workers]
    assert info["role"] == "coordinator" and info["peers"] == workers, info
    for w in info["workers"]:
        fp = w["fingerprint"]
        # a CPU worker never initialises CUDA: it reports none
        assert (fp.get("platform") == "cuda" and fp.get("device_kind")
                == name) if device == "cuda" else fp == {}, fp
    row = {"alive_seconds": alive_s,
           "listening_seconds": {"coordinator":
                                 fleet.coordinator.ready_seconds,
                                 **{f"w{i}": w.ready_seconds
                                    for i, w in enumerate(fleet.workers)}},
           "fingerprint": info["workers"][0]["fingerprint"]}
    report["fleet_up"] = row
    log(f"  coordinator and 2 workers alive in /federation {alive_s:.1f} s "
        "after their start (listening after "
        + ", ".join(f"{k} {v:.1f} s"
                    for k, v in row["listening_seconds"].items())
        + f"); each worker's fingerprint names {name}")
    return fleet, c


def fleet_upload_phase(report, tmp, fleet, c, dht10k, ref_dht, ref_launches):
    """[60] compile-on-upload: dht@10k (fused front) prewarmed through
    the coordinator (a miss on the worker it routes to), then run once
    that worker's heartbeat names its digest: the run routes there,
    journals memory_hit and compiles 0, and its files (collected through
    the coordinator's proxy) equal [37]'s (``ref_dht``: its copy and the
    directory it was written in). The worker's launch counts
    across the prewarm (its eager warm-ups) and the run (the replays of
    the captured iteration) are [37]'s."""
    from testground_tpu_torch.runner.outputs import summary

    a = bench_upload(fleet, dht10k, os.path.join(tmp, "d60"))
    warm = a["run"]["routed_to"]
    w = fleet.by_endpoint(warm)
    lp, lr = a["prewarm_launches"], a["run_launches"]
    total = {k: lp[k] + lr[k] for k in KERNELS}
    assert total == ref_launches, (total, ref_launches)
    st = a["run"]
    want = summary(ref_dht[0])["outcome"]
    assert st["outcome"] == want, (st["outcome"], want, st.get("error"))
    assert_like_ref(st, a["dir"], w.run_dir("dht", st["id"]), ref_dht[0],
                    skip=("live", "compiles"), ref_orig=ref_dht[1])
    row = {"worker": warm, "prewarm": task_timing(a["prewarm"]),
           "run": task_timing(st), "prewarm_launches": lp,
           "run_launches": lr,
           "prewarm_submit_to_complete_seconds": a["prewarm_seconds"],
           "run_submit_to_complete_seconds": a["run_seconds"]}
    report["fleet_upload"] = row
    log(f"  prewarm routed to {warm}: miss, build and capture "
        f"{row['prewarm']['compile_seconds']:.3f} s, submit to complete "
        f"{a['prewarm_seconds']:.2f} s; the run routed there: memory_hit, "
        f"compiles 0, build and capture {row['run']['compile_seconds']:.3f}"
        f" s, dispatch {row['run']['dispatch_seconds']:.3f} s, submit to "
        f"complete {a['run_seconds']:.2f} s; launches prewarm {lp}, run "
        f"{lr} ([37]: {ref_launches}); files equal to [37]'s")
    return warm


def bench_upload(fleet, comp, dest) -> dict:
    """``bench.routed_prewarm`` then ``bench.routed_run``, the routed
    worker's launch counts read around each (while it runs nothing)."""
    from testground_tpu_torch import bench

    before = {w.endpoint(): worker_launches(w.endpoint())
              for w in fleet.workers}
    pw, pw_s = bench.routed_prewarm(fleet, comp)
    warm = pw["routed_to"]
    mid = worker_launches(warm)
    st, run_s = bench.routed_run(fleet, comp, warm)
    after = worker_launches(warm)
    return {"prewarm": pw, "run": st,
            "dir": bench.collect(fleet.client(), st["id"], dest),
            "prewarm_seconds": pw_s, "run_seconds": run_s,
            "prewarm_launches": {k: mid[k] - before[warm][k]
                                 for k in KERNELS},
            "run_launches": {k: after[k] - mid[k] for k in KERNELS}}


def fleet_pair_phase(report, tmp, fleet, c, warm, comps, refs,
                     want_launches):
    """[61] dht@10k (its worker warm from [60]) and storm@10k cut at
    ``FLEET_STORM_CUT`` submitted at once: dht routes to the warm worker
    by affinity, storm to the other (no lease read yet: unbounded
    headroom); each ends with its in-process run's outcome and files
    ([37]'s, the cut's) and each worker's launches with
    ``want_launches`` (dht: [60]'s routed run's; storm: the in-process
    cut's); the merged ``/metrics``
    (scraped once both are done) carries ``tg_fed_routes_total`` under
    ``worker=`` labels, at least 3, and ``tg_tasks_queue_depth`` from 3
    sources. The fleet's wall beside the two runs' serial sum, reported
    (both workers share the card)."""
    import threading

    from testground_tpu_torch import bench
    from testground_tpu_torch.federation import affinity_key

    # [60]'s run checked its executor back in: wait for the heartbeat
    # that says so (a checked-out executor is not offered)
    fleet.wait_cache_key(warm, affinity_key(comps["dht10k"]))
    before = {w.endpoint(): worker_launches(w.endpoint())
              for w in fleet.workers}
    plan = {k: comp["global"]["plan"] for k, comp in comps.items()}
    t0 = time.monotonic()
    tids = {k: c.run(comp, plan_dir=os.path.join(ROOT, "plans", plan[k]))
            for k, comp in comps.items()}
    sts, done = {}, {}

    def waiter(k):
        sts[k] = bench.wait_task(fleet.client(), tids[k])
        done[k] = time.monotonic() - t0

    threads = [threading.Thread(target=waiter, args=(k,)) for k in tids]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    assert set(sts) == set(comps), sts
    assert sts["dht10k"]["routed_to"] == warm, sts["dht10k"]["routed_to"]
    assert sts["storm10k"]["routed_to"] not in ("", warm), (
        sts["storm10k"]["routed_to"])
    rows = {}
    for k, st in sts.items():
        from testground_tpu_torch.runner.outputs import summary

        want = summary(refs[k][0])["outcome"]
        assert st["state"] == "complete" and st["outcome"] == want, (
            k, st["outcome"], want, st.get("error"))
        w = fleet.by_endpoint(st["routed_to"])
        got = bench.collect(c, st["id"], os.path.join(tmp, "d61", k))
        assert_like_ref(st, got, w.run_dir(plan[k], st["id"]), refs[k][0],
                        skip=("live", "compiles"), ref_orig=refs[k][1])
        after = worker_launches(st["routed_to"])
        launches = {n: after[n] - before[st["routed_to"]][n]
                    for n in KERNELS}
        assert launches == want_launches[k], (k, launches, want_launches[k])
        rows[k] = {"worker": st["routed_to"], **task_timing(st),
                   "done_after_seconds": done[k], "launches": launches}
    fams = scrape(fleet.coordinator.endpoint())
    routes = fams["tg_fed_routes_total"]["samples"]
    assert routes and all(lab.get("worker") for _, lab, _ in routes), routes
    n_routes = sum(v for _, _, v in routes)
    assert n_routes >= 3, n_routes
    sources = {lab.get("worker")
               for _, lab, _ in fams["tg_tasks_queue_depth"]["samples"]}
    assert None in sources and len(sources) == 3, sources
    serial = sum(r["submit_to_complete_seconds"] for r in rows.values())
    report["fleet_pair"] = {"runs": rows, "wall_seconds": wall,
                            "serial_sum_seconds": serial,
                            "routes_total": n_routes}
    log("  " + "; ".join(
        f"{k} on {r['worker']}: {sts[k]['outcome']}, build and capture "
        f"{r['compile_seconds']:.3f} s, dispatch {r['dispatch_seconds']:.3f}"
        f" s, submit to complete {r['submit_to_complete_seconds']:.2f} s,"
        f" launches {r['launches']}"
        for k, r in rows.items()) + f"; files and launches equal to the "
        f"in-process "
        f"runs'; the fleet's wall {wall:.2f} s against the serial sum "
        f"{serial:.2f} s (one card); tg_fed_routes_total {n_routes:g}, "
        f"queue depth from {len(sources)} sources")
    return sts["storm10k"]["routed_to"], {
        w: worker_launches(w) for w in before}


def fleet_loss_phase(report, tmp, fleet, c, storm_worker, storm10k,
                     ref_storm, before, want_launches):
    """[62] storm@10k (whole: the digest leaves ``max_ticks`` out) routed
    to the worker holding it warm from [61] (``storm_worker``);
    SIGKILL that worker while the run is processing: the coordinator
    marks it lost and requeues the run on the survivor with ``resume``,
    where it completes with ``success``, the attempt counted, and
    [36]'s files and launches (``want_launches``; the survivor's counts
    were ``before``)."""
    from testground_tpu_torch import bench
    from testground_tpu_torch.federation import affinity_key

    fleet.wait_cache_key(storm_worker, affinity_key(storm10k))
    plan_dir = os.path.join(ROOT, "plans", "benchmarks")
    t0 = time.monotonic()
    tid = c.run(storm10k, plan_dir=plan_dir)
    owner = None
    while owner is None:
        routes = {r["task_id"]: r for r in c.federation()["routes"]}
        r = routes.get(tid, {})
        if r.get("state") == "processing":
            owner = r["worker"]
            assert owner == storm_worker, (owner, storm_worker)
        assert time.monotonic() - t0 < 120, ("never processing", r)
        time.sleep(0.05)
    processing_s = time.monotonic() - t0
    fleet.by_endpoint(owner).kill()
    t_kill = time.monotonic()
    while any(w["alive"] for w in c.federation()["workers"]
              if w["worker"] == owner):
        assert time.monotonic() - t_kill < 60, "the killed worker stayed alive"
        time.sleep(0.05)
    lost_s = time.monotonic() - t_kill
    st = bench.wait_task(c, tid)
    done_s = time.monotonic() - t_kill
    j = st["result"]["journal"]
    assert st["outcome"] == "success", (st["outcome"], st.get("error"))
    assert st["routed_to"] not in ("", owner), st["routed_to"]
    assert st["attempts"] >= 1 and j.get("attempt", 0) >= 1, (
        st["attempts"], j.get("attempt"))
    survivor = fleet.by_endpoint(st["routed_to"])
    got = bench.collect(c, tid, os.path.join(tmp, "d62"))
    assert_like_ref(st, got, survivor.run_dir("benchmarks", tid),
                    ref_storm[0], skip=("live", "attempt", "resume"),
                    ref_orig=ref_storm[1])
    after = worker_launches(st["routed_to"])
    launches = {n: after[n] - before[st["routed_to"]][n] for n in KERNELS}
    assert launches == want_launches, (launches, want_launches)
    row = {"killed": owner, "survivor": st["routed_to"],
           "processing_after_seconds": processing_s,
           "lost_after_seconds": lost_s,
           "complete_after_kill_seconds": done_s,
           "attempts": st["attempts"], "journal_attempt": j.get("attempt"),
           "survivor_run": task_timing(st), "survivor_launches": launches}
    report["fleet_loss"] = row
    log(f"  processing on {owner} after {processing_s:.2f} s; SIGKILL: lost "
        f"in /federation {lost_s:.2f} s later, requeued on {st['routed_to']}"
        f" (attempts {st['attempts']}), success {done_s:.2f} s after the "
        f"kill (build and capture {row['survivor_run']['compile_seconds']:.3f}"
        f" s, dispatch {row['survivor_run']['dispatch_seconds']:.3f} s); "
        f"launches {launches}; files and launches equal to [36]'s")


def fleet_phases(report, tmp, refs, ref_launches, device="cuda", n=10_000):
    """[59]-[62] on one fleet (its daemons on ``device``, the runs at
    ``n``; ``refs`` and ``ref_launches`` the in-process runs' directories
    (a copy, and where it was written) and launch counts, by key); its
    daemons stopped (the killed worker reaped) at the end."""
    from testground_tpu_torch import bench

    storm10k = composition_of("benchmarks", "storm", n, bench.PARAMS,
                              STORM_RUN_CONFIG)
    storm_cut = composition_of("benchmarks", "storm", n, bench.PARAMS,
                               dict(STORM_RUN_CONFIG, **FLEET_STORM_CUT))
    dht10k = composition_of("dht", "find-providers", n, DHT_PARAMS,
                            DHT_RUN_CONFIG)
    log(f"[59] (before it) storm @ 10,000 cut at "
        f"{FLEET_STORM_CUT['max_ticks']:,d} ticks in this process: [61]'s "
        "reference")
    t_ref = time.monotonic()
    cut_dir = os.path.join(tmp, "storm_cut")
    reset_launch_counts()
    s = bench.in_process_run(storm_cut, cut_dir, device)
    cut_launches = other_launches()
    from testground_tpu_torch.sim import runner as trunner

    trunner.clear_executor_pool()
    report["fleet_storm_cut_reference"] = {
        "outcome": s["outcome"], "ticks": s["ticks"],
        "launches": cut_launches, "seconds": time.monotonic() - t_ref}
    log(f"  {s['outcome']} at tick {s['ticks']} (timed out: "
        f"{s['timed_out']}), launches {cut_launches}, "
        f"{time.monotonic() - t_ref:.1f} s")
    assert s["ticks"] == FLEET_STORM_CUT["max_ticks"] and s["timed_out"]
    t0 = time.monotonic()
    log("[59] the fleet comes up: a coordinator and two worker daemons on "
        "the card")
    fleet, c = fleet_up_phase(report, tmp, device)
    try:
        log("[60] compile-on-upload: dht @ 10,000 (fused front) prewarmed "
            "through the coordinator, then run")
        warm = fleet_upload_phase(report, tmp, fleet, c, dht10k,
                                  refs["dht10k"], ref_launches["dht10k"])
        log(f"[61] dht @ 10,000 and storm @ 10,000 (cut at "
            f"{FLEET_STORM_CUT['max_ticks']:,d} ticks) submitted at once to "
            "the fleet")
        storm_worker, counts = fleet_pair_phase(
            report, tmp, fleet, c, warm,
            {"dht10k": dht10k, "storm10k": storm_cut},
            {"dht10k": refs["dht10k"], "storm10k": (cut_dir, cut_dir)},
            {"dht10k": report["fleet_upload"]["run_launches"],
             "storm10k": cut_launches})
        log("[62] a lost worker: storm @ 10,000's worker SIGKILLed "
            "mid-run, the run requeued on the survivor")
        fleet_loss_phase(report, tmp, fleet, c, storm_worker, storm10k,
                         refs["storm10k"], counts, ref_launches["storm10k"])
        report["fleet_phases_seconds"] = time.monotonic() - t0
    finally:
        rcs = fleet.close()
    killed = report.get("fleet_loss", {}).get("killed")
    assert all(rc == 0 for home, rc in rcs.items()
               if not killed or home != fleet.by_endpoint(killed).home), rcs
    log(f"  [59]-[62]: {report['fleet_phases_seconds']:.1f} s; the other "
        f"daemons stopped by SIGTERM, exit 0 "
        f"({time.monotonic() - t0 - report['fleet_phases_seconds']:.1f} s)")


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
    import tempfile

    global CPU_DIR
    cpu_tmp = tempfile.TemporaryDirectory(prefix="chip-smoke-cpu-")
    CPU_DIR = cpu_tmp.name
    pool = start_cpu_sides(CPU_DIR)
    ok = False
    try:
        rc = phases(torch)
        ok = True
        return rc
    finally:
        if not ok:
            # a failed phase: the child's running side is not waited for
            for p in list(getattr(pool, "_processes", {}).values()):
                p.terminate()
        pool.shutdown(wait=ok, cancel_futures=True)
        cpu_tmp.cleanup()


def phases(torch) -> int:
    """Every phase, in order; the CPU sides come from the child."""
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

    log("[2] the kernels' custom ops dispatched once (torch's one-time "
        "imports)")
    t0 = time.monotonic()
    first_dispatch(torch)
    report["first_dispatch_seconds"] = time.monotonic() - t0
    log(f"  first dispatch: {report['first_dispatch_seconds']:.2f} s")

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
    parity_phase(np, dev, report, "dht300_parity")
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
    parity_phase(np, dev, report, "gossipsub300_parity")
    parity_phase(np, dev, report, "dht300_default_parity")
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
    parity_phase(np, dev, report, "storm300_parity")
    parity_phase(np, dev, report, "storm300_shaped_parity")

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
    for key in ("barrier300_parity", "subtree300_parity",
                "sparsetimer300_dense_parity", "sparsetimer300_skip_parity"):
        parity_phase(np, dev, report, key)
    report["sparsetimer_count_scatter_launches"] = {
        k: v["launches"]["count_scatter"] for k, v in
        (("dense", sparse[False]), ("skip", sparse[True]))}

    log("[19] network: ping-pong, traffic-allowed, traffic-blocked @ 2")
    network_phase(torch, dev, report)
    log(f"[20] splitbrain all-pairs drop, reject, accept @ "
        f"{SPLITBRAIN_ALL_N}")
    t0 = time.monotonic()
    splitbrain_phase(torch, dev, report, ("drop", "reject", "accept"),
                     SPLITBRAIN_ALL_N)
    report["splitbrain_all_pairs_seconds"] = time.monotonic() - t0
    log(f"[21] splitbrain sampled drop, reject, accept @ {SPLITBRAIN_N:,d} "
        "x 8 probes")
    sampled = splitbrain_phase(
        torch, dev, report,
        ("drop-sampled", "reject-sampled", "accept-sampled"), SPLITBRAIN_N)
    log(f"[21b] splitbrain drop-sampled@{SPLITBRAIN_N:,d} tick under "
        "torch.profiler")
    profile_phase(torch, report, "splitbrain_sampled_profile",
                  tbench.splitbrain_executable(SPLITBRAIN_N, dev,
                                               "drop-sampled"),
                  sampled["drop-sampled"]["ms_per_executed_tick"])
    log("[22] example, placebo and verify, every case at its manifest's "
        "largest instance count")
    small_plans_phase(torch, dev, report)
    log("[23] splitbrain drop-sampled and a queued class-rule dialing "
        "program @ 300: GPU vs CPU")
    parity_phase(np, dev, report, "splitbrain300_parity")
    reset_launch_counts()
    parity_phase(np, dev, report, "classdials300_parity")
    merges = other_launches()["ring_merge"]
    report["classdials300_parity"]["gpu_ring_merge_launches"] = merges
    log(f"  ring-merge kernel launches on the card's run: {merges}")
    assert merges > 0, "the queued program ran no ring merge on the card"

    from testground_tpu_torch import bench as tb

    log("[24] storm @ 10,000 under bench.py's 8-event fault timeline")
    faulted = plane_phase(torch, dev, report, "faults")
    log("[24b] faulted storm@10k tick under torch.profiler (inside the "
        "degrade windows)")
    profile_phase(torch, report, "storm10k_faults_profile",
                  tb.storm_executable(10_000, dev, planes=("faults",)),
                  faulted["ms_per_executed_tick"], warm_ticks=150)
    log("[25] storm @ 10,000 traced (capacity 64)")
    traced = plane_phase(torch, dev, report, "trace")
    log("[25b] traced storm@10k tick under torch.profiler")
    profile_phase(torch, report, "storm10k_trace_profile",
                  tb.storm_executable(10_000, dev, planes=("trace",)),
                  traced["ms_per_executed_tick"])
    log("[26] storm @ 10,000 sampled (interval 100)")
    sampled_storm = plane_phase(torch, dev, report, "telem")
    log("[26b] sampled storm@10k tick under torch.profiler, and the "
        "whole-state passes with and without the sample buffer")
    telem_ex = tb.storm_executable(10_000, dev, planes=("telem",))
    profile_phase(torch, report, "storm10k_telem_profile", telem_ex,
                  sampled_storm["ms_per_executed_tick"])
    state_pass_phase(torch, report, "storm10k_telem_state_passes", telem_ex)
    state_pass_phase(torch, report, "storm10k_state_passes",
                     storm_exec(10_000, dev, False))
    del telem_ex
    log("[26c] storm @ 10,000 with every plane's table off: phase 11's "
        "leaves and device ops a tick")
    zero_overhead_phase(torch, report, dev, storm["ms_per_executed_tick"])
    log(f"[27] faultsdemo chaos @ 4 and @ {FAULTSDEMO_BIG_N:,d} with its "
        "composition's [faults], [trace] and [telemetry]")
    for n in (4, FAULTSDEMO_BIG_N):
        faultsdemo_phase(torch, dev, report, n)
    log("[28] storm with all three planes and faultsdemo @ 300: GPU vs CPU")
    parity_phase(np, dev, report, "storm300_planes_parity")
    parity_phase(np, dev, report, "faultsdemo300_parity")
    report["plane_count_scatter_launches"] = {
        p: report[k]["launches"]["count_scatter"]
        for p, k in PLANE_KEYS.items()}

    log("[29] bench --replay @ 10,000: the disabled table, the echo "
        "self-driven and replayed, the sparse trace")
    replay_phase(torch, dev, report,
                 report["planes_off_graph_nodes"]["storm10k"])
    log("[30] bench --drain @ 10,000: sparsetimer traced and sampled, "
        "drained at every chunk")
    drain_phase(torch, dev, report)
    log(f"[31] election quorum @ 5 and @ {ELECTION_BIG_N:,d} with its "
        "composition's [replay] and [faults]")
    for n in (5, ELECTION_BIG_N):
        election_phase(torch, dev, report, n)
    log("[32] replayed echo (dense and skipped), drained sparsetimer and "
        "election @ 5: GPU vs CPU")
    for key in ("replay300_dense_parity", "replay300_skip_parity"):
        parity_phase(np, dev, report, key)
    drain_parity_phase(torch, np, dev, report)
    parity_phase(np, dev, report, "election5_parity", n=5)
    log(f"[33] bench --sweep: the {SWEEP_SEEDS}-seed storm @ 10,000 sweep, "
        "batched and a serial sample; scenarios "
        f"{', '.join(map(str, SWEEP_HELD))} against their serial runs")
    sweep, sweep_ex = sweep_phase(torch, dev, report)
    log("[33b] the batched storm@10k iteration under torch.profiler")
    profile_phase(torch, report, "sweep10k_profile", sweep_ex,
                  sweep["ms_per_batched_tick"])
    del sweep_ex
    log("[34] bench --search: cliff's edge @ 10,000 by bisection")
    search_phase(torch, dev, report)
    log("[35] shaped storm sweep @ 300 x 4 seeds under the fault timeline: "
        "GPU vs CPU")
    sweep_parity_phase(np, dev, report)

    import tempfile

    t_runner = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-runner-") as tmp:
        log("[36] storm @ 10,000 as a composition through the runner "
            "(run_composition)")
        runner_storm = runner_storm_phase(torch, dev, report, tmp, storm)
        log("[37] dht @ 10,000 with the fused front through the runner")
        runner_dht = runner_dht_phase(torch, dev, report, tmp, dht)
        log("[38] prewarm then run; storm @ 10,000 preempted at boundary "
            f"{RESUME_STOP_AT} and resumed; a terminated run")
        from testground_tpu_torch.runner.outputs import summary

        runner_pool_resume_phase(torch, dev, report, tmp,
                                 summary(os.path.join(tmp, "storm")))
        log("[39] the memory model: peak against state model, and a run "
            "under a forced budget")
        memory_model_phase(torch, dev, report, tmp)
        log("[40] storm and faultsdemo @ 300 through the runner: GPU vs "
            "CPU")
        runner_parity_phase(torch, dev, report, tmp)
        log("[41] python -m testground_tpu_torch healthcheck and run "
            "composition plans/faultsdemo/composition.toml")
        cli_phase(report, tmp)
        from testground_tpu_torch.sim import runner as trunner

        trunner.clear_executor_pool()
        report["runner_phases_seconds"] = time.monotonic() - t_runner
        log(f"  [36]-[41]: {report['runner_phases_seconds']:.1f} s")

        t_batched = time.monotonic()
        log(f"[42] storm @ 10,000 over {SWEEP_RUNNER_SEEDS} seeds as a "
            "[sweep] composition through the runner")
        swept = runner_sweep_phase(torch, dev, report, tmp,
                                   summary(os.path.join(tmp, "storm")))
        log("[43] the same sweep under a forced budget: 2 scenario chunks, "
            "preempted inside chunk 1 and resumed")
        runner_sweep_resume_phase(
            torch, dev, report, tmp, os.path.join(tmp, "sweep"),
            {**swept, "summary": summary(os.path.join(tmp, "sweep"))})
        log(f"[44] dht @ 10,000, default lowering, over {DHT_SWEEP_SEEDS} "
            "seeds through the runner")
        runner_dht_sweep_phase(torch, dev, report, tmp, dht_default)
        log("[45] searches through the runner: cliff @ 10,000, faultsdemo "
            f"@ {FAULTSDEMO_BIG_N:,d} with its [search], preempted and "
            "resumed")
        runner_search_phase(torch, dev, report, tmp, report["search10k"])
        log("[46] device leases: two concurrent runner runs, together and "
            "one at a time")
        leases_phase(torch, dev, report, tmp)
        log("[47] a storm sweep @ 300 x 4 (chunks of 2) and a cliff search "
            "@ 64 through the runner: GPU vs CPU")
        batched_parity_phase(torch, dev, report, tmp)
        report["batched_runner_phases_seconds"] = (time.monotonic()
                                                   - t_batched)
        log(f"  [42]-[47]: {report['batched_runner_phases_seconds']:.1f} s")
        report["cpu_side_waits_seconds"] = dict(CPU_WAITS)
        log(f"  the phases waited {sum(CPU_WAITS.values()):.1f} s in all "
            "for the CPU child")

        rs, rd = report["runner_storm10k"], report["runner_dht10k"]
        daemon_phases(report, tmp, {
            "storm10k": (os.path.join(tmp, "storm"), rs["wall_seconds"],
                         rs["compile_seconds"]),
            "dht10k": (os.path.join(tmp, "dht"), rd["wall_seconds"],
                       rd["compile_seconds"])})
        # [36]'s run, for [56] to hold the command line's run against
        import shutil

        cli_tmp = tempfile.TemporaryDirectory(prefix="chip-smoke-cli-")
        storm36 = os.path.join(cli_tmp.name, "storm36")
        shutil.copytree(os.path.join(tmp, "storm"), storm36)
        # and [37]'s, for [60]-[61]
        dht37 = os.path.join(cli_tmp.name, "dht37")
        shutil.copytree(os.path.join(tmp, "dht"), dht37)

    for k, plane in ((51, "live"), (52, "metrics"), (53, "ckpt")):
        log(f"[{k}] bench --{plane} @ 10,000: sparsetimer dense in "
            f"{tbench.PLANE_CHUNK}-tick chunks, {HOST_PLANE_ROUNDS} "
            "rounds, plain and under the plane")
        host_plane_phase(dev, report, plane)
    log("[54] bench --compile: the faultsdemo chaos ladder against "
        "op_budgets.json")
    ladder_phase(dev, report)
    log("[55] check_contracts on the card")
    contracts_phase(dev, report)

    t_cli = time.monotonic()
    with cli_tmp:
        log("[56] run single --plan benchmarks --testcase storm --instances "
            "10000 --runner sim:jax --builder sim:module, through cli.main")
        cli_single_phase(torch, dev, report, cli_tmp.name, storm36,
                         runner_storm["launches"])
        log(f"[57] run composition faultsdemo preempted at boundary "
            f"{CLI_STOP_AT}, then run --resume TASK_ID")
        cli_resume_phase(dev, report, cli_tmp.name)
        log("[58] a templated composition, --drain, --replay with "
            "--replay-scale, --runner, build composition and build purge")
        cli_rest_phase(dev, report, cli_tmp.name)
        from testground_tpu_torch.sim import runner as trunner

        trunner.clear_executor_pool()
        report["cli_phases_seconds"] = time.monotonic() - t_cli
        log(f"  [56]-[58]: {report['cli_phases_seconds']:.1f} s")
        fleet_phases(report, cli_tmp.name,
                     {"storm10k": (storm36, os.path.join(tmp, "storm")),
                      "dht10k": (dht37, os.path.join(tmp, "dht"))},
                     {"storm10k": runner_storm["launches"],
                      "dht10k": runner_dht["launches"]})

    front_row = next(r for r in rows if r["n"] == 10_000
                     and r["regime"] == "mixed")
    merge_row = merge_rows[0]  # dht@10k's shape
    # the shape of the path whose launches the line reports: a storm@10k
    # tick on the staging row (the runner's storm of [36])
    scatter_row = next(r for r in scatter_rows
                       if (r["shape"], r["case"]) == ("staging", "storm"))
    kernels = {"kernels": [
        {
            "name": "deliver_front",
            "route": "cuda",
            "source": "testground_tpu_torch/csrc/deliver_front.cu",
            "replaces": "testground_tpu/sim/pallas_front.py:214",
            # this slice's path that runs it: the runner's dht of [37]
            "launches": runner_dht["launches"]["deliver_front"],
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
            "launches": runner_dht["launches"]["ring_merge"],
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
            # this slice's path that runs it: the runner's storm of [36]
            "launches": runner_storm["launches"]["count_scatter"],
            "max_abs_err": scatter_err,
            "ms": scatter_row["wrapper_ms"],
            "plain_ms": scatter_row["plain_ms"],
            "bound_ms": scatter_row["bound_ms"],
            "bound_by": "bytes",
            "library_ms": scatter_row["library_ms"],
        },
    ]}
    report["kernels"] = kernels["kernels"]
    end = time.monotonic()
    report["seconds"] = end - t_start
    report["phase_seconds"] = phase_seconds(end)
    report["against_r14f"] = {
        "storm10k_ms_per_executed_tick": (
            storm["ms_per_executed_tick"],
            R14F["storm10k_ms_per_executed_tick"]),
        "runner_storm10k_dispatch_seconds": (
            report["runner_storm10k"]["wall_seconds"],
            R14F["runner_storm10k_dispatch_seconds"]),
        "runner_sweep10k_scenarios_per_sec": (
            report["runner_sweep10k"]["scenarios_per_sec"],
            R14F["runner_sweep10k_scenarios_per_sec"]),
    }
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(f"done in {report['seconds']:.1f} s")
    for k, (now, then) in report["against_r14f"].items():
        log(f"  {k}: {now:.4f} (R14f: {then:.4f}, x{now / then:.3f})")
    print("the ten slowest phases:")
    for label, sec in sorted(report["phase_seconds"].items(),
                             key=lambda kv: -kv[1])[:10]:
        print(f"  {label:7s} {sec:7.1f} s")
    print(smi)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
