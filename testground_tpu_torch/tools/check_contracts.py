"""One command that checks every zero-overhead contract of the port: the
counterpart of ``tools/check_contracts.py``.

Each plane promises that switching it off (or never declaring it) leaves
the program as it was, so the feature costs nothing unless used. The JAX
package holds that to byte-identical lowered HLO. The port holds it to
the same state leaves and the same loop iteration
(``bench.loop_signature``): the torch ops one iteration dispatches and,
on the card, the nodes of the CUDA graph it is captured in. The checks
run on a tiny program and print a pass/fail table:

  trace-off       no [trace] table == a disabled one        (leaves, loop)
  telemetry-off   no [telemetry] table == a disabled one    (leaves, loop)
  no-faults       no [faults] table == an empty one         (leaves, loop)
  replay          no [replay] table == a disabled one naming a file that
                  does not exist                            (leaves, loop)
  live-off        a build that streamed progress rows keeps the plain
                  loop after its run                                (loop)
  drain-off       the drain flag is host-only: identical tables but for
                  drain=true build the same leaves and loop, and a build
                  that drained keeps it after its run       (leaves, loop)
  warmstart       NOT PORTED (11.3): the port has no disk executor tier
  checkpoint      a build that snapshotted every boundary keeps the
                  plain loop, and a resume from its last snapshot ends
                  bit-identical                            (loop, state)
  prewarm         NOT PORTED (11.3): the JAX form holds an executor
                  prewarm-persisted to the local and shared disk tiers;
                  the port's prewarm fills the in-memory pool only
  metrics-off     a build run with the metrics plane at every boundary
                  (obs counters, tg_run_chunk_seconds fed by a
                  ChunkProfiler) keeps the plain loop               (loop)
  fused-deliver   the faultsdemo chaos ladder's ``all`` combo with
                  fused_observers on and off: the final state, the trace
                  events and the telemetry records bit-equal
  op-budget       every ladder combo's ``ops`` (and on the card its
                  ``graph_nodes``) within tools/op_budgets.json

Usage::

    python -m testground_tpu_torch.tools.check_contracts [-n N] [--cpu]

On the card unless ``--cpu``. Exit code 0 iff every ported contract
holds; the two rows not ported count neither as holding nor as failing.
"""

from __future__ import annotations

import argparse
import sys
import tempfile

N_DEFAULT = 8
NOT_PORTED = {"warmstart": "11.3", "prewarm": "11.3"}


def _build(b):
    """A tiny plan exercising sleep, sync, a user trace hook and a
    metric: something for every plane to hook, cheap to build."""
    h = b.loop_begin(4)
    b.sleep_ms(3)
    b.trace(1)
    b.loop_end(h)
    b.record_point("m", lambda env, mem: 1.0)
    b.signal_and_wait("all")
    b.end_ok()


def _compile(n, device, **tables):
    from ..sim import BuildContext, GroupSpec, SimConfig, compile_program

    ctx = BuildContext([GroupSpec("single", 0, n, {})], test_case="t",
                       test_run="r")
    cfg = SimConfig(quantum_ms=1.0, chunk_ticks=10, max_ticks=400,
                    metrics_capacity=8, event_skip=False)
    return compile_program(_build, ctx, cfg, device=device, **tables)


def _same_build(n, device, what, **tables):
    """The plain build and one with ``tables``: the same leaves and the
    same loop iteration."""
    from ..bench import loop_signature, same_leaves

    a, b = _compile(n, device), _compile(n, device, **tables)
    return (same_leaves(a, b) and loop_signature(a) == loop_signature(b),
            what)


def check_trace_off(n, device):
    from ..sim.tables import Trace

    return _same_build(n, device, "no [trace] == disabled [trace]",
                       trace=Trace(enabled=False))


def check_telemetry_off(n, device):
    from ..sim.tables import Telemetry

    return _same_build(n, device, "no [telemetry] == disabled [telemetry]",
                       telemetry=Telemetry(enabled=False))


def check_no_faults(n, device):
    from ..sim.tables import Faults

    return _same_build(n, device, "no [faults] == empty [faults]",
                       faults=Faults.from_dict({"events": []}))


def check_replay(n, device):
    """A disabled [replay] table (the --no-replay leg) builds the
    replay-free program; its trace file is never read."""
    from ..sim.tables import Replay

    return _same_build(n, device, "no [replay] == disabled [replay]",
                       replay=Replay(trace="does-not-exist.jsonl",
                                     enabled=False))


def _after_run(n, device, run):
    """A build's loop iteration after ``run(ex)`` against a second,
    never-run build's: (equal, what ``run`` returned)."""
    from ..bench import loop_signature

    ref = loop_signature(_compile(n, device))
    ex = _compile(n, device)
    ex.warmup()
    got = run(ex)
    return loop_signature(ex) == ref, got


def check_live_off(n, device):
    from ..bench import boundary_hook
    from ..sim.live import LiveSink

    with tempfile.TemporaryDirectory(prefix="tg-contracts-") as tmp:
        sink = LiveSink(tmp, kind="run")

        def run(ex):
            ex.run(on_chunk=boundary_hook(ex, n, sink=sink))
            return sink.seq

        same, rows = _after_run(n, device, run)
    return (same and rows >= 1,
            "streamed build's loop == never-streamed build's")


def check_drain_off(n, device):
    from ..bench import loop_signature, same_leaves
    from ..sim.drain import ObserverDrain
    from ..sim.tables import Telemetry, Trace

    off = _compile(n, device, trace=Trace(capacity=16),
                   telemetry=Telemetry(interval=50))
    on = _compile(n, device, trace=Trace(capacity=16, drain=True),
                  telemetry=Telemetry(interval=50, drain=True))
    ref = loop_signature(off)
    if not same_leaves(off, on) or loop_signature(on) != ref:
        return False, "drain=true changed the build"
    with tempfile.TemporaryDirectory(prefix="tg-contracts-") as tmp:
        drain = ObserverDrain(on, trace_drain=True, telem_drain=True,
                              run_dir=tmp)
        on.warmup()
        res = on.run(drain=drain)
        drain.finalize(res.state)
    return (loop_signature(on) == ref and drain.batches >= 1,
            "drained build's loop == drain-off build's")


def check_checkpoint(n, device):
    """Checkpointing attaches nothing to the loop, and a run resumed from
    its last snapshot ends in the uninterrupted run's state, bit for
    bit."""
    from ..sim.checkpoint import Checkpointer, key_digest, load_checkpoint
    from ..sim.state_io import compare_leaves, flatten, state_to_numpy

    khash = key_digest("contract-ckpt")
    with tempfile.TemporaryDirectory(prefix="tg-contracts-") as tmp:
        ck = Checkpointer(tmp, key_hash=khash, kind="run", interval_s=0.0)

        def run(ex):
            full = flatten(state_to_numpy(ex.run(checkpoint=ck).state))
            rp = load_checkpoint(tmp)
            if rp is None:
                return None
            rp.verify(khash)
            resumed = ex.run(resume_state=rp.state)
            return full, flatten(state_to_numpy(resumed.state))

        same, states = _after_run(n, device, run)
    if not same or ck.snapshots < 1:
        return False, "checkpointing changed the loop iteration"
    if states is None:
        return False, "no loadable checkpoint after the run"
    try:
        compare_leaves(*states, "resumed vs full run")
    except AssertionError as e:
        return False, str(e)
    return (True, "checkpointed build's loop == never-checkpointed; resume "
                  "bit-identical")


def check_metrics_off(n, device):
    """The obs registry and the chunk profiler are host-only: a build run
    with both at every boundary keeps the plain loop."""
    from .. import obs
    from ..bench import boundary_hook
    from ..sim.profile import ChunkProfiler

    prof = ChunkProfiler(device=device)
    chunks = obs.counter(
        "tg_contracts_chunks_total",
        "Chunk boundaries seen by the metrics-off contract check.")

    def run(ex):
        cb = boundary_hook(ex, n, profiler=prof)

        def on_chunk(tick, running, info):
            cb(tick, running, info)
            chunks.inc()

        ex.run(on_chunk=on_chunk)

    same, _ = _after_run(n, device, run)
    dp = prof.journal()
    if dp is None or dp["chunks"] < 1:
        return False, "profiler recorded no chunk boundaries"
    if "tg_run_chunk_seconds_count" not in obs.render():
        return False, "histogram missing from the exposition"
    return same, "instrumented build's loop == metrics-free build's"


def check_fused_deliver(n, device):
    """``fused_observers`` on and off give the same bits: the final state,
    the trace events and the telemetry records, on the chaos ladder's
    ``all`` combo."""
    import numpy as np

    from ..sim import trace as tracemod
    from ..sim.state_io import compare_leaves, flatten, state_to_numpy
    from .compile_ladder import build_combo

    runs = []
    for fused in (True, False):
        res = build_combo("all", fused_observers=fused, device=device).run()
        runs.append((flatten(state_to_numpy(res.state)),
                     tracemod.trace_events(res.state),
                     res.telemetry_records()))
    (sa, ta, ra), (sb, tb, rb) = runs
    try:
        compare_leaves(sa, sb, "fused vs unfused")
    except AssertionError as e:
        return False, str(e)
    if not np.array_equal(ta, tb):
        return False, "trace event stream differs"
    if ra != rb:
        return False, "telemetry records differ"
    return True, "fused == unfused (state + trace + telemetry bits)"


def check_op_budget(n, device):
    """Every ladder combo within tools/op_budgets.json."""
    from .compile_ladder import ladder, load_budgets, over_budget

    rows, budgets = ladder(device), load_budgets()
    over = over_budget(rows, budgets)
    if over:
        return False, "; ".join(f"{c}: {u} {v} > budget {b}"
                                for c, u, v, b in over)
    worst = max(rows, key=lambda r: r["ops"] / budgets["ops"]["budgets"][
        r["combo"]])
    units = " and graph nodes" if "graph_nodes" in rows[0] else ""
    return True, (f"{len(rows)} combos' ops{units} within budget; ops "
                  f"headroom low-water {worst['combo']}: {worst['ops']}/"
                  f"{budgets['ops']['budgets'][worst['combo']]}")


CONTRACTS = (
    ("trace-off", check_trace_off),
    ("telemetry-off", check_telemetry_off),
    ("no-faults", check_no_faults),
    ("replay", check_replay),
    ("live-off", check_live_off),
    ("drain-off", check_drain_off),
    ("warmstart", None),
    ("checkpoint", check_checkpoint),
    ("prewarm", None),
    ("metrics-off", check_metrics_off),
    ("fused-deliver", check_fused_deliver),
    ("op-budget", check_op_budget),
)


def run_contracts(n=N_DEFAULT, device="cuda") -> list:
    """Every contract at ``n`` instances on ``device``: a list of (name,
    status, detail), status "PASS", "FAIL" or "NOT PORTED (item)"."""
    from ..device import resolve_device

    device = resolve_device(device)
    rows = []
    for name, fn in CONTRACTS:
        if fn is None:
            rows.append((name, f"NOT PORTED ({NOT_PORTED[name]})",
                         "counted neither as holding nor as failing"))
            continue
        try:
            ok, detail = fn(n, device)
        except Exception as e:  # noqa: BLE001 — a crash is a failure
            ok, detail = False, f"{type(e).__name__}: {e}"
        rows.append((name, "PASS" if ok else "FAIL", detail))
    return rows


def summary(rows) -> str:
    """The table's last line."""
    ported = [r for r in rows if not r[1].startswith("NOT PORTED")]
    held = sum(r[1] == "PASS" for r in ported)
    line = f"{held}/{len(ported)} ported contracts hold"
    if held < len(ported):
        line += f" — {len(ported) - held} BROKEN"
    skipped = [f"{r[0]}: {NOT_PORTED[r[0]]}" for r in rows
               if r[1].startswith("NOT PORTED")]
    return (line + f"; {len(skipped)} not ported ({', '.join(skipped)}), "
            "counted neither as holding nor as failing")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-n", type=int, default=N_DEFAULT,
                    help=f"instances (default {N_DEFAULT})")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    rows = run_contracts(args.n, device)
    width = max(len(r[0]) for r in rows)
    status_w = max(len(r[1]) for r in rows)
    print(f"zero-overhead contracts (n={args.n}, device {device}):")
    for name, status, detail in rows:
        print(f"  {name:<{width}}  {status:<{status_w}}  {detail}")
    print(summary(rows))
    return 0 if all(r[1] != "FAIL" for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
