"""The tick engine: runs a Program as one batched torch computation per
tick, on the card or (when asked) on the CPU.

Counterpart of ``testground_tpu/sim/core.py``. Per tick:

1. churn kills take effect (a victim does not act on its kill tick);
   in count mode this tick's wheel bucket (or staging row) drains into
   the visible counts;
2. every instance evaluates its current phase: each phase function is
   batched over the instance axis with ``torch.func.vmap``, EVERY phase
   is computed and the result selected by the program counter, as the
   JAX package's vmapped ``lax.switch`` does;
3. signals and publishes are ranked by lane (the sync service's arrival
   order) and counted; publishes append into their topics; the churn
   ledger counts what churn-watched states and topics received; metrics
   append into the per-lane ring;
4. the network applies ConfigureNetwork writes, delivers this tick's
   sends (sim/net.py; with ``pallas_front`` through the deliver-front
   kernel, sim/deliver_front.py) and consumes what the phases read.

The state is a ``dict`` of tensors whose leaves keep the JAX state's
names, shapes and dtypes, so the two compare leaf by leaf
(sim/state_io.py). The loop stays on the device: termination is read
back every ``POLL_TICKS`` iterations and the state at chunk boundaries,
every ``chunk_ticks`` ticks, and a tick past the point where the JAX
loop would have stopped is an identity (every leaf is selected back to
its old value), so ``SimResult.ticks`` equals the JAX run's.

Under event skip (on by default unless ``pallas_front=True``) each
executed tick is followed by a jump of ``tick`` to the next event
(``next_event_tick``), as the JAX package's ``event_skip_loop`` does;
the jump is guarded like the tick. ``phase_gating`` runs the same
ungated step (the JAX package's gated step is bit-identical to it, and
its per-phase ``lax.cond`` would cost a host read per phase in eager
torch).

The fault plane (sim/faults.py) adds the rejoin of restarted lanes and
its kills before the step, and its window overlay to ``net.deliver``;
the trace (sim/trace.py) and telemetry (sim/telemetry.py) planes hook
the tick's sites in the JAX package's order; the replay plane
(sim/replay.py) feeds each lane its head-of-schedule view, advances the
cursors by what the phases consumed and adds its next arrival to the
event-horizon min. Each plane is a Python branch on its compiled spec,
so without one a tick builds the same state and runs the same ops. At
each chunk boundary ``SimExecutable.run`` hands the state to the drain
plane (sim/drain.py), then to the caller's ``on_chunk``,
``should_stop`` and the durability plane (sim/checkpoint.py). A sweep (sim/sweep.py) runs ``guarded_tick`` batched
over a leading scenario axis with ``torch.func.vmap``, each scenario
with its own key and params in the state (``rng_key``, ``params``).
"""

from __future__ import annotations

import dataclasses
import json
import math
import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from . import faults as faultsmod
from . import net as netmod
from . import prng
from . import replay as replaymod
from . import telemetry as telemetrymod
from . import trace as tracemod
from .context import BuildContext
from .deliver_front import eligible as front_eligible
from .program import (
    CRASHED,
    DONE_FAIL,
    DONE_OK,
    PAD,
    Program,
    RUNNING,
    TickEnv,
    _not_ported,
)
from .subkernels import ring_append


@dataclass
class SimConfig:
    """The JAX package's SimConfig, field for field. ``chunk_ticks`` is
    the port's own chunk policy: ticks run between two host reads of the
    termination condition."""

    quantum_ms: float = 1.0
    max_ticks: int = 600_000
    chunk_ticks: int = 32
    metrics_capacity: int = 64
    seed: int = 0
    churn_fraction: float = 0.0
    churn_start_ms: float = 0.0
    churn_end_ms: float = 0.0
    dest_sharded: Optional[bool] = None  # a no-op on one device
    phase_gating: bool = False
    pallas_front: Optional[bool] = None
    event_skip: Optional[bool] = None
    # the fused observer lowering: one drop-cause lattice a tick feeds
    # the trace (one EV_DROP append) and telemetry (one net_drops add)
    # planes, and the kill/restart pair is one CAT_FAULT append; False
    # keeps the per-cause emits (the same records and counts)
    fused_observers: bool = True
    slices: int = 1


def watchdog_chunk_ticks(n: int, cost_scale: float = 1.0) -> int:
    """The JAX package's per-dispatch tick budget at ``n`` instances,
    which the runner gives ``SimConfig.chunk_ticks`` when the run config
    leaves it unset: chunk boundaries (drain, live rows, checkpoints)
    then fall on the JAX runner's ticks. 8,192 up to 100k instances,
    1,536 to 300k, 512 to 3M, 64 above; ``cost_scale`` > 1 divides it,
    rounded down to a power of two and floored at 64. The port reads
    termination every ``POLL_TICKS`` iterations inside a chunk, so a
    long chunk costs no identity iterations past the end of a run."""
    if n <= 100_000:
        base = 8192
    elif n <= 300_000:
        base = 1536
    elif n <= 3_000_000:
        base = 512
    else:
        base = 64
    if cost_scale > 1.0:
        base = max(64, 2 ** int(math.floor(math.log2(base / cost_scale))))
    return base


def churn_kill_tick(cfg: SimConfig, group_ids: np.ndarray) -> np.ndarray:
    """Per-instance kill tick for the churn schedule, -1 = never (the same
    host-side numpy RNG as the JAX package, so the same schedule)."""
    n = group_ids.shape[0]
    kill_tick = np.full(n, -1, np.int32)
    if cfg.churn_fraction > 0:
        rng = np.random.default_rng(cfg.seed + 0xC0FFEE)
        victims = rng.random(n) < cfg.churn_fraction
        victims &= group_ids >= 0
        t0 = int(cfg.churn_start_ms / cfg.quantum_ms)
        t1 = max(t0 + 1, int(cfg.churn_end_ms / cfg.quantum_ms))
        kill_tick = np.where(
            victims, rng.integers(t0, t1, size=n), -1
        ).astype(np.int32)
    return kill_tick


def merge_kill_ticks(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Merge two per-instance kill schedules (-1 = never): the earliest
    scheduled death wins."""
    a = np.asarray(a, np.int32)
    b = np.asarray(b, np.int32)
    return np.where(
        a < 0, b, np.where(b < 0, a, np.minimum(a, b))
    ).astype(np.int32)


def live_lanes(st: dict, has_restarts: bool = False):
    """Lanes that keep the run alive: RUNNING instances, and under a
    fault plane with restart events the CRASHED ones whose rejoin is
    still scheduled (the run idles forward to the restart)."""
    live = st["status"] == RUNNING
    if has_restarts:
        live = live | ((st["status"] == CRASHED)
                       & (st["faults"]["restart_tick"] >= 0))
    return live


# "no scheduled event" sentinel of the event-horizon min (int32 max)
_EV_NEVER = 2**31 - 1

# state leaves that exist only on a skip-enabled executor (the JAX
# package's list)
EVENT_SKIP_STATE_LEAVES = ("ticks_executed", "staging_cnt", "wheel_occ")


def next_event_tick(out: dict, nt, has_restarts: bool = False,
                    fault_plan=None, telem_spec=None):
    """The event-horizon min: the earliest tick >= ``nt`` at which the
    post-tick state ``out`` can evolve (every tick before it is provably
    an identity): RUNNING lanes wake at max(blocked_until, nt), pending
    kills land at max(kill_tick, nt), pending restarts at
    max(restart_tick, nt), a fault window opens or closes at its
    boundary, a queued egress send can leave on any tick, an occupied
    staging row drains at ``nt``, the delay wheel's earliest occupied
    bucket drains at its tick, a running lane's next recorded arrival
    comes due (under a replay plan: ``out["replay"]``), and a telemetry
    sample is taken at its boundary. ``nt`` when no lane lives."""
    run_m = out["status"] == RUNNING
    never = torch.full_like(out["blocked_until"], _EV_NEVER)
    ev = torch.min(
        torch.where(run_m, torch.maximum(out["blocked_until"], nt), never)
    )
    kill_p = run_m & (out["kill_tick"] >= 0)
    ev = torch.minimum(
        ev,
        torch.min(torch.where(kill_p, torch.maximum(out["kill_tick"], nt),
                              never)),
    )
    if has_restarts:
        rt = out["faults"]["restart_tick"]
        rj = (out["status"] == CRASHED) & (rt >= 0)
        ev = torch.minimum(
            ev, torch.min(torch.where(rj, torch.maximum(rt, nt), never)))
    if fault_plan is not None and fault_plan.has_windows:
        ev = torch.minimum(ev, faultsmod.next_boundary(out["faults"], nt))
    nst = out.get("net", {})
    if "pend_dest" in nst:
        ev = torch.minimum(
            ev,
            torch.where(torch.any(nst["pend_dest"] >= 0), nt, _EV_NEVER),
        )
    if "staging_cnt" in nst:
        ev = torch.minimum(
            ev, torch.where(nst["staging_cnt"] > 0, nt, _EV_NEVER))
    if "wheel_occ" in nst:
        W = nst["wheel_occ"].shape[0]
        # bucket b holds messages for tick nt + ((b - nt) mod W)
        offs = torch.remainder(
            torch.arange(W, dtype=torch.int32, device=nt.device) - nt, W)
        mo = torch.min(torch.where(nst["wheel_occ"] > 0, offs, W))
        ev = torch.minimum(ev, torch.where(mo < W, nt + mo, _EV_NEVER))
    if "replay" in out:
        ev = torch.minimum(
            ev, replaymod.next_arrival_term(out["replay"], run_m, nt))
    if telem_spec is not None:
        ev = torch.minimum(ev, telemetrymod.next_boundary_tick(telem_spec,
                                                               nt))
    live_any = torch.any(live_lanes(out, has_restarts))
    return torch.where(live_any, torch.maximum(ev, nt), nt)


def _ranked_scatter(ids: torch.Tensor, table_size: int,
                    prev_counts: torch.Tensor):
    """signal_entry / publish lowering: each instance's RANK among same-id
    emitters this tick (ordered by instance id) and the updated per-id
    counts. One exact lowering (stable sort + segment ranks) for every
    table size. Returns (new_counts [table_size], seq [N] = prev_count +
    rank + 1 where id >= 0 else 0, valid mask)."""
    valid = ids >= 0
    safe = torch.where(valid, ids, table_size)  # drop id
    order, _, rank_sorted = netmod.sort_rank(safe)
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted
    prev = prev_counts[torch.clamp(ids, 0, table_size - 1)]
    seq = torch.where(valid, prev + rank + 1, 0)
    # integer adds (exact in any order); a scatter_add, not an
    # index_add_, so that a sweep's vmap batches it in one op
    counts = torch.cat([prev_counts, prev_counts.new_zeros(1)]).scatter_add(
        0, safe.to(torch.int64), valid.to(prev_counts.dtype))
    return counts[:table_size], seq, valid


def _static_eq(v, const) -> bool:
    """True when a PhaseCtrl field is provably the static scalar
    ``const``: a Python number (a tensor proves nothing)."""
    if isinstance(v, (bool, int, float)):
        return v == const
    if isinstance(v, (np.ndarray, np.generic)):
        return bool(np.all(v == const))
    return False


def _static_zero(v) -> bool:
    return _static_eq(v, 0)


def _check_phase_net_ctrl(ctrl, spec, phase_name: str) -> None:
    """Reject hand-written phases whose PhaseCtrl net writes would be
    silently dropped because the state they target was never allocated
    (the JAX package's check, message for message)."""
    if (
        spec is not None
        and not spec.uses_dials
        and not _static_zero(ctrl.send_tag)
    ):
        raise ValueError(
            f"phase {phase_name!r} emits PhaseCtrl(send_tag=...) that may "
            "be TAG_SYN, but the program never declared the dial "
            "capability — use ProgramBuilder.dial() or "
            "enable_net(uses_dials=True); without it the handshake "
            "register is not allocated and the SYN's reply would be "
            "silently dropped. A data-only relay that forwards a traced "
            "tag should instead pin send_tag=TAG_DATA statically (data "
            "frames all carry the same tag), avoiding the handshake "
            "plane's cost entirely."
        )
    uses_any_net = not (
        _static_zero(ctrl.net_set)
        and ctrl.rule_row is None
        and ctrl.class_rule_row is None
        and _static_eq(ctrl.net_class, -1)
    )
    if not uses_any_net:
        return
    if spec is None:
        raise ValueError(
            f"phase {phase_name!r} emits PhaseCtrl net writes but the "
            "program never enabled the data plane — call enable_net() or "
            "use ProgramBuilder.configure_network"
        )
    if ctrl.rule_row is not None and not spec.use_pair_rules:
        raise ValueError(
            f"phase {phase_name!r} emits PhaseCtrl(rule_row=...) but the "
            "program never enabled pair rules, so no [N, N] filter state "
            "exists and the row would be silently dropped — use "
            "configure_network(rules_fn=...) or enable_net(pair_rules=True)."
        )
    if ctrl.class_rule_row is not None and not spec.use_class_rules:
        raise ValueError(
            f"phase {phase_name!r} emits PhaseCtrl(class_rule_row=...) but "
            "the program never enabled class rules — use "
            "configure_network(class_rules_fn=...) or "
            "enable_net(class_rules=True)."
        )
    if not _static_eq(ctrl.net_class, -1) and not spec.use_class_rules:
        raise ValueError(
            f"phase {phase_name!r} emits PhaseCtrl(net_class=...) but the "
            "program never enabled class rules — use set_net_class() or "
            "enable_net(class_rules=True)."
        )
    if _static_zero(ctrl.net_set):
        return
    for field_name, flag, knob in (
        ("net_latency_ms", spec.uses_latency, "uses_latency"),
        ("net_jitter_ms", spec.uses_jitter, "uses_jitter"),
        ("net_bandwidth", spec.uses_rate, "uses_rate"),
        ("net_loss", spec.uses_loss, "uses_loss"),
        ("net_corrupt", spec.uses_corrupt, "uses_corrupt"),
        ("net_reorder", spec.uses_reorder, "uses_reorder"),
        ("net_duplicate", spec.uses_duplicate, "uses_duplicate"),
        ("net_loss_corr", spec.uses_loss_corr, "uses_loss_corr"),
        ("net_corrupt_corr", spec.uses_corrupt_corr, "uses_corrupt_corr"),
        ("net_reorder_corr", spec.uses_reorder_corr, "uses_reorder_corr"),
        ("net_duplicate_corr", spec.uses_duplicate_corr,
         "uses_duplicate_corr"),
    ):
        if flag or _static_zero(getattr(ctrl, field_name)):
            continue
        raise ValueError(
            f"phase {phase_name!r} writes {field_name} via "
            "PhaseCtrl(net_set=...) but the program never proved the "
            f"{knob} capability, so no shaping state is allocated and the "
            "write would be silently dropped. Route shaping through "
            "ProgramBuilder.configure_network, or declare the capability "
            f"explicitly with enable_net({knob}=True)."
        )


# PhaseCtrl fields the tick consumes, in the JAX package's FIELDS order:
# (name, kind, static default). Kinds: "i" int32, "f" float32, "pay"
# net payload vector, "tpay" topic payload vector, "rule" pair-rule row
# ([N], all -1 by default; [1] zeros without pair rules), "crule"
# class-rule row (likewise [C]). The trace and telemetry fields are
# carried only under their plane (without it the JAX package's XLA
# drops them as dead code).
_FIELDS = (
    ("advance", "i", 0),
    ("jump", "i", -1),
    ("signal", "i", -1),
    ("publish_topic", "i", -1),
    ("publish_payload", "tpay", None),
    ("status", "i", 0),
    ("sleep", "i", 0),
    ("metric_id", "i", -1),
    ("metric_value", "f", 0.0),
    ("send_dest", "i", -1),
    ("send_tag", "i", 0),
    ("send_port", "i", 0),
    ("send_size", "f", 0.0),
    ("send_payload", "pay", None),
    ("recv_count", "i", 0),
    ("hs_clear", "i", 0),
    ("net_set", "i", 0),
    ("net_latency_ms", "f", 0.0),
    ("net_jitter_ms", "f", 0.0),
    ("net_bandwidth", "f", 0.0),
    ("net_loss", "f", 0.0),
    ("net_corrupt", "f", 0.0),
    ("net_reorder", "f", 0.0),
    ("net_duplicate", "f", 0.0),
    ("net_loss_corr", "f", 0.0),
    ("net_corrupt_corr", "f", 0.0),
    ("net_reorder_corr", "f", 0.0),
    ("net_duplicate_corr", "f", 0.0),
    ("net_enabled", "i", 1),
    ("rule_row", "rule", None),
    ("net_class", "i", -1),
    ("class_rule_row", "crule", None),
    ("trace_code", "i", -1),
    ("trace_a0", "i", 0),
    ("trace_a1", "i", 0),
    ("observe_hist", "i", -1),
    ("observe_value", "f", 0.0),
    ("count_add", "i", 0),
    ("gauge_set", "i", 0),
    ("gauge_value", "f", 0.0),
    ("replay_consume", "i", 0),
)
_VECTOR_KINDS = ("pay", "tpay", "rule", "crule")
_TRACE_FIELDS = ("trace_code", "trace_a0", "trace_a1")
_TELEM_FIELDS = ("observe_hist", "observe_value", "count_add", "gauge_set",
                 "gauge_value")
_REPLAY_FIELDS = ("replay_consume",)
# the replay plane's per-lane head view, as the phases' TickEnv reads it
_REPLAY_VIEW = ("arr_tick", "arr_op", "arr_arg", "arr_pending", "arr_left")


def _topic_append(buf, mask, pos0, payloads, pay):
    """The non-stream topic append: each ``mask`` lane adds its payload
    row into slot ``pos0`` of ``buf`` ``[cap, pay]``. The ranked seq gives
    every publisher a distinct slot, and every other lane gets a drop row
    of its own past the end (sliced off), so no two updates meet in one
    row and ``index_put_(accumulate=True)`` is exact in any order; it
    adds, as the JAX package's ``buf.at[pos].add`` does (0.0 + -0.0 is
    +0.0)."""
    cap = buf.shape[0]
    n = mask.shape[0]
    lanes = torch.arange(n, dtype=torch.int64, device=buf.device)
    rows = torch.where(mask, pos0.to(torch.int64), cap + lanes)
    ext = torch.cat([buf, buf.new_zeros((n, buf.shape[1]))])
    ext.index_put_(
        (rows,),
        torch.where(mask[:, None], payloads[:, :pay], 0.0),
        accumulate=True,
    )
    return ext[:cap]


def _stream_push(buf, head, mask, pos0, payloads, pay):
    """The stream-topic append (single publisher a tick): the first
    ``mask`` lane's row goes into slot ``pos0`` of ``buf`` ``[cap, pay]``
    and into the head register ``head`` ``[pay]``; a second publisher in
    the same tick is dropped (the caller counts it). The JAX package
    takes the row as a masked sum over all lanes, which turns a -0.0
    payload into +0.0; one gathered row plus 0.0 gives the same bits.
    Branch-free and with no host read: with no publisher the slot and
    the head are selected back to what they were."""
    cap = buf.shape[0]
    any_pub = torch.any(mask)
    at = torch.min(torch.where(mask, pos0, cap - 1)).reshape(1).to(
        torch.int64)
    lane = torch.argmax((mask & (pos0 == at)).to(torch.int32)).reshape(1)
    row = payloads.index_select(0, lane)[:, :pay] + 0.0
    row = torch.where(any_pub, row, buf.index_select(0, at))
    new_head = torch.where(any_pub, row[0], head)
    return buf.index_copy(0, at, row), new_head


# eager loop iterations a CUDA stepper runs (and discards) before its
# capture: they make what a tick caches on first use (kernel scratch,
# constants) outside the graph
STEPPER_WARMUP = 2
# loop iterations between two host reads of the termination condition
# inside a chunk: a run ends within this many identity iterations of its
# last tick, whatever ``chunk_ticks`` is
POLL_TICKS = 32


def _leaves(tree: dict):
    """The tensors of a nested state dict, in a fixed order."""
    for k in sorted(tree, key=str):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _tree_where(go, new, old):
    if isinstance(new, dict):
        return {k: _tree_where(go, new[k], old[k]) for k in new}
    # a leaf the step passed through (a key, a schedule) is its own select
    return old if new is old else torch.where(go, new, old)


# one capture at a time in the process: two runs on two threads (admitted
# together by sim/leases.py) each capture their own loop iteration
_CAPTURE_LOCK = threading.Lock()


def capture_step(step, st: dict, device):
    """``step`` (state -> state) captured once in a CUDA graph on
    ``device``, after ``STEPPER_WARMUP`` eager calls (which leave ``st``
    as it was: the step is pure), with a copy of its result back into
    ``st``'s tensors. The returned function replays the graph: it
    advances ``st`` itself by one step and returns it. The capture fails
    if the step reads anything back to the host; it is thread-local, so
    another thread's run goes on replaying and reading its own state
    meanwhile."""
    with _CAPTURE_LOCK:
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(STEPPER_WARMUP):
                step(st)
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        ins = list(_leaves(st))
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = step(st)
            for dst, src in zip(ins, _leaves(out)):
                if src is not dst:
                    dst.copy_(src)

    def replay(state):
        assert state is st, "a captured stepper advances its own state"
        graph.replay()
        return state

    replay.graph = graph  # the graph lives as long as the stepper
    return replay


class SimExecutable:
    """A built composition, ready to run on ``device``."""

    def __init__(
        self,
        program: Program,
        ctx: BuildContext,
        config: SimConfig,
        device="cuda",
        params: Optional[dict[str, np.ndarray]] = None,
        faults=None,
        trace=None,
        telemetry=None,
        replay=None,
    ) -> None:
        self.device = resolve_device(device)
        if config.slices > 1:
            raise _not_ported("SimConfig.slices > 1", 12, "multi-GPU")
        self.program = program
        self.ctx = ctx
        self.config = config
        # the replay plane: a compiled ReplayPlan or None. Its recorded
        # churn rows fold into the fault plane before anything reads it
        # (a windowless plan when there is no [faults] table)
        self.replay = replay
        if replay is not None:
            faults = replaymod.merge_into_faults(replay, faults)
        # the trace plane: a compiled TraceSpec or None
        self.trace = trace
        if (
            config.churn_fraction > 0
            and config.churn_end_ms <= config.churn_start_ms
        ):
            raise ValueError(
                "churn window is empty or inverted: churn_end_ms="
                f"{config.churn_end_ms} <= churn_start_ms="
                f"{config.churn_start_ms} with churn_fraction="
                f"{config.churn_fraction}; the window is [start, end) — "
                "set churn_end_ms > churn_start_ms"
            )
        # the fault plane: a compiled FaultPlan or None. Window rows
        # overlay the data plane, and degrade magnitudes force the
        # shaping capabilities the overlay adds to
        self.faults = faults
        if faults is not None and faults.has_windows:
            if program.net_spec is None:
                raise ValueError(
                    "[faults] declares partition/degrade windows but the "
                    "plan never enables the network data plane — there "
                    "is no traffic to shape. Use enable_net()/"
                    "configure_network in the plan, or restrict the "
                    "schedule to kill/restart events."
                )
            forced = {
                k: True
                for k, v in faults.shaping_needs().items()
                if v and not getattr(program.net_spec, k)
            }
            if forced:
                self.program = program = dataclasses.replace(
                    program,
                    net_spec=dataclasses.replace(program.net_spec, **forced),
                )
        # the telemetry plane, compiled after the fault plane forced its
        # capabilities (probe applicability reads the net statics)
        self.telemetry = telemetrymod.compile_telemetry(
            telemetry, ctx, program.net_spec, config,
            has_fault_windows=faults is not None and faults.has_windows,
        )
        self.params = params or {}
        self.n = ctx.padded_n
        if config.event_skip is True and config.pallas_front is True:
            raise ValueError(
                "SimConfig.event_skip=True cannot compose with "
                "pallas_front=True — the fused deliver kernel bypasses "
                "the wheel-occupancy bookkeeping the event-horizon jump "
                "consumes; run the skip on the default lowering"
            )
        self.event_skip = (
            config.pallas_front is not True
            if config.event_skip is None
            else bool(config.event_skip)
        )
        if config.pallas_front is True:
            # every observer or fault plane hooks the drop-cause mask
            # chain the fused kernel owns: one raise names them all
            conflicts = []
            if faults is not None and faults.has_windows:
                conflicts.append("[faults] (partition/degrade schedule)")
            if trace is not None:
                conflicts.append("[trace]")
            if self.telemetry is not None:
                conflicts.append("[telemetry]")
            if conflicts:
                raise ValueError(
                    "SimConfig.pallas_front=True cannot compose with "
                    + ", ".join(conflicts)
                    + " — the fused deliver kernel bypasses the "
                    "drop-cause mask chain these planes hook into. "
                    "Remove the conflicting table"
                    + ("s" if len(conflicts) > 1 else "")
                    + " or drop pallas_front=True to run on the "
                    "default lowering (docs/perf.md \"Compile cost\")."
                )
            elig = program.net_spec is not None and front_eligible(
                program.net_spec, self.n
            )
            if not elig:
                raise ValueError(
                    "SimConfig.pallas_front=True but the program's "
                    "feature set or mesh is ineligible "
                    + (
                        "(the program has no net plane)"
                        if program.net_spec is None
                        else "(sim/pallas_front.py eligible())"
                    )
                )
            self.program = program = dataclasses.replace(
                program,
                net_spec=dataclasses.replace(
                    program.net_spec, pallas_front=True
                ),
            )
        spec = program.net_spec
        if spec is not None:
            netmod.check_supported(spec)
        if (
            (self.event_skip
             or (self.telemetry is not None
                 and "wheel_occ" in self.telemetry.glob))
            and spec is not None and not spec.store_entries
        ):
            # the jump's min, and the wheel_occ gauge, read the staging /
            # wheel occupancy counts
            self.program = program = dataclasses.replace(
                program,
                net_spec=dataclasses.replace(spec, track_occupancy=True),
            )
        self.has_restarts = faults is not None and faults.has_restarts
        self._tick_fn = None
        # CUDA-graph captures of the loop iteration made so far: one a
        # run on the card (a drain at a chunk boundary captures nothing),
        # or one for every run after ``warmup``
        self.captures = 0
        # (state, stepper) captured by ``warmup`` and reused by every
        # later run; ``_held_fresh``: the state is still the initial one
        self._held = None
        self._held_fresh = False
        self.compile_breakdown = None

    # ------------------------------------------------------ initial state

    def init_state(self) -> dict:
        """Initial loop-carried state on the executor's device."""
        prog, ctx, cfg = self.program, self.ctx, self.config
        n, dev = self.n, self.device
        S = prog.states.count
        T = prog.topics.count
        i32, f32 = torch.int32, torch.float32
        mem = {
            name: torch.full((n, *shape), init, dtype=dtype, device=dev)
            for name, (shape, dtype, init) in prog.mem_spec.items()
        }
        status0 = np.where(ctx.group_ids >= 0, RUNNING, PAD).astype(np.int32)
        # the churn schedule, with the fault plane's kills merged in (the
        # earliest scheduled death wins)
        kill_tick = churn_kill_tick(cfg, ctx.group_ids)
        if self.faults is not None and self.faults.has_kills:
            kill_tick = merge_kill_ticks(kill_tick, self.faults.kill_tick)

        def z(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        state = {
            "tick": z((), i32),
            "kill_tick": torch.as_tensor(kill_tick, device=dev),
            "pc": z(n, i32),
            "status": torch.as_tensor(status0, device=dev),
            "blocked_until": z(n, i32),
            "last_seq": z(n, i32),
            "counters": z(S, i32),
            "topic_len": z(T, i32),
            "stream_violations": z((), i32),
            # one [cap, pay] buffer per topic; a dummy [1, 1] for a
            # topic-less program
            "topic_bufs": {
                tid: z((cap, pay), f32)
                for tid, cap, pay, _ in (prog.topics.specs()
                                         or [(0, 1, 1, False)])
            },
            # stream topics keep a head register: the newest row pushed
            "topic_head": {
                tid: z((pay,), f32)
                for tid, _, pay, stream in prog.topics.specs() if stream
            },
            "metrics_buf": z((n, cfg.metrics_capacity, 3), f32),
            "metrics_cnt": z(n, i32),
            "metrics_dropped": z(n, i32),
            "mem": mem,
        }
        # per-instance contribution counts for churn-watched states and
        # topics ([N, K]): what churn barriers add back for the dead
        if prog.churn_sids:
            state["churn_sig"] = z((n, len(prog.churn_sids)), i32)
        if prog.churn_tids:
            state["churn_pub"] = z((n, len(prog.churn_tids)), i32)
        if prog.net_spec is not None:
            state["net"] = netmod.init_net_state(n, prog.net_spec, dev)
        # the fault plane: its window numerics and restart schedule, the
        # restarts counter and the first-life signal ledger
        if self.faults is not None:
            leaves = self.faults.dynamic_leaves()
            if leaves:
                state["faults"] = {k: torch.as_tensor(v, device=dev)
                                   for k, v in leaves.items()}
            if self.has_restarts:
                state["restarts"] = z(n, i32)
                if prog.churn_sids:
                    state["stale_sig"] = z(len(prog.churn_sids), i32)
        if self.event_skip:
            # executed tick_fn iterations (the gap to ``tick`` is the
            # dead time the event-horizon jump skipped)
            state["ticks_executed"] = z((), i32)
        # the observer planes' rings and sample buffers (they survive a
        # restart: observer state, not process state)
        if self.trace is not None:
            state["trace"] = tracemod.init_trace_state(n, self.trace, dev)
        if self.telemetry is not None:
            state["telem"] = telemetrymod.init_telemetry_state(
                n, self.telemetry, dev)
        # the replay plane's arrival table and cursors (the cursor
        # survives a restart: delivered requests are not replayed)
        if self.replay is not None:
            state["replay"] = replaymod.init_replay_state(n, self.replay,
                                                          dev)
        return state

    # ----------------------------------------------------------- tick fn

    def _make_tick_fn(self):
        prog, ctx, cfg = self.program, self.ctx, self.config
        n, dev = self.n, self.device
        S = prog.states.count
        T = prog.topics.count
        n_phases = len(prog.phases)
        group_ids = torch.as_tensor(ctx.group_ids, device=dev)
        group_instance = torch.as_tensor(ctx.group_instance_index, device=dev)
        instance_ids = torch.arange(n, dtype=torch.int32, device=dev)
        params = {k: torch.as_tensor(v, device=dev)
                  for k, v in self.params.items()}
        base_key = prng.PRNGKey(cfg.seed, device=dev)
        net_spec = prog.net_spec
        use_net = net_spec is not None
        count_mode = use_net and not net_spec.store_entries
        NET_PAY = net_spec.payload_len if use_net else 1
        pair_rules = use_net and net_spec.use_pair_rules
        class_rules = use_net and net_spec.use_class_rules
        PAY = prog.topics.payload_len
        topic_specs = prog.topics.specs()
        churn_sids, churn_tids = prog.churn_sids, prog.churn_tids
        quantum_ms = cfg.quantum_ms
        topic_caps = torch.zeros(T, dtype=torch.int32, device=dev)
        for tid, cap, _, _ in topic_specs:
            topic_caps[tid] = cap
        # the fault and observer planes (each a Python branch below)
        fault_plan = self.faults
        has_restarts = self.has_restarts
        overlay = (
            faultsmod.Overlay(fault_plan, dev,
                              want_rev=use_net and net_spec.uses_dials)
            if fault_plan is not None and fault_plan.has_windows else None
        )
        trace_spec, telem_spec = self.trace, self.telemetry
        replay_plan = self.replay
        replay_rows = (
            torch.arange(replay_plan.capacity, dtype=torch.int32, device=dev)
            if replay_plan is not None else None
        )
        trace_gmask = (
            torch.as_tensor(np.asarray(trace_spec.group_mask, bool),
                            device=dev)
            if trace_spec is not None and trace_spec.group_mask is not None
            else None
        )
        telem_consts = (telemetrymod.accum_consts(telem_spec, dev)
                        if telem_spec is not None else {})
        zero_i32 = torch.zeros((), dtype=torch.int32, device=dev)
        # the fields the tick reads: an absent plane's are never carried
        off = set()
        if trace_spec is None:
            off |= set(_TRACE_FIELDS)
        if telem_spec is None:
            off |= set(_TELEM_FIELDS)
        if replay_plan is None:
            off |= set(_REPLAY_FIELDS)
        live_fields = tuple(i for i, (name, _, _) in enumerate(_FIELDS)
                            if name not in off)
        consts: dict = {}

        def const(v, dtype):
            key = (v, dtype)
            if key not in consts:
                consts[key] = torch.tensor(v, dtype=dtype, device=dev)
            return consts[key]

        def pack(kind, v):
            if kind in ("rule", "crule"):
                if not (pair_rules if kind == "rule" else class_rules):
                    return torch.zeros(1, dtype=torch.int32, device=dev)
                if v is None:
                    width = n if kind == "rule" else net_spec.n_classes
                    return torch.full((width,), -1, dtype=torch.int32,
                                      device=dev)
                return torch.as_tensor(v).to(torch.int32)
            if kind in ("pay", "tpay"):
                width = NET_PAY if kind == "pay" else PAY
                if v is None:
                    return torch.zeros(width, dtype=torch.float32,
                                       device=dev)
                p = torch.as_tensor(v).to(torch.float32).reshape(-1)
                if p.shape[0] < width:
                    p = torch.cat([p, p.new_zeros(width - p.shape[0])])
                return p
            dtype = torch.int32 if kind == "i" else torch.float32
            if isinstance(v, torch.Tensor):
                return v.to(dtype)
            return const(int(v) if kind == "i" else float(v), dtype)

        def is_default(kind, v, default):
            if kind in _VECTOR_KINDS:
                return v is None
            return _static_eq(v, default)

        # ---- build-time probe: which mem slots each phase writes and
        # which ctrl fields it sets to non-defaults (one lane, on the CPU)
        def probe(phase):
            cpu = torch.device("cpu")
            mem = {
                name: torch.full(tuple(shape), init, dtype=dtype)
                for name, (shape, dtype, init) in prog.mem_spec.items()
            }
            scal = torch.zeros((), dtype=torch.int32)
            env = TickEnv(
                tick=scal, instance=scal, group=scal, group_instance=scal,
                last_seq=scal, rng=torch.zeros(2, dtype=torch.int64),
                counters=torch.zeros(S, dtype=torch.int32),
                topic_len=torch.zeros(T, dtype=torch.int32),
                topic_buf={
                    tid: torch.zeros((cap, pay))
                    for tid, cap, pay, _ in (topic_specs
                                             or [(0, 1, 1, False)])
                },
                topic_head={tid: torch.zeros(pay)
                            for tid, _, pay, stream in topic_specs if stream},
                crashed_total=scal,
                dead_signals={k: scal for k in churn_sids} or None,
                dead_pubs={k: scal for k in churn_tids} or None,
                restarts=scal,
                params={k: torch.zeros((), dtype=v.dtype, device=cpu)
                        for k, v in params.items()},
                quantum_ms=quantum_ms,
            )
            if replay_plan is not None:
                for k in _REPLAY_VIEW:
                    setattr(env, k, torch.zeros(()) if k == "arr_arg"
                            else scal)
            if use_net:
                env.inbox_avail = scal
                if net_spec.uses_dials:
                    env.hs = torch.zeros(4)
                if net_spec.store_entries:
                    env.inbox = torch.zeros(
                        (net_spec.inbox_capacity, net_spec.width))
                    env.inbox_r = scal
                    env.inbox_head = torch.zeros(
                        (net_spec.head_k, net_spec.width))
                    env.egress_busy = torch.zeros((), dtype=torch.bool)
                else:
                    env.inbox_bytes = torch.zeros(())
                if net_spec.uses_latency:
                    env.eg_latency_ticks = torch.zeros(())
                if pair_rules:
                    env.filter_row = torch.zeros(n, dtype=torch.int8)
            try:
                mem2, ctrl = phase.fn(env, dict(mem))
            except Exception:  # noqa: BLE001 — best-effort, as in JAX
                return tuple(prog.mem_spec), live_fields, {}
            _check_phase_net_ctrl(ctrl, net_spec, phase.name)
            wset = tuple(k for k in mem if mem2.get(k) is not mem[k])
            dyn = tuple(
                i for i in live_fields
                if not is_default(_FIELDS[i][1], getattr(ctrl, _FIELDS[i][0]),
                                  _FIELDS[i][2])
            )
            # fields set to a Python number: the same number every tick
            static = {
                i: getattr(ctrl, _FIELDS[i][0]) for i in dyn
                if _FIELDS[i][1] in ("i", "f")
                and isinstance(getattr(ctrl, _FIELDS[i][0]),
                               (bool, int, float))
            }
            return wset, dyn, static

        probes = [probe(p) for p in prog.phases]
        dyn_union = tuple(sorted(set().union(*(set(d) for _, d, _ in probes))))
        wset_union = tuple(
            s for s in prog.mem_spec if any(s in w for w, _, _ in probes)
        )
        defaults = {
            name: pack(kind, default) for name, kind, default in _FIELDS
        }
        mem_dtypes = {s: prog.mem_spec[s][1] for s in prog.mem_spec}
        # The JAX package selects every carried field and slot among all
        # phases by pc. A phase that does not write a slot leaves it as it
        # was, and one that leaves a field at its static default gives the
        # default; so the port selects only among the phases that write
        # it, and takes the Python numbers phases set a field to from one
        # [n_phases] table gathered at pc. Same values, far fewer ops.
        writers = {s: [k for k, (w, _, _) in enumerate(probes) if s in w]
                   for s in wset_union}
        tensor_setters = {
            i: [k for k, (_, d, st) in enumerate(probes)
                if i in d and i not in st]
            for i in dyn_union
        }
        tables = {}
        for i in dyn_union:
            if any(i in st for _, _, st in probes):
                name, kind, default = _FIELDS[i]
                tables[i] = torch.tensor(
                    [st.get(i, default) for _, _, st in probes],
                    dtype=torch.int32 if kind == "i" else torch.float32,
                    device=dev,
                )

        def run_phase(k, phase, env, mem_row):
            wset, dyn, static = probes[k]
            mem2, ctrl = phase.fn(env, dict(mem_row))
            for s in wset:
                if mem2[s].dtype != mem_dtypes[s]:
                    raise TypeError(
                        f"phase {phase.name!r} wrote mem slot {s!r} as "
                        f"{mem2[s].dtype}, declared {mem_dtypes[s]}"
                    )
            fields = {}
            for i in dyn:
                name, kind, _ = _FIELDS[i]
                v = getattr(ctrl, name)
                if i in static:
                    if not _static_eq(v, static[i]):
                        raise RuntimeError(
                            f"phase {phase.name!r} set PhaseCtrl.{name} to "
                            f"{static[i]!r} when probed and to {v!r} now")
                    continue
                fields[i] = pack(kind, v)
            return {s: mem2[s] for s in wset}, fields

        def make_step(tick, counters, topic_len, topic_bufs, topic_head,
                      crashed_total, dead_signals, dead_pubs):
            def step_instance(pc, status, blocked_until, last_seq, mem_row,
                              instance, group, ginst, prow, net_row, key,
                              lane_extra):
                env = TickEnv(
                    tick=tick,
                    instance=instance,
                    group=group,
                    group_instance=ginst,
                    last_seq=last_seq,
                    rng=key,
                    counters=counters,
                    topic_len=topic_len,
                    topic_buf=topic_bufs,
                    topic_head=topic_head,
                    crashed_total=crashed_total,
                    dead_signals=dead_signals,
                    dead_pubs=dead_pubs,
                    restarts=lane_extra.get("restarts", zero_i32),
                    params=prow,
                    inbox=net_row.get("inbox"),
                    inbox_r=net_row.get("inbox_r"),
                    inbox_avail=net_row.get("inbox_avail"),
                    inbox_head=net_row.get("inbox_head"),
                    inbox_bytes=net_row.get("bytes_in"),
                    hs=net_row.get("hs"),
                    egress_busy=net_row.get("egress_busy"),
                    eg_latency_ticks=net_row.get("eg_latency"),
                    filter_row=net_row.get("filter_row"),
                    arr_pending=lane_extra.get("arr_pending"),
                    arr_op=lane_extra.get("arr_op"),
                    arr_arg=lane_extra.get("arr_arg"),
                    arr_tick=lane_extra.get("arr_tick"),
                    arr_left=lane_extra.get("arr_left"),
                    quantum_ms=quantum_ms,
                )
                safe_pc = torch.clamp(pc, 0, n_phases - 1)
                outs = [run_phase(k, p, env, mem_row)
                        for k, p in enumerate(prog.phases)]
                eqs = {}

                def at(k):
                    if k not in eqs:
                        eqs[k] = safe_pc == k
                    return eqs[k]

                mem2 = {}
                for s in wset_union:
                    acc = mem_row[s]
                    for k in writers[s]:
                        acc = torch.where(at(k), outs[k][0][s], acc)
                    mem2[s] = acc
                ctrl = dict(defaults)
                for i in dyn_union:
                    name = _FIELDS[i][0]
                    acc = tables[i][safe_pc] if i in tables else ctrl[name]
                    for k in tensor_setters[i]:
                        acc = torch.where(at(k), outs[k][1][i], acc)
                    ctrl[name] = acc
                active = (
                    (status == RUNNING) & (tick >= blocked_until)
                    & (pc < n_phases)
                )
                mem_out = {
                    s: (torch.where(active, mem2[s], mem_row[s])
                        if s in mem2 else mem_row[s])
                    for s in mem_row
                }
                jump, advance = ctrl["jump"], ctrl["advance"]
                new_status, sleep = ctrl["status"], ctrl["sleep"]
                new_pc = torch.where(
                    active,
                    torch.where(jump >= 0, jump,
                                torch.where(advance > 0, pc + 1, pc)),
                    pc,
                )
                fell_off = active & (new_pc >= n_phases) & (new_status == 0)
                out_status = torch.where(
                    active & (new_status != 0),
                    new_status,
                    torch.where(fell_off, DONE_OK, status),
                )
                out_blocked = torch.where(
                    active & (sleep > 0), tick + 1 + sleep, blocked_until
                )
                out = {
                    "pc": new_pc,
                    "status": out_status,
                    "blocked_until": out_blocked,
                    "mem": mem_out,
                    "signal": torch.where(active, ctrl["signal"], -1),
                    "publish": torch.where(active, ctrl["publish_topic"],
                                           -1),
                    "publish_payload": ctrl["publish_payload"],
                    "metric_id": torch.where(active, ctrl["metric_id"], -1),
                    "metric_value": ctrl["metric_value"],
                }
                if use_net:
                    out.update(
                        send_dest=torch.where(active, ctrl["send_dest"], -1),
                        recv_count=torch.where(active, ctrl["recv_count"], 0),
                        hs_clear=torch.where(active, ctrl["hs_clear"], 0),
                        net_set=torch.where(active, ctrl["net_set"], 0),
                        net_class=torch.where(active, ctrl["net_class"], -1),
                    )
                    for name in (
                        "send_tag", "send_port", "send_size", "send_payload",
                        "net_latency_ms", "net_jitter_ms", "net_bandwidth",
                        "net_loss", "net_corrupt", "net_reorder",
                        "net_duplicate", "net_loss_corr", "net_corrupt_corr",
                        "net_reorder_corr", "net_duplicate_corr",
                        "net_enabled", "rule_row", "class_rule_row",
                    ):
                        out[name] = ctrl[name]
                if trace_spec is not None:
                    out.update(
                        trace_code=torch.where(active, ctrl["trace_code"], -1),
                        trace_a0=ctrl["trace_a0"], trace_a1=ctrl["trace_a1"],
                    )
                if telem_spec is not None:
                    out.update(
                        observe_hist=torch.where(active, ctrl["observe_hist"],
                                                 -1),
                        observe_value=ctrl["observe_value"],
                        count_add=torch.where(active, ctrl["count_add"], 0),
                        gauge_set=torch.where(active, ctrl["gauge_set"], 0),
                        gauge_value=ctrl["gauge_value"],
                    )
                if replay_plan is not None:
                    out["replay_take"] = torch.where(
                        active, ctrl["replay_consume"], 0)
                return out

            return torch.func.vmap(step_instance)

        def rejoin(st, tick, em):
            """The fault plane's restarts, before the kill check: a
            CRASHED lane whose restart tick came re-enters as a fresh
            process (pc 0, fresh memory, empty inbox, the default link,
            its kill cleared, its restarts counted); its first-life
            signals move to the stale ledger. Mutates ``st``."""
            ftst = st["faults"]
            rj = (
                (st["status"] == CRASHED)
                & (ftst["restart_tick"] >= 0)
                & (tick >= ftst["restart_tick"])
            )
            st["status"] = torch.where(rj, RUNNING, st["status"])
            st["pc"] = torch.where(rj, 0, st["pc"])
            st["blocked_until"] = torch.where(rj, 0, st["blocked_until"])
            st["last_seq"] = torch.where(rj, 0, st["last_seq"])
            st["kill_tick"] = torch.where(rj, -1, st["kill_tick"])
            st["faults"] = {
                **ftst,
                "restart_tick": torch.where(rj, -1, ftst["restart_tick"]),
            }
            st["restarts"] = st["restarts"] + rj.to(torch.int32)
            if em is not None and not em.fused:
                # the rings survive the rejoin (observer state); the
                # fused build merges this into the kill site's append
                em.emit(tracemod.CAT_FAULT, rj, tracemod.EV_RESTART,
                        arg0=st["restarts"])
            st["mem"] = {
                name: torch.where(
                    rj.reshape((n,) + (1,) * len(shape)), init,
                    st["mem"][name])
                for name, (shape, dtype, init) in prog.mem_spec.items()
            }
            # signals are rendezvous contributions, re-made by the fresh
            # life; topic rows are data and persist
            if churn_sids:
                st["stale_sig"] = st["stale_sig"] + torch.sum(
                    torch.where(rj[:, None], st["churn_sig"], 0), dim=0,
                    dtype=torch.int32)
                st["churn_sig"] = torch.where(rj[:, None], 0, st["churn_sig"])
            if use_net:
                nrst = dict(st["net"])
                if net_spec.store_entries:
                    nrst["inbox_r"] = torch.where(rj, nrst["inbox_w"],
                                                  nrst["inbox_r"])
                else:
                    nrst["avail"] = torch.where(rj, 0, nrst["avail"])
                    nrst["bytes_in"] = torch.where(rj, 0.0, nrst["bytes_in"])
                if "hs" in nrst:
                    nrst["hs"] = torch.where(rj[:, None],
                                             netmod._hs_empty(dev), nrst["hs"])
                if "pend_dest" in nrst:
                    nrst["pend_dest"] = torch.where(rj, -1, nrst["pend_dest"])
                # the default link: the fresh plan has configured nothing
                for k in (
                    "eg_latency", "eg_jitter", "eg_rate", "eg_busy",
                    "eg_loss", "eg_corrupt", "eg_reorder", "eg_duplicate",
                    "eg_loss_corr", "eg_corrupt_corr", "eg_reorder_corr",
                    "eg_duplicate_corr", "ar_loss", "ar_corrupt",
                    "ar_reorder", "ar_duplicate",
                ):
                    if k in nrst:
                        nrst[k] = torch.where(rj, 0.0, nrst[k])
                nrst["net_enabled"] = torch.where(rj, 1, nrst["net_enabled"])
                for k in ("pair_filter", "class_rules"):
                    if k in nrst:
                        nrst[k] = torch.where(rj[:, None], 0, nrst[k])
                if "class_of" in nrst:
                    nrst["class_of"] = torch.where(rj, 0, nrst["class_of"])
                st["net"] = nrst
            return rj

        def tick_fn(st: dict) -> dict:
            tick = st["tick"]
            # a sweep's state (sim/sweep.py) carries each scenario's key
            # and the param arrays that vary across its scenarios; a plain
            # run keeps them as constants (the same bits either way)
            key = prng.fold_in(
                st["rng_key"].to(torch.int64) if "rng_key" in st
                else base_key, tick)
            prows = ({**params, **st["params"]} if "params" in st
                     else params)
            st = dict(st)
            # this tick's observer helpers; a lane's records keep the JAX
            # site order: restart, kill, wheel drain, lane transitions,
            # user, sync, net send and drops
            em = (
                tracemod.TraceEmitter(trace_spec, st["trace"], tick, n,
                                      fused=cfg.fused_observers,
                                      gmask=trace_gmask)
                if trace_spec is not None else None
            )
            acc = (
                telemetrymod.TelemetryAccum(telem_spec, st["telem"], n,
                                            fused=cfg.fused_observers,
                                            consts=telem_consts)
                if telem_spec is not None else None
            )
            rj = rejoin(st, tick, em) if has_restarts else None
            # churn BEFORE the step: a victim must not act on its kill tick
            killed_now = (
                (st["status"] == RUNNING)
                & (st["kill_tick"] >= 0)
                & (tick >= st["kill_tick"])
            )
            st["status"] = torch.where(killed_now, CRASHED, st["status"])
            if em is not None:
                if em.fused and has_restarts:
                    # a rejoin clears kill_tick, so a lane writes at most
                    # one of the pair a tick: one append, the same slots
                    em.emit(
                        tracemod.CAT_FAULT, rj | killed_now,
                        torch.where(rj, tracemod.EV_RESTART,
                                    tracemod.EV_KILL),
                        arg0=torch.where(rj, st["restarts"], st["kill_tick"]),
                    )
                else:
                    em.emit(tracemod.CAT_FAULT, killed_now, tracemod.EV_KILL,
                            arg0=st["kill_tick"])
            if acc is not None:
                # a wake: the first executed tick at a lane's
                # blocked_until (a rejoin resets it to 0: not a wake)
                acc.count(
                    "lane_wakes",
                    (st["status"] == RUNNING) & (st["blocked_until"] > 0)
                    & (tick == st["blocked_until"]),
                )
            crashed = st["status"] == CRASHED
            crashed_total = torch.sum(crashed, dtype=torch.int32)
            # contributions the dead already made to churn-watched states
            # and topics (churn barriers add these back), and the
            # first-life signals of restarted lanes
            dead_signals = {
                sid: torch.sum(torch.where(crashed, st["churn_sig"][:, k], 0),
                               dtype=torch.int32)
                + (st["stale_sig"][k] if has_restarts else 0)
                for k, sid in enumerate(churn_sids)
            } or None
            dead_pubs = {
                tid: torch.sum(torch.where(crashed, st["churn_pub"][:, k], 0),
                               dtype=torch.int32)
                for k, tid in enumerate(churn_tids)
            } or None

            net_row = {}
            if use_net:
                netst = st["net"]
                if count_mode:
                    # this tick's bucket becomes visible before the phases
                    # read avail and bytes (deliver writes ticks >= tick+1)
                    netst = netmod.advance_wheel(netst, net_spec, tick,
                                                 trace=em, telem=acc)
                    st["net"] = netst
                avail0 = netmod.visible_prefix(netst, net_spec, tick)
                net_row = {"inbox_avail": avail0}
                if net_spec.uses_dials:
                    net_row["hs"] = netst["hs"]
                if count_mode:
                    net_row["bytes_in"] = netst["bytes_in"]
                else:
                    net_row["inbox"] = netst["inbox"]
                    net_row["inbox_r"] = netst["inbox_r"]
                    net_row["inbox_head"] = netmod.head_cache(netst, net_spec)
                    if "pend_dest" in netst:
                        net_row["egress_busy"] = netst["pend_dest"] >= 0
                if "eg_latency" in netst:
                    net_row["eg_latency"] = netst["eg_latency"]
                if pair_rules:
                    net_row["filter_row"] = netst["pair_filter"]

            lane_keys = prng.fold_in(key, instance_ids)
            lane_extra = {"restarts": st["restarts"]} if has_restarts else {}
            if replay_plan is not None:
                # this tick's head-of-schedule view, one [N, R] pass
                lane_extra.update(zip(
                    _REPLAY_VIEW,
                    replaymod.head_fields(st["replay"], tick, replay_rows)))
            # the shared registers (counters, topics, head registers) are
            # closed over, not mapped: a phase's reduce of one runs once
            vstep = make_step(tick, st["counters"], st["topic_len"],
                              st["topic_bufs"], st["topic_head"],
                              crashed_total, dead_signals, dead_pubs)
            res = vstep(
                st["pc"], st["status"], st["blocked_until"], st["last_seq"],
                st["mem"], instance_ids, group_ids, group_instance, prows,
                net_row, lane_keys, lane_extra,
            )
            pc, status, blocked = res["pc"], res["status"], res["blocked_until"]
            if em is not None:
                # lane transitions: BLOCK with its wake tick, PC moves,
                # DONE; then the plan's own CAT_USER events
                em.emit(tracemod.CAT_LANE,
                        (blocked != st["blocked_until"]) & (blocked > tick),
                        tracemod.EV_BLOCK, arg0=blocked)
                em.emit(tracemod.CAT_LANE, pc != st["pc"], tracemod.EV_PC,
                        arg0=pc, arg1=st["pc"])
                em.emit(tracemod.CAT_LANE,
                        (status != st["status"])
                        & ((status == DONE_OK) | (status == DONE_FAIL)),
                        tracemod.EV_DONE, arg0=status)
                codes = res["trace_code"]
                em.emit(tracemod.CAT_USER, codes >= 0, codes,
                        arg0=res["trace_a0"], arg1=res["trace_a1"])
            if acc is not None:
                acc.observe(res["observe_hist"], res["observe_value"])
                acc.count("user_count", res["count_add"])
                acc.set_gauge(res["gauge_set"], res["gauge_value"])

            sig, pub = res["signal"], res["publish"]
            new_counters, sig_seq, sig_valid = _ranked_scatter(
                sig, S, st["counters"]
            )
            new_topic_len, pub_seq, pub_valid = _ranked_scatter(
                pub, T, st["topic_len"]
            )
            pos0 = torch.where(pub_valid, pub_seq - 1, 0)  # 0-based slot
            if em is not None:
                # every signal_entry and publish, with its ranked seq
                em.emit(tracemod.CAT_SYNC, sig_valid, tracemod.EV_SIGNAL,
                        arg0=sig, arg1=sig_seq)
                em.emit(tracemod.CAT_SYNC, pub_valid, tracemod.EV_PUBLISH,
                        arg0=pub, arg1=pub_seq)
            if acc is not None:
                acc.count("sync_signals", sig_valid)
                acc.count("sync_publishes", pub_valid)
            topic_bufs = dict(st["topic_bufs"])
            topic_head = dict(st["topic_head"])
            stream_viol = st["stream_violations"]
            churn_pub = st.get("churn_pub")
            for tid, cap, pay, stream in topic_specs:
                mask = pub_valid & (pub == tid) & (pos0 < cap)
                if tid in churn_tids:
                    # only appends that land count (topic_count clamps at
                    # the capacity)
                    churn_pub = churn_pub + (
                        mask[:, None] & (torch.arange(
                            len(churn_tids), device=dev)
                            == churn_tids.index(tid))[None, :]
                    ).to(torch.int32)
                if stream:
                    n_pub = torch.sum(mask, dtype=torch.int32)
                    stream_viol = stream_viol + torch.clamp(n_pub - 1, min=0)
                    topic_bufs[tid], topic_head[tid] = _stream_push(
                        topic_bufs[tid], topic_head[tid], mask, pos0,
                        res["publish_payload"], pay)
                else:
                    topic_bufs[tid] = _topic_append(
                        topic_bufs[tid], mask, pos0, res["publish_payload"],
                        pay)
            new_topic_len = torch.minimum(new_topic_len, topic_caps)
            last_seq = torch.where(
                sig_valid, sig_seq,
                torch.where(pub_valid, pub_seq, st["last_seq"]),
            )

            mids = res["metric_id"]
            rec = torch.stack(
                [
                    mids.to(torch.float32),
                    tick.to(torch.float32).expand(n),
                    res["metric_value"],
                ],
                dim=-1,
            )
            metrics_buf, metrics_cnt, metrics_dropped = ring_append(
                st["metrics_buf"], st["metrics_cnt"], st["metrics_dropped"],
                mids >= 0, rec,
            )
            out = {
                "tick": tick + 1,
                "kill_tick": st["kill_tick"],
                "pc": pc,
                "status": status,
                "blocked_until": blocked,
                "last_seq": last_seq,
                "counters": new_counters,
                "topic_len": new_topic_len,
                "topic_bufs": topic_bufs,
                "topic_head": topic_head,
                "stream_violations": stream_viol,
                "metrics_buf": metrics_buf,
                "metrics_cnt": metrics_cnt,
                "metrics_dropped": metrics_dropped,
                "mem": res["mem"],
            }
            if churn_sids:
                # signals to churn-watched states (sig is -1 on inactive
                # lanes, and a victim cannot signal on its kill tick)
                out["churn_sig"] = st["churn_sig"] + torch.stack(
                    [sig == s for s in churn_sids], dim=1).to(torch.int32)
            if churn_tids:
                out["churn_pub"] = churn_pub
            if use_net:
                nst = netmod.apply_net_config(
                    st["net"], quantum_ms, res["net_set"],
                    res["net_latency_ms"], res["net_jitter_ms"],
                    res["net_bandwidth"], res["net_loss"],
                    res["net_enabled"],
                    rule_rows=res["rule_row"] if pair_rules else None,
                    net_class=res["net_class"] if class_rules else None,
                    class_rule_rows=(res["class_rule_row"] if class_rules
                                     else None),
                    corrupt_pct=res["net_corrupt"],
                    reorder_pct=res["net_reorder"],
                    duplicate_pct=res["net_duplicate"],
                    loss_corr_pct=res["net_loss_corr"],
                    corrupt_corr_pct=res["net_corrupt_corr"],
                    reorder_corr_pct=res["net_reorder_corr"],
                    duplicate_corr_pct=res["net_duplicate_corr"],
                )
                # the fault overlay composes after the plan's writes, so
                # a plan cannot clear it
                fault_arg = (overlay(st["faults"], tick, group_ids,
                                     res["send_dest"])
                             if overlay is not None else None)
                nst = netmod.deliver(
                    nst, net_spec, tick, prng.fold_in(key, 7),
                    res["send_dest"], res["send_tag"], res["send_port"],
                    res["send_size"], res["send_payload"],
                    status == RUNNING, hs_clear=res["hs_clear"],
                    fault=fault_arg, trace=em, telem=acc,
                )
                nst = netmod.consume(nst, net_spec, tick, res["recv_count"],
                                     prefix=avail0)
                out["net"] = nst
            if replay_plan is not None:
                # pop the consumed arrivals: each cursor advances by what
                # its lane took, clamped to its due count
                take = torch.minimum(torch.clamp(res["replay_take"], min=0),
                                     lane_extra["arr_pending"])
                out["replay"] = {**st["replay"],
                                 "cursor": st["replay"]["cursor"] + take}
            # the sweep's leaves ride through; the fault plane's carry
            # this tick's rejoin updates
            for k in ("rng_key", "params", "faults", "restarts",
                      "stale_sig"):
                if k in st:
                    out[k] = st[k]
            if em is not None:
                out["trace"] = em.state
            if acc is not None:
                out["telem"] = boundary(acc, out, tick, status, blocked)
            return out

        def boundary(acc, out, tick, status, blocked):
            """The telemetry sample boundary at the end of the tick, its
            gauges read from the post-tick state."""
            lane_g, glob_g = {}, {}
            if "inbox_depth" in telem_spec.gauges:
                nst2 = out["net"]
                lane_g["inbox_depth"] = (
                    nst2["inbox_w"] - nst2["inbox_r"]
                    if net_spec.store_entries else nst2["avail"])
            if "user_gauge" in telem_spec.gauges:
                lane_g["user_gauge"] = acc.state["gauge_reg"]
            run_m = status == RUNNING
            if "live_lanes" in telem_spec.glob:
                glob_g["live_lanes"] = torch.sum(run_m, dtype=torch.int32)
            if "blocked_frac" in telem_spec.glob:
                # blocked next tick while blocked > tick + 1; a true
                # division of two sums, as in JAX
                blk = run_m & (blocked > tick + 1)
                glob_g["blocked_frac"] = torch.sum(
                    blk.to(torch.float32)) / torch.clamp(
                        torch.sum(run_m.to(torch.float32)), min=1.0)
            if "wheel_occ" in telem_spec.glob:
                nst2 = out["net"]
                glob_g["wheel_occ"] = (
                    torch.sum(nst2["wheel_occ"], dtype=torch.int32)
                    if "wheel_occ" in nst2 else nst2["staging_cnt"])
            return telemetrymod.apply_boundary(telem_spec, acc.state, tick,
                                               lane_g, glob_g)

        return tick_fn

    # ----------------------------------------------------------- running

    def tick_fn(self):
        """The (state -> state) tick function, built on first use."""
        if self._tick_fn is None:
            self._tick_fn = self._make_tick_fn()
        return self._tick_fn

    def skip_step(self, st: dict) -> dict:
        """One iteration of the JAX package's ``event_skip_loop`` body:
        count it in ``ticks_executed``, run ``tick_fn``, then jump
        ``tick`` to the next event (bounded by ``max_ticks``). The jump
        stays on the device."""
        executed = st["ticks_executed"] + 1
        out = self.tick_fn()(st)
        out["ticks_executed"] = executed
        nxt = next_event_tick(out, out["tick"], self.has_restarts,
                              self.faults, self.telemetry)
        out["tick"] = torch.clamp(nxt, max=self.config.max_ticks)
        return out

    def guarded_tick(self, st: dict) -> dict:
        """One iteration of the loop (``skip_step`` under event skip,
        ``tick_fn`` otherwise) where the JAX loop's condition (tick <
        max_ticks and a lane still running) holds, an identity on every
        leaf (the jump and ``ticks_executed`` included) where it does
        not. No host read."""
        go = (st["tick"] < self.config.max_ticks) & torch.any(
            live_lanes(st, self.has_restarts))
        step = self.skip_step if self.event_skip else self.tick_fn()
        return _tree_where(go, step(st), st)

    def stepper(self, st: dict):
        """A function that advances the state ``st`` by one loop iteration
        (``guarded_tick``) and returns it. On the CPU it is
        ``guarded_tick``. On the card the iteration is captured once in a
        CUDA graph, after ``STEPPER_WARMUP`` eager iterations (which leave
        ``st`` as it was: the tick is pure), with a copy of its result
        back into ``st``'s tensors; each call replays the graph, so the host
        launches one graph an iteration instead of thousands of ops. The
        capture fails if the tick reads anything back to the host. The
        replayed kernels are the captured ones, so the state is the eager
        tick's, bit for bit."""
        if self.device.type != "cuda":
            return self.guarded_tick
        replay = capture_step(self.guarded_tick, st, self.device)
        self.captures += 1
        return replay

    def warmup(self) -> float:
        """Build the tick function and, on the card, capture the loop
        iteration on an initial state that the executor keeps: every
        later ``run`` replays that capture, copying its start state
        (initial or resumed) into the captured tensors, so a repeat run
        builds and captures nothing. The JAX package's ``warmup``
        compiles its dispatcher in the same place. Returns its seconds
        (0 for a second call)."""
        t0 = time.monotonic()
        built = self._tick_fn is None
        self.tick_fn()
        t1 = time.monotonic()
        captured = self.device.type == "cuda" and self._held is None
        if captured:
            st = self.init_state()
            self._held = (st, self.stepper(st))
            self._held_fresh = True
            torch.cuda.synchronize(self.device)
        t2 = time.monotonic()
        # the port's split of the JAX package's compile_breakdown: None
        # when nothing was built or captured
        self.compile_breakdown = (
            {"build_seconds": round(t1 - t0, 6),
             "capture_seconds": round(t2 - t1, 6)}
            if built or captured else None)
        return t2 - t0

    def release_capture(self) -> None:
        """Drop the capture ``warmup`` kept (and the memory it holds)."""
        self._held = None
        self._held_fresh = False

    def _start_state(self, resume_state):
        """The loop's state and stepper for one run, and the capture's
        seconds. After ``warmup`` on the card: the kept capture, its
        tensors overwritten in place with the initial state or with
        ``resume_state`` (host numpy leaves, sim/state_io.py). Otherwise
        a fresh state (on the card, with its own capture)."""
        if self._held is not None:
            st, step = self._held
            if resume_state is not None:
                _copy_into(st, resume_state)
            elif not self._held_fresh:
                _copy_into(st, self.init_state())
            self._held_fresh = False
            return st, step, 0.0
        if resume_state is not None:
            from .state_io import state_from_numpy

            st = state_from_numpy(resume_state, self.device)
        else:
            st = self.init_state()
        t0 = time.monotonic()
        step = self.stepper(st)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return st, step, time.monotonic() - t0

    def run(self, on_chunk=None, drain=None, should_stop=None,
            watchdog=None, checkpoint=None,
            resume_state=None) -> "SimResult":
        """Run the loop to completion in chunks of ``chunk_ticks`` loop
        iterations (``stepper``), which gives the JAX package's chunk
        boundaries (dense: every ``chunk_ticks`` ticks up to
        ``max_ticks``; event skip: every ``chunk_ticks`` executed
        iterations). Inside a chunk the termination condition is read
        every ``POLL_TICKS`` iterations and the chunk ends with the run:
        the iterations it leaves out are identities.

        At each boundary, in the JAX package's order: ``drain`` (a
        sim/drain.py ``ObserverDrain``) streams the observer rings and
        sample buffers out and zeroes their cursors in place, then
        ``on_chunk(tick, running, info)`` is called (``info`` holds the
        boundary state, and the drain's watermarks under
        ``"observer"``), then ``should_stop()`` is polled, at the last
        boundary too: True ends the run there with the drained prefix
        kept and ``SimResult.terminated`` set. Before the last
        boundary, ``checkpoint`` (a sim/checkpoint.py ``Checkpointer``)
        snapshots the boundary state (forced when stopping) and
        ``watchdog`` (a ``DispatchWatchdog``) judges the chunk's wall
        time, armed around the chunk by ``begin``/``end``.
        ``resume_state`` (a checkpoint's host leaves) replaces the
        initial state. ``wall_seconds`` starts after the stepper's
        capture (``capture_seconds``). After ``warmup`` on the card the
        result's state is the executor's own: the next run overwrites
        it."""
        cfg = self.config
        self.tick_fn()  # built before the clock starts
        st, step, capture_s = self._start_state(resume_state)
        chunk = max(1, cfg.chunk_ticks)
        poll = min(POLL_TICKS, chunk)
        # the capture is set-up, as the JAX package's warmup is: the
        # clock starts after it
        wall0 = time.monotonic()
        terminated = False
        while True:
            d0 = time.monotonic()
            if watchdog is not None:
                watchdog.begin()
            left = chunk
            while left:
                k = min(poll, left)
                for _ in range(k):
                    st = step(st)
                left -= k
                tick = int(st["tick"])
                running = int(torch.sum(live_lanes(st, self.has_restarts)))
                if running == 0 or tick >= cfg.max_ticks:
                    break
            # the watchdog's unit is the chunk (device work + the host
            # reads), before the boundary's host work below
            dispatch_s = time.monotonic() - d0
            if watchdog is not None:
                watchdog.end()
            if drain is not None:
                # before the callback, so it reads the post-drain
                # cumulative watermarks
                st = drain.drain(st)
            if on_chunk is not None:
                info = {"state": st}
                if drain is not None:
                    info["observer"] = drain.stats()
                on_chunk(tick, running, info)
            done = running == 0 or tick >= cfg.max_ticks
            stopping = should_stop is not None and should_stop()
            if checkpoint is not None and not done:
                checkpoint.boundary(st, force=stopping)
            if watchdog is not None and not done:
                watchdog.observe(dispatch_s)
            if done:
                break
            if stopping:
                terminated = True
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.monotonic() - wall0
        return SimResult(self, st, wall_seconds=wall, terminated=terminated,
                         capture_seconds=capture_s)


def _copy_into(dst: dict, src: dict) -> None:
    """Copy every leaf of ``src`` (tensors or numpy arrays) into
    ``dst``'s tensor in place."""
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_into(dst[k], v)
        else:
            dst[k].copy_(torch.as_tensor(v))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


@dataclass
class SimResult:
    """A finished run: the final state (on the run's device) and the
    accessors the bench and the tests read."""

    executable: SimExecutable
    state: dict
    wall_seconds: float = 0.0
    # the run was stopped at a chunk boundary by the caller's
    # should_stop: the state is a valid prefix, not a finished run
    terminated: bool = False
    # the stepper's warm-up and capture before the clock started (on the
    # card; about 0 on the CPU), not in wall_seconds
    capture_seconds: float = 0.0

    @property
    def ticks(self) -> int:
        return int(self.state["tick"])

    @property
    def ticks_executed(self) -> int:
        """tick_fn iterations actually run: equals :attr:`ticks` under
        dense ticking; under event skip the gap is the jumped dead time."""
        return int(self.state.get("ticks_executed", self.state["tick"]))

    @property
    def skip_ratio(self) -> float:
        """ticks_executed / ticks simulated (1.0 = every tick executed)."""
        t = self.ticks
        return (self.ticks_executed / t) if t else 1.0

    @property
    def virtual_seconds(self) -> float:
        """Simulated seconds: ``ticks * quantum_ms / 1e3`` in Python
        floats, as the JAX package computes it."""
        return self.ticks * self.executable.config.quantum_ms / 1e3

    def statuses(self) -> np.ndarray:
        return _np(self.state["status"])

    def timed_out(self) -> bool:
        return bool((self.statuses() == RUNNING).any())

    def outcomes(self) -> dict[str, tuple[int, int]]:
        """Per-group (ok, total), the reference's grading unit."""
        ctx = self.executable.ctx
        st = self.statuses()
        return {
            g.id: (int(((st == DONE_OK) & (ctx.group_ids == g.index)).sum()),
                   g.instances)
            for g in ctx.groups
        }

    def counter(self, state_name: str, index: int = None) -> int:
        """Final value of a state counter (``index`` for a family state).
        Raises KeyError on unknown names."""
        states = self.executable.program.states
        if index is not None:
            fam = states._families.get(state_name)
            if fam is None:
                raise KeyError(f"unknown state family: {state_name!r}")
            base, size = fam
            if not 0 <= index < size:
                raise IndexError(
                    f"family {state_name!r} index {index} >= {size}")
            return int(self.state["counters"][base + index])
        sid = states.names().get(state_name)
        if sid is None:
            raise KeyError(f"unknown sync state: {state_name!r}")
        return int(self.state["counters"][sid])

    def metrics_dropped(self) -> int:
        return int(_np(self.state["metrics_dropped"]).sum())

    def stream_violations(self) -> int:
        """Stream-topic publishes past the first in their topic and tick
        (the single-publisher contract; only the first row is stored)."""
        return int(self.state["stream_violations"])

    def _net(self, key: str) -> int:
        if "net" not in self.state or key not in self.state["net"]:
            return 0
        return int(_np(self.state["net"][key]).sum())

    def net_dropped(self) -> int:
        """Messages dropped by inbox-ring overflow (0 in count mode, whose
        counters do not overflow)."""
        return self._net("inbox_dropped")

    def net_horizon_clamped(self) -> int:
        """Count-mode messages whose visibility lay past the delay wheel
        and were clamped into its last bucket."""
        return self._net("horizon_clamped")

    def net_send_compact_fallbacks(self) -> int:
        """Count-mode ticks with more data lanes than ``send_slots``."""
        return self._net("send_compact_fallback")

    def net_payload_sanitized(self) -> int:
        return self._net("payload_sanitized")

    def net_egress_deferred(self) -> int:
        return self._net("egress_deferred")

    def net_egress_abandoned(self) -> int:
        return self._net("egress_abandoned")

    def net_egress_overflow(self) -> int:
        return self._net("egress_overflow")

    def restarts_total(self) -> int:
        """Rejoins under the fault plane (0 without one)."""
        if "restarts" not in self.state:
            return 0
        return int(_np(self.state["restarts"]).sum())

    def replay_consumed(self) -> int:
        """Recorded arrivals consumed across all lanes (0 without a
        [replay] table)."""
        if "replay" not in self.state:
            return 0
        return int(_np(self.state["replay"]["cursor"]).sum())

    def replay_consumed_per_lane(self) -> np.ndarray:
        """Per-lane consumed-arrival counts (empty without a [replay]
        table)."""
        if "replay" not in self.state:
            return np.zeros(0, np.int32)
        return _np(self.state["replay"]["cursor"])

    def trace_events_total(self) -> int:
        """Recorded trace events across all lanes (0 untraced)."""
        if "trace" not in self.state:
            return 0
        return int(_np(self.state["trace"]["trace_cnt"]).sum())

    def trace_dropped_total(self) -> int:
        """Trace events lost to full per-lane rings."""
        if "trace" not in self.state:
            return 0
        return int(_np(self.state["trace"]["trace_dropped"]).sum())

    def telemetry_samples(self) -> int:
        """Sample boundaries recorded by the telemetry plane."""
        if "telem" not in self.state:
            return 0
        return int(self.state["telem"]["cnt"])

    def telemetry_clipped(self) -> int:
        """Sample boundaries lost to a full buffer."""
        if "telem" not in self.state:
            return 0
        return int(self.state["telem"]["clipped"])

    def telemetry_records(self) -> tuple[list[dict], list[dict]]:
        """The demuxed (lane_records, global_records) in the
        ``results.out`` format (sim/telemetry.py telemetry_records)."""
        if "telem" not in self.state:
            return [], []
        ex = self.executable
        return telemetrymod.telemetry_records(
            self.state, ex.telemetry, ex.ctx, ex.config.quantum_ms)

    def chrome_trace(self) -> dict:
        """The trace rings as Chrome trace-event JSON, the dict; empty
        events untraced."""
        return json.loads(self.chrome_trace_json())

    def chrome_trace_json(self, fault_plan=None) -> str:
        """The trace rings as the text of a ``trace.json`` (Chrome
        trace-event JSON); the fault windows' track from ``fault_plan``
        (a sweep scenario's own), else the executable's."""
        ex = self.executable
        if "trace" not in self.state:
            return '{"traceEvents": [], "displayTimeUnit": "ms"}'
        return tracemod.chrome_trace_json(
            self.state, ex.ctx, ex.config.quantum_ms,
            fault_plan=fault_plan if fault_plan is not None else ex.faults)

    def _metric_rows(self):
        """Every occupied metrics slot, instance by instance: parallel
        lists of the instance, its group's id, the metric's name, the
        virtual time in seconds and the value."""
        names = self.executable.program.metrics.names()
        ctx = self.executable.ctx
        group_of = {g.index: g.id for g in ctx.groups}
        buf = _np(self.state["metrics_buf"])
        cnt = _np(self.state["metrics_cnt"])
        q_ms = self.executable.config.quantum_ms
        occupied = np.arange(buf.shape[1])[None, :] < cnt[:, None]
        inst_idx, slot_idx = np.nonzero(occupied)
        mids = buf[inst_idx, slot_idx, 0].astype(np.int64)
        times = buf[inst_idx, slot_idx, 1].astype(np.float64) * q_ms / 1e3
        vals = buf[inst_idx, slot_idx, 2].astype(np.float64)
        groups = [group_of.get(int(g), "") for g in ctx.group_ids[inst_idx]]
        n_names = len(names)
        mnames = [names[m] if m < n_names else str(m) for m in mids.tolist()]
        return (inst_idx.tolist(), groups, mnames, times.tolist(),
                vals.tolist())

    def metrics_records(self) -> list[dict]:
        """Flatten per-instance metric buffers into records."""
        return [
            {"instance": i, "group": g, "name": m, "virtual_time_s": t,
             "value": v}
            for i, g, m, t, v in zip(*self._metric_rows())
        ]

    def metrics_lines(self) -> list[str]:
        """``metrics_records()`` as ``results.out`` lines: each record's
        ``json.dumps`` and a newline, formatted without a dict a record
        (a 10k-instance run or sweep scenario writes tens of thousands;
        the runner's demux)."""
        inst, groups, mnames, times, vals = self._metric_rows()
        js = {x: json.dumps(x) for x in set(groups) | set(mnames)}
        ff = _json_float
        return [
            f'{{"instance": {i}, "group": {js[g]}, "name": {js[m]}, '
            f'"virtual_time_s": {ff(t)}, "value": {ff(v)}}}\n'
            for i, g, m, t, v in zip(inst, groups, mnames, times, vals)
        ]


def _json_float(x: float) -> str:
    """A float as ``json.dumps`` writes it."""
    return float.__repr__(x) if math.isfinite(x) else json.dumps(x)


def compile_program(
    build_fn,
    ctx: BuildContext,
    config: Optional[SimConfig] = None,
    device="cuda",
    faults=None,
    trace=None,
    telemetry=None,
    replay=None,
) -> SimExecutable:
    """Build a plan's program and wrap it in an executable on ``device``.
    ``build_fn(builder)`` may return a dict of per-instance param arrays
    exposed to phases via ``env.params``. ``faults`` is a compiled
    sim.faults.FaultPlan, or a sim.tables.Faults / dict schedule,
    compiled here (an empty or disabled one is no plan); ``trace`` a
    sim.trace.TraceSpec or a Trace / dict table; ``telemetry`` a
    sim.telemetry.TelemetrySpec or a Telemetry / dict table, compiled by
    the executor; ``replay`` a sim.replay.ReplayPlan or a Replay / dict
    table, compiled here against the padded context. An absent or
    disabled table builds the plain program."""
    from .program import ProgramBuilder
    from .tables import Faults

    config = config or SimConfig()
    resolve_device(device)
    if isinstance(faults, dict):
        faults = Faults.from_dict(faults)
    if faults is not None and getattr(faults, "disabled", False):
        faults = None
    if faults is not None:
        if not isinstance(faults, faultsmod.FaultPlan):
            faults = faultsmod.compile_faults(faults, ctx, config)
        elif faults.kill_tick.shape[0] != ctx.padded_n:
            faults = faults.padded_to(ctx.padded_n)
    if trace is not None:
        if isinstance(trace, tracemod.TraceSpec):
            gm = trace.group_mask
            if gm is not None and len(gm) < ctx.padded_n:
                trace = dataclasses.replace(
                    trace,
                    group_mask=tuple(gm)
                    + (False,) * (ctx.padded_n - len(gm)),
                )
        else:
            trace = tracemod.compile_trace(trace, ctx)
    if replay is not None:
        if isinstance(replay, replaymod.ReplayPlan):
            if replay.arr_cnt.shape[0] != ctx.padded_n:
                replay = replay.padded_to(ctx.padded_n)
        else:
            replay = replaymod.compile_replay(replay, ctx, config)
    b = ProgramBuilder(ctx)
    params = build_fn(b) or {}
    program = b.build()
    return SimExecutable(
        program, ctx, config, device=device, params=params, faults=faults,
        trace=trace, telemetry=telemetry, replay=replay,
    )
