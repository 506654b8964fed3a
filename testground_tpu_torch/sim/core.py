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
back every ``chunk_ticks`` ticks, and a tick past the point where the
JAX loop would have stopped is an identity (every leaf is selected back
to its old value), so ``SimResult.ticks`` equals the JAX run's.

Under event skip (on by default unless ``pallas_front=True``) each
executed tick is followed by a jump of ``tick`` to the next event
(``next_event_tick``), as the JAX package's ``event_skip_loop`` does;
the jump is guarded like the tick. ``phase_gating`` runs the same
ungated step (the JAX package's gated step is bit-identical to it, and
its per-phase ``lax.cond`` would cost a host read per phase in eager
torch). Faults, trace, telemetry, replay and sweep raise
``NotImplementedError`` naming the ROADMAP.md module that ports them.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from . import net as netmod
from . import prng
from .context import BuildContext
from .deliver_front import eligible as front_eligible
from .program import (
    CRASHED,
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
    fused_observers: bool = True  # a no-op without observer planes
    slices: int = 1


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


def live_lanes(st: dict):
    """Lanes that keep the run alive: RUNNING instances (CRASHED lanes
    with a scheduled restart belong to the fault plane, not ported)."""
    return st["status"] == RUNNING


# "no scheduled event" sentinel of the event-horizon min (int32 max)
_EV_NEVER = 2**31 - 1

# state leaves that exist only on a skip-enabled executor (the JAX
# package's list)
EVENT_SKIP_STATE_LEAVES = ("ticks_executed", "staging_cnt", "wheel_occ")


def next_event_tick(out: dict, nt):
    """The event-horizon min: the earliest tick >= ``nt`` at which the
    post-tick state ``out`` can evolve (every tick before it is provably
    an identity), from the terms that exist without faults, replay or
    telemetry: RUNNING lanes wake at max(blocked_until, nt), pending
    kills land at max(kill_tick, nt), a queued egress send can leave on
    any tick, an occupied staging row drains at ``nt``, and the delay
    wheel's earliest occupied bucket drains at its tick. ``nt`` when no
    lane lives."""
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
    live_any = torch.any(live_lanes(out))
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
    counts = torch.cat([prev_counts, prev_counts.new_zeros(1)])
    counts.index_add_(0, safe, valid.to(prev_counts.dtype))
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
# net payload vector, "tpay" topic payload vector. Fields of planes the
# port does not run (filter rules, trace, telemetry, replay) must stay
# at their defaults; the build-time probe rejects a phase that sets them,
# naming the ROADMAP.md item that ports them.
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
)
_UNPORTED_FIELDS = (
    ("rule_row", None, 7), ("net_class", -1, 7), ("class_rule_row", None, 7),
    ("trace_code", -1, 9), ("trace_a0", 0, 9), ("trace_a1", 0, 9),
    ("observe_hist", -1, 9), ("observe_value", 0.0, 9), ("count_add", 0, 9),
    ("gauge_set", 0, 9), ("gauge_value", 0.0, 9), ("replay_consume", 0, 9),
)
_ITEM_TITLES = {7: "entry-mode data plane", 9: "observer planes"}


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
    return torch.where(go, new, old)


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
        for plane, val, module, title in (
            ("[faults]", faults, 8, "fault plane"),
            ("[trace]", trace, 9, "observer planes"),
            ("[telemetry]", telemetry, 9, "observer planes"),
            ("[replay]", replay, 9, "observer planes"),
        ):
            if val is not None:
                raise _not_ported(f"the {plane} plane", module, title)
        if config.slices > 1:
            raise _not_ported("SimConfig.slices > 1", 12, "multi-GPU")
        self.program = program
        self.ctx = ctx
        self.config = config
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
        if self.event_skip and spec is not None and not spec.store_entries:
            # the jump's min reads the staging / wheel occupancy counts
            self.program = program = dataclasses.replace(
                program,
                net_spec=dataclasses.replace(spec, track_occupancy=True),
            )
        self._tick_fn = None

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
        kill_tick = churn_kill_tick(cfg, ctx.group_ids)

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
        if self.event_skip:
            # executed tick_fn iterations (the gap to ``tick`` is the
            # dead time the event-horizon jump skipped)
            state["ticks_executed"] = z((), i32)
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
        PAY = prog.topics.payload_len
        topic_specs = prog.topics.specs()
        churn_sids, churn_tids = prog.churn_sids, prog.churn_tids
        quantum_ms = cfg.quantum_ms
        topic_caps = torch.zeros(T, dtype=torch.int32, device=dev)
        for tid, cap, _, _ in topic_specs:
            topic_caps[tid] = cap
        consts: dict = {}

        def const(v, dtype):
            key = (v, dtype)
            if key not in consts:
                consts[key] = torch.tensor(v, dtype=dtype, device=dev)
            return consts[key]

        def pack(kind, v):
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
            if kind in ("pay", "tpay"):
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
                params={k: torch.zeros((), dtype=v.dtype, device=cpu)
                        for k, v in params.items()},
                quantum_ms=quantum_ms,
            )
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
            try:
                mem2, ctrl = phase.fn(env, dict(mem))
            except Exception:  # noqa: BLE001 — best-effort, as in JAX
                return tuple(prog.mem_spec), tuple(range(len(_FIELDS))), {}
            _check_phase_net_ctrl(ctrl, net_spec, phase.name)
            for name, default, item in _UNPORTED_FIELDS:
                if not is_default("pay" if default is None else "i",
                                  getattr(ctrl, name), default):
                    raise _not_ported(
                        f"phase {phase.name!r} sets PhaseCtrl.{name}", item,
                        _ITEM_TITLES[item],
                    )
            wset = tuple(k for k in mem if mem2.get(k) is not mem[k])
            dyn = tuple(
                i for i, (name, kind, default) in enumerate(_FIELDS)
                if not is_default(kind, getattr(ctrl, name), default)
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
                              instance, group, ginst, prow, net_row, key):
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
                    params=prow,
                    inbox=net_row.get("inbox"),
                    inbox_r=net_row.get("inbox_r"),
                    inbox_avail=net_row.get("inbox_avail"),
                    inbox_head=net_row.get("inbox_head"),
                    inbox_bytes=net_row.get("bytes_in"),
                    hs=net_row.get("hs"),
                    egress_busy=net_row.get("egress_busy"),
                    eg_latency_ticks=net_row.get("eg_latency"),
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
                    )
                    for name in (
                        "send_tag", "send_port", "send_size", "send_payload",
                        "net_latency_ms", "net_jitter_ms", "net_bandwidth",
                        "net_loss", "net_corrupt", "net_reorder",
                        "net_duplicate", "net_loss_corr", "net_corrupt_corr",
                        "net_reorder_corr", "net_duplicate_corr",
                        "net_enabled",
                    ):
                        out[name] = ctrl[name]
                return out

            return torch.func.vmap(step_instance)

        def tick_fn(st: dict) -> dict:
            tick = st["tick"]
            key = prng.fold_in(base_key, tick)
            st = dict(st)
            # churn BEFORE the step: a victim must not act on its kill tick
            killed_now = (
                (st["status"] == RUNNING)
                & (st["kill_tick"] >= 0)
                & (tick >= st["kill_tick"])
            )
            st["status"] = torch.where(killed_now, CRASHED, st["status"])
            crashed = st["status"] == CRASHED
            crashed_total = torch.sum(crashed, dtype=torch.int32)
            # contributions the dead already made to churn-watched states
            # and topics: churn barriers add these back
            dead_signals = {
                sid: torch.sum(torch.where(crashed, st["churn_sig"][:, k], 0),
                               dtype=torch.int32)
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
                    netst = netmod.advance_wheel(netst, net_spec, tick)
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

            lane_keys = prng.fold_in(key, instance_ids)
            # the shared registers (counters, topics, head registers) are
            # closed over, not mapped: a phase's reduce of one runs once
            vstep = make_step(tick, st["counters"], st["topic_len"],
                              st["topic_bufs"], st["topic_head"],
                              crashed_total, dead_signals, dead_pubs)
            res = vstep(
                st["pc"], st["status"], st["blocked_until"], st["last_seq"],
                st["mem"], instance_ids, group_ids, group_instance, params,
                net_row, lane_keys,
            )

            sig, pub = res["signal"], res["publish"]
            new_counters, sig_seq, sig_valid = _ranked_scatter(
                sig, S, st["counters"]
            )
            new_topic_len, pub_seq, pub_valid = _ranked_scatter(
                pub, T, st["topic_len"]
            )
            pos0 = torch.where(pub_valid, pub_seq - 1, 0)  # 0-based slot
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
            status = res["status"]
            out = {
                "tick": tick + 1,
                "kill_tick": st["kill_tick"],
                "pc": res["pc"],
                "status": status,
                "blocked_until": res["blocked_until"],
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
                    corrupt_pct=res["net_corrupt"],
                    reorder_pct=res["net_reorder"],
                    duplicate_pct=res["net_duplicate"],
                    loss_corr_pct=res["net_loss_corr"],
                    corrupt_corr_pct=res["net_corrupt_corr"],
                    reorder_corr_pct=res["net_reorder_corr"],
                    duplicate_corr_pct=res["net_duplicate_corr"],
                )
                nst = netmod.deliver(
                    nst, net_spec, tick, prng.fold_in(key, 7),
                    res["send_dest"], res["send_tag"], res["send_port"],
                    res["send_size"], res["send_payload"],
                    status == RUNNING, hs_clear=res["hs_clear"],
                )
                nst = netmod.consume(nst, net_spec, tick, res["recv_count"],
                                     prefix=avail0)
                out["net"] = nst
            return out

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
        nxt = next_event_tick(out, out["tick"])
        out["tick"] = torch.clamp(nxt, max=self.config.max_ticks)
        return out

    def guarded_tick(self, st: dict) -> dict:
        """One iteration of the loop (``skip_step`` under event skip,
        ``tick_fn`` otherwise) where the JAX loop's condition (tick <
        max_ticks and a lane still running) holds, an identity on every
        leaf (the jump and ``ticks_executed`` included) where it does
        not. No host read."""
        go = (st["tick"] < self.config.max_ticks) & torch.any(live_lanes(st))
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
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(STEPPER_WARMUP):
                self.guarded_tick(st)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        ins = list(_leaves(st))
        with torch.cuda.graph(graph):
            out = self.guarded_tick(st)
            for dst, src in zip(ins, _leaves(out)):
                dst.copy_(src)

        def replay(state):
            assert state is st, "a captured stepper advances its own state"
            graph.replay()
            return state

        replay.graph = graph  # the graph lives as long as the stepper
        return replay

    def run(self) -> "SimResult":
        """Run the dense loop to completion: ``chunk_ticks`` loop
        iterations (``stepper``) between two host reads of the
        termination condition."""
        cfg = self.config
        self.tick_fn()  # built before the clock starts
        st = self.init_state()
        wall0 = time.monotonic()
        step = self.stepper(st)
        while True:
            for _ in range(max(1, cfg.chunk_ticks)):
                st = step(st)
            tick = int(st["tick"])
            running = int(torch.sum(live_lanes(st)))
            if running == 0 or tick >= cfg.max_ticks:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.monotonic() - wall0
        return SimResult(self, st, wall_seconds=wall)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


@dataclass
class SimResult:
    """A finished run: the final state (on the run's device) and the
    accessors the bench and the tests read."""

    executable: SimExecutable
    state: dict
    wall_seconds: float = 0.0

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

    def metrics_records(self) -> list[dict]:
        """Flatten per-instance metric buffers into records."""
        names = self.executable.program.metrics.names()
        ctx = self.executable.ctx
        group_of = {g.index: g.id for g in ctx.groups}
        buf = _np(self.state["metrics_buf"])
        cnt = _np(self.state["metrics_cnt"])
        q_ms = self.executable.config.quantum_ms
        cap = buf.shape[1]
        occupied = np.arange(cap)[None, :] < cnt[:, None]
        inst_idx, slot_idx = np.nonzero(occupied)
        mids = buf[inst_idx, slot_idx, 0].astype(np.int64)
        ticks = buf[inst_idx, slot_idx, 1]
        vals = buf[inst_idx, slot_idx, 2]
        groups = [group_of.get(int(g), "") for g in ctx.group_ids[inst_idx]]
        times = ticks.astype(np.float64) * q_ms / 1e3
        n_names = len(names)
        return [
            {
                "instance": int(i),
                "group": grp,
                "name": names[m] if m < n_names else str(m),
                "virtual_time_s": float(t),
                "value": float(v),
            }
            for i, grp, m, t, v in zip(inst_idx, groups, mids, times, vals)
        ]


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
    exposed to phases via ``env.params``."""
    from .program import ProgramBuilder

    config = config or SimConfig()
    resolve_device(device)
    b = ProgramBuilder(ctx)
    params = build_fn(b) or {}
    program = b.build()
    return SimExecutable(
        program, ctx, config, device=device, params=params, faults=faults,
        trace=trace, telemetry=telemetry, replay=replay,
    )
