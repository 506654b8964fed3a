"""Phase-machine programs: the plan representation, in torch.

Counterpart of ``testground_tpu/sim/program.py``. A sim plan is a
PROGRAM, an ordered list of phases. Every instance holds a program
counter; each virtual-time tick the instance's current phase runs and
decides: update plan memory, emit at most one sync action, record a
metric, sleep, advance, send one message, or finish with a status.

Phase functions are written PER INSTANCE (every ``TickEnv`` field is one
lane's value) and the core batches them over the instance axis with
``torch.func.vmap``, as the JAX package batches them with ``jax.vmap``.
Inside a phase, make tensors from the env's own tensors (``*_like``,
``new_*``) so they land on the run's device.

This package ports the builder methods the dht, gossipsub and
benchmarks plans use, and ``end_fail``, ``end_crash`` and
``send_message``; the others raise ``NotImplementedError`` naming the
ROADMAP.md module that will port them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

# instance statuses
RUNNING = 0
DONE_OK = 1
DONE_FAIL = 2
CRASHED = 3
PAD = 4  # padding row (instance axis padded to a multiple)

# message tags (sim/net.py data plane)
TAG_DATA = 0
TAG_SYN = 1
TAG_ACK = 2
TAG_RST = 3


def _not_ported(what: str, module: int, title: str):
    return NotImplementedError(
        f"{what} is not ported to testground_tpu_torch yet "
        f"(ROADMAP.md, modules still to port, item {module}: {title})"
    )


def ticks_to_secs(ticks, quantum_ms: float):
    """``ticks * quantum_ms / 1e3`` (``ticks`` int32) as XLA lowers it:
    the division by the constant becomes a multiplication by its float32
    reciprocal (sim/net.py ``recip``), and the two constant factors fold
    into one float32 product, so it is ``f32(ticks) * f32(quantum_ms *
    (1/1e3))``, not ``(f32(ticks) * quantum_ms) * (1/1e3)``."""
    from .net import recip

    c = np.float32(quantum_ms) * np.float32(recip(1e3))
    return ticks.to(torch.float32) * float(c)


def onehot_get(vec, idx):
    """vec[idx] for a SMALL per-instance vector and a per-lane scalar
    index, as a dense one-hot reduction (the JAX package's lowering)."""
    k = vec.shape[-1]
    ar = torch.arange(k, device=vec.device)
    return torch.sum(torch.where(ar == idx, vec, torch.zeros_like(vec)), dim=-1)


def onehot_set(vec, idx, val):
    """vec.at[idx].set(val) for a SMALL per-instance vector and a per-lane
    scalar index, as a dense one-hot select."""
    k = vec.shape[-1]
    ar = torch.arange(k, device=vec.device)
    return torch.where(ar == idx, val, vec)


@dataclass
class PhaseCtrl:
    """Per-instance result of evaluating one phase for one tick.

    All fields are per-lane scalars; defaults mean "stay on this phase,
    do nothing". Field for field the JAX package's PhaseCtrl."""

    advance: Any = 0  # 1 → pc+1
    jump: Any = -1  # >= 0 → absolute pc (wins over advance)
    signal: Any = -1  # state id to signal_entry
    publish_topic: Any = -1
    publish_payload: Any = None
    status: Any = 0  # 0 keep running; DONE_OK/DONE_FAIL/CRASHED
    sleep: Any = 0  # ticks to sleep after this tick
    metric_id: Any = -1
    metric_value: Any = 0.0
    # ---- data plane ----
    send_dest: Any = -1
    send_tag: Any = 0
    send_port: Any = 0
    send_size: Any = 0.0
    send_payload: Any = None
    recv_count: Any = 0
    hs_clear: Any = 0
    # ---- ConfigureNetwork writes (LinkShape row updates) ----
    net_set: Any = 0
    net_latency_ms: Any = 0.0
    net_jitter_ms: Any = 0.0
    net_bandwidth: Any = 0.0
    net_loss: Any = 0.0
    net_corrupt: Any = 0.0
    net_reorder: Any = 0.0
    net_duplicate: Any = 0.0
    net_loss_corr: Any = 0.0
    net_corrupt_corr: Any = 0.0
    net_reorder_corr: Any = 0.0
    net_duplicate_corr: Any = 0.0
    net_enabled: Any = 1
    rule_row: Any = None
    net_class: Any = -1
    class_rule_row: Any = None
    # ---- observer planes (not ported; must stay at their defaults) ----
    trace_code: Any = -1
    trace_a0: Any = 0
    trace_a1: Any = 0
    observe_hist: Any = -1
    observe_value: Any = 0.0
    count_add: Any = 0
    gauge_set: Any = 0
    gauge_value: Any = 0.0
    replay_consume: Any = 0


@dataclass
class Phase:
    name: str
    fn: Callable  # (TickEnv, mem: dict) -> (mem, PhaseCtrl)


@dataclass
class TickEnv:
    """What a phase fn sees (per-instance scalars unless noted)."""

    tick: Any  # i32 — current virtual tick (shared)
    instance: Any  # i32 — global instance id
    group: Any  # i32 — group index (-1 padding)
    group_instance: Any  # i32 — index within the group
    last_seq: Any  # i32 — seq from this instance's most recent signal
    rng: Any  # per-instance PRNG key for this tick (sim/prng.py)
    counters: Any  # [S] i32 (shared) — state counters, previous tick
    topic_len: Any  # [T] i32 (shared)
    topic_buf: Any  # {tid: [cap_t, pay_t] f32} (shared)
    params: dict  # name -> per-instance scalar
    topic_head: Any = None
    crashed_total: Any = None  # i32 (shared): instances CRASHED so far
    # {sid: i32} (shared): signals to churn-watched states already made
    # by now-CRASHED instances; churn barriers add them back
    dead_signals: Any = None
    # {tid: i32} (shared): the same, for publishes to churn-watched topics
    dead_pubs: Any = None
    # ---- data plane views (None when the program doesn't use the net)
    inbox: Any = None  # [Q, width] this instance's inbox ring
    inbox_r: Any = None  # i32 read cursor
    inbox_avail: Any = None  # i32 visible FIFO prefix length
    inbox_head: Any = None  # [K, width] FIFO head rows 0..K-1
    inbox_bytes: Any = None  # f32 data bytes delivered to me (count mode)
    hs: Any = None  # [4] my handshake register (dialing programs)
    egress_busy: Any = None  # bool: my egress queue holds a deferred send
    eg_latency_ticks: Any = None  # f32 my current egress latency
    quantum_ms: float = 1.0  # ms per tick

    # -------- helpers usable inside phase fns --------

    def barrier_done(self, state_id, target):
        return self.counters[state_id] >= target

    def family_counter(self, base: int, size: int, idx):
        return onehot_get(self.counters[base:base + size], idx)

    def egress_ready(self):
        """True when my egress queue can accept a send this tick; always
        True when no queue is configured."""
        if self.egress_busy is None:
            return torch.ones_like(self.tick, dtype=torch.bool)
        return ~self.egress_busy

    def topic_count(self, topic_id):
        return self.topic_len[topic_id]

    def read_topic(self, topic_id, pos):
        """Payload vector at position ``pos`` of a topic (``topic_id`` is
        the static int from topics.topic())."""
        return self.topic_buf[topic_id][pos]

    def ms(self, ticks):
        return ticks * self.quantum_ms

    def ticks_for_ms(self, ms):
        if isinstance(ms, torch.Tensor):
            from .net import recip

            q = (ms * recip(self.quantum_ms)).to(torch.int32)
            return torch.clamp(q, min=1)
        return max(1, int(ms / self.quantum_ms))

    def inbox_entry(self, k):
        """The k-th visible inbox record ([width] f32); valid iff
        ``k < inbox_avail``. Rows 0..head_k-1 come from the per-tick head
        cache; deeper static reads come from the ring."""
        if self.inbox is None:
            raise RuntimeError(
                "inbox_entry() needs entry records; this program enabled "
                "the count-only inbox (enable_net(count_only=True)) which "
                "tracks only arrival counts and byte totals"
            )
        if not isinstance(k, int):
            raise _not_ported("inbox_entry() with a traced index", 9,
                              "observer planes (the election plan)")
        cap = self.inbox.shape[0]
        if self.inbox_head is not None and k < self.inbox_head.shape[0]:
            return self.inbox_head[k]
        pos = torch.remainder(self.inbox_r + k, cap)
        oh = torch.arange(cap, device=self.inbox.device) == pos
        return torch.sum(
            torch.where(oh[:, None], self.inbox, torch.zeros_like(self.inbox)),
            dim=0,
        )


class StateRegistry:
    """Assigns dense ids to sync states at build time."""

    def __init__(self) -> None:
        self._ids: dict[str, int] = {}
        self._families: dict[str, tuple[int, int]] = {}
        self._next = 0

    def state(self, name: str) -> int:
        if name not in self._ids:
            self._ids[name] = self._next
            self._next += 1
        return self._ids[name]

    def family(self, name: str, size: int) -> int:
        if name in self._families:
            base, sz = self._families[name]
            if sz != size:
                raise ValueError(f"state family {name} redeclared with size {size} != {sz}")
            return base
        base = self._next
        self._next += size
        self._families[name] = (base, size)
        return base

    @property
    def count(self) -> int:
        return max(1, self._next)

    def names(self) -> dict[str, int]:
        return dict(self._ids)


class TopicRegistry:
    """Topics get ragged buffers ([cap, pay] each). ``stream=True``
    declares a single-publisher topic (at most one publisher a tick): its
    append is a one-row push that also fills the topic's head register."""

    def __init__(self) -> None:
        self._topics: dict[str, tuple[int, int, int, bool]] = {}
        self._next = 0

    def topic(self, name: str, capacity: int, payload_len: int = 1,
              stream: bool = False) -> int:
        if name not in self._topics:
            self._topics[name] = (self._next, capacity, payload_len, stream)
            self._next += 1
        return self._topics[name][0]

    def specs(self) -> list[tuple[int, int, int, bool]]:
        """[(id, cap, pay, stream)] sorted by id."""
        return sorted(self._topics.values())

    def by_name(self) -> dict[str, tuple[int, int, int, bool]]:
        """name -> (id, cap, pay, stream)."""
        return dict(self._topics)

    @property
    def count(self) -> int:
        return max(1, self._next)

    @property
    def payload_len(self) -> int:
        """The publish payload width: the widest topic's."""
        return max([1] + [p for _, _, p, _ in self._topics.values()])


class MetricRegistry:
    def __init__(self) -> None:
        self._ids: dict[str, int] = {}

    def metric(self, name: str) -> int:
        if name not in self._ids:
            self._ids[name] = len(self._ids)
        return self._ids[name]

    def names(self) -> list[str]:
        return [k for k, _ in sorted(self._ids.items(), key=lambda kv: kv[1])]

    @property
    def count(self) -> int:
        return max(1, len(self._ids))


@dataclass
class Program:
    phases: list[Phase]
    states: StateRegistry
    topics: TopicRegistry
    metrics: MetricRegistry
    mem_spec: dict[str, tuple[tuple, Any, Any]]  # name -> (shape, dtype, init)
    net_spec: Any = None  # net.NetSpec when the program uses the data plane
    # state / topic ids watched by churn-tolerant barriers: the core keeps
    # per-instance signal / publish counts for exactly these
    churn_sids: tuple = ()
    churn_tids: tuple = ()


@dataclass
class LoopHandle:
    slot: str  # mem slot holding the loop counter
    start_pc: int
    count: Any = 0  # iteration bound (set by loop_begin, used by loop_end)

    def index(self, mem) -> Any:
        """Current loop iteration (for state-family indexing)."""
        return mem[self.slot]


def _dead(table, key):
    """Dead-contribution compensation for a churn-watched state/topic (0
    when the env carries no tracking)."""
    if table is None:
        return 0
    return table.get(key, 0)


def _no_churn_family(churn_weight, family_size, index_fn) -> None:
    if churn_weight and (family_size or index_fn is not None):
        raise ValueError(
            "churn_weight is unsupported on family/indexed barriers: "
            "env.crashed_total is GLOBAL, so one family's crashes "
            "would over-release every other family's barrier"
        )


class ProgramBuilder:
    """Combinator DSL that lowers to phases (the subset the port runs)."""

    def __init__(self, ctx) -> None:
        self.ctx = ctx
        self.states = StateRegistry()
        self.topics = TopicRegistry()
        self.metrics = MetricRegistry()
        self._phases: list[Phase] = []
        self._mem: dict[str, tuple[tuple, Any, Any]] = {}
        self._auto = 0
        self._net_spec = None  # net.NetSpec once the data plane is enabled
        self._churn_sids: list[int] = []  # states watched by churn barriers
        self._churn_tids: list[int] = []  # topics watched by churn waits
        self._churn_weights_s: dict[int, int] = {}  # sid -> last weight
        self._churn_weights_t: dict[int, int] = {}  # tid -> last weight

    # ------------------------------------------------------------- memory

    def declare(self, name: str, shape=(), dtype=torch.int32, init=0) -> str:
        """Declare a per-instance memory slot (shape is per instance)."""
        self._mem[name] = (tuple(shape), dtype, init)
        return name

    def _watch_churn_state(self, sid: int, weight: int) -> None:
        self._check_cumulative_weight(self._churn_weights_s, sid, weight,
                                      "state")
        if sid not in self._churn_sids:
            self._churn_sids.append(sid)

    def _watch_churn_topic(self, tid: int, weight: int) -> None:
        self._check_cumulative_weight(self._churn_weights_t, tid, weight,
                                      "topic")
        if tid not in self._churn_tids:
            self._churn_tids.append(tid)

    def _check_cumulative_weight(self, seen: dict, key, weight, kind) -> None:
        """Repeated churn barriers on one state/topic must use CUMULATIVE
        weights (counters never reset and the dead compensation is for the
        whole run); a per-round weight would deadlock survivors."""
        prev = seen.get(key)
        if prev is not None and weight <= prev:
            raise ValueError(
                f"repeated churn-tolerant barrier on the same {kind} needs "
                f"a strictly larger CUMULATIVE churn_weight (got {weight} "
                f"after {prev}): targets and weights must both accumulate "
                "across rounds — see ProgramBuilder.barrier"
            )
        seen[key] = weight

    def _auto_slot(self, kind: str, dtype=torch.int32, init=0, shape=()) -> str:
        self._auto += 1
        name = f"_{kind}{self._auto}"
        self._mem[name] = (tuple(shape), dtype, init)
        return name

    # ------------------------------------------------------------ phases

    def phase(self, fn: Callable, name: str = "") -> int:
        """Add a custom phase: fn(env, mem) -> (mem, PhaseCtrl)."""
        pc = len(self._phases)
        self._phases.append(Phase(name or f"phase{pc}", fn))
        return pc

    def log(self, message: str) -> None:
        """A static plan message: a phase that only advances (the JAX
        package keeps the strings; nothing in the port reads them)."""

        def fn(env, mem):
            return mem, PhaseCtrl(advance=1)

        self.phase(fn, name=f"log:{message[:24]}")

    def sleep_ms(self, ms) -> None:
        def fn(env, mem):
            return mem, PhaseCtrl(advance=1, sleep=env.ticks_for_ms(ms))

        self.phase(fn, name=f"sleep:{ms}ms")

    def signal(self, state: str, family_size: int = 0, index_fn=None) -> None:
        """signal_entry then advance (non-blocking); seq lands in
        env.last_seq next tick."""
        if index_fn is not None and not family_size:
            raise ValueError(
                "index_fn requires family_size: without a family block "
                "sid + idx would signal into an unrelated state's counter"
            )
        sid = (
            self.states.family(state, family_size)
            if family_size
            else self.states.state(state)
        )

        def fn(env, mem):
            idx = index_fn(env, mem) if index_fn is not None else 0
            return mem, PhaseCtrl(advance=1, signal=sid + idx)

        self.phase(fn, name=f"signal:{state}")

    def barrier(self, state: str, target, family_size: int = 0,
                index_fn=None, churn_weight: int = 0) -> None:
        """Wait until the state counter reaches target. ``churn_weight`` >
        0 makes the barrier churn-tolerant: the target shrinks by weight x
        instances crashed so far, and the signals the dead already made
        are added back (env.dead_signals). Repeated churn barriers on one
        state take cumulative targets and weights."""
        _no_churn_family(churn_weight, family_size, index_fn)
        if index_fn is not None and not family_size:
            raise ValueError(
                "index_fn requires family_size: without a family block the "
                "indexed counter read has no bounds and would be silently "
                "ignored"
            )
        sid = (
            self.states.family(state, family_size)
            if family_size
            else self.states.state(state)
        )
        if churn_weight:
            self._watch_churn_state(sid, churn_weight)

        def fn(env, mem):
            tgt = target
            if churn_weight:
                tgt = tgt - churn_weight * env.crashed_total + _dead(
                    env.dead_signals, sid
                )
            if family_size:
                idx = index_fn(env, mem) if index_fn is not None else 0
                done = env.family_counter(sid, family_size, idx) >= tgt
            else:
                done = env.barrier_done(sid, tgt)
            return mem, PhaseCtrl(advance=done.to(torch.int32))

        self.phase(fn, name=f"barrier:{state}")

    def signal_and_wait(self, state: str, target=None, family_size: int = 0,
                        index_fn=None, save_seq: Optional[str] = None,
                        churn_weight: int = 0) -> None:
        """MustSignalAndWait: one phase that signals once, then polls the
        barrier. ``target=None`` → all (non-padding) instances.
        ``churn_weight`` as in :meth:`barrier`."""
        _no_churn_family(churn_weight, family_size, index_fn)
        if index_fn is not None and not family_size:
            raise ValueError(
                "index_fn requires family_size: without a family block the "
                "indexed counter read has no bounds and would be silently "
                "ignored"
            )
        sid = (
            self.states.family(state, family_size)
            if family_size
            else self.states.state(state)
        )
        tgt = self.ctx.n_instances if target is None else target
        flag = self._auto_slot("saw_flag")
        if churn_weight:
            self._watch_churn_state(sid, churn_weight)

        def fn(env, mem):
            idx = index_fn(env, mem) if index_fn is not None else 0
            signaled = mem[flag] > 0
            do_signal = torch.where(
                signaled, -1, torch.full_like(mem[flag], sid) + idx
            )
            t = tgt
            if churn_weight:
                t = t - churn_weight * env.crashed_total + _dead(
                    env.dead_signals, sid
                )
            if family_size:
                reached = env.family_counter(sid, family_size, idx) >= t
            else:
                reached = env.barrier_done(sid, t)
            done = signaled & reached
            mem = dict(mem)
            if save_seq is not None:
                mem[save_seq] = torch.where(
                    signaled & (mem[flag] == 1), env.last_seq, mem[save_seq]
                )
            mem[flag] = torch.where(
                done, 0, torch.clamp(mem[flag] + 1, max=2)
            )  # 0→1 signalled; 2 = seq latched; reset on advance
            return mem, PhaseCtrl(advance=done.to(torch.int32),
                                  signal=do_signal)

        if save_seq is not None and save_seq not in self._mem:
            self.declare(save_seq, (), torch.int32, 0)
        self.phase(fn, name=f"signal_and_wait:{state}")

    def publish(self, topic: str, capacity: int, payload_fn,
                payload_len: int = 1, save_seq: Optional[str] = None,
                stream: bool = False) -> None:
        """Publish once and advance. payload_fn(env, mem) -> [payload_len]
        f32 (or a scalar)."""
        tid = self.topics.topic(topic, capacity, payload_len, stream=stream)
        flag = self._auto_slot("pub_flag")
        if save_seq is not None and save_seq not in self._mem:
            self.declare(save_seq, (), torch.int32, 0)

        def fn(env, mem):
            published = mem[flag] > 0
            mem = dict(mem)
            if save_seq is not None:
                # seq is available the tick after publishing
                mem[save_seq] = torch.where(
                    published & (mem[flag] == 1), env.last_seq,
                    mem[save_seq],
                )
            width = self.topics.payload_len
            p = torch.as_tensor(payload_fn(env, mem)).to(
                torch.float32).reshape(-1)
            payload = torch.cat([p, p.new_zeros(width - p.shape[0])])
            mem[flag] = torch.where(published, 0, mem[flag] + 1)
            return mem, PhaseCtrl(
                advance=published.to(torch.int32),
                publish_topic=torch.where(
                    published, -1, torch.full_like(mem[flag], tid)),
                publish_payload=payload,
            )

        self.phase(fn, name=f"publish:{topic}")

    def wait_topic(self, topic: str, capacity: int, count,
                   payload_len: int = 1, churn_weight: int = 0) -> None:
        """Block until a topic holds ``count`` entries. ``churn_weight``
        as in :meth:`barrier`."""
        tid = self.topics.topic(topic, capacity, payload_len)
        if churn_weight:
            self._watch_churn_topic(tid, churn_weight)

        def fn(env, mem):
            c = count
            if churn_weight:
                c = c - churn_weight * env.crashed_total + _dead(
                    env.dead_pubs, tid
                )
            return mem, PhaseCtrl(
                advance=(env.topic_count(tid) >= c).to(torch.int32))

        self.phase(fn, name=f"wait_topic:{topic}")

    # -------------------------------------------------------------- loops

    def loop_begin(self, count) -> LoopHandle:
        slot = self._auto_slot("loop")

        def fn(env, mem):
            return mem, PhaseCtrl(advance=1)

        start_pc = self.phase(fn, name="loop_begin")
        return LoopHandle(slot=slot, start_pc=start_pc, count=count)

    def loop_end(self, handle: LoopHandle) -> None:
        def fn(env, mem):
            mem = dict(mem)
            nxt = mem[handle.slot] + 1
            again = nxt < handle.count
            mem[handle.slot] = torch.where(again, nxt, 0)
            return mem, PhaseCtrl(
                advance=(~again).to(torch.int32),
                jump=torch.where(again, handle.start_pc + 1, -1),
            )

        self.phase(fn, name="loop_end")

    # ------------------------------------------------------------ metrics

    def mark_tick(self, slot: str) -> None:
        """Store the current tick in a mem slot (t0 for elapsed timers)."""
        if slot not in self._mem:
            self.declare(slot, (), torch.int32, 0)

        def fn(env, mem):
            return {**mem, slot: env.tick}, PhaseCtrl(advance=1)

        self.phase(fn, name=f"mark:{slot}")

    def elapsed_point(self, metric: str, slot: str) -> None:
        """Record seconds of virtual time since ``mark_tick(slot)``."""
        self.record_point(
            metric,
            lambda env, mem: ticks_to_secs(env.tick - mem[slot],
                                           env.quantum_ms),
        )

    def record_point(self, metric: str, value_fn) -> None:
        mid = self.metrics.metric(metric)

        def fn(env, mem):
            v = value_fn(env, mem)
            v = (v.to(torch.float32) if isinstance(v, torch.Tensor)
                 else float(v))
            return mem, PhaseCtrl(advance=1, metric_id=mid, metric_value=v)

        self.phase(fn, name=f"record:{metric}")

    # -------------------------------------------------------------- ends

    def end_ok(self) -> None:
        def fn(env, mem):
            return mem, PhaseCtrl(status=DONE_OK)

        self.phase(fn, name="end_ok")

    def end_fail(self) -> None:
        def fn(env, mem):
            return mem, PhaseCtrl(status=DONE_FAIL)

        self.phase(fn, name="end_fail")

    def end_crash(self) -> None:
        def fn(env, mem):
            return mem, PhaseCtrl(status=CRASHED)

        self.phase(fn, name="end_crash")

    def fail_if(self, cond_fn, message: str = "") -> None:
        """Fail instances where cond_fn(env, mem) is True; others advance."""

        def fn(env, mem):
            bad = cond_fn(env, mem)
            return mem, PhaseCtrl(
                advance=(~bad).to(torch.int32),
                status=torch.where(bad, DONE_FAIL, 0),
            )

        self.phase(fn, name=f"fail_if:{message[:24]}")

    # ---------------------------------------------------------- data plane

    def enable_net(
        self, inbox_capacity=None, payload_len=None, pair_rules: bool = False,
        count_only: bool = None, horizon: int = None,
        class_rules: bool = False, n_classes: int = None,
        uses_latency: bool = None, uses_jitter: bool = None,
        uses_rate: bool = None, uses_loss: bool = None,
        uses_corrupt: bool = None, uses_reorder: bool = None,
        uses_duplicate: bool = None,
        uses_loss_corr: bool = None, uses_corrupt_corr: bool = None,
        uses_reorder_corr: bool = None, uses_duplicate_corr: bool = None,
        uses_dials: bool = None,
        head_k: int = None, send_slots: int = None,
        arrival_slots: int = None, a2a_slots: int = None,
    ):
        """Turn on the network data plane. Implicit calls pass None ("no
        opinion") so they never override an explicit plan choice;
        shaping capabilities start False and are proven by
        configure_network. The executor rejects the feature sets this
        slice does not run."""
        from .net import NetSpec

        if self._net_spec is None:
            self._net_spec = NetSpec(
                uses_latency=False,
                uses_jitter=False,
                uses_rate=False,
                uses_loss=False,
            )
        s = self._net_spec
        if inbox_capacity is not None:
            s.inbox_capacity = inbox_capacity
        if payload_len is not None:
            s.payload_len = payload_len
        s.use_pair_rules = s.use_pair_rules or pair_rules
        s.use_class_rules = s.use_class_rules or class_rules
        if n_classes is not None:
            s.n_classes = n_classes
        if count_only is not None:
            s.store_entries = not count_only
        if horizon is not None:
            s.horizon = horizon
        if head_k is not None:
            s.head_k = head_k
        if send_slots is not None:
            s.send_slots = send_slots
        if arrival_slots is not None:
            s.arrival_slots = arrival_slots
        if a2a_slots is not None:
            s.a2a_slots = a2a_slots
        for name, val in (
            ("uses_latency", uses_latency), ("uses_jitter", uses_jitter),
            ("uses_rate", uses_rate), ("uses_loss", uses_loss),
            ("uses_corrupt", uses_corrupt), ("uses_reorder", uses_reorder),
            ("uses_duplicate", uses_duplicate),
            ("uses_loss_corr", uses_loss_corr),
            ("uses_corrupt_corr", uses_corrupt_corr),
            ("uses_reorder_corr", uses_reorder_corr),
            ("uses_duplicate_corr", uses_duplicate_corr),
            ("uses_dials", uses_dials),
        ):
            if val is False:
                raise ValueError(
                    f"enable_net({name}=False): capabilities are monotonic "
                    "— they can be declared (True) but never revoked; "
                    "omit the argument instead"
                )
            if val:
                setattr(s, name, True)
        return self._net_spec

    def wait_network_initialized(self, churn_weight: int = 0) -> None:
        """MustWaitNetworkInitialized: the global 'network-initialized'
        barrier across all instances."""
        self.enable_net()
        self.signal_and_wait("network-initialized", churn_weight=churn_weight)

    def configure_network(
        self,
        latency_ms=0.0,
        jitter_ms=0.0,
        bandwidth=0.0,
        loss=0.0,
        loss_corr=0.0,
        corrupt=0.0,
        corrupt_corr=0.0,
        reorder=0.0,
        reorder_corr=0.0,
        duplicate=0.0,
        duplicate_corr=0.0,
        enabled=1,
        rules_fn=None,
        class_rules_fn=None,
        callback_state: str = "",
        callback_target=None,
        churn_weight: int = 0,
    ) -> None:
        """(Must)ConfigureNetwork: write my egress LinkShape row, then
        signal the callback state and wait for callback_target instances
        to have done the same. Scalar args may be numbers or
        fns(env, mem) -> value."""
        if rules_fn is not None or class_rules_fn is not None:
            raise _not_ported("configure_network filter rules", 7,
                              "entry-mode data plane")
        spec = self.enable_net()
        spec.uses_latency |= callable(latency_ms) or bool(latency_ms)
        spec.uses_jitter |= callable(jitter_ms) or bool(jitter_ms)
        spec.uses_rate |= callable(bandwidth) or bool(bandwidth)
        spec.uses_loss |= callable(loss) or bool(loss)
        spec.uses_corrupt |= callable(corrupt) or bool(corrupt)
        spec.uses_reorder |= callable(reorder) or bool(reorder)
        spec.uses_duplicate |= callable(duplicate) or bool(duplicate)
        spec.uses_loss_corr |= callable(loss_corr) or bool(loss_corr)
        spec.uses_corrupt_corr |= callable(corrupt_corr) or bool(corrupt_corr)
        spec.uses_reorder_corr |= callable(reorder_corr) or bool(reorder_corr)
        spec.uses_duplicate_corr |= (
            callable(duplicate_corr) or bool(duplicate_corr)
        )
        if not callback_state:
            raise ValueError("configure_network requires a callback_state")

        def fn(env, mem):
            # static scalars stay PYTHON values (the core's static-default
            # probe reads them); callables get cast per lane
            def num(v):
                if not callable(v):
                    return float(v)
                return torch.as_tensor(v(env, mem)).to(torch.float32)

            en = (torch.as_tensor(enabled(env, mem)).to(torch.int32)
                  if callable(enabled) else int(enabled))
            return mem, PhaseCtrl(
                advance=1,
                net_set=1,
                net_latency_ms=num(latency_ms),
                net_jitter_ms=num(jitter_ms),
                net_bandwidth=num(bandwidth),
                net_loss=num(loss),
                net_corrupt=num(corrupt),
                net_reorder=num(reorder),
                net_duplicate=num(duplicate),
                net_loss_corr=num(loss_corr),
                net_corrupt_corr=num(corrupt_corr),
                net_reorder_corr=num(reorder_corr),
                net_duplicate_corr=num(duplicate_corr),
                net_enabled=en,
            )

        self.phase(fn, name=f"configure_network:{callback_state}")
        self.signal(callback_state)
        self.barrier(
            callback_state,
            self.ctx.n_instances if callback_target is None else callback_target,
            churn_weight=churn_weight,
        )

    def dial(self, dest_fn, port: int, result_slot: str,
             timeout_ms: float = 30_000.0,
             elapsed_slot: Optional[str] = None, retries: int = 0) -> None:
        """TCP-dial analog: send a SYN, wait for the ACK (success, about
        one RTT), an RST (refused) or the timeout. Writes ``result_slot``:
        1 ok, -1 refused, -2 gave up after every attempt.

        ``retries`` re-sends the SYN after each per-attempt ``timeout_ms``
        up to that many extra times (an RST is not retried);
        ``elapsed_slot`` spans all attempts. The first SYN and every
        retransmit wait for ``env.egress_ready()``; the attempt clock
        starts at phase entry. The reply lands in the handshake register
        (``env.hs``), which is cleared at phase entry (``hs_clear``), so a
        stale reply from an earlier dial is unreadable."""
        from .net import HS_PORT, HS_SRC, HS_TAG, HS_VIS

        self.enable_net()
        if result_slot not in self._mem:
            self.declare(result_slot, (), torch.int32, 0)
        if elapsed_slot is not None and elapsed_slot not in self._mem:
            self.declare(elapsed_slot, (), torch.int32, 0)
        self._net_spec.uses_dials = True
        t0 = self._auto_slot("dial_t0")
        tfirst = self._auto_slot("dial_tf") if elapsed_slot else None
        tries = self._auto_slot("dial_try") if retries else None
        dialed = self._auto_slot("dial_dest")
        sent = self._auto_slot("dial_syn")  # SYN for the current attempt out?

        def fn(env, mem):
            entered = mem[t0] > 0
            dest = torch.as_tensor(dest_fn(env, mem)).to(torch.int32)
            noop = (~entered) & (dest < 0)  # no-dial role: skip at once
            eg_ok = env.egress_ready()
            enter = (~entered) & ~noop
            mem = dict(mem)
            mem[dialed] = torch.where(enter, dest, mem[dialed])
            mem[t0] = torch.where(enter, env.tick + 1, mem[t0])
            if tfirst is not None:
                mem[tfirst] = torch.where(enter, env.tick + 1, mem[tfirst])
            syn_out = mem[sent] > 0
            # reply ready? (src and port must match the dial)
            ready = (
                entered
                & (env.hs[HS_VIS] <= env.tick)
                & (env.hs[HS_SRC] == mem[dialed].to(torch.float32))
                & (env.hs[HS_PORT] == port)
            )
            is_ack = ready & (env.hs[HS_TAG] == TAG_ACK)
            is_rst = ready & (env.hs[HS_TAG] == TAG_RST)
            timed_out = entered & ~is_ack & ~is_rst & (
                env.ms(env.tick - mem[t0]) >= timeout_ms
            )
            if tries is not None:
                # an attempt window expires by clock even when the egress
                # is pinned (the retransmit then emits later)
                roll = timed_out & (mem[tries] < retries)
            else:
                roll = torch.zeros_like(timed_out)
            gave_up = timed_out & ~roll
            done = noop | (entered & (is_ack | is_rst | gave_up))
            result = torch.where(
                is_ack, 1,
                torch.where(is_rst, -1, torch.where(gave_up, -2, 0)),
            ).to(torch.int32)
            mem[result_slot] = torch.where(done & ~noop, result,
                                           mem[result_slot])
            if elapsed_slot is not None:
                mem[elapsed_slot] = torch.where(
                    done & ~noop, env.tick - mem[tfirst], mem[elapsed_slot]
                )
                mem[tfirst] = torch.where(done, 0, mem[tfirst])
            if tries is not None:
                mem[tries] = torch.where(
                    done, 0, mem[tries] + roll.to(torch.int32)
                )
            # a window rollover restarts the attempt clock now
            mem[t0] = torch.where(
                done, 0, torch.where(roll, env.tick + 1, mem[t0])
            )
            retry_syn = roll & eg_ok
            # the current attempt's SYN fires on the first admitted tick
            first_syn = (enter | entered) & ~syn_out & eg_ok & ~done
            sending = first_syn | retry_syn
            mem[sent] = torch.where(
                done | (roll & ~eg_ok), 0,
                torch.where(sending, 1, mem[sent]),
            )
            return mem, PhaseCtrl(
                advance=done.to(torch.int32),
                send_dest=torch.where(sending, mem[dialed], -1),
                send_tag=TAG_SYN,
                send_port=port,
                # cleared at phase entry only: a retransmit keeps the
                # previous attempt's in-flight ACK valid
                hs_clear=enter.to(torch.int32),
            )

        self.phase(fn, name=f"dial:{port}")

    def send_message(self, dest_fn, port: int, size_fn,
                     payload_fn=None) -> None:
        """Fire-and-forget data send on an established flow; the payload
        (``payload_fn(env, mem)``, a vector or a scalar) is padded with
        zeros to the net's ``payload_len``."""
        self.enable_net()

        def fn(env, mem):
            pay = None
            if payload_fn is not None:
                p = torch.as_tensor(payload_fn(env, mem)).to(
                    torch.float32).reshape(-1)
                width = self._net_spec.payload_len
                pay = torch.cat([p, p.new_zeros(width - p.shape[0])])
            dest = dest_fn(env, mem)
            size = size_fn(env, mem) if callable(size_fn) else size_fn
            return mem, PhaseCtrl(
                advance=1,
                send_dest=(dest.to(torch.int32)
                           if isinstance(dest, torch.Tensor) else int(dest)),
                send_tag=TAG_DATA,
                send_port=port,
                send_size=(size.to(torch.float32)
                           if isinstance(size, torch.Tensor)
                           else float(size)),
                send_payload=pay,
            )

        self.phase(fn, name=f"send:{port}")

    # ------------------------------------------------- not ported (yet)

    def trace(self, *a, **k) -> None:
        raise _not_ported("ProgramBuilder.trace", 9, "observer planes")

    def observe(self, *a, **k) -> None:
        raise _not_ported("ProgramBuilder.observe", 9, "observer planes")

    def count(self, *a, **k) -> None:
        raise _not_ported("ProgramBuilder.count", 9, "observer planes")

    def gauge(self, *a, **k) -> None:
        raise _not_ported("ProgramBuilder.gauge", 9, "observer planes")

    def on_arrival(self, *a, **k) -> None:
        raise _not_ported("ProgramBuilder.on_arrival", 9, "observer planes")

    def set_net_class(self, *a, **k) -> None:
        raise _not_ported("ProgramBuilder.set_net_class", 7,
                          "entry-mode data plane")

    # -------------------------------------------------------------- build

    def build(self) -> Program:
        if self._net_spec is not None:
            for knob in ("loss", "corrupt", "reorder", "duplicate"):
                if getattr(
                    self._net_spec, f"uses_{knob}_corr"
                ) and not getattr(self._net_spec, f"uses_{knob}"):
                    raise ValueError(
                        f"{knob}_corr is configured but the program never "
                        f"proves the {knob} rate itself — the correlation "
                        "would allocate per-lane Markov state and then do "
                        "nothing (the toxic block is elided). Configure "
                        f"{knob}= alongside the correlation, or declare "
                        f"enable_net(uses_{knob}=True) for hand-written "
                        "shaping phases."
                    )
        return Program(
            phases=list(self._phases),
            states=self.states,
            topics=self.topics,
            metrics=self.metrics,
            mem_spec=dict(self._mem),
            net_spec=self._net_spec,
            churn_sids=tuple(self._churn_sids),
            churn_tids=tuple(self._churn_tids),
        )
