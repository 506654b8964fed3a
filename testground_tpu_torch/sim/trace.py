"""The trace plane: per-lane event rings in the state, demuxed to Chrome
trace-event JSON.

Counterpart of ``testground_tpu/sim/trace.py``. The ring is

  ``trace_buf   [N, capacity, 5]``  int32 records
  ``trace_cnt   [N]``               occupied slots a lane
  ``trace_dropped [N]``             events lost to a full ring

one record ``(tick, category, code, arg0, arg1)``. Each emission site of
a tick is one masked ``subkernels.ring_append`` (a dense one-hot select,
no scatter), in JAX's site order, since a lane's slot order is the
contract. A category the spec filters out emits nothing; an absent or
disabled ``[trace]`` table builds no emitter at all, so the untraced
program keeps its state and its ops.

After the run, :func:`trace_events` flattens the rings and
:func:`chrome_trace` gives the Chrome trace-event dict (Perfetto): lanes
as threads, ticks as microseconds, blocked windows as spans, the fault
plane's windows on their own track from the window leaves in the state.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .subkernels import ring_append
from .tables import Trace

# record fields
F_FIELDS = 5
F_TICK, F_CAT, F_CODE, F_ARG0, F_ARG1 = range(F_FIELDS)

# categories (the [trace] table's `categories` filter names these)
CAT_LANE = 0  # block, pc transition, done
CAT_NET = 1  # send, deliver, drop with its cause
CAT_SYNC = 2  # signal (barrier enter), publish
CAT_FAULT = 3  # kill, restart (windows are drawn at demux)
CAT_USER = 4  # PhaseCtrl(trace_code=...) / ProgramBuilder.trace()

CATEGORY_NAMES = {
    "lane": CAT_LANE,
    "net": CAT_NET,
    "sync": CAT_SYNC,
    "fault": CAT_FAULT,
    "user": CAT_USER,
}
_CAT_LABEL = {v: k for k, v in CATEGORY_NAMES.items()}

# CAT_LANE codes
EV_BLOCK = 0  # arg0 = wake tick (the blocked span is [tick, arg0))
EV_PC = 1  # arg0 = new pc, arg1 = old pc
EV_DONE = 2  # arg0 = final status

# CAT_NET codes
EV_SEND = 0  # arg0 = dest, arg1 = tag
EV_DELIVER = 1  # arg0 = arrivals this tick, arg1 = bytes (count mode)
EV_DROP = 2  # arg0 = cause (DROP_*), arg1 = dest

# CAT_SYNC codes
EV_SIGNAL = 0  # arg0 = state id, arg1 = seq
EV_PUBLISH = 1  # arg0 = topic id, arg1 = seq

# CAT_FAULT codes
EV_KILL = 0  # arg0 = the kill tick the schedule stamped
EV_RESTART = 1  # arg0 = the lane's restart count after this rejoin

# EV_DROP causes
DROP_PARTITION = 0  # a [faults] partition window blocked the send
DROP_LOSS = 1  # link or degrade loss
DROP_CHURN = 2  # the destination host is dead (crashed/finished)
DROP_QUEUE_FULL = 3  # egress or inbox queue overflow
DROP_FILTER = 4  # REJECT/DROP filter rule
DROP_DISABLED = 5  # the sender's own link is down

DROP_CAUSE_NAMES = {
    DROP_PARTITION: "partition",
    DROP_LOSS: "loss",
    DROP_CHURN: "churn",
    DROP_QUEUE_FULL: "queue-full",
    DROP_FILTER: "filter",
    DROP_DISABLED: "disabled",
}


class TraceError(ValueError):
    """A [trace] table that cannot compile against this composition."""


@dataclass(frozen=True)
class TraceSpec:
    """Compiled trace-plane statics: ``categories`` the enabled CAT_*
    ids (empty = all), ``group_mask`` the per-instance rows whose events
    record (None = every real lane)."""

    capacity: int = 256
    categories: tuple = ()
    group_mask: Optional[tuple] = None

    def wants(self, cat: int) -> bool:
        return not self.categories or cat in self.categories

    def structure(self) -> tuple:
        """Program-shaping identity (sim/sweep.py fingerprint)."""
        return (self.capacity, self.categories, self.group_mask)


def compile_trace(trace, ctx) -> Optional[TraceSpec]:
    """Compile a ``[trace]`` table (sim/tables.py ``Trace`` or its dict
    form) against a BuildContext; None when absent or disabled."""
    if trace is None:
        return None
    if isinstance(trace, TraceSpec):
        return trace
    if isinstance(trace, dict):
        trace = Trace.from_dict(trace)
    if not getattr(trace, "enabled", True):
        return None
    if trace.capacity < 1:
        raise TraceError(f"trace.capacity must be >= 1, got {trace.capacity}")
    cats = []
    for name in trace.categories or ():
        if name not in CATEGORY_NAMES:
            raise TraceError(
                f"trace.categories: unknown category {name!r}; known: "
                f"{sorted(CATEGORY_NAMES)}"
            )
        cats.append(CATEGORY_NAMES[name])
    group_mask = None
    if trace.groups:
        known = {g.id for g in ctx.groups}
        for gid in trace.groups:
            if gid not in known:
                raise TraceError(
                    f"trace.groups: unknown group {gid!r}; composition "
                    f"groups: {sorted(known)}"
                )
        sel = {g.index for g in ctx.groups if g.id in set(trace.groups)}
        group_mask = tuple(
            bool(g in sel) for g in ctx.group_ids.tolist()
        )
    return TraceSpec(
        capacity=int(trace.capacity),
        categories=tuple(sorted(set(cats))),
        group_mask=group_mask,
    )


def init_trace_state(n: int, spec: TraceSpec, device) -> dict:
    def z(shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    return {
        "trace_buf": z((n, spec.capacity, F_FIELDS)),
        "trace_cnt": z(n),
        "trace_dropped": z(n),
    }


class TraceEmitter:
    """One tick's emission helper: holds the trace leaves through the
    tick's sites (:attr:`state`); each :meth:`emit` is one masked ring
    append of the records ``(tick, cat, code, arg0, arg1)`` on the
    ``mask`` lanes. ``fused`` mirrors ``SimConfig.fused_observers``: the
    sites read it to merge per-lane disjoint emissions (the drop-cause
    lattice, the kill/restart pair) into one append each. ``gmask`` is
    the group filter as a device tensor (None = every lane)."""

    def __init__(self, spec: TraceSpec, state: dict, tick, n: int,
                 fused: bool = True, gmask=None) -> None:
        self.spec = spec
        self.state = dict(state)
        self.tick = tick
        self.n = n
        self.fused = fused
        self._gmask = gmask

    def _lanes(self, v):
        if isinstance(v, torch.Tensor):
            return v.to(torch.int32).expand(self.n)
        return torch.full((self.n,), int(v), dtype=torch.int32,
                          device=self.tick.device)

    def emit(self, cat: int, mask, code, arg0=0, arg1=0) -> None:
        if not self.spec.wants(cat):
            return
        if self._gmask is not None:
            mask = mask & self._gmask
        tr = self.state
        rec = torch.stack(
            [self._lanes(self.tick), self._lanes(cat), self._lanes(code),
             self._lanes(arg0), self._lanes(arg1)],
            dim=-1,
        )  # [N, F]
        buf, cnt, dropped = ring_append(
            tr["trace_buf"], tr["trace_cnt"], tr["trace_dropped"], mask, rec,
        )
        self.state = {"trace_buf": buf, "trace_cnt": cnt,
                      "trace_dropped": dropped}


# ---------------------------------------------------------------- demux


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def trace_events(state: dict, n_instances: Optional[int] = None):
    """A final state's trace rings as one structured array sorted by
    (tick, lane, slot): fields lane, tick, cat, code, arg0, arg1. Takes
    the whole state or its ``trace`` sub-dict."""
    if "trace" in state:
        state = state["trace"]
    buf = _np(state["trace_buf"])
    cnt = _np(state["trace_cnt"])
    if n_instances is not None:
        buf = buf[:n_instances]
        cnt = cnt[:n_instances]
    cap = buf.shape[1]
    occupied = np.arange(cap)[None, :] < cnt[:, None]
    lane, slot = np.nonzero(occupied)
    rec = buf[lane, slot]  # [E, F]
    out = np.zeros(
        lane.shape[0],
        dtype=[
            ("lane", np.int32), ("tick", np.int32), ("cat", np.int32),
            ("code", np.int32), ("arg0", np.int32), ("arg1", np.int32),
        ],
    )
    out["lane"] = lane
    out["tick"] = rec[:, F_TICK]
    out["cat"] = rec[:, F_CAT]
    out["code"] = rec[:, F_CODE]
    out["arg0"] = rec[:, F_ARG0]
    out["arg1"] = rec[:, F_ARG1]
    # a lane's slot order is its tick order: a stable sort on tick keeps
    # the same-tick emission order
    order = np.argsort(out["tick"], kind="stable")
    return out[order]


def _event_name(cat: int, code: int) -> str:
    table = {
        CAT_LANE: {EV_BLOCK: "blocked", EV_PC: "pc", EV_DONE: "done"},
        CAT_NET: {EV_SEND: "send", EV_DELIVER: "deliver", EV_DROP: "drop"},
        CAT_SYNC: {EV_SIGNAL: "signal", EV_PUBLISH: "publish"},
        CAT_FAULT: {EV_KILL: "kill", EV_RESTART: "restart"},
    }
    if cat == CAT_USER:
        return f"user:{code}"
    name = table.get(cat, {}).get(code)
    return name if name else f"{_CAT_LABEL.get(cat, cat)}:{code}"


PROCESS_META = {
    "name": "process_name",
    "ph": "M",
    "pid": 0,
    "args": {"name": "sim"},
}


def chrome_thread_meta(lanes, ctx) -> list[dict]:
    """Thread-name rows for ``lanes``: one thread a lane (tid = lane id,
    named ``<group>/<ginst> (lane <id>)``) under pid 0."""
    group_of = {g.index: g.id for g in ctx.groups}
    gids = np.asarray(ctx.group_ids)
    ginst = np.asarray(ctx.group_instance_index)
    return [
        {
            "name": "thread_name",
            "ph": "M",
            "pid": 0,
            "tid": lane,
            "args": {
                "name": (
                    f"{group_of.get(int(gids[lane]), '?')}/"
                    f"{int(ginst[lane])} (lane {lane})"
                )
            },
        }
        for lane in sorted(int(x) for x in lanes)
    ]


def _json_float(x: float) -> str:
    """A float as ``json.dumps`` writes it."""
    return float.__repr__(x) if math.isfinite(x) else json.dumps(x)


def chrome_event_json(ev, quantum_ms: float) -> list[str]:
    """The Chrome events of a demuxed event array, in its order, each as
    the ``json.dumps`` text of its row: ``blocked`` as complete-event
    spans (``ph: "X"``, ``dur`` from the wake tick), the rest as
    thread-scoped instants, drops named by cause (``drop:partition``,
    ``drop:loss``, ...). Formatted without a dict a row: a 1,024-lane
    run records ~260k events, a drained batch as many."""
    q_us = float(quantum_ms) * 1e3  # one tick in microseconds
    cols = [ev[k].tolist() for k in ("lane", "tick", "cat", "code", "arg0",
                                     "arg1")]
    # the span's length in the rings' int32, as the JAX demux takes it
    span = (ev["arg0"] - ev["tick"]).tolist()
    cats: dict = {}
    names: dict = {}
    ff = _json_float
    out: list[str] = []
    for ln, t, c, cd, a0, a1, sp in zip(*cols, span):
        cat = cats.get(c)
        if cat is None:
            cat = cats[c] = json.dumps(_CAT_LABEL.get(c, str(c)))
        head = (f'{{"pid": 0, "tid": {ln}, "ts": {ff(float(t) * q_us)}, '
                f'"cat": {cat}, ')
        if c == CAT_LANE and cd == EV_BLOCK:
            out.append(f'{head}"name": "blocked", "ph": "X", "dur": '
                       f'{ff(max(0.0, float(sp) * q_us))}, "args": '
                       f'{{"wake_tick": {a0}}}}}')
            continue
        key = (c, cd, a0) if c == CAT_NET and cd == EV_DROP else (c, cd)
        name = names.get(key)
        if name is None:
            name = names[key] = json.dumps(
                f"drop:{DROP_CAUSE_NAMES.get(a0, a0)}" if len(key) == 3
                else _event_name(c, cd))
        out.append(f'{head}"name": {name}, "ph": "i", "s": "t", "args": '
                   f'{{"arg0": {a0}, "arg1": {a1}}}}}')
    return out


def chrome_trace_json(
    state: dict,
    ctx,
    quantum_ms: float,
    fault_plan=None,
    n_instances: Optional[int] = None,
) -> str:
    """A final state as the text of a Chrome trace-event JSON document
    (a ``trace.json`` Perfetto loads; ``json.dumps`` of
    :func:`chrome_trace`): the process row, one thread row a lane that
    recorded, the events, and the fault plane's windows on a "faults"
    track (pid 1) from the window leaves in the state."""
    n = n_instances if n_instances is not None else ctx.n_instances
    ev = trace_events(state, n)
    q_us = float(quantum_ms) * 1e3
    rows = [json.dumps(PROCESS_META)]
    rows.extend(json.dumps(r)
                for r in chrome_thread_meta(set(ev["lane"].tolist()), ctx))
    rows.extend(chrome_event_json(ev, quantum_ms))
    if fault_plan is not None and fault_plan.has_windows and "faults" in state:
        rows.extend(json.dumps(r) for r in fault_window_events(
            fault_plan, state["faults"], q_us,
            last_tick=int(_np(state.get("tick", 0)))))
    return ('{"traceEvents": [' + ", ".join(rows)
            + '], "displayTimeUnit": "ms"}')


def chrome_trace(
    state: dict,
    ctx,
    quantum_ms: float,
    fault_plan=None,
    n_instances: Optional[int] = None,
) -> dict:
    """:func:`chrome_trace_json`'s document as a dict."""
    return json.loads(chrome_trace_json(state, ctx, quantum_ms,
                                        fault_plan=fault_plan,
                                        n_instances=n_instances))


def fault_window_events(plan, ft: dict, q_us: float, last_tick: int) -> list:
    """The fault windows as spans on their own track (pid 1, "faults"),
    from the window leaves in the state; an unhealed partition ends at
    the run's last tick."""
    from .faults import NEVER_ENDS, W_BLOCK

    ws = _np(ft["win_start"])
    we = _np(ft["win_end"])
    out = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": 1,
            "args": {"name": "faults"},
        }
    ]
    for e, kind in enumerate(plan.win_kind):
        start = int(ws[e])
        end = int(we[e])
        if end >= NEVER_ENDS:
            end = max(last_tick, start)
        label = "partition" if kind == W_BLOCK else "degrade"
        out.append(
            {
                "pid": 1,
                "tid": e,
                "name": (
                    f"{label} g{plan.win_src[e]}"
                    f"→g{plan.win_dst[e]}"
                ),
                "ph": "X",
                "cat": "fault",
                "ts": start * q_us,
                "dur": max(0.0, (end - start) * q_us),
                "args": {"start_tick": start, "end_tick": end},
            }
        )
    return out
