"""The replay plane: recorded workload traces compiled to schedule tensors
(counterpart of ``testground_tpu/sim/replay.py``).

A composition's ``[replay]`` table (sim/tables.py ``Replay``) names a
recorded trace file: request arrivals per instance per tick, and
optional kill/restart rows. :func:`compile_replay` lowers it once at
build time into per-lane schedule tensors riding in the state:

- the **arrival table**: per lane up to ``R`` rows of ``(tick, op,
  arg)`` sorted by tick, as three leaves ``arr_tick``/``arr_op``/
  ``arr_arg`` plus the row count ``arr_cnt``, consumed through a
  per-lane ``cursor``. Phases read the head row through the TickEnv
  helpers (``arrivals_pending()``, ``next_arrival()``) and pop it with
  ``PhaseCtrl(replay_consume=...)``, or let ``ProgramBuilder.on_arrival``
  drive the schedule;
- the **churn rows** feed the fault plane: :func:`merge_into_faults`
  folds them into the composition's FaultPlan (minting a windowless plan
  when there is no ``[faults]`` table), so a recorded crash-restart runs
  through the same rejoin path a declared one does.

``scale`` multiplies the request load (each arrival replays
``floor(scale)`` times, and one more by a seed-keyed draw with the
fractional part's probability, drawn in file order) and ``time_scale``
stretches the timeline; both may be ``"$param"`` references. The
per-lane next-arrival tick joins the event-horizon min, so a sparse
trace executes one loop iteration per arrival. A composition without a
``[replay]`` table, or with a disabled one, builds the replay-free
program: every hook in sim/core.py is a Python branch on the plan.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .subkernels import cursor_select

# "no arrival" sentinel: int32 max, the fault plane's horizon too, so an
# exhausted lane's head never reads as an event
REPLAY_NEVER = np.iinfo(np.int32).max

# trace-file row kinds
ROW_KINDS = ("arrival", "kill", "restart")


class ReplayError(ValueError):
    """A replay trace that cannot compile against this composition."""


def _resolve(v, params: dict, tag: str) -> float:
    """A numeric field or a ``"$param"`` reference -> float."""
    if isinstance(v, str):
        if not v.startswith("$"):
            raise ReplayError(
                f"{tag}: expected a number or '$param', got {v!r}"
            )
        name = v[1:]
        if params is None or name not in params:
            raise ReplayError(
                f"{tag}: references ${name} but no test param {name!r} "
                "is set (define it in test_params or a [sweep.params] "
                "grid)"
            )
        try:
            return float(params[name])
        except (TypeError, ValueError):
            raise ReplayError(
                f"{tag}: test param {name!r}={params[name]!r} is not "
                "numeric"
            )
    return float(v)


@dataclass
class ReplayPlan:
    """A compiled replay schedule: the static shape (``capacity``, the
    churn-row presence) and the numeric tensors that ride in the state
    under ``state["replay"]`` (:meth:`dynamic_leaves`)."""

    capacity: int = 1  # R, arrival rows a lane
    # arrival tensors [N, R]; padding rows hold REPLAY_NEVER ticks
    arr_tick: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 1), np.int32)
    )
    arr_op: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 1), np.int32)
    )
    arr_arg: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 1), np.float32)
    )
    arr_cnt: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int32)
    )
    # churn schedules [N]; -1 = never (fed into the fault plane)
    kill_tick: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int32)
    )
    restart_tick: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int32)
    )
    # the trace has churn rows (structural, even when a time_scale
    # pushes every one past the horizon)
    kill_rows: bool = False
    restart_rows: bool = False
    # journal facts
    n_events: int = 0  # arrival rows after scaling
    lanes: int = 0  # distinct lanes with arrivals
    horizon: int = 0  # last scheduled tick (arrivals and churn)
    churn_events: int = 0  # kill and restart rows
    source: str = ""  # the trace file path

    @property
    def has_churn(self) -> bool:
        return self.kill_rows or self.restart_rows

    def structure(self) -> tuple:
        """The trace-shaping identity: scenarios batched into one sweep
        must agree on it."""
        return (
            self.capacity, self.arr_tick.shape, self.kill_rows,
            self.restart_rows,
        )

    def dynamic_leaves(self) -> dict:
        """The numeric tensors that ride in the state (the cursor is not
        here: the executor's init_state makes it, zero)."""
        return {
            "arr_tick": self.arr_tick,
            "arr_op": self.arr_op,
            "arr_arg": self.arr_arg,
            "arr_cnt": self.arr_cnt,
        }

    def model_bytes(self) -> int:
        """The device bytes of the replay leaves: the arrival table, the
        counts and the cursor."""
        n = self.arr_cnt.shape[0]
        return (
            self.arr_tick.nbytes
            + self.arr_op.nbytes
            + self.arr_arg.nbytes
            + self.arr_cnt.nbytes
            + n * 4  # cursor [N] i32
        )

    def journal(self) -> dict:
        """The run journal's ``replay`` record."""
        return {
            "events": int(self.n_events),
            "lanes": int(self.lanes),
            "horizon": int(self.horizon),
            "capacity": int(self.capacity),
            "churn_events": int(self.churn_events),
            "source": self.source,
        }

    def padded_to(self, n: int) -> "ReplayPlan":
        """This plan with its [N] leaves padded to ``n`` lanes (padding
        lanes carry no arrivals and never churn)."""
        cur = self.arr_cnt.shape[0]
        if n == cur:
            return self
        if n < cur:
            raise ValueError(
                f"replay plan compiled for {cur} lanes cannot shrink "
                f"to {n}"
            )
        extra = n - cur
        pad2 = ((0, extra), (0, 0))
        pad1 = ((0, extra),)
        return dataclasses.replace(
            self,
            arr_tick=np.pad(
                self.arr_tick, pad2, constant_values=REPLAY_NEVER
            ),
            arr_op=np.pad(self.arr_op, pad2),
            arr_arg=np.pad(self.arr_arg, pad2),
            arr_cnt=np.pad(self.arr_cnt, pad1),
            kill_tick=np.pad(self.kill_tick, pad1, constant_values=-1),
            restart_tick=np.pad(
                self.restart_tick, pad1, constant_values=-1
            ),
        )


# (path, mtime_ns, size) -> parsed rows: a sweep compiles the same file
# once a scenario. The cached list is read-only downstream.
_TRACE_CACHE: dict = {}
_TRACE_CACHE_DEPTH = 4


def load_trace(path) -> list[dict]:
    """Parse a replay trace file (JSON lines). Rows: ``{"kind":
    "arrival", "lane": i, "tick": t, "op": c, "arg": x}`` (kind defaults
    to arrival, op and arg to 0) and ``{"kind": "kill"|"restart",
    "lane": i, "tick": t}``; a line carrying ``replay_version`` is a
    header and skipped. Raises :class:`ReplayError` naming the line of
    anything malformed. Parses are kept per (path, mtime, size); treat
    the returned list as read-only."""
    p = Path(path)
    try:
        st = p.stat()
        cache_key = (str(p), st.st_mtime_ns, st.st_size)
        cached = _TRACE_CACHE.get(cache_key)
        if cached is not None:
            return cached
        text = p.read_text()
    except OSError as e:
        raise ReplayError(f"replay trace {path}: {e}") from e
    rows: list[dict] = []
    for ln, line in enumerate(text.splitlines(), start=1):
        line = line.strip()
        if not line:
            continue
        try:
            d = json.loads(line)
        except json.JSONDecodeError as e:
            raise ReplayError(
                f"replay trace {path}:{ln}: not JSON ({e.msg})"
            ) from e
        if not isinstance(d, dict):
            raise ReplayError(
                f"replay trace {path}:{ln}: expected an object, got "
                f"{type(d).__name__}"
            )
        if "replay_version" in d:
            continue  # header line
        kind = d.get("kind", "arrival")
        if kind not in ROW_KINDS:
            raise ReplayError(
                f"replay trace {path}:{ln}: unknown kind {kind!r}; "
                f"expected one of {', '.join(ROW_KINDS)}"
            )
        for req in ("lane", "tick"):
            v = d.get(req)
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise ReplayError(
                    f"replay trace {path}:{ln}: {req} must be a number, "
                    f"got {v!r}"
                )
            if float(v) != int(v):
                # truncating would replay a different workload
                raise ReplayError(
                    f"replay trace {path}:{ln}: {req} must be an "
                    f"integer, got {v!r}"
                )
        if d["tick"] < 0 or d["lane"] < 0:
            raise ReplayError(
                f"replay trace {path}:{ln}: lane/tick must be >= 0"
            )
        rows.append(
            {
                "kind": kind,
                "lane": int(d["lane"]),
                "tick": int(d["tick"]),
                "op": int(d.get("op", 0)),
                "arg": float(d.get("arg", 0.0)),
            }
        )
    _TRACE_CACHE[cache_key] = rows
    while len(_TRACE_CACHE) > _TRACE_CACHE_DEPTH:
        _TRACE_CACHE.pop(next(iter(_TRACE_CACHE)))
    return rows


def _merged_params(groups) -> dict:
    """One name -> value view over all groups' test params for
    ``$param`` resolution (a value that differs across groups is
    ambiguous for a global schedule)."""
    out: dict = {}
    for g in groups:
        for k, v in (g.parameters or {}).items():
            if k in out and out[k] != v:
                raise ReplayError(
                    f"replay: test param {k!r} differs across groups "
                    f"({out[k]!r} vs {v!r}); $param references need one "
                    "global value"
                )
            out[k] = v
    return out


def compile_replay(replay, ctx, cfg, params: Optional[dict] = None):
    """Compile a ``[replay]`` table (sim/tables.py ``Replay`` or its dict
    form) against a build context. ``cfg`` is the SimConfig (its seed
    keys the fractional-scale draw); ``params`` the test-param view for
    ``$param`` references (default: the groups' merged params). Returns
    a :class:`ReplayPlan`, or None when the table is absent or
    disabled."""
    from .tables import Replay

    if replay is None:
        return None
    if isinstance(replay, dict):
        replay = Replay.from_dict(replay)
    if not replay.enabled:
        return None
    replay.validate()
    if params is None:
        params = _merged_params(ctx.groups)
    scale = _resolve(replay.scale, params, "replay.scale")
    tscale = _resolve(replay.time_scale, params, "replay.time_scale")
    for name, v in (("scale", scale), ("time_scale", tscale)):
        if v <= 0:
            raise ReplayError(
                f"replay.{name} must be > 0, got {v} (a zero/negative "
                "scaling is an empty or inverted workload)"
            )
    rows = load_trace(replay.trace)

    n = ctx.padded_n
    n_real = ctx.n_instances

    def tick_of(t: int) -> int:
        return int(round(t * tscale))

    # arrivals: scale, then sort per lane. The fractional part keeps
    # each extra copy by a draw in file order, keyed by (seed, row)
    base_copies = int(scale)
    frac = scale - base_copies
    arr_rows = [r for r in rows if r["kind"] == "arrival"]
    rng = np.random.default_rng((int(cfg.seed), 0x4E9147))
    extra_draw = (
        rng.random(len(arr_rows)) < frac
        if frac > 0
        else np.zeros(len(arr_rows), bool)
    )
    per_lane: dict[int, list] = {}
    n_events = 0
    horizon = 0
    for i, r in enumerate(arr_rows):
        if r["lane"] >= n_real:
            raise ReplayError(
                f"replay trace {replay.trace}: arrival lane {r['lane']} "
                f">= the composition's {n_real} instances (record and "
                "replay must agree on the instance count, or re-scale "
                "the trace with tools/trace2replay.py --lanes)"
            )
        copies = base_copies + int(extra_draw[i])
        if not copies:
            continue
        t = tick_of(r["tick"])
        per_lane.setdefault(r["lane"], []).extend(
            [(t, r["op"], r["arg"])] * copies
        )
        n_events += copies
        horizon = max(horizon, t)

    max_rows = max((len(v) for v in per_lane.values()), default=0)
    if replay.capacity:
        if max_rows > replay.capacity:
            lane = max(per_lane, key=lambda k: len(per_lane[k]))
            raise ReplayError(
                f"replay: lane {lane} needs {max_rows} arrival rows at "
                f"scale {scale:g} but replay.capacity is "
                f"{replay.capacity} — raise the capacity (the table is "
                "[N, capacity, 3] in device state; docs/replay.md "
                "'Sizing'), lower the scale, or split the trace"
            )
        R = replay.capacity
    else:
        R = max(1, max_rows)

    arr_tick = np.full((n, R), REPLAY_NEVER, np.int32)
    arr_op = np.zeros((n, R), np.int32)
    arr_arg = np.zeros((n, R), np.float32)
    arr_cnt = np.zeros(n, np.int32)
    for lane, items in per_lane.items():
        items.sort(key=lambda it: it[0])  # stable: ties keep file order
        k = len(items)
        arr_tick[lane, :k] = [it[0] for it in items]
        arr_op[lane, :k] = [it[1] for it in items]
        arr_arg[lane, :k] = [it[2] for it in items]
        arr_cnt[lane] = k

    # churn rows, in resolved-tick order (kills before restarts at equal
    # ticks), not file order: a concatenated recording may list a lane's
    # restart before its kill
    kill_tick = np.full(n, -1, np.int32)
    restart_tick = np.full(n, -1, np.int32)
    kill_rows = restart_rows = False
    churn_events = 0
    churn = sorted(
        (r for r in rows if r["kind"] != "arrival"),
        key=lambda r: (
            tick_of(r["tick"]),
            0 if r["kind"] == "kill" else 1,
            r["lane"],
        ),
    )
    for r in churn:
        lane, t = r["lane"], tick_of(r["tick"])
        if lane >= n_real:
            raise ReplayError(
                f"replay trace {replay.trace}: {r['kind']} lane {lane} "
                f">= the composition's {n_real} instances"
            )
        churn_events += 1
        if r["kind"] == "kill":
            kill_rows = True
            prior = kill_tick[lane]
            kill_tick[lane] = t if prior < 0 else min(prior, t)
        else:
            restart_rows = True
            if kill_tick[lane] < 0:
                raise ReplayError(
                    f"replay trace {replay.trace}: restart of lane "
                    f"{lane} at tick {t} has no earlier kill row for "
                    "that lane"
                )
            if t <= kill_tick[lane]:
                raise ReplayError(
                    f"replay trace {replay.trace}: restart of lane "
                    f"{lane} at tick {t} does not follow its kill "
                    f"(tick {int(kill_tick[lane])}) — an instance dies "
                    "at most once per run"
                )
            if restart_tick[lane] < 0:  # the first restart wins
                restart_tick[lane] = t
        horizon = max(horizon, t)

    if not arr_rows and not churn_events:
        raise ReplayError(
            f"replay trace {replay.trace}: no arrival or churn rows — "
            "an empty workload replays nothing; drop the [replay] table"
        )

    return ReplayPlan(
        capacity=R,
        arr_tick=arr_tick,
        arr_op=arr_op,
        arr_arg=arr_arg,
        arr_cnt=arr_cnt,
        kill_tick=kill_tick,
        restart_tick=restart_tick,
        kill_rows=kill_rows,
        restart_rows=restart_rows,
        n_events=n_events,
        lanes=len(per_lane),
        horizon=horizon,
        churn_events=churn_events,
        source=str(replay.trace),
    )


def merge_into_faults(plan: Optional[ReplayPlan], faults):
    """Fold a replay plan's churn schedule into the fault plane: the
    recorded kills and restarts run through the rejoin machinery a
    declared schedule uses. Returns ``faults`` untouched when the replay
    has no churn, and a windowless FaultPlan when there is no fault
    plan. Idempotent (earliest death, first restart; a timeline entry of
    the same kind and source is not appended twice)."""
    if plan is None or not plan.has_churn:
        return faults
    from .core import merge_kill_ticks
    from .faults import FaultPlan

    timeline = []
    n_kill = int((plan.kill_tick >= 0).sum())
    if n_kill:
        timeline.append(
            {
                "kind": "kill", "source": "replay",
                "n_victims": n_kill,
                "victims": np.nonzero(plan.kill_tick >= 0)[0][
                    :20
                ].tolist(),
            }
        )
    n_rst = int((plan.restart_tick >= 0).sum())
    if n_rst:
        timeline.append(
            {
                "kind": "restart", "source": "replay",
                "n_restarted": n_rst,
                "restarted": np.nonzero(plan.restart_tick >= 0)[0][
                    :20
                ].tolist(),
            }
        )
    if faults is None:
        return FaultPlan(
            kill_tick=plan.kill_tick.copy(),
            restart_tick=plan.restart_tick.copy(),
            restart_events=plan.restart_rows,
            timeline=timeline,
        )
    if faults.kill_tick.shape != plan.kill_tick.shape:
        raise ValueError(
            f"replay churn schedule ({plan.kill_tick.shape[0]} lanes) "
            f"does not align with the fault plan "
            f"({faults.kill_tick.shape[0]} lanes)"
        )
    a, b = faults.restart_tick, plan.restart_tick
    merged_restart = np.where(
        a < 0, b, np.where(b < 0, a, np.minimum(a, b))
    ).astype(np.int32)
    have = {
        (e.get("kind"), e.get("source")) for e in faults.timeline
    }
    new_tl = [
        e for e in timeline if (e["kind"], e["source"]) not in have
    ]
    return dataclasses.replace(
        faults,
        kill_tick=merge_kill_ticks(faults.kill_tick, plan.kill_tick),
        restart_tick=merged_restart,
        restart_events=faults.restart_events or plan.restart_rows,
        timeline=list(faults.timeline) + new_tl,
    )


# ---------------------------------------------------------- tick hooks


def init_replay_state(n: int, plan: ReplayPlan, device) -> dict:
    """The replay leaves: the arrival tensors and the per-lane cursor.
    The cursor survives a crash-restart (delivered requests are not
    replayed to a fresh process)."""
    return {
        **{k: torch.as_tensor(v, device=device)
           for k, v in plan.dynamic_leaves().items()},
        "cursor": torch.zeros(n, dtype=torch.int32, device=device),
    }


def head_fields(rst: dict, tick, rows):
    """This tick's per-lane head-of-schedule view, as one ``[N, R]``
    one-hot pass: ``(head_tick, head_op, head_arg, pending, left)``,
    where ``head_*`` are the cursor row's fields (the tick is
    REPLAY_NEVER once the lane's schedule is exhausted), ``pending``
    counts the rows due at ``tick`` not yet consumed and ``left`` all
    unconsumed rows. ``rows`` is the ``[R]`` int32 row index, made once
    on the device (no host copy inside a captured tick)."""
    cur = rst["cursor"]
    cnt = rst["arr_cnt"]
    live = cur < cnt
    head_tick = torch.where(
        live, cursor_select(rst["arr_tick"], cur), REPLAY_NEVER
    )
    head_op = cursor_select(rst["arr_op"], cur)
    head_arg = cursor_select(rst["arr_arg"], cur)
    # padding rows hold REPLAY_NEVER ticks, so the due compare alone
    # excludes them; the >= cursor mask excludes consumed rows
    due = (rows[None, :] >= cur[:, None]) & (rst["arr_tick"] <= tick)
    pending = torch.sum(due, dim=1, dtype=torch.int32)
    left = torch.clamp(cnt - cur, min=0)
    return head_tick, head_op, head_arg, pending, left


def next_arrival_term(rst: dict, run_mask, nt):
    """The replay term of the event-horizon min: the earliest unreached
    arrival tick of any running lane, at least ``nt`` (REPLAY_NEVER when
    there is none). The jump then never passes a scheduled request."""
    cur = rst["cursor"]
    live = cur < rst["arr_cnt"]
    head = torch.where(
        live, cursor_select(rst["arr_tick"], cur), REPLAY_NEVER
    )
    return torch.amin(
        torch.where(
            run_mask & (head < REPLAY_NEVER), torch.maximum(head, nt),
            REPLAY_NEVER,
        )
    )
