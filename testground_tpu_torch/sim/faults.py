"""The fault-schedule plane: ``[faults]`` compiled to tensors.

Counterpart of ``testground_tpu/sim/faults.py``. The composition's
ordered timeline (partition / heal / degrade / kill / restart,
sim/tables.py ``Faults``) compiles on the host, in numpy, into:

- **window rows**: each partition[+heal] and degrade event becomes one
  directional row a direction (a symmetric pair gives two). The row
  structure (kind, source group, destination group) is static; the
  numerics (start and end tick, latency and jitter ticks, loss fraction)
  are ``[E]`` leaves of the state under ``state["faults"]``, as in JAX;
- **per-instance schedules**: each ``kill`` draws a seed-keyed victim
  set (``np.random.default_rng((seed, 0xFA17, i))``, the JAX draw) into
  a ``kill_tick [N]`` merged with the churn schedule; each ``restart``
  stamps ``restart_tick [N]``, a state leaf cleared at the rejoin.

In the tick the window rows become a per-lane overlay on the plan's
shaping (:class:`Overlay`): a partition masks ``transmits`` (DROP
semantics), degrade latency and jitter add to the sender's link row,
degrade loss combines as ``1 - (1-p_link)(1-p_fault)``.

An absent or empty ``[faults]`` table compiles to no plan at all, so a
fault-free program builds the same state and runs the same ops.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from .tables import Faults

# window-row kinds (static per row)
W_BLOCK = 0
W_DEGRADE = 1

# an open partition (no heal) ends at the int32 horizon
NEVER_ENDS = 2**31 - 1


class FaultError(ValueError):
    """A fault schedule that cannot compile against this composition."""


def _resolve(v, params: dict, tag: str) -> float:
    """A numeric field or a ``"$param"`` reference → float."""
    if isinstance(v, str):
        if not v.startswith("$"):
            raise FaultError(f"{tag}: expected a number or '$param', got {v!r}")
        name = v[1:]
        if params is None or name not in params:
            raise FaultError(
                f"{tag}: references ${name} but no test param {name!r} is "
                "set (define it in test_params or a [sweep.params] grid)"
            )
        try:
            return float(params[name])
        except (TypeError, ValueError):
            raise FaultError(
                f"{tag}: test param {name!r}={params[name]!r} is not numeric"
            )
    if v is None:
        return 0.0
    return float(v)


@dataclass
class FaultPlan:
    """A compiled schedule: static row structure (``win_kind/src/dst``,
    group index, -1 = any group) and the numeric tensors that ride in
    the state (:meth:`dynamic_leaves`)."""

    win_kind: tuple = ()
    win_src: tuple = ()
    win_dst: tuple = ()
    win_start: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    win_end: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    win_lat: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    win_jit: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    win_loss: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    # per-instance schedules [N]; -1 = never
    kill_tick: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    restart_tick: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int32)
    )
    # realized timeline (resolved ticks, victim ids) for a run's journal
    timeline: list = field(default_factory=list)
    # the shaping capabilities the schedule's degrade events may use
    # (sorted (name, bool) pairs; a $param magnitude counts as nonzero)
    shaping: tuple = ()
    # the schedule has restart events
    restart_events: bool = False

    @property
    def has_windows(self) -> bool:
        return len(self.win_kind) > 0

    @property
    def has_kills(self) -> bool:
        return bool((self.kill_tick >= 0).any())

    @property
    def has_restarts(self) -> bool:
        return self.restart_events

    def shaping_needs(self) -> dict:
        """The NetSpec capabilities the degrade events may exercise: the
        executor forces them on, so the registers and draws the overlay
        adds to exist even when the plan never shapes."""
        return dict(self.shaping)

    def structure(self) -> tuple:
        """Program-shaping identity: scenarios batched into one sweep
        must agree on it (sim/sweep.py fingerprint)."""
        return (
            self.win_kind, self.win_src, self.win_dst,
            self.kill_tick.shape, self.restart_events, self.shaping,
        )

    def padded_to(self, n: int) -> "FaultPlan":
        """This plan with its [N] schedules -1-padded to ``n`` rows
        (padding rows belong to no group, so they are never victims)."""
        cur = self.kill_tick.shape[0]
        if n == cur:
            return self
        if n < cur:
            raise ValueError(
                f"fault plan compiled for {cur} instances cannot shrink "
                f"to {n}"
            )
        pad = ((0, n - cur),)
        return dataclasses.replace(
            self,
            kill_tick=np.pad(self.kill_tick, pad, constant_values=-1),
            restart_tick=np.pad(
                self.restart_tick, pad, constant_values=-1
            ),
        )

    def dynamic_leaves(self) -> dict:
        """The numeric arrays that ride in the state: the window rows'
        numerics (read-only) and ``restart_tick`` (cleared at rejoin)."""
        out = {}
        if self.has_windows:
            out["win_start"] = self.win_start
            out["win_end"] = self.win_end
            out["win_lat"] = self.win_lat
            out["win_jit"] = self.win_jit
            out["win_loss"] = self.win_loss
        if self.has_restarts:
            out["restart_tick"] = self.restart_tick
        return out


def _merged_params(groups) -> dict:
    """One name→value view over all groups' test params; a name with
    conflicting values across groups is rejected (the schedule is
    global)."""
    out: dict = {}
    for g in groups:
        for k, v in (g.parameters or {}).items():
            if k in out and out[k] != v:
                raise FaultError(
                    f"faults: test param {k!r} differs across groups "
                    f"({out[k]!r} vs {v!r}); $param references need one "
                    "global value"
                )
            out[k] = v
    return out


def compile_faults(faults, ctx, cfg, params: Optional[dict] = None):
    """Compile a fault schedule (sim/tables.py ``Faults`` or its dict
    form) against a BuildContext, with ``cfg``'s quantum and seed;
    ``params`` resolves ``$param`` references (default: the groups'
    test params). Returns a :class:`FaultPlan`, or None for an empty
    schedule."""
    if faults is None:
        return None
    if isinstance(faults, dict):
        faults = Faults.from_dict(faults)
    if not faults.events:
        return None
    faults.validate(group_ids={g.id for g in ctx.groups})
    if params is None:
        params = _merged_params(ctx.groups)

    n = ctx.padded_n
    q = cfg.quantum_ms
    gidx = {g.id: g.index for g in ctx.groups}
    group_ids = ctx.group_ids  # [padded_n], -1 padding

    def tick_of(ms: float) -> int:
        return max(0, int(ms / q))

    def gi(name: str) -> int:
        return -1 if name == "*" else gidx[name]

    kinds: list[int] = []
    srcs: list[int] = []
    dsts: list[int] = []
    starts: list[int] = []
    ends: list[int] = []
    lats: list[float] = []
    jits: list[float] = []
    losses: list[float] = []
    kill_tick = np.full(n, -1, np.int32)
    restart_tick = np.full(n, -1, np.int32)
    open_parts: dict = {}  # unordered pair -> list of row lists
    timeline: list = []

    def add_rows(kind, a, b, t0, t1, lat=0.0, jit=0.0, loss=0.0):
        """One symmetric event → directional rows (a→b and b→a; one row
        when the directions coincide)."""
        pairs = [(gi(a), gi(b))]
        if gi(a) != gi(b):
            pairs.append((gi(b), gi(a)))
        rows = []
        for s, d in pairs:
            rows.append(len(kinds))
            kinds.append(kind)
            srcs.append(s)
            dsts.append(d)
            starts.append(t0)
            ends.append(t1)
            lats.append(lat)
            jits.append(jit)
            losses.append(loss)
        return rows

    for i, ev in enumerate(faults.events):
        tag = f"faults.events[{i}] ({ev.kind})"
        at = tick_of(_resolve(ev.at_ms, params, f"{tag}.at_ms"))
        if ev.kind == "partition":
            rows = add_rows(W_BLOCK, ev.a, ev.b, at, NEVER_ENDS)
            open_parts.setdefault(tuple(sorted((ev.a, ev.b))), []).append(rows)
            timeline.append(
                {"kind": "partition", "tick": at, "a": ev.a, "b": ev.b}
            )
        elif ev.kind == "heal":
            pair = tuple(sorted((ev.a, ev.b)))
            stack = open_parts.get(pair) or []
            if not stack:
                raise FaultError(f"{tag}: no open partition {pair} to heal")
            rows = stack.pop(0)
            for r in rows:
                if at <= starts[r]:
                    raise FaultError(
                        f"{tag}: heal at tick {at} does not follow its "
                        f"partition (tick {starts[r]})"
                    )
                ends[r] = at
            timeline.append({"kind": "heal", "tick": at, "a": ev.a, "b": ev.b})
        elif ev.kind == "degrade":
            until = tick_of(_resolve(ev.until_ms, params, f"{tag}.until_ms"))
            lat = _resolve(ev.latency_ms, params, f"{tag}.latency_ms")
            jit = _resolve(ev.jitter_ms, params, f"{tag}.jitter_ms")
            loss = _resolve(ev.loss_pct, params, f"{tag}.loss_pct")
            if until <= at:
                raise FaultError(
                    f"{tag}: window [{at}, {until}) is empty or inverted"
                )
            if not 0 <= loss <= 100:
                raise FaultError(f"{tag}: loss_pct {loss} outside [0, 100]")
            if lat < 0 or jit < 0:
                raise FaultError(f"{tag}: negative latency/jitter")
            add_rows(
                W_DEGRADE, ev.a, ev.b, at, until,
                lat=lat / q, jit=jit / q, loss=loss / 100.0,
            )
            timeline.append(
                {
                    "kind": "degrade", "tick": at, "until_tick": until,
                    "a": ev.a, "b": ev.b, "latency_ms": lat,
                    "jitter_ms": jit, "loss_pct": loss,
                }
            )
        elif ev.kind == "kill":
            members = np.nonzero(group_ids == gidx[ev.group])[0]
            if ev.count:
                k = min(int(ev.count), members.size)
            else:
                frac = _resolve(ev.fraction, params, f"{tag}.fraction")
                if not 0 <= frac <= 1:
                    raise FaultError(
                        f"{tag}: fraction {frac} outside (0, 1]"
                    )
                k = int(round(frac * members.size))
            # the victim draw is keyed per event, apart from churn's
            rng = np.random.default_rng((int(cfg.seed), 0xFA17, i))
            victims = np.sort(rng.choice(members, size=k, replace=False))
            prior = kill_tick[victims]
            kill_tick[victims] = np.where(
                (prior >= 0) & (prior <= at), prior, at
            ).astype(np.int32)
            timeline.append(
                {
                    "kind": "kill", "tick": at, "group": ev.group,
                    "n_victims": int(k),
                    "victims": victims[:20].tolist(),
                }
            )
        elif ev.kind == "restart":
            in_group = group_ids == gidx[ev.group]
            # every fault victim of the group killed before the restart
            # rejoins (the first restart wins)
            sel = (
                in_group
                & (kill_tick >= 0)
                & (kill_tick < at)
                & (restart_tick < 0)
            )
            # a kill resolved at or after the restart restarts nobody: an
            # inverted schedule, not a no-op
            late = in_group & (kill_tick >= at)
            if not sel.any() and late.any():
                raise FaultError(
                    f"{tag}: restart at tick {at} precedes the group's "
                    f"kill (earliest victim tick "
                    f"{int(kill_tick[late].min())}) — an inverted "
                    "kill/restart order restarts nobody"
                )
            restart_tick[sel] = at
            timeline.append(
                {
                    "kind": "restart", "tick": at, "group": ev.group,
                    "n_restarted": int(sel.sum()),
                    "restarted": np.nonzero(sel)[0][:20].tolist(),
                }
            )

    # shaping capabilities come from the schedule, not resolved values
    def may_shape(v):
        return isinstance(v, str) or bool(v)

    shaping = {"uses_latency": False, "uses_jitter": False,
               "uses_loss": False}
    restart_events = False
    for ev in faults.events:
        if ev.kind == "degrade":
            shaping["uses_latency"] |= may_shape(ev.latency_ms)
            shaping["uses_jitter"] |= may_shape(ev.jitter_ms)
            shaping["uses_loss"] |= may_shape(ev.loss_pct)
        elif ev.kind == "restart":
            restart_events = True

    return FaultPlan(
        win_kind=tuple(kinds),
        win_src=tuple(srcs),
        win_dst=tuple(dsts),
        win_start=np.asarray(starts, np.int32),
        win_end=np.asarray(ends, np.int32),
        win_lat=np.asarray(lats, np.float32),
        win_jit=np.asarray(jits, np.float32),
        win_loss=np.asarray(losses, np.float32),
        kill_tick=kill_tick,
        restart_tick=restart_tick,
        timeline=timeline,
        shaping=tuple(sorted(shaping.items())),
        restart_events=restart_events,
    )


def next_boundary(ft: dict, nt):
    """Earliest fault-window boundary (start or end) at a tick >= ``nt``,
    from the window leaves in the state: the fault term of the
    event-horizon min. ``NEVER_ENDS`` when none remains (an unhealed
    partition's end never reads as an event). int32."""
    ws, we = ft["win_start"], ft["win_end"]
    return torch.minimum(
        torch.min(torch.where(ws >= nt, ws, NEVER_ENDS)),
        torch.min(torch.where((we >= nt) & (we < NEVER_ENDS), we,
                              NEVER_ENDS)),
    )


def fma_f32(a, b, c):
    """``a * b + c`` for float32 ``a``, ``b`` with one rounding, as a
    fused multiply-add gives it (XLA's CPU backend contracts a multiply
    into the add that consumes it inside a fusion). The product is exact
    in float64; TwoSum gives the float64 sum's rounding error, and the
    one case where rounding that sum to float32 is not the correct
    rounding (the sum lands on a float32 midpoint and the error is not
    0) moves to the neighbour the error points at. Exact on every
    device."""
    p = a.double() * b.double()
    # a Python number stays one: a tensor made of it would be copied from
    # the host, which a CUDA-graph capture refuses
    cd = c.double() if isinstance(c, torch.Tensor) else float(c)
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    r = s.float()
    inf = torch.full_like(r, float("inf"))
    hi, lo = torch.nextafter(r, inf), torch.nextafter(r, -inf)
    rd = r.double()
    r = torch.where((s == (rd + hi.double()) * 0.5) & (err > 0), hi, r)
    return torch.where((s == (rd + lo.double()) * 0.5) & (err < 0), lo, r)


class Overlay:
    """The per-lane fault overlay of one tick's sends, built once for a
    plan with window rows (its static row structure as device tensors).

    Calling it gives a dict for ``net.deliver``: ``block`` [N] bool (a
    partition row matches my group and my dest's group), ``lat``/``jit``
    [N] f32 ticks (the max over matching degrade rows), ``loss`` [N] f32
    (``1 - prod(1 - p)`` over matching rows) and, with ``want_rev``,
    ``rev_lat`` (degrade latency of the reverse direction, added to the
    handshake ACK's return leg). JAX reduces the ``[E, N]`` loss product
    with ``jnp.prod`` over the window axis, which XLA runs in row order
    from 1.0; the port multiplies the rows in that order, one at a
    time."""

    def __init__(self, plan: FaultPlan, device, want_rev: bool = False):
        self.n_rows = len(plan.win_kind)
        kinds = np.asarray(plan.win_kind)
        self.any_block = bool((kinds == W_BLOCK).any())
        self.all_block = bool((kinds == W_BLOCK).all())
        self.want_rev = want_rev

        def col(v, dtype):
            return torch.as_tensor(np.asarray(v), dtype=dtype,
                                   device=device)[:, None]

        self.src_g = col(plan.win_src, torch.int32)  # [E, 1]
        self.dst_g = col(plan.win_dst, torch.int32)
        self.is_block = col(kinds == W_BLOCK, torch.bool)

    @staticmethod
    def _match(g, grp):
        # g < 0 wildcards a side
        return (g < 0) | (grp[None, :] == g)

    def __call__(self, ft: dict, tick, group_ids, send_dest) -> dict:
        n = send_dest.shape[0]
        dest_c = torch.clamp(send_dest, 0, n - 1)
        sgrp = group_ids
        dgrp = group_ids[dest_c]
        active = ((tick >= ft["win_start"]) & (tick < ft["win_end"]))[:, None]
        m = (active & self._match(self.src_g, sgrp)
             & self._match(self.dst_g, dgrp))  # [E, N]
        out: dict[str, Any] = {}
        if self.any_block:
            out["block"] = torch.any(m & self.is_block, dim=0)
        if self.all_block:
            return out
        m_deg = m & ~self.is_block
        lat_e = ft["win_lat"][:, None]
        out["lat"] = torch.clamp(
            torch.amax(torch.where(m_deg, lat_e, 0.0), dim=0), min=0.0)
        out["jit"] = torch.clamp(
            torch.amax(torch.where(m_deg, ft["win_jit"][:, None], 0.0),
                       dim=0), min=0.0)
        keep = torch.where(m_deg, 1.0 - ft["win_loss"][:, None], 1.0)
        # XLA on the CPU runs the product in row order and contracts its
        # last multiply into the `1 -` that follows (one rounding)
        pass1m = torch.ones_like(keep[0])
        for e in range(self.n_rows - 1):
            pass1m = pass1m * keep[e]
        out["loss"] = fma_f32(-pass1m, keep[-1], 1.0)
        if self.want_rev:
            rm = (active & ~self.is_block & self._match(self.src_g, dgrp)
                  & self._match(self.dst_g, sgrp))
            out["rev_lat"] = torch.clamp(
                torch.amax(torch.where(rm, lat_e, 0.0), dim=0), min=0.0)
        return out
