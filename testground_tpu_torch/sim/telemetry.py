"""The telemetry plane: sampled counters, gauges and histograms in the
state.

Counterpart of ``testground_tpu/sim/telemetry.py``. Under
``state["telem"]``:

  ``lane_buf  [N, S_cap, K]``  f32   per-lane samples, a row a boundary
                                     (K = the selected lane probes,
                                     counters then gauges)
  ``glob_buf  [S_cap, KG]``    f32   global gauges
  ``acc_<probe>  [N]``         i32   this interval's counter accumulators
  ``gauge_reg    [N]``         f32   the user gauge register
  ``hist  [N, H, B]``          i32   log2 user histograms
  ``cnt`` / ``clipped``        i32   samples taken / boundaries lost to a
                                     full buffer

Boundary ticks are ``t ≡ interval-1 (mod interval)``: sample *s* covers
ticks ``[s·interval, (s+1)·interval)``. ``S_cap = ceil(max_ticks /
interval)``. The sample boundary is a term of the event-horizon min, so
a skipped run samples as the dense one does. An absent or disabled
``[telemetry]`` table builds no accumulator at all.
"""

from __future__ import annotations

import difflib
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .tables import Telemetry

# ---------------------------------------------------------------- catalog

# lane counters: accumulated over the interval, reset at each boundary
LANE_COUNTERS = (
    "net_sends",  # sends reaching the link attempt (sender lane)
    "net_delivers",  # arrivals (receiver lane; count mode: wheel drain)
    "net_drops",  # dropped sends, all causes
    "net_drops_partition",  # a [faults] window blocked the send
    "net_drops_loss",  # link or degrade loss
    "net_drops_churn",  # destination host dead
    "net_drops_queue_full",  # egress or inbox queue overflow
    "net_drops_filter",  # REJECT/DROP filter rule
    "net_drops_disabled",  # sender's own link down
    "sync_signals",  # signal_entry ops
    "sync_publishes",  # topic publishes
    "lane_wakes",  # lanes waking from a sleep this interval
    "user_count",  # PhaseCtrl(count_add=...) / ProgramBuilder.count()
)
# lane gauges: snapshotted at the boundary
LANE_GAUGES = (
    "inbox_depth",  # entry mode: unread ring entries; count mode: avail
    "user_gauge",  # the PhaseCtrl(gauge_set/gauge_value) register
)
# global gauges: one value a sample
GLOBAL_GAUGES = (
    "live_lanes",  # RUNNING instances at the boundary
    "blocked_frac",  # fraction of RUNNING instances that are sleeping
    "wheel_occ",  # count-mode delay-wheel occupancy (or staging count)
)

ALL_PROBES = LANE_COUNTERS + LANE_GAUGES + GLOBAL_GAUGES

# bound on the sample axis
MAX_SAMPLES = 65_536


class TelemetryError(ValueError):
    """A [telemetry] table that cannot compile against this program."""


def _probe_applicable(name: str, net_spec, has_fault_windows: bool) -> bool:
    """Whether a catalog probe can record anything on this program (the
    default, empty ``probes`` selection keeps exactly these)."""
    if name in (
        "sync_signals", "sync_publishes", "lane_wakes", "user_count",
        "user_gauge", "live_lanes", "blocked_frac",
    ):
        return True
    if net_spec is None:
        return False
    if name == "net_drops_partition":
        return has_fault_windows
    if name == "net_drops_loss":
        return bool(net_spec.uses_loss)
    if name == "net_drops_filter":
        return bool(net_spec.use_pair_rules or net_spec.use_class_rules)
    if name == "wheel_occ":
        return not net_spec.store_entries
    return True


@dataclass(frozen=True)
class TelemetrySpec:
    """Compiled telemetry statics: the selected lane counters and gauges
    (catalog order; together the K axis of ``lane_buf``), the global
    gauges, the user histograms and their declared widths (``n_buckets``
    is the widest, the storage width)."""

    interval: int
    s_cap: int
    counters: tuple = ()
    gauges: tuple = ()
    glob: tuple = ()
    hist_names: tuple = ()
    n_buckets: int = 24
    hist_buckets: tuple = ()

    @property
    def k_lane(self) -> int:
        return len(self.counters) + len(self.gauges)

    @property
    def lane_probes(self) -> tuple:
        return self.counters + self.gauges

    @property
    def n_hist(self) -> int:
        return len(self.hist_names)

    @property
    def hist_widths(self) -> tuple:
        """Per-histogram declared bucket counts (the storage width for
        every histogram of a spec built without ``hist_buckets``)."""
        if self.hist_buckets:
            return self.hist_buckets
        return (self.n_buckets,) * self.n_hist

    def structure(self) -> tuple:
        """Program-shaping identity (sim/sweep.py fingerprint)."""
        return (
            self.interval, self.s_cap, self.counters, self.gauges,
            self.glob, self.hist_names, self.n_buckets,
            self.hist_buckets,
        )


def compile_telemetry(
    telem, ctx, net_spec, cfg, has_fault_windows: bool = False,
) -> Optional[TelemetrySpec]:
    """Compile a ``[telemetry]`` table (sim/tables.py ``Telemetry`` or
    its dict form) against the program's statics; None when absent or
    disabled."""
    if telem is None:
        return None
    if isinstance(telem, TelemetrySpec):
        return telem
    if isinstance(telem, dict):
        telem = Telemetry.from_dict(telem)
    if not getattr(telem, "enabled", True):
        return None
    interval = int(telem.interval)
    if interval < 1:
        raise TelemetryError(
            f"telemetry.interval must be >= 1 tick, got {interval}"
        )
    s_cap_full = max(1, math.ceil(cfg.max_ticks / interval))
    samples = int(getattr(telem, "samples", 0) or 0)
    drain = bool(getattr(telem, "drain", False))
    if samples:
        # without a drain an undersized buffer loses data: a build error
        if not drain and samples < s_cap_full:
            raise TelemetryError(
                f"telemetry.samples={samples} is smaller than the "
                f"{s_cap_full} rows max_ticks={cfg.max_ticks} needs at "
                f"interval={interval}, and the table does not drain — "
                "the overflow would be lost, not streamed. Set "
                "[telemetry] drain = true (docs/observability.md "
                '"Streaming drains") or drop the samples knob.'
            )
        s_cap = min(s_cap_full, samples)
    else:
        s_cap = s_cap_full
        if s_cap > MAX_SAMPLES:
            raise TelemetryError(
                f"telemetry.interval={interval} over "
                f"max_ticks={cfg.max_ticks} needs {s_cap} sample rows, "
                f"above the {MAX_SAMPLES} bound — raise the interval "
                "(the buffer is [N, samples, K] device state), or set "
                "[telemetry] drain = true with a fixed samples depth "
                "(the buffer then bounds one chunk, not the run)"
            )
    if s_cap > MAX_SAMPLES:
        raise TelemetryError(
            f"telemetry.samples={samples} exceeds the {MAX_SAMPLES} "
            "bound"
        )
    if telem.probes:
        selected = set()
        for p in telem.probes:
            if p not in ALL_PROBES:
                close = difflib.get_close_matches(str(p), ALL_PROBES, n=1)
                raise TelemetryError(
                    f"telemetry.probes: unknown probe {p!r}"
                    + (f" (did you mean {close[0]!r}?)" if close else "")
                    + f"; known: {sorted(ALL_PROBES)}"
                )
            if not _probe_applicable(p, net_spec, has_fault_windows):
                # a net probe without a data plane, or wheel_occ on the
                # entry-mode inbox, can never record: a build error
                if net_spec is None or p == "wheel_occ":
                    raise TelemetryError(
                        f"telemetry.probes: {p!r} cannot record anything "
                        "on this program "
                        + (
                            "(the plan never enables the network data "
                            "plane)"
                            if net_spec is None
                            else "(the entry-mode inbox has no delay "
                            "wheel — sample inbox_depth instead)"
                        )
                    )
                # a capability the composition did not compile in (a
                # partition-drop column without windows): the column
                # is elided
                continue
            selected.add(p)
    else:
        selected = {
            p for p in ALL_PROBES
            if _probe_applicable(p, net_spec, has_fault_windows)
        }
    hist_names = tuple(h.name for h in telem.histograms)
    hist_buckets = tuple(int(h.buckets) for h in telem.histograms)
    return TelemetrySpec(
        interval=interval,
        s_cap=s_cap,
        counters=tuple(p for p in LANE_COUNTERS if p in selected),
        gauges=tuple(p for p in LANE_GAUGES if p in selected),
        glob=tuple(p for p in GLOBAL_GAUGES if p in selected),
        hist_names=hist_names,
        n_buckets=max(hist_buckets, default=24),
        hist_buckets=hist_buckets,
    )


def init_telemetry_state(n: int, spec: TelemetrySpec, device) -> dict:
    i32, f32 = torch.int32, torch.float32

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    st: dict = {"cnt": z((), i32), "clipped": z((), i32)}
    if spec.k_lane:
        st["lane_buf"] = z((n, spec.s_cap, spec.k_lane), f32)
    if spec.glob:
        st["glob_buf"] = z((spec.s_cap, len(spec.glob)), f32)
    for c in spec.counters:
        st[f"acc_{c}"] = z(n, i32)
    if "user_gauge" in spec.gauges:
        st["gauge_reg"] = z(n, f32)
    if spec.n_hist:
        st["hist"] = z((n, spec.n_hist, spec.n_buckets), i32)
    return st


def bucket_thresholds(n_buckets: int) -> np.ndarray:
    """The f32 thresholds ``exp2(1..n_buckets-1)`` of the log2 buckets,
    as the JAX package computes them: ``jnp.exp2`` lowers to
    ``exp(f32(ln 2) * k)``, which XLA on the CPU rounds from the exact
    exponential of that f32 product. They are not exact powers of two
    (from 2^13 on some miss by a few ulp), so the port uses this table,
    not ``2.0 ** k``."""
    k = np.arange(1, n_buckets, dtype=np.float32)
    x = np.float32(np.log(2.0)) * k
    return np.array([math.exp(float(v)) for v in x], np.float32)


def bucket_of(val, thresholds):
    """Log2 bucket index: the count of ``thresholds``
    (:func:`bucket_thresholds`, a device tensor) at or below ``val``.
    Bucket 0 holds values below 2, the last bucket the tail."""
    v = val.to(torch.float32)
    return torch.sum((v[..., None] >= thresholds).to(torch.int32), dim=-1,
                     dtype=torch.int32)


class TelemetryAccum:
    """One tick's accumulation helper: holds the ``telem`` leaves through
    the tick's hook sites (:attr:`state`); the tick applies the boundary
    at its end. A probe the spec does not carry records nothing.
    ``fused`` mirrors ``SimConfig.fused_observers``: the net sites read
    it to fold the per-cause drops into one ``net_drops`` union add.
    ``consts`` holds the build-time tensors :meth:`observe` needs
    (``thresholds``, ``widths``)."""

    def __init__(self, spec: TelemetrySpec, state: dict, n: int,
                 fused: bool = True, consts: Optional[dict] = None) -> None:
        self.spec = spec
        self.state = dict(state)
        self.n = n
        self.fused = fused
        self.consts = consts or {}

    def count(self, probe: str, amount) -> None:
        """Add ``amount`` ([N] bool mask or int32 counts) to a lane
        counter's interval accumulator."""
        if probe not in self.spec.counters:
            return
        key = f"acc_{probe}"
        self.state[key] = self.state[key] + amount.to(torch.int32).expand(
            self.n)

    def drop(self, cause_probe: str, amount) -> None:
        """A dropped send: the per-cause column and the ``net_drops``
        total (either may be deselected)."""
        self.count("net_drops", amount)
        self.count(cause_probe, amount)

    def observe(self, hist_ids, values) -> None:
        """One observation a lane into the log2 histograms: ``hist_ids``
        [N] int32 (-1 = none; out of range ids drop), ``values`` [N]
        f32. Each histogram clamps the tail into its own last bucket."""
        if not self.spec.n_hist:
            return
        H, B = self.spec.n_hist, self.spec.n_buckets
        dev = hist_ids.device
        valid = (hist_ids >= 0) & (hist_ids < H)
        limit = self.consts["widths"][torch.clamp(hist_ids, 0, H - 1)]
        b = torch.minimum(bucket_of(values, self.consts["thresholds"]),
                          limit - 1)
        upd = (
            valid[:, None, None]
            & (torch.arange(H, device=dev)[None, :, None]
               == hist_ids[:, None, None])
            & (torch.arange(B, device=dev)[None, None, :] == b[:, None, None])
        )
        self.state["hist"] = self.state["hist"] + upd.to(torch.int32)

    def set_gauge(self, set_mask, values) -> None:
        """Latch the user gauge register where ``set_mask`` > 0."""
        if "gauge_reg" not in self.state:
            return
        self.state["gauge_reg"] = torch.where(
            set_mask > 0, values.to(torch.float32), self.state["gauge_reg"])


def accum_consts(spec: TelemetrySpec, device) -> dict:
    """The build-time tensors of :meth:`TelemetryAccum.observe`."""
    if not spec.n_hist:
        return {}
    return {
        "thresholds": torch.as_tensor(bucket_thresholds(spec.n_buckets),
                                      device=device),
        "widths": torch.as_tensor(np.asarray(spec.hist_widths, np.int32),
                                  device=device),
    }


def apply_boundary(spec: TelemetrySpec, tstate: dict, tick,
                   lane_gauges: dict, glob_gauges: dict) -> dict:
    """The end of a tick: on a boundary tick the interval's counters
    and the boundary gauges go into sample row ``cnt`` and the counters
    reset; with the buffer full the boundary counts in ``clipped`` (its
    counts are still reset: lost, not deferred). A dense one-hot select
    over the sample axis."""
    dev = tstate["cnt"].device
    boundary = torch.remainder(tick + 1, spec.interval) == 0
    cnt = tstate["cnt"]
    ok = boundary & (cnt < spec.s_cap)
    out = dict(tstate)
    slot = (
        torch.arange(spec.s_cap, dtype=torch.int32, device=dev)
        == torch.clamp(cnt, max=spec.s_cap - 1)
    ) & ok
    if spec.k_lane:
        cols = [tstate[f"acc_{c}"].to(torch.float32) for c in spec.counters]
        cols += [lane_gauges[g].to(torch.float32) for g in spec.gauges]
        row = torch.stack(cols, dim=-1)  # [N, K]
        out["lane_buf"] = torch.where(slot[None, :, None], row[:, None, :],
                                      tstate["lane_buf"])
    if spec.glob:
        grow = torch.stack(
            [glob_gauges[g].to(torch.float32) for g in spec.glob])  # [KG]
        out["glob_buf"] = torch.where(slot[:, None], grow[None, :],
                                      tstate["glob_buf"])
    out["cnt"] = cnt + ok.to(torch.int32)
    out["clipped"] = tstate["clipped"] + (
        boundary & (cnt >= spec.s_cap)).to(torch.int32)
    for c in spec.counters:
        key = f"acc_{c}"
        out[key] = torch.where(boundary, 0, tstate[key])
    return out


def next_boundary_tick(spec: TelemetrySpec, nt):
    """Earliest sample-boundary tick >= ``nt``: the telemetry term of the
    event-horizon min (a boundary writes a sample row)."""
    iv = spec.interval
    return nt + torch.remainder((iv - 1) - nt, iv)


# ---------------------------------------------------------------- demux


def hist_bounds(b: int) -> tuple[float, float]:
    """The value range [lo, hi) a log2 bucket covers."""
    lo = 0.0 if b == 0 else float(2**b)
    return lo, float(2 ** (b + 1))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def telemetry_records(
    state: dict,
    spec: TelemetrySpec,
    ctx,
    quantum_ms: float,
    n_instances: Optional[int] = None,
    sample_base: int = 0,
    include_samples: bool = True,
    include_hist: bool = True,
) -> tuple[list[dict], list[dict]]:
    """A final state's samples in the ``results.out`` record format:
    ``(lane_records, global_records)``. Lane records: one a nonzero
    (lane, sample, probe) cell, then one a nonzero histogram bucket,
    tagged by instance and group; global records: every sample of every
    global gauge. Sample *s* is stamped at its interval's end,
    ``(sample_base + s + 1)·interval·quantum_ms`` in seconds."""
    ts = state.get("telem", state)
    cnt = min(int(_np(ts["cnt"])), spec.s_cap)
    if not include_samples:
        cnt = 0
    n = n_instances if n_instances is not None else ctx.n_instances
    group_of = {g.index: g.id for g in ctx.groups}
    gids = np.asarray(ctx.group_ids)
    q_s = float(quantum_ms) / 1e3

    lane_recs: list[dict] = []
    glob_recs: list[dict] = []

    def t_of(s: int) -> float:
        return (sample_base + s + 1) * spec.interval * q_s

    def groups_of(lanes):
        return [group_of.get(g, "") for g in gids[lanes].tolist()]

    # the cells as Python lists: a 1,024-lane run samples ~57k of them
    if spec.k_lane and cnt and "lane_buf" in ts:
        buf = _np(ts["lane_buf"])[:n, :cnt, :]
        for k, probe in enumerate(spec.lane_probes):
            col = buf[:, :, k]
            lanes, samples = np.nonzero(col)
            name = f"telemetry.{probe}"
            for i, g, s, v in zip(lanes.tolist(), groups_of(lanes),
                                  samples.tolist(),
                                  col[lanes, samples].astype(
                                      np.float64).tolist()):
                lane_recs.append(
                    {
                        "instance": i,
                        "group": g,
                        "name": name,
                        "virtual_time_s": t_of(s),
                        "value": v,
                    }
                )
    if spec.glob and cnt and "glob_buf" in ts:
        gbuf = _np(ts["glob_buf"])[:cnt, :]
        for k, probe in enumerate(spec.glob):
            for s in range(cnt):
                glob_recs.append(
                    {
                        "instance": "",
                        "group": "",
                        "name": f"telemetry.{probe}",
                        "virtual_time_s": t_of(s),
                        "value": float(gbuf[s, k]),
                    }
                )
    if include_hist and spec.n_hist and "hist" in ts:
        hist = _np(ts["hist"])[:n]
        end_t = float(_np(state.get("tick", 0))) * q_s
        for h, hname in enumerate(spec.hist_names):
            lanes, buckets = np.nonzero(hist[:, h, :])
            name = f"telemetry.hist.{hname}"
            for i, g, b, v in zip(lanes.tolist(), groups_of(lanes),
                                  buckets.tolist(),
                                  hist[lanes, h, buckets].astype(
                                      np.float64).tolist()):
                lane_recs.append(
                    {
                        "instance": i,
                        "group": g,
                        "name": name,
                        "type": "histogram",
                        "bucket": b,
                        "virtual_time_s": end_t,
                        "value": v,
                    }
                )
    return lane_recs, glob_recs
