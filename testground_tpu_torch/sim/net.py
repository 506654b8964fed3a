"""The network data plane: link-state tensors, the per-instance inbox
rings (entry mode) or per-dest counts (count mode), in torch.

Counterpart of ``testground_tpu/sim/net.py``: the net state, the
ConfigureNetwork writes, the record wire contract, the FIFO egress
queue, the loss / rate / jitter / latency / reorder / duplicate /
corrupt shaping (iid or Markov-correlated toxics), both appends into the
inbox rings (the ranked scatter without a queue; the bounded two-level
append, whose ring merge is sim/ring_merge.py, behind one), and the
head cache / visible prefix / consume reads. ``deliver`` runs the
default front, or the deliver-front kernel with
``SimConfig.pallas_front=True``. In count mode (``store_entries``
False) deliveries add ``[count, bytes]`` rows into the fixed-next-tick
staging row or the delay wheel through the ordered scatter-add
(sim/count_scatter.py), and ``advance_wheel`` drains them. Filter rules
(a dense ``[N, N]`` pair matrix, per-class rows, or both; the strictest
action wins) keep a send off the link, and in both modes a dial's SYN
gets its ACK, or its RST from a REJECT rule, in the dialer's handshake
register. The fault plane's overlay (sim/faults.py) blocks, delays and
drops sends in ``deliver``; the trace and telemetry planes record each
send, each drop with its cause, each delivery and each queue overflow
through the ``trace`` and ``telem`` hooks, in the JAX package's order.
Destination-sharded delivery raises ``NotImplementedError``.

Inbox entry layout (NET_HDR + payload floats):
``[visible_tick, src, tag, port, size, payload...]``

Scatter discipline: every scatter here writes UNIQUE slots; rows that
must not land are routed to an explicit drop row past the end, which is
sliced off (torch leaves the winner of repeated indices undefined, so
nothing may depend on it). Float sums into one row go through
sim/count_scatter.py, which adds them in lane order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import count_scatter, prng, ring_merge
from . import trace as tracemod
from .program import TAG_ACK, TAG_RST, TAG_SYN, _not_ported

NET_HDR = 5  # visible, src, tag, port, size
F_VISIBLE, F_SRC, F_TAG, F_PORT, F_SIZE = range(NET_HDR)

# handshake register fields [N, 4]
HS_VIS, HS_SRC, HS_PORT, HS_TAG = range(4)
HS_NONE = 3.0e18  # "no pending reply" visibility sentinel

# filter actions (pair_filter / class_rules entries; -1 in a written row
# leaves the entry unchanged)
ACTION_ACCEPT = 0
ACTION_REJECT = 1
ACTION_DROP = 2

_INT32_MAX = 2**31 - 1


@dataclass
class NetSpec:
    """Static data-plane dimensions (set by the builder); field for field
    the JAX package's NetSpec."""

    inbox_capacity: int = 64
    payload_len: int = 4
    use_pair_rules: bool = False
    use_class_rules: bool = False
    n_classes: int = 8
    head_k: int = 8
    arrival_slots: int = 8
    send_slots: int | None = None
    uses_dials: bool = False
    store_entries: bool = True
    horizon: int = 64
    uses_latency: bool = True
    uses_jitter: bool = True
    uses_rate: bool = True
    uses_loss: bool = True
    uses_corrupt: bool = False
    uses_reorder: bool = False
    uses_duplicate: bool = False
    uses_loss_corr: bool = False
    uses_corrupt_corr: bool = False
    uses_reorder_corr: bool = False
    uses_duplicate_corr: bool = False
    dest_sharded: bool = False
    a2a_slots: int | None = None
    track_occupancy: bool = False
    # route the deliver front through the hand-written kernel
    # (sim/deliver_front.py); set by the executor
    pallas_front: bool = False

    @property
    def width(self) -> int:
        return NET_HDR + self.payload_len

    @property
    def fixed_next_tick(self) -> bool:
        """True when every delivery is visible exactly next tick (no
        latency, jitter or rate anywhere in the program): count mode then
        keeps one [N, 2] staging row in place of the delay wheel."""
        return not (self.uses_latency or self.uses_jitter or self.uses_rate)


def check_supported(spec: NetSpec) -> None:
    """Raise for the data-plane features the port does not run yet."""
    if spec.dest_sharded:
        raise _not_ported("dest_sharded delivery (all_to_all)", 12,
                          "multi-GPU")


def init_net_state(n: int, spec: NetSpec, device) -> dict:
    """The net leaves of the state dict: names, shapes and dtypes of the
    JAX package's init_net_state."""
    check_supported(spec)
    i32, f32 = torch.int32, torch.float32

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    st = {
        "inbox_dropped": z(n, i32),
        "net_enabled": torch.ones(n, dtype=i32, device=device),
    }
    if spec.uses_dials:
        # handshake registers: [visible, src (dialee), port, tag]
        st["hs"] = torch.tensor([HS_NONE, -1.0, 0.0, 0.0], dtype=f32,
                                device=device).repeat(n, 1)
    if spec.store_entries:
        st["inbox"] = z((n, spec.inbox_capacity, spec.width), f32)
        st["inbox_r"] = z(n, i32)
        st["inbox_w"] = z(n, i32)
        st["payload_sanitized"] = z((), i32)
        if spec.send_slots is not None and spec.send_slots < n:
            st["pend_dest"] = torch.full((n,), -1, dtype=i32, device=device)
            st["pend_tick"] = z(n, i32)
            st["pend_tag"] = z(n, i32)
            st["pend_port"] = z(n, i32)
            st["pend_size"] = z(n, f32)
            st["pend_pay"] = z((n, spec.payload_len), f32)
            st["egress_deferred"] = z((), i32)
            st["egress_overflow"] = z((), i32)
            st["egress_abandoned"] = z((), i32)
    else:
        if spec.fixed_next_tick:
            st["staging"] = z((n, 2), f32)
            if spec.track_occupancy:
                st["staging_cnt"] = z((), i32)
        else:
            st["wheel"] = z((spec.horizon, n, 2), f32)
            st["horizon_clamped"] = z(n, i32)
            if spec.track_occupancy:
                st["wheel_occ"] = z(spec.horizon, i32)
        st["avail"] = z(n, i32)
        st["bytes_in"] = z(n, f32)
    if spec.send_slots is not None and not spec.store_entries:
        # count-mode ticks with more data lanes than send_slots (the JAX
        # package's full-scatter fallback)
        st["send_compact_fallback"] = z((), i32)
    for name, flag in (
        ("eg_latency", spec.uses_latency),
        ("eg_jitter", spec.uses_jitter),
        ("eg_rate", spec.uses_rate),
        ("eg_busy", spec.uses_rate),
        ("eg_loss", spec.uses_loss),
        ("eg_corrupt", spec.uses_corrupt),
        ("eg_reorder", spec.uses_reorder),
        ("eg_duplicate", spec.uses_duplicate),
    ):
        if flag:
            st[name] = z(n, f32)
    for name, flag in (
        ("loss", spec.uses_loss_corr),
        ("corrupt", spec.uses_corrupt_corr),
        ("reorder", spec.uses_reorder_corr),
        ("duplicate", spec.uses_duplicate_corr),
    ):
        if flag:
            st[f"eg_{name}_corr"] = z(n, f32)
            st[f"ar_{name}"] = z(n, f32)
    if spec.use_pair_rules:
        st["pair_filter"] = z((n, n), torch.int8)
    if spec.use_class_rules:
        st["class_of"] = z(n, i32)
        st["class_rules"] = z((n, spec.n_classes), torch.int8)
    return st


def recip(c: float) -> float:
    """The float32 reciprocal of a constant divisor. XLA rewrites ``x / c``
    for a constant ``c`` into ``x * (1/c)`` with ``1/c`` rounded to
    float32 (and torch's CUDA division by a scalar does the same), so the
    port divides by a constant as that multiplication, on every device."""
    return float(np.float32(1.0) / np.float32(c))


def apply_net_config(
    net: dict,
    quantum_ms: float,
    set_flag,
    latency_ms,
    jitter_ms,
    bandwidth_bps,
    loss_pct,
    enabled,
    rule_rows=None,
    net_class=None,
    class_rule_rows=None,
    corrupt_pct=0.0,
    reorder_pct=0.0,
    duplicate_pct=0.0,
    loss_corr_pct=0.0,
    corrupt_corr_pct=0.0,
    reorder_corr_pct=0.0,
    duplicate_corr_pct=0.0,
) -> dict:
    """Apply per-instance ConfigureNetwork writes (vectorized over N).
    ``net_class`` [N] (-1 = keep) re-classes a lane whether or not it
    sets its shaping this tick; ``rule_rows`` [N, N] and
    ``class_rule_rows`` [N, C] write their entries >= 0 on lanes that
    set it."""
    on = set_flag > 0
    net = dict(net)
    if net_class is not None and "class_of" in net:
        net["class_of"] = torch.where(net_class >= 0, net_class,
                                      net["class_of"])
    for key, rows in (("class_rules", class_rule_rows),
                      ("pair_filter", rule_rows)):
        if rows is not None and key in net:
            net[key] = torch.where(on[:, None] & (rows >= 0),
                                   rows.to(torch.int8), net[key])
    per_tick, pct = recip(quantum_ms), recip(100.0)
    for key, val in (
        ("eg_latency", lambda: latency_ms * per_tick),
        ("eg_jitter", lambda: jitter_ms * per_tick),
        # bits/sec → bytes/tick
        ("eg_rate",
         lambda: bandwidth_bps * recip(8.0) * float(np.float32(
             quantum_ms / 1e3))),
        ("eg_loss", lambda: loss_pct * pct),
        ("eg_corrupt", lambda: corrupt_pct * pct),
        ("eg_reorder", lambda: reorder_pct * pct),
        ("eg_duplicate", lambda: duplicate_pct * pct),
        ("eg_loss_corr", lambda: loss_corr_pct * pct),
        ("eg_corrupt_corr", lambda: corrupt_corr_pct * pct),
        ("eg_reorder_corr", lambda: reorder_corr_pct * pct),
        ("eg_duplicate_corr", lambda: duplicate_corr_pct * pct),
    ):
        if key in net:
            net[key] = torch.where(on, val(), net[key])
    net["net_enabled"] = torch.where(on, enabled, net["net_enabled"])
    return net


FLT_MIN_NORMAL = 1.1754944e-38  # smallest normal f32


def sanitize_records(rec):
    """The entry-record wire contract, applied once at append: non-finite
    fields clamp to 3e38; denormals and -0.0 flush to +0.0. Returns
    (sanitized rec, clean mask); the mask marks values stored
    unchanged."""
    finite = torch.isfinite(rec)
    tiny = torch.abs(rec) < FLT_MIN_NORMAL
    clean = finite & (~tiny | (rec == 0.0))
    rec = torch.where(finite, rec, 3.0e38)
    rec = torch.where(tiny, 0.0, rec)
    return rec, clean


def sort_rank(safe: torch.Tensor):
    """Deterministic same-id ranking, ordered by lane index: stable sort +
    segment arithmetic (the JAX package's core._sort_rank). Returns
    (order, sorted_ids, rank_sorted)."""
    n = safe.shape[0]
    sorted_ids, order = torch.sort(safe, stable=True)
    idx = torch.arange(n, dtype=torch.int32, device=safe.device)
    is_start = torch.ones_like(sorted_ids, dtype=torch.bool)
    is_start[1:] = sorted_ids[1:] != sorted_ids[:-1]
    seg_start = torch.cummax(
        torch.where(is_start, idx, torch.zeros_like(idx)), dim=0
    ).values
    return order, sorted_ids, idx - seg_start


def nonzero_static(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """``jnp.nonzero(mask, size=size, fill_value=fill)`` without a host
    sync: the first ``size`` set lanes in ascending order, padded with
    ``fill`` (int64 indices)."""
    n = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int64), dim=0) - 1
    keep = mask & (pos < size)
    out = mask.new_full((size + 1,), fill, dtype=torch.int64)
    lanes = torch.arange(n, dtype=torch.int64, device=mask.device)
    out[torch.where(keep, pos, size)] = lanes  # row `size` is the drop row
    return out[:size]


_ADMIT_BUCKETS = 64  # wait buckets of the counting admitters (deliver front)


def _boundary_of(hist, slots):
    """Oldest-first bucket admission over a [B] histogram: buckets above
    b* admit fully, b* partially. Returns (bstar, slots_left_in_bstar)."""
    B = hist.shape[0]
    cum_gt = torch.flip(
        torch.cumsum(torch.flip(hist, (0,)), 0, dtype=torch.int32), (0,)
    ) - hist
    cum_ge = cum_gt + hist
    sat = cum_ge >= slots
    ar = torch.arange(B, dtype=torch.int32, device=hist.device)
    bstar = torch.max(torch.where(sat, ar, torch.full_like(ar, -1)))
    # a gather, not cum_gt[bstar]: indexing by a 0-dim tensor reads it
    # back to the host
    slots_left = slots - cum_gt.gather(
        0, torch.clamp(bstar, min=0).reshape(1).to(torch.int64))[0]
    return bstar, slots_left


_STARVED_WAIT = _ADMIT_BUCKETS * _ADMIT_BUCKETS - 1  # 4095


def wait_of(tick, age):
    """``max(tick - age, 0)`` with the int32 wraparound subtraction of
    the JAX package (an age more than 2**31 ticks back wraps to a
    negative difference, so to a wait of 0)."""
    d = tick.to(torch.int64) - age.to(torch.int64)
    d = torch.where(d > _INT32_MAX, d - 2**32, d)
    d = torch.where(d < -(2**31), d + 2**32, d)
    return torch.clamp(d, min=0).to(torch.int32)


def _sort_admit(key, M, n):
    """``rank < M`` of every lane in the stable ascending order of
    ``key`` (lane id breaking ties): the JAX package's ``sort_admit``."""
    order = torch.sort(key, stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, dtype=order.dtype, device=order.device)
    return rank < M


def _egress_admit(tick, age, wants, M, n):
    """Admit M wanting lanes, oldest first (lane id breaking ties): the
    egress queue's FIFO allocation, as the JAX package decides it. With
    ``max_wait`` the largest wait of a wanting lane (``wait_of``):
    below 4095 its counting admitters order by the wait, descending;
    from 4095 on its ``sort_admit`` orders every lane by ``age`` (raw,
    so an age past the tick comes after the tick), a lane that does not
    want keyed INT32_MAX, where it can take the rank of a wanting lane
    of larger id and age INT32_MAX. One lowering of both: a stable sort
    of a key chosen on the device."""
    wait = wait_of(tick, age)
    max_wait = torch.max(torch.where(wants, wait, torch.zeros_like(wait)))
    key = torch.where(
        wants,
        torch.where(max_wait >= _STARVED_WAIT, age, -wait),
        torch.full_like(age, _INT32_MAX),
    )
    return wants & _sort_admit(key, M, n)


def _append_messages_bounded(net: dict, spec: NetSpec, dest, records,
                             max_valid: int, trace=None, telem=None) -> dict:
    """Entry-mode append when the egress queue guarantees at most
    ``max_valid`` valid lanes: compact, rank within the compact domain,
    stage into a flat [arrival_slots*N, width] buffer at rank*N + dest,
    then merge staging into the ring (sim/ring_merge.py: the ring-merge
    kernel on the card, arrival_slots dense passes on the CPU). Drops
    (ring space, same-tick fan-in beyond arrival_slots) are counted in
    ``inbox_dropped``."""
    n = dest.shape[0]
    N = net["inbox_r"].shape[0]
    cap = spec.inbox_capacity
    A = spec.arrival_slots
    valid = dest >= 0
    idx = nonzero_static(valid, max_valid, n)
    ic = torch.clamp(idx, max=n - 1)
    d = torch.where(idx < n, dest[ic], n)  # n = drop lane
    rec = records[ic]  # [max_valid, width] row gather
    order_m, _, rank_sorted_m = sort_rank(d)
    rank = torch.empty_like(rank_sorted_m)
    rank[order_m] = rank_sorted_m

    dc = torch.clamp(d, max=N - 1)
    ok_a = (d < N) & (rank < A)
    flat = torch.clamp(rank, max=A - 1) * N + dc
    arr = rec.new_zeros((A * N + 1, spec.width))
    arr[torch.where(ok_a, flat, A * N)] = rec  # row A*N is the drop row
    arr = arr[:A * N]
    # integer adds as scatter_add (a sweep's vmap batches it in one op)
    k_all = dest.new_zeros(N + 1, dtype=torch.int32).scatter_add(
        0, torch.where(d < N, dc, N).to(torch.int64),
        torch.ones_like(d, dtype=torch.int32))
    k_all = k_all[:N]

    r = net["inbox_r"]
    w = net["inbox_w"]
    space = r + cap - w
    k_eff = torch.minimum(torch.clamp(k_all, max=A), space)
    net = dict(net)
    net["inbox"] = ring_merge.merge(net["inbox"], w, k_eff, arr)
    net["inbox_w"] = w + k_eff
    net["inbox_dropped"] = net["inbox_dropped"] + (k_all - k_eff)
    if trace is not None:
        # rx overflow is per-dest accounting here: the drop sits on the
        # RECEIVER lane, arg1 the negated dropped count
        trace.emit(tracemod.CAT_NET, k_all > k_eff, tracemod.EV_DROP,
                   arg0=tracemod.DROP_QUEUE_FULL, arg1=-(k_all - k_eff))
    if telem is not None:
        telem.drop("net_drops_queue_full", k_all - k_eff)
    return net


def _isum(mask):
    return torch.sum(mask, dtype=torch.int32)


def _append_messages(net: dict, spec: NetSpec, dest, records, trace=None,
                     telem=None) -> dict:
    """Ranked scatter of message records into destination inboxes: the
    UNBOUNDED path (no egress queue), where every lane may send. A lane's
    rank among same-dest senders (ordered by lane) fixes its slot
    ``w + rank``; lanes past the ring's space drop, counted in
    ``inbox_dropped``. dest: [n] (-1 = no message, n = 2N when duplicates
    double the lane domain); records: [n, width]."""
    n = dest.shape[0]
    N = net["inbox_r"].shape[0]
    cap = spec.inbox_capacity
    valid = dest >= 0
    safe = torch.where(valid, dest, n)  # n = drop lane
    order, _, rank_sorted = sort_rank(safe)
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted

    r, w = net["inbox_r"], net["inbox_w"]
    # the JAX package gathers w[min(safe, n - 1)] and its gather clamps
    # past the N rows; only in-capacity lanes use the value
    dc = torch.clamp(safe, max=N - 1)
    slot = w[dc] + rank
    in_cap = (safe < n) & (slot < r[dc] + cap)
    pos = torch.remainder(slot, cap)
    lands = in_cap & (safe < N)  # rows past N drop, as mode="drop" does
    width = records.shape[1]
    buf = torch.cat([net["inbox"].reshape(N * cap, width),
                     records.new_zeros((1, width))])
    # (row, pos) pairs of landing lanes are unique by rank; the rest go
    # to the drop row N*cap, which is sliced off
    buf[torch.where(lands, safe.to(torch.int64) * cap + pos, N * cap)] = \
        records
    net = dict(net)
    net["inbox"] = buf[:N * cap].reshape(N, cap, width)
    ones = torch.ones_like(safe)
    wq = torch.cat([w, w.new_zeros(1)]).scatter_add(
        0, torch.where(lands, safe, N).to(torch.int64), ones)
    net["inbox_w"] = wq[:N]
    lost = valid & ~in_cap & (safe < N)
    dropped = torch.cat([net["inbox_dropped"],
                         net["inbox_dropped"].new_zeros(1)]).scatter_add(
        0, torch.where(lost, safe, N).to(torch.int64), ones)
    net["inbox_dropped"] = dropped[:N]
    # rx-ring overflow on the SENDER lane (a duplicate copy's drop lands
    # on its original's lane)
    if telem is not None:
        telem.drop("net_drops_queue_full",
                   lost[:N].to(torch.int32)
                   + (lost[N:].to(torch.int32) if n > N else 0))
    if trace is not None:
        trace.emit(tracemod.CAT_NET, lost[:N], tracemod.EV_DROP,
                   arg0=tracemod.DROP_QUEUE_FULL, arg1=dest[:N])
        if n > N:
            # the duplicate copies (lanes N..2N-1) rank after their
            # originals: a second append records their drops
            trace.emit(tracemod.CAT_NET, lost[N:], tracemod.EV_DROP,
                       arg0=tracemod.DROP_QUEUE_FULL, arg1=dest[N:])
    return net


def _toxic_event(net: dict, key, name: str, n: int, sending, rate):
    """Per-packet toxic decision on each sender lane (True = the toxic
    fires): iid ``u < rate``, or, with a configured correlation
    (``eg_<name>_corr``), a first-order Markov chain per sender lane
    (P(event | prev event) = p + c(1-p), P(event | no event) = p(1-c))
    whose register ``ar_<name>`` advances only on ``sending`` lanes.
    Mutates ``net`` (the caller has already copied it)."""
    u = prng.uniform(key, (n,))
    ar = f"ar_{name}"
    if ar not in net:
        return u < rate
    c = net[f"eg_{name}_corr"]
    prev = net[ar] > 0.5
    thr = torch.where(prev, rate + c * (1.0 - rate), rate * (1.0 - c))
    ev = u < thr
    net[ar] = torch.where(sending, ev.to(torch.float32), net[ar])
    return ev


def egress_queue(pend: dict, tick, send, running, M: int, masks=None):
    """The entry-mode egress queue: at most ``M`` sends leave per tick,
    oldest first; the rest wait in the depth-1 per-sender ``pend_*``
    registers. A dead lane abandons its queued send; a new send arriving
    while the queued one is deferred again overflows (tail drop).

    Returns ``(pend_out, capped send, counters)``: the new ``pend_*``
    lanes, the effective send set with ``send_dest = -1`` on lanes that
    do not leave this tick, and int32 [3] (abandoned, deferred + stashed,
    overflowed). A ``masks`` dict gets the per-lane ``overflow`` mask
    (the observer planes' queue-full drops)."""
    send_dest, send_tag, send_port, send_size, send_payload = send
    n = send_dest.shape[0]
    abandoned = (pend["pend_dest"] >= 0) & ~running
    pend_dest = torch.where(abandoned, -1, pend["pend_dest"])
    has_pending = pend_dest >= 0
    new_valid = send_dest >= 0
    eff_dest = torch.where(has_pending, pend_dest, send_dest)
    eff_tag = torch.where(has_pending, pend["pend_tag"], send_tag)
    eff_port = torch.where(has_pending, pend["pend_port"], send_port)
    eff_size = torch.where(has_pending, pend["pend_size"], send_size)
    eff_pay = torch.where(has_pending[:, None], pend["pend_pay"],
                          send_payload)
    wants = (eff_dest >= 0) & running
    age = torch.where(has_pending, pend["pend_tick"], tick)
    go = _egress_admit(tick, age, wants, M, n)
    deferred = wants & ~go
    overflow = deferred & has_pending & new_valid
    if masks is not None:
        masks["overflow"] = overflow
    # a deferred send stays queued; a delivered pending frees the slot
    # for the simultaneous new send (stashed, admitted now)
    stash_new = ~deferred & has_pending & new_valid
    keep = deferred | stash_new
    out = {
        "pend_tick": torch.where(
            keep,
            torch.where(deferred & has_pending, pend["pend_tick"], tick),
            0,
        ),
        "pend_dest": torch.where(
            keep, torch.where(deferred, eff_dest, send_dest), -1
        ),
        "pend_tag": torch.where(
            keep, torch.where(deferred, eff_tag, send_tag), 0
        ),
        "pend_port": torch.where(
            keep, torch.where(deferred, eff_port, send_port), 0
        ),
        "pend_size": torch.where(
            keep, torch.where(deferred, eff_size, send_size), 0.0
        ),
        "pend_pay": torch.where(
            keep[:, None],
            torch.where(deferred[:, None], eff_pay, send_payload),
            0.0,
        ),
    }
    counters = torch.stack(
        [_isum(abandoned), _isum(deferred | stash_new), _isum(overflow)]
    )
    capped = (torch.where(go, eff_dest, -1), eff_tag, eff_port, eff_size,
              eff_pay)
    return out, capped, counters


def build_records(visible, send_tag, send_port, send_size, send_payload,
                  data_ok, send_dest):
    """The entry records ``[visible, src, tag, port, size, payload...]``
    of every lane, sanitized. Returns (records, dest_app, sanitized):
    ``dest_app`` is the dest on data_ok lanes, -1 elsewhere, and
    ``sanitized`` counts the values rewritten on data_ok lanes."""
    n = visible.shape[0]
    src_ids = torch.arange(n, dtype=torch.int32, device=visible.device)
    rec = torch.cat(
        [
            visible[:, None],
            src_ids.to(torch.float32)[:, None],
            send_tag.to(torch.float32)[:, None],
            send_port.to(torch.float32)[:, None],
            send_size[:, None],
            send_payload,
        ],
        dim=-1,
    )
    rec, rec_clean = sanitize_records(rec)
    sanitized = _isum(~rec_clean & data_ok[:, None])
    return rec, torch.where(data_ok, send_dest, -1), sanitized


@torch.library.custom_op("testground_tpu_torch::xor_f32_bits",
                         mutates_args=())
def xor_f32_bits(x: torch.Tensor, bits: int) -> torch.Tensor:
    """The float32 ``x`` with ``bits`` xor-ed into its bit pattern: a
    custom op, so that a sweep's vmap can carry the dtype views (its
    rule applies the op to the batched tensor as it is)."""
    return (x.view(torch.int32) ^ bits).view(torch.float32)


torch.library.register_vmap(
    "testground_tpu_torch::xor_f32_bits",
    lambda info, in_dims, x, bits: (xor_f32_bits(x, bits), in_dims[0]))


def _corrupt(net, rng_key, n, transmits, data_ok, send_payload):
    """netem corrupt: bit 22 of ONE rng-chosen payload float flips on each
    corrupted data lane; a flip into the zero-exponent range becomes the
    finite sentinel -3e38 (so the append-time flush cannot undo it)."""
    corrupted = _toxic_event(
        net, prng.fold_in(rng_key, 3), "corrupt", n, transmits,
        net["eg_corrupt"],
    ) & data_ok
    flipped = xor_f32_bits(send_payload.contiguous(), 0x00400000)
    flipped = torch.where(torch.abs(flipped) < FLT_MIN_NORMAL, -3.0e38,
                          flipped)
    pay_w = send_payload.shape[-1]
    hit_lane = prng.randint(prng.fold_in(rng_key, 5), (n,), 0, pay_w)
    hit = corrupted[:, None] & (
        torch.arange(pay_w, device=hit_lane.device)[None, :]
        == hit_lane[:, None]
    )
    return torch.where(hit, flipped, send_payload)


def deliver(net: dict, spec: NetSpec, tick, rng_key, send_dest, send_tag,
            send_port, send_size, send_payload, status_running,
            hs_clear=None, fault=None, trace=None, telem=None) -> dict:
    """One tick of the data plane: the egress queue (entry mode with
    ``send_slots``), destination viability, the loss / rate / jitter /
    latency / reorder / duplicate / corrupt shaping, then either the
    record build and the append into the inboxes (entry mode: bounded
    behind the queue, the ranked scatter without it) or the count-mode
    add of ``[count, bytes]`` into the staging row or the delay wheel;
    last, for a dialing program, the SYN replies into the dialers'
    handshake registers. With ``spec.pallas_front`` the entry-mode front
    up to the records runs as the deliver-front kernel
    (sim/deliver_front.py).

    ``hs_clear`` [N] i32: lanes starting a fresh dial this tick; their
    register is cleared before this tick's reply is written. ``fault``:
    the fault overlay of this tick (sim/faults.py ``Overlay``): ``block``
    keeps a send off the link (DROP semantics), ``lat``/``jit`` add to
    the sender's link row, ``loss`` combines with the link's loss as an
    independent drop, ``rev_lat`` adds to the ACK's return leg.
    ``trace``/``telem``: the tick's TraceEmitter and TelemetryAccum (None
    without the plane)."""
    check_supported(spec)
    net = dict(net)
    if spec.pallas_front and "pend_dest" in net:
        for plane, what in ((fault, "a [faults] partition/degrade overlay"),
                            (trace, "a [trace] table"),
                            (telem, "a [telemetry] table")):
            if plane is not None:
                raise ValueError(
                    f"pallas_front=True cannot compose with {what} (the "
                    "fused kernel bypasses the mask chain it hooks into) "
                    "— run it on the default lowering")
        from . import deliver_front

        pend_out, rec, dest_app, ctr = deliver_front.front(
            net, spec, tick, rng_key,
            (send_dest, send_tag, send_port, send_size, send_payload),
            status_running, send_dest.shape[0],
        )
        net.update(pend_out)
        net["egress_abandoned"] = net["egress_abandoned"] + ctr[0]
        net["egress_deferred"] = net["egress_deferred"] + ctr[1]
        net["egress_overflow"] = net["egress_overflow"] + ctr[2]
        net["payload_sanitized"] = net["payload_sanitized"] + ctr[3]
        return _append_messages_bounded(
            net, spec, dest_app, rec, max_valid=spec.send_slots
        )

    n = send_dest.shape[0]
    t = tick.to(torch.float32)
    has_queue = "pend_dest" in net
    if has_queue:
        new_dest, masks = send_dest, {}
        pend_out, send, ctr = egress_queue(
            net, tick, (send_dest, send_tag, send_port, send_size,
                        send_payload),
            status_running, spec.send_slots, masks,
        )
        net.update(pend_out)
        net["egress_abandoned"] = net["egress_abandoned"] + ctr[0]
        net["egress_deferred"] = net["egress_deferred"] + ctr[1]
        net["egress_overflow"] = net["egress_overflow"] + ctr[2]
        if trace is not None or telem is not None:
            # the overflowed new send is tail-dropped at the sender's
            # own queue
            overflow = masks["overflow"]
            if trace is not None:
                trace.emit(tracemod.CAT_NET, overflow, tracemod.EV_DROP,
                           arg0=tracemod.DROP_QUEUE_FULL, arg1=new_dest)
            if telem is not None:
                telem.drop("net_drops_queue_full", overflow)
        send_dest, send_tag, send_port, send_size, send_payload = send

    sending = (send_dest >= 0) & status_running
    dest_c = torch.clamp(send_dest, 0, n - 1)
    # destination viability: a crashed or finished instance has no host
    dest_ok = (net["net_enabled"] > 0) & status_running
    enabled = (net["net_enabled"] > 0) & dest_ok[dest_c]
    action = filter_action(net, spec, dest_c)
    # a REJECT or DROP route is a local error: the packet never reaches
    # the link (no occupancy, no toxic draw advances, no reply); a fault
    # partition blocks the same way
    if action is None:
        transmits = sending & enabled
        rejected = None
    else:
        transmits = sending & enabled & (action == ACTION_ACCEPT)
        rejected = sending & enabled & (action == ACTION_REJECT)
    if fault is not None and "block" in fault:
        transmits = transmits & ~fault["block"]

    observed = trace is not None or telem is not None
    fused = (trace.fused if trace is not None
             else (telem.fused if telem is not None else True))
    if observed:
        # each local drop with its cause; the causes partition
        # `sending & ~transmits` (disabled, churn, filter, partition)
        drops = _drop_causes(net, sending, dest_ok, dest_c, enabled,
                             action, fault)
    if trace is not None:
        trace.emit(tracemod.CAT_NET, sending, tracemod.EV_SEND,
                   arg0=send_dest, arg1=send_tag)
    if telem is not None:
        telem.count("net_sends", sending)
    if observed and not fused:
        _emit_drops(drops, send_dest, trace, telem)

    # a degrade window's loss combines with the link's as an independent
    # drop (and shifts a correlated link's Markov threshold alike)
    if "eg_loss" in net:
        loss_rate = net["eg_loss"]
        if fault is not None and "loss" in fault:
            loss_rate = 1.0 - (1.0 - loss_rate) * (1.0 - fault["loss"])
        lost = _toxic_event(net, rng_key, "loss", n, transmits, loss_rate)
    else:
        lost = torch.zeros_like(transmits)
    if observed:
        loss_drops = ([(tracemod.DROP_LOSS, transmits & lost)]
                      if "eg_loss" in net else [])
        if fused:
            _fused_drops(drops + loss_drops, send_dest, trace, telem)
        else:
            _emit_drops(loss_drops, send_dest, trace, telem)
    deliverable = transmits & ~lost
    # serialization delay on the sender's link (HTB rate analog)
    if "eg_rate" in net:
        rate = net["eg_rate"]
        # a clamp, not a maximum with a new tensor: that copies from the
        # host, which a CUDA-graph capture of the tick refuses
        ser = torch.where(rate > 0, send_size / torch.clamp(rate, min=1e-9),
                          0.0)
        start = torch.maximum(t, net["eg_busy"])
        net["eg_busy"] = torch.where(transmits, start + ser, net["eg_busy"])
    else:
        ser, start = 0.0, t
    # jitter: uniform in [-j, +j]; a degrade window widens the amplitude
    if "eg_jitter" in net:
        jit_amp = net["eg_jitter"]
        if fault is not None and "jit" in fault:
            jit_amp = jit_amp + fault["jit"]
        jit = jit_amp * (
            2.0 * prng.uniform(prng.fold_in(rng_key, 1), (n,)) - 1.0
        )
    else:
        jit = 0.0
    lat = net["eg_latency"] if "eg_latency" in net else 0.0
    if fault is not None and "lat" in fault:
        # degrade latency adds to the sender's link row
        lat = lat + fault["lat"]
    lj = lat + jit
    lj = (torch.maximum(lj, torch.zeros_like(lj))
          if isinstance(lj, torch.Tensor) else max(lj, 0.0))
    visible = torch.maximum(start + ser + lj, t + 1.0).expand(n)
    if "eg_reorder" in net:
        # netem gap-style reorder: the selected packets skip the delay
        reordered = _toxic_event(
            net, prng.fold_in(rng_key, 2), "reorder", n, transmits,
            net["eg_reorder"],
        )
        visible = torch.where(reordered, t + 1.0, visible)
    data_ok = deliverable & (send_tag != TAG_SYN)
    dup = None
    if "eg_duplicate" in net:
        dup = _toxic_event(
            net, prng.fold_in(rng_key, 4), "duplicate", n, transmits,
            net["eg_duplicate"],
        ) & data_ok
    if not spec.store_entries:
        _count_add(net, spec, tick, visible, data_ok, dest_c, send_size, dup)
    else:
        _entry_append(net, spec, rng_key, n, visible, transmits, data_ok,
                      dup, send_dest, send_tag, send_port, send_size,
                      send_payload, has_queue, trace, telem)
    if spec.uses_dials:
        _handshake(net, spec, t, visible, deliverable, rejected, send_dest,
                   send_tag, send_port, dest_c, hs_clear,
                   rev_lat=None if fault is None else fault.get("rev_lat"))
    return net


# the telemetry column of each drop cause
_DROP_PROBE = {
    tracemod.DROP_DISABLED: "net_drops_disabled",
    tracemod.DROP_CHURN: "net_drops_churn",
    tracemod.DROP_FILTER: "net_drops_filter",
    tracemod.DROP_PARTITION: "net_drops_partition",
    tracemod.DROP_LOSS: "net_drops_loss",
}


def _drop_causes(net, sending, dest_ok, dest_c, enabled, action, fault):
    """The local drops of this tick's sends as ``[(cause, mask), ...]``
    in the JAX lattice's order: the sender's own link down, the
    destination dead, a filter rule, a fault partition (the last two
    only where the program has them)."""
    own_up = net["net_enabled"] > 0
    drops = [
        (tracemod.DROP_DISABLED, sending & ~own_up),
        (tracemod.DROP_CHURN, sending & own_up & ~dest_ok[dest_c]),
    ]
    if action is not None:
        drops.append((tracemod.DROP_FILTER,
                      sending & enabled & (action != ACTION_ACCEPT)))
    if fault is not None and "block" in fault:
        accept = sending & enabled
        if action is not None:
            accept = accept & (action == ACTION_ACCEPT)
        drops.append((tracemod.DROP_PARTITION, accept & fault["block"]))
    return drops


def _emit_drops(drops, send_dest, trace, telem):
    """The per-cause drop path: one EV_DROP append and one telemetry
    column add a cause."""
    for cause, mask in drops:
        if trace is not None:
            trace.emit(tracemod.CAT_NET, mask, tracemod.EV_DROP, arg0=cause,
                       arg1=send_dest)
        if telem is not None:
            telem.drop(_DROP_PROBE[cause], mask)


def _fused_drops(drops, send_dest, trace, telem):
    """The fused drop path: one cause lattice feeds one EV_DROP append
    and one ``net_drops`` union add. The causes are disjoint a lane (a
    loss fires only on a transmitting lane), so the records and the
    counts are the per-cause build's."""
    cause = None
    for c, mask in drops:
        cause = (torch.where(mask, c, -1) if cause is None
                 else torch.where(mask, c, cause))
    dropped_m = cause >= 0
    if trace is not None:
        trace.emit(tracemod.CAT_NET, dropped_m, tracemod.EV_DROP,
                   arg0=cause, arg1=send_dest)
    if telem is not None:
        telem.count("net_drops", dropped_m)
        for c, mask in drops:
            telem.count(_DROP_PROBE[c], mask)


def _entry_append(net, spec, rng_key, n, visible, transmits, data_ok, dup,
                  send_dest, send_tag, send_port, send_size, send_payload,
                  has_queue, trace=None, telem=None):
    """Entry mode: corrupt the payloads, build and sanitize the records
    and append them (bounded behind the egress queue, the ranked scatter
    without it). Mutates ``net``."""
    if "eg_corrupt" in net:
        send_payload = _corrupt(net, rng_key, n, transmits, data_ok,
                                send_payload)
    rec, dest_app, sanitized = build_records(
        visible, send_tag, send_port, send_size, send_payload, data_ok,
        send_dest,
    )
    net["payload_sanitized"] = net["payload_sanitized"] + sanitized
    if dup is not None:
        # netem duplicate: the copy shares the original's visibility and
        # ranks after every original (lanes N..2N-1)
        dest_app = torch.cat([dest_app, torch.where(dup, send_dest, -1)])
        rec = torch.cat([rec, rec])
    if trace is not None or telem is not None:
        # the arrivals at each receiver's NIC (the appends account for
        # their ring's own overflow)
        N_r = net["inbox_r"].shape[0]
        arr_cnt = dest_app.new_zeros(N_r + 1, dtype=torch.int32).scatter_add(
            0, torch.where(dest_app >= 0, dest_app, N_r).to(torch.int64),
            torch.ones_like(dest_app, dtype=torch.int32))
        arr_cnt = arr_cnt[:N_r]
        if trace is not None:
            trace.emit(tracemod.CAT_NET, arr_cnt > 0, tracemod.EV_DELIVER,
                       arg0=arr_cnt)
        if telem is not None:
            telem.count("net_delivers", arr_cnt)
    if has_queue:
        out = _append_messages_bounded(
            net, spec, dest_app, rec,
            max_valid=spec.send_slots * (2 if dup is not None else 1),
            trace=trace, telem=telem,
        )
    else:
        out = _append_messages(net, spec, dest_app, rec, trace=trace,
                               telem=telem)
    net.update(out)


def filter_action(net, spec, dest_c):
    """The filter action of each lane's send to ``dest_c`` [N]: the max
    of its ``pair_filter`` entry and of its ``class_rules`` entry at the
    destination's class (the strictest wins, like stacked routes), int8;
    None for a filter-free program. A gather of one entry a lane: the
    JAX package's one-hot sum over the C classes adds exact zeros to the
    same integer."""
    if "pair_filter" not in net and "class_rules" not in net:
        return None
    n = dest_c.shape[0]
    src = torch.arange(n, device=dest_c.device)
    action = torch.zeros(n, dtype=torch.int8, device=dest_c.device)
    if "pair_filter" in net:
        action = torch.maximum(action, net["pair_filter"][src, dest_c])
    if "class_rules" in net:
        dcls = torch.clamp(net["class_of"][dest_c], 0, spec.n_classes - 1)
        action = torch.maximum(action, net["class_rules"][src, dcls])
    return action


def _count_add(net, spec, tick, visible, data_ok, dest_c, send_size, dup):
    """Count mode: this tick's data lanes add ``[count, bytes]`` into the
    staging row (fixed next tick) or into the delay-wheel bucket of their
    first consumable tick, in lane order (sim/count_scatter.py), with the
    occupancy and clamp counters. Mutates ``net``.

    The JAX package picks among an identity (no data lane), a compacted
    and a full scatter with ``lax.cond``; all three give the full
    scatter's values, so the port runs that one lowering with no host
    read, and counts ``send_compact_fallback`` as JAX does: +1 on a tick
    with more data lanes than ``send_slots``."""
    n = data_ok.shape[0]
    ones = torch.ones_like(send_size)
    # netem duplicate: the copy carries the same byte count
    mult = ones + dup.to(torch.float32) if dup is not None else ones
    upd = torch.stack([mult, send_size.to(torch.float32) * mult], dim=-1)
    M = spec.send_slots
    if M is not None and M < n:
        n_data = _isum(data_ok)
        net["send_compact_fallback"] = net["send_compact_fallback"] + (
            n_data > M).to(torch.int32)
    if spec.fixed_next_tick:
        rows = net["staging"].shape[0]
        idx = torch.where(data_ok, dest_c, rows)
        net["staging"] = count_scatter.scatter_add(net["staging"], idx, upd)
        if "staging_cnt" in net:
            net["staging_cnt"] = net["staging_cnt"] + _isum(data_ok)
        return
    W = spec.horizon
    wheel = net["wheel"]
    rows = wheel.shape[1]
    tt = torch.ceil(visible).to(torch.int32)  # first consumable tick
    over = data_ok & (tt > tick + (W - 1))
    tt = torch.minimum(tt, tick + (W - 1))
    b = torch.remainder(tt, W)
    idx = torch.where(data_ok, b * rows + dest_c, W * rows)
    net["wheel"] = count_scatter.scatter_add(
        wheel.reshape(W * rows, 2), idx, upd).reshape(W, rows, 2)
    if "wheel_occ" in net:
        # per-bucket message counts (integer adds: exact in any order)
        occ = torch.cat([net["wheel_occ"],
                         net["wheel_occ"].new_zeros(1)]).scatter_add(
            0, torch.where(data_ok, b, W).to(torch.int64),
            torch.ones_like(b, dtype=torch.int32))
        net["wheel_occ"] = occ[:W]
    # indexed by sender lane; only the total is read
    net["horizon_clamped"] = net["horizon_clamped"] + over.to(torch.int32)


_HS_EMPTY: dict = {}


def _hs_empty(device):
    """The cleared register row ``[HS_NONE, -1, 0, 0]`` on ``device``,
    made once (a tick then copies nothing from the host)."""
    if device not in _HS_EMPTY:
        _HS_EMPTY[device] = torch.tensor([[HS_NONE, -1.0, 0.0, 0.0]],
                                         dtype=torch.float32, device=device)
    return _HS_EMPTY[device]


def _handshake(net, spec, t, visible, deliverable, rejected, send_dest,
               send_tag, send_port, dest_c, hs_clear, rev_lat=None):
    """A delivered SYN writes an ACK into the dialer's register, visible
    one return leg after the SYN arrives; a SYN refused by a REJECT rule
    writes an RST, visible after the dialer's own egress latency (the
    prohibit route's immediate error). The ACK must pass the dialee's own
    egress filter toward the dialer, so a one-sided DROP breaks both
    directions (the dial times out). Mutates ``net``.

    The JAX package computes the reply only on a tick that carries a SYN
    (``lax.cond``); on any other tick no lane writes the register, so
    computing it every tick gives the same state. ``rev_lat``: a degrade
    window's latency on the return leg (sim/faults.py), added to the
    dialee's own before the one-tick floor."""
    is_syn = send_tag == TAG_SYN
    syn_ok = deliverable & is_syn
    if "pair_filter" in net:
        src = torch.arange(dest_c.shape[0], device=dest_c.device)
        syn_ok = syn_ok & (net["pair_filter"][dest_c, src] == ACTION_ACCEPT)
    if "class_rules" in net:
        my_cls = torch.clamp(net["class_of"], 0, spec.n_classes - 1)
        syn_ok = syn_ok & (net["class_rules"][dest_c, my_cls]
                           == ACTION_ACCEPT)
    if "eg_latency" in net:
        lat = net["eg_latency"]
        back_lat = lat[dest_c] if rev_lat is None else lat[dest_c] + rev_lat
        back_a = torch.clamp(back_lat, min=1.0)
        back_r = t + 1.0 + torch.clamp(lat, min=0.0)
        back_visible = torch.where(syn_ok, visible + back_a, back_r)
    elif rev_lat is not None:
        back_visible = torch.where(syn_ok,
                                   visible + torch.clamp(rev_lat, min=1.0),
                                   t + 1.0)
    else:
        back_visible = torch.where(syn_ok, visible + 1.0, t + 1.0)
    hs = net["hs"]
    if hs_clear is not None:
        hs = torch.where((hs_clear > 0)[:, None], _hs_empty(hs.device), hs)
    hs_new = torch.stack(
        [
            back_visible,
            send_dest.to(torch.float32),
            send_port.to(torch.float32).expand(send_dest.shape),
            torch.where(syn_ok, float(TAG_ACK), float(TAG_RST)),
        ],
        dim=-1,
    )
    write = syn_ok if rejected is None else syn_ok | (rejected & is_syn)
    net["hs"] = torch.where(write[:, None], hs_new, hs)


def advance_wheel(net: dict, spec: NetSpec, tick, trace=None,
                  telem=None) -> dict:
    """Count mode, start of tick: drain the staging row or this tick's
    wheel bucket into the per-dest visible count and byte total. The
    bucket is picked with a one-element index tensor, never a 0-dim one,
    which torch would read back to the host. A nonzero drained row is
    the count-mode delivery: EV_DELIVER (count, bytes) and
    ``net_delivers`` are recorded here."""
    net = dict(net)
    if spec.fixed_next_tick:
        row = net["staging"]
        net["staging"] = torch.zeros_like(row)
        if "staging_cnt" in net:
            net["staging_cnt"] = torch.zeros_like(net["staging_cnt"])
    else:
        W = spec.horizon
        b = torch.remainder(tick, W).reshape(1).to(torch.int64)
        row = net["wheel"].index_select(0, b)[0]
        net["wheel"] = net["wheel"].index_fill(0, b, 0.0)
        if "wheel_occ" in net:
            net["wheel_occ"] = net["wheel_occ"].index_fill(0, b, 0)
    if trace is not None:
        cnt = row[:, 0].to(torch.int32)
        trace.emit(tracemod.CAT_NET, cnt > 0, tracemod.EV_DELIVER, arg0=cnt,
                   arg1=row[:, 1].to(torch.int32))
    if telem is not None:
        telem.count("net_delivers", row[:, 0].to(torch.int32))
    net["avail"] = net["avail"] + row[:, 0].to(torch.int32)
    net["bytes_in"] = net["bytes_in"] + row[:, 1]
    return net


def head_cache(net: dict, spec: NetSpec) -> torch.Tensor:
    """[N, head_k, width] copy of each instance's FIFO head rows: a
    one-hot masked reduce over the capacity axis (exact: one row is
    selected and the rest add true zeros; the ring holds no -0.0 by the
    append-time sanitize)."""
    cap = spec.inbox_capacity
    K = spec.head_k
    r = net["inbox_r"]
    dev = r.device
    pos = torch.remainder(
        r[:, None] + torch.arange(K, device=dev)[None, :], cap
    )  # [N, K]
    oh = pos[:, :, None] == torch.arange(cap, device=dev)[None, None, :]
    inbox = net["inbox"]
    return torch.sum(
        torch.where(oh[:, :, :, None], inbox[:, None, :, :],
                    torch.zeros((), dtype=inbox.dtype, device=dev)),
        dim=2,
    )


def visible_prefix(net: dict, spec: NetSpec, tick) -> torch.Tensor:
    """[N] count of inbox entries consumable this tick: the FIFO prefix of
    in-window slots whose visibility time has arrived (count mode: the
    drained count)."""
    if not spec.store_entries:
        return net["avail"]
    cap = spec.inbox_capacity
    t = tick.to(torch.float32)
    r, w = net["inbox_r"], net["inbox_w"]
    vis = net["inbox"][:, :, F_VISIBLE]
    p = torch.arange(cap, dtype=torch.int32, device=r.device)[None, :]
    fifo = torch.remainder(p - r[:, None], cap)
    in_window = fifo < (w - r)[:, None]
    invisible = in_window & (vis > t)
    avail = torch.min(
        torch.where(invisible, fifo, torch.full_like(fifo, cap)), dim=1
    ).values
    return torch.minimum(avail, w - r)


def consume(net: dict, spec: NetSpec, tick, recv_count, prefix=None) -> dict:
    """Advance per-instance read state by the consumed visible entries."""
    if prefix is None:
        prefix = visible_prefix(net, spec, tick)
    take = torch.minimum(torch.clamp(recv_count, min=0), prefix)
    net = dict(net)
    if spec.store_entries:
        net["inbox_r"] = net["inbox_r"] + take
    else:
        net["avail"] = net["avail"] - take
    return net
