"""The network data plane, entry-mode half: link-state tensors + the
per-instance inbox rings, in torch.

Counterpart of ``testground_tpu/sim/net.py``. This slice ports what the
entry-mode egress queue with the fused deliver front
(``SimConfig.pallas_front=True``) runs: the net state, the
ConfigureNetwork writes, the record wire contract, the FIFO egress
admitter, the bounded two-level append into the inbox rings, and the
head cache / visible prefix / consume reads. Count mode, dials, filter
rules and the default (non-kernel) front raise ``NotImplementedError``.

Inbox entry layout (NET_HDR + payload floats):
``[visible_tick, src, tag, port, size, payload...]``

Scatter discipline: every scatter here writes UNIQUE slots; rows that
must not land are routed to an explicit drop row past the end, which is
sliced off (torch leaves the winner of repeated indices undefined, so
nothing may depend on it).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .program import _not_ported

NET_HDR = 5  # visible, src, tag, port, size
F_VISIBLE, F_SRC, F_TAG, F_PORT, F_SIZE = range(NET_HDR)

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


def init_net_state(n: int, spec: NetSpec, device) -> dict:
    """The net leaves of the state dict (names, shapes and dtypes of the
    JAX package's init_net_state) for the entry-mode feature set."""
    if not spec.store_entries or spec.uses_dials:
        raise _not_ported("count mode / dial handshake registers", 4,
                          "count-mode data plane")
    if spec.use_pair_rules or spec.use_class_rules:
        raise _not_ported("filter rules", 7, "entry-mode data plane")
    i32, f32 = torch.int32, torch.float32

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    st = {
        "inbox_dropped": z(n, i32),
        "net_enabled": torch.ones(n, dtype=i32, device=device),
        "inbox": z((n, spec.inbox_capacity, spec.width), f32),
        "inbox_r": z(n, i32),
        "inbox_w": z(n, i32),
        "payload_sanitized": z((), i32),
    }
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
    corrupt_pct=0.0,
    reorder_pct=0.0,
    duplicate_pct=0.0,
    loss_corr_pct=0.0,
    corrupt_corr_pct=0.0,
    reorder_corr_pct=0.0,
    duplicate_corr_pct=0.0,
) -> dict:
    """Apply per-instance ConfigureNetwork writes (vectorized over N)."""
    on = set_flag > 0
    net = dict(net)
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
    is_start = torch.ones(n, dtype=torch.bool, device=safe.device)
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
    out = torch.full((size + 1,), fill, dtype=torch.int64, device=mask.device)
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
    slots_left = slots - cum_gt[torch.clamp(bstar, min=0)]
    return bstar, slots_left


def _egress_admit(tick, age, wants, M, n):
    """Admit the M oldest wanting lanes (age ascending, lane id breaking
    ties): the egress queue's FIFO allocation. One exact lowering, a
    stable sort; the JAX package's counting admitters bucket the wait
    ``max(tick - age, 0)``, so ages past the tick sort as the tick."""
    key = torch.where(
        wants, torch.minimum(age, tick), torch.full_like(age, _INT32_MAX)
    )
    order = torch.sort(key, stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, dtype=order.dtype, device=order.device)
    return wants & (rank < M)


def _append_messages_bounded(net: dict, spec: NetSpec, dest, records,
                             max_valid: int) -> dict:
    """Entry-mode append when the egress queue guarantees at most
    ``max_valid`` valid lanes: compact, rank within the compact domain,
    stage into a flat [arrival_slots*N, width] buffer at rank*N + dest,
    then merge staging into the ring with arrival_slots dense passes.
    Drops (ring space, same-tick fan-in beyond arrival_slots) are counted
    in ``inbox_dropped``."""
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
    arr = torch.zeros((A * N + 1, spec.width), dtype=rec.dtype,
                      device=rec.device)
    arr[torch.where(ok_a, flat, A * N)] = rec  # row A*N is the drop row
    arr = arr[:A * N]
    k_all = torch.zeros(N + 1, dtype=torch.int32, device=dest.device)
    k_all.index_add_(
        0, torch.where(d < N, dc, N), torch.ones_like(d, dtype=torch.int32)
    )
    k_all = k_all[:N]

    r = net["inbox_r"]
    w = net["inbox_w"]
    space = r + cap - w
    k_eff = torch.minimum(torch.clamp(k_all, max=A), space)
    net = dict(net)
    ring = net["inbox"]
    slots = torch.arange(cap, device=ring.device)
    for a in range(A):
        pos = torch.remainder(w + a, cap)
        mask = (slots[None, :] == pos[:, None]) & (a < k_eff)[:, None]
        ring = torch.where(
            mask[:, :, None], arr[a * N:(a + 1) * N, None, :], ring
        )
    net["inbox"] = ring
    net["inbox_w"] = w + k_eff
    net["inbox_dropped"] = net["inbox_dropped"] + (k_all - k_eff)
    return net


def deliver(net: dict, spec: NetSpec, tick, rng_key, send_dest, send_tag,
            send_port, send_size, send_payload, status_running) -> dict:
    """One tick of the data plane through the fused deliver front: egress
    queue + admission + loss/latency masks + record build in
    sim/deliver_front.py, then the bounded append into the inboxes."""
    if not (spec.pallas_front and "pend_dest" in net):
        raise _not_ported(
            "the default (non-kernel) entry-mode deliver front", 7,
            "entry-mode data plane",
        )
    from . import deliver_front

    n = send_dest.shape[0]
    pend_out, rec, dest_app, ctr = deliver_front.front(
        net, spec, tick, rng_key,
        (send_dest, send_tag, send_port, send_size, send_payload),
        status_running, n,
    )
    net = dict(net)
    net.update(pend_out)
    net["egress_abandoned"] = net["egress_abandoned"] + ctr[0]
    net["egress_deferred"] = net["egress_deferred"] + ctr[1]
    net["egress_overflow"] = net["egress_overflow"] + ctr[2]
    net["payload_sanitized"] = net["payload_sanitized"] + ctr[3]
    return _append_messages_bounded(
        net, spec, dest_app, rec, max_valid=spec.send_slots
    )


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
    in-window slots whose visibility time has arrived."""
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
    net["inbox_r"] = net["inbox_r"] + take
    return net
