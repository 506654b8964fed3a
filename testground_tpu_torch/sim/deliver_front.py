"""The fused entry-mode deliver front: egress queue + FIFO admission +
loss/latency masks, per lane, as one hand-written CUDA kernel.

Counterpart of ``testground_tpu/sim/pallas_front.py``, whose Pallas TPU
kernel (``_kernel``, launched by ``_front_kernel``, dispatched by
``front``) this module's kernel replaces. The kernel itself is
``testground_tpu_torch/csrc/deliver_front.cu``; its build and ctypes
binding are ``testground_tpu_torch/kernels/deliver_front.py``.

Pieces, in the order the dispatch runs them:

- ``eligible``: the static feature-set gate (entry mode + egress queue,
  dial-free, filter-free, iid loss and latency only, ``n < 2**24``),
  unchanged from the JAX package so the port raises where it raises;
- the glue outside the kernel: the two 64-bucket wait histograms and
  ``_boundary_of`` give the admission scalars ``(tick, cstar, fstar,
  slots_f)``, which stay on the device;
- ``front_lanes``: the kernel's wrapper. A CUDA tensor launches the
  kernel (or raises); a CPU tensor takes ``front_lanes_plain``, the
  plain torch version of the same function. ``front_lanes.launches``
  counts kernel launches;
- the record build and ``sanitize_records`` stay outside the kernel, as
  in the JAX package;
- ``front``: the dispatch. Waits past ``B*B - 1 = 4095`` ticks lose
  bucket resolution, so those ticks take ``front_reference`` instead (a
  semantic branch of the JAX package, not a fallback; counted in
  ``front.reference_ticks``). Deciding it reads one scalar back to the
  host per tick (``front.host_reads``, ``front.host_read_seconds``).

Bit-exactness: the kernel, the plain version and ``front_reference``
produce identical outputs (tests/test_torch_front.py on the CPU;
chip_smoke.py on the card).
"""

from __future__ import annotations

import time

import torch

from . import net as netmod
from . import prng
from .program import TAG_SYN

_B = 64  # wait buckets per level (net._ADMIT_BUCKETS)


def eligible(spec, n: int) -> bool:
    """Static feature-set gate (see module docstring). ``n < 2**24`` is
    the JAX package's limit (its f32 matmul ranks), kept so both raise
    alike."""
    return (
        spec.store_entries
        and spec.send_slots is not None
        and spec.send_slots < n
        and not spec.uses_dials
        and not spec.use_pair_rules
        and not spec.use_class_rules
        and not spec.uses_rate
        and not spec.uses_jitter
        and not spec.uses_corrupt
        and not spec.uses_reorder
        and not spec.uses_duplicate
        and not spec.uses_loss_corr
        and not spec.uses_corrupt_corr
        and not spec.uses_reorder_corr
        and not spec.uses_duplicate_corr
        and not spec.dest_sharded
        and spec.payload_len <= 8
        and n < 2**24
    )


_PEND_KEYS = (
    "pend_dest", "pend_tick", "pend_tag", "pend_port", "pend_size",
    "pend_pay",
)


def front_reference(spec, tick, u_loss, send, running, pend, eg_latency,
                    eg_loss, enab_ok):
    """The net.deliver front restricted to the eligible feature set: the
    starvation branch of ``front`` and the contract the kernel is held
    to. The JAX package's ``_front_reference``, through the same egress
    queue and record build as the default front (sim/net.py)."""
    n = send[0].shape[0]
    t = tick.to(torch.float32)
    out, capped, ctr3 = netmod.egress_queue(pend, tick, send, running,
                                            spec.send_slots)
    send_dest2, eff_tag, eff_port, eff_size, eff_pay = capped
    sending = (send_dest2 >= 0) & running
    transmits = sending & enab_ok
    if eg_loss is not None:
        lost = u_loss < eg_loss
    else:
        lost = torch.zeros_like(transmits)
    deliverable = transmits & ~lost
    visible = _visible(t, eg_latency, n)
    data_ok = deliverable & (eff_tag != TAG_SYN)
    rec, dest_app, sanitized_add = netmod.build_records(
        visible, eff_tag, eff_port, eff_size, eff_pay, data_ok, send_dest2
    )
    return out, rec, dest_app, torch.cat([ctr3, sanitized_add[None]])


def _visible(t, eg_latency, n):
    """max(t + max(lat, 0), t + 1) per lane (NaN-propagating maxima, as
    jnp.maximum)."""
    one = t + 1.0
    if eg_latency is None:
        return one.expand(n).contiguous()
    return torch.maximum(
        t + torch.maximum(eg_latency, torch.zeros_like(eg_latency)), one
    )


def front_lanes_plain(pend, send, running, enab_ok, eg_latency, eg_loss,
                      u_loss, adm_scal):
    """The kernel's function in plain torch: per lane, abandon a dead
    lane's pending send, merge the pending slot with the new send, admit
    against the boundary scalars ``adm_scal = (tick, cstar, fstar,
    slots_f)`` with an exclusive prefix rank inside the boundary bucket,
    write the new pend lanes, and mask loss and visibility.

    Returns ``(pend_out, sd2, eff_tag, eff_port, eff_size, eff_pay,
    visible, data_ok, counters[3])`` with counters = (abandoned,
    deferred + stash, overflow)."""
    send_dest, send_tag, send_port, send_size, send_pay = send
    n = send_dest.shape[0]
    tick, cstar, fstar, slots_f = adm_scal[0], adm_scal[1], adm_scal[2], \
        adm_scal[3]
    t = tick.to(torch.float32)
    pd = pend["pend_dest"]
    ptick = pend["pend_tick"]

    abandoned = (pd >= 0) & ~running
    pd0 = torch.where(abandoned, -1, pd)
    hp = pd0 >= 0
    nv = send_dest >= 0
    eff_dest = torch.where(hp, pd0, send_dest)
    eff_tag = torch.where(hp, pend["pend_tag"], send_tag)
    eff_port = torch.where(hp, pend["pend_port"], send_port)
    eff_size = torch.where(hp, pend["pend_size"], send_size)
    eff_pay = torch.where(hp[:, None], pend["pend_pay"], send_pay)
    wants = (eff_dest >= 0) & running
    age = torch.where(hp, ptick, tick)
    wait = torch.clamp(tick - age, min=0)
    wc = torch.clamp(wait, max=_B * _B - 1)
    c = wc // _B
    f = wc % _B
    in_bf = wants & (c == cstar) & (f == fstar)
    in_bf_i = in_bf.to(torch.int32)
    pr = torch.cumsum(in_bf_i, 0, dtype=torch.int32) - in_bf_i
    go = wants & (
        (c > cstar) | ((c == cstar) & (f > fstar)) | (in_bf & (pr < slots_f))
    )
    deferred = wants & ~go
    ovf = deferred & hp & nv
    stash = ~deferred & hp & nv
    keep = deferred | stash
    nxt_dest = torch.where(deferred, eff_dest, send_dest)
    out = {
        "pend_tick": torch.where(
            keep, torch.where(deferred & hp, ptick, tick), 0
        ),
        "pend_dest": torch.where(keep, nxt_dest, -1),
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
            keep[:, None], torch.where(deferred[:, None], eff_pay, send_pay),
            0.0,
        ),
    }
    sd2 = torch.where(go, eff_dest, -1)
    sending = (sd2 >= 0) & running
    transmits = sending & enab_ok
    if eg_loss is not None:
        deliverable = transmits & ~(u_loss < eg_loss)
    else:
        deliverable = transmits
    visible = _visible(t, eg_latency, n)
    data_ok = deliverable & (eff_tag != TAG_SYN)
    isum = netmod._isum
    counters = torch.stack([isum(abandoned), isum(deferred | stash),
                            isum(ovf)])
    return (out, sd2, eff_tag, eff_port, eff_size, eff_pay, visible,
            data_ok, counters)


def front_lanes(pend, send, running, enab_ok, eg_latency, eg_loss, u_loss,
                adm_scal):
    """The deliver-front kernel's wrapper (same contract as
    ``front_lanes_plain``). CUDA tensors launch the kernel and bump
    ``front_lanes.launches``; CPU tensors take the plain version."""
    if running.is_cuda:
        from ..kernels import deliver_front as kern

        res = kern.launch(pend, send, running, enab_ok, eg_latency, eg_loss,
                          u_loss, adm_scal)
        front_lanes.launches += 1
        return res
    return front_lanes_plain(pend, send, running, enab_ok, eg_latency,
                             eg_loss, u_loss, adm_scal)


front_lanes.launches = 0


def admission_scalars(tick, wants, wait, send_slots):
    """The counting admitter's two-level boundary (the glue before the
    kernel): int32 ``[tick, cstar, fstar, slots_f]`` on the device."""
    wc = torch.clamp(wait, max=_B * _B - 1)
    c = wc // _B
    f = wc % _B
    bins = torch.arange(_B, dtype=torch.int32, device=wait.device)
    hist_c = torch.sum(
        ((c[:, None] == bins[None, :]) & wants[:, None]).to(torch.int32),
        dim=0, dtype=torch.int32,
    )
    cstar, slots_c = netmod._boundary_of(hist_c, send_slots)
    in_c = wants & (c == cstar)
    hist_f = torch.sum(
        ((f[:, None] == bins[None, :]) & in_c[:, None]).to(torch.int32),
        dim=0, dtype=torch.int32,
    )
    fstar, slots_f = netmod._boundary_of(hist_f, slots_c)
    return torch.stack(
        [tick.to(torch.int32), cstar.to(torch.int32), fstar.to(torch.int32),
         torch.as_tensor(slots_f).to(torch.int32)]
    )


def front(net, spec, tick, rng_key, send, status_running, n):
    """Dispatch: the kernel in the exact-bucket regime, ``front_reference``
    past it (max wait >= 4095). Returns (pend updates, rec, dest_app,
    counters[4]) with counters = [abandoned, deferred, overflow,
    sanitized] deltas."""
    send_dest = send[0]
    running = status_running
    eg_latency = net.get("eg_latency")
    eg_loss = net.get("eg_loss")
    u_loss = prng.uniform(rng_key, (n,)) if eg_loss is not None else None
    pend = {k: net[k] for k in _PEND_KEYS}

    # destination viability on the EFFECTIVE dest (pre-admission)
    pd0 = torch.where((pend["pend_dest"] >= 0) & ~running, -1,
                      pend["pend_dest"])
    eff_dest = torch.where(pd0 >= 0, pd0, send_dest)
    dest_ok = ((net["net_enabled"] > 0) & running).to(torch.int32)
    g = dest_ok[torch.clamp(eff_dest, 0, n - 1)]
    enab_ok = (net["net_enabled"] > 0) & (g > 0)

    wants = (eff_dest >= 0) & running
    age = torch.where(pd0 >= 0, net["pend_tick"], tick)
    wait = torch.clamp(tick - age, min=0)
    max_wait = torch.max(torch.where(wants, wait, torch.zeros_like(wait)))
    t0 = time.perf_counter()
    starved = bool(max_wait >= _B * _B - 1)  # the one host read per tick
    front.host_read_seconds += time.perf_counter() - t0
    front.host_reads += 1
    if starved:
        front.reference_ticks += 1
        return front_reference(spec, tick, u_loss, send, running, pend,
                               eg_latency, eg_loss, enab_ok)
    front.kernel_ticks += 1
    adm_scal = admission_scalars(tick, wants, wait, spec.send_slots)
    # a phase's constant send field arrives as an expanded (stride-0) view
    send = tuple(s.contiguous() for s in send)
    (pend_out, sd2, eff_tag, eff_port, eff_size, eff_pay, visible, data_ok,
     ctr3) = front_lanes(pend, send, running, enab_ok, eg_latency, eg_loss,
                         u_loss, adm_scal)
    rec, dest_app, sanitized_add = netmod.build_records(
        visible, eff_tag, eff_port, eff_size, eff_pay, data_ok, sd2
    )
    counters = torch.cat([ctr3, sanitized_add[None]])
    return pend_out, rec, dest_app, counters


front.kernel_ticks = 0
front.reference_ticks = 0
front.host_reads = 0
front.host_read_seconds = 0.0


def reset_counters() -> None:
    """Zero the launch and dispatch counters (before a measured run)."""
    front_lanes.launches = 0
    front.kernel_ticks = 0
    front.reference_ticks = 0
    front.host_reads = 0
    front.host_read_seconds = 0.0
