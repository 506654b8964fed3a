"""The fused entry-mode deliver front: viability, egress queue, FIFO
admission (both of its branches), loss and latency masks, per lane, as
one hand-written CUDA kernel in one launch.

Counterpart of ``testground_tpu/sim/pallas_front.py``, whose Pallas TPU
kernel (``_kernel``, launched by ``_front_kernel``, dispatched by
``front``) this module's kernel replaces, together with the admission
histograms and the ``lax.cond`` around it. The kernel itself is
``testground_tpu_torch/csrc/deliver_front.cu``; its build and ctypes
binding are ``testground_tpu_torch/kernels/deliver_front.py``.

Pieces:

- ``eligible``: the static feature-set gate (entry mode + egress queue,
  dial-free, filter-free, iid loss and latency only, ``n < 2**24``),
  unchanged from the JAX package so the port raises where it raises;
- ``front_lanes``: the kernel's wrapper, the whole front up to the
  records. A CUDA tensor launches the kernel (or raises); a CPU tensor
  takes ``front_lanes_plain``, the plain torch version of the same
  function. ``front_lanes.launches`` counts kernel launches. The JAX
  package's two branches (the counting admitter while every wait is
  below 4095 ticks, the sort admitter past it) are both inside, chosen
  on the device: nothing is read back to the host;
- ``front``: the dispatch, ``front_lanes`` then the record build and
  ``sanitize_records`` (outside the kernel, as in the JAX package);
- ``front_reference``: the net.deliver front restricted to the eligible
  feature set, the contract both branches are held to.

Bit-exactness: the kernel, the plain version and ``front_reference``
produce identical outputs, and ``front`` equals the JAX package's
``pallas_front.front`` (tests/test_torch_front.py on the CPU;
chip_smoke.py and tests/test_torch_cuda.py on the card).
"""

from __future__ import annotations

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
    contract both admission branches of the kernel are held to, given
    the viability mask ``enab_ok`` (``viability``). The JAX package's
    ``_front_reference``, through the same egress queue and record build
    as the default front (sim/net.py)."""
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


def viability(pend_dest, send_dest, running, net_enabled):
    """Destination viability on the EFFECTIVE dest (pre-admission): the
    lane's host is enabled, and so is the dest's, which also runs. For
    admitted lanes it equals the default front's post-admission gather;
    other lanes never read it."""
    n = send_dest.shape[0]
    pd0 = torch.where((pend_dest >= 0) & ~running, -1, pend_dest)
    eff_dest = torch.where(pd0 >= 0, pd0, send_dest)
    dest_ok = ((net_enabled > 0) & running).to(torch.int32)
    return (net_enabled > 0) & (dest_ok[torch.clamp(eff_dest, 0, n - 1)]
                                > 0)


def _visible(t, eg_latency, n):
    """max(t + max(lat, 0), t + 1) per lane (NaN-propagating maxima, as
    jnp.maximum)."""
    one = t + 1.0
    if eg_latency is None:
        return one.expand(n).contiguous()
    return torch.maximum(
        t + torch.maximum(eg_latency, torch.zeros_like(eg_latency)), one
    )


def front_lanes_plain(pend, send, running, net_enabled, eg_latency,
                      eg_loss, u_loss, tick, send_slots):
    """The kernel's function in plain torch: per lane, destination
    viability on the effective dest, abandon a dead lane's pending send,
    merge the pending slot with the new send, admit ``send_slots`` lanes
    oldest first, write the new pend lanes, and mask loss and
    visibility. The admission is the JAX package's: the two-level
    counting admitter (64 coarse x 64 fine wait buckets, an exclusive
    lane-order rank inside the boundary bucket) while the largest wait
    of a wanting lane is below 4095, its sort admitter from 4095 on,
    selected with ``torch.where`` on the device.

    Returns ``(pend_out, sd2, eff_tag, eff_port, eff_size, eff_pay,
    visible, data_ok, counters[3])`` with counters = (abandoned,
    deferred + stash, overflow)."""
    send_dest, send_tag, send_port, send_size, send_pay = send
    n = send_dest.shape[0]
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
    enab_ok = viability(pd, send_dest, running, net_enabled)
    wants = (eff_dest >= 0) & running
    age = torch.where(hp, ptick, tick)
    wait = netmod.wait_of(tick, age)
    max_wait = torch.max(torch.where(wants, wait, torch.zeros_like(wait)))
    go_sort = wants & netmod._sort_admit(
        torch.where(wants, age, torch.full_like(age, netmod._INT32_MAX)),
        send_slots, n)
    go = torch.where(max_wait >= netmod._STARVED_WAIT, go_sort,
                     _count_admit(wants, wait, send_slots))
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


def _count_admit(wants, wait, send_slots):
    """The JAX package's two-level counting admitter (``count_admit2``):
    coarse buckets ``wc // 64`` and fine buckets ``wc % 64`` of ``wc =
    min(wait, 4095)``, oldest first, and an exclusive lane-order rank
    inside the boundary bucket. Exact while every wait is below 4095."""
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
    in_bf = in_c & (f == fstar)
    in_bf_i = in_bf.to(torch.int32)
    pr = torch.cumsum(in_bf_i, 0, dtype=torch.int32) - in_bf_i
    return wants & ((c > cstar) | (in_c & (f > fstar))
                    | (in_bf & (pr < slots_f)))


def front_lanes(pend, send, running, net_enabled, eg_latency, eg_loss,
                u_loss, tick, send_slots):
    """The deliver-front kernel's wrapper (same contract as
    ``front_lanes_plain``). CUDA tensors launch the kernel and bump
    ``front_lanes.launches``; CPU tensors take the plain version."""
    if running.is_cuda:
        from ..kernels import deliver_front as kern

        res = kern.launch(pend, send, running, net_enabled, eg_latency,
                          eg_loss, u_loss, tick, send_slots)
        front_lanes.launches += 1
        return res
    return front_lanes_plain(pend, send, running, net_enabled, eg_latency,
                             eg_loss, u_loss, tick, send_slots)


front_lanes.launches = 0


def front(net, spec, tick, rng_key, send, status_running, n):
    """Dispatch: the kernel (both admission branches inside), then the
    record build. Returns (pend updates, rec, dest_app, counters[4])
    with counters = [abandoned, deferred, overflow, sanitized] deltas.
    Reads nothing back to the host."""
    eg_latency = net.get("eg_latency")
    eg_loss = net.get("eg_loss")
    u_loss = prng.uniform(rng_key, (n,)) if eg_loss is not None else None
    pend = {k: net[k] for k in _PEND_KEYS}
    (pend_out, sd2, eff_tag, eff_port, eff_size, eff_pay, visible, data_ok,
     ctr3) = front_lanes(pend, send, status_running, net["net_enabled"],
                         eg_latency, eg_loss, u_loss, tick, spec.send_slots)
    rec, dest_app, sanitized_add = netmod.build_records(
        visible, eff_tag, eff_port, eff_size, eff_pay, data_ok, sd2
    )
    counters = torch.cat([ctr3, sanitized_add[None]])
    return pend_out, rec, dest_app, counters


def reset_counters() -> None:
    """Zero the launch count (before a measured run)."""
    front_lanes.launches = 0
