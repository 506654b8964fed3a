"""Shared per-lane ring append (counterpart of
``testground_tpu/sim/subkernels.py``)."""

from __future__ import annotations

import torch


def ring_append(buf, cnt, dropped, mask, rec):
    """One masked append into a per-lane ring: ``buf [N, cap, F]``,
    ``cnt [N]`` occupied slots, ``dropped [N]`` overflow counter,
    ``mask [N]`` bool (which lanes append), ``rec [N, F]`` the record.
    Returns the updated ``(buf, cnt, dropped)``. The slot is the lane's
    cursor and the write a dense one-hot select over the capacity axis
    (no scatter); a full ring counts the event into ``dropped``."""
    cap = buf.shape[1]
    writes = mask & (cnt < cap)
    slot = writes[:, None] & (
        torch.arange(cap, device=buf.device)[None, :] == cnt[:, None]
    )
    return (
        torch.where(slot[:, :, None], rec[:, None, :], buf),
        cnt + writes.to(cnt.dtype),
        dropped + (mask & (cnt >= cap)).to(dropped.dtype),
    )
