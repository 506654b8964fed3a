"""The inbox-ring merge of the bounded entry-mode append: the staged
records of one tick land in the per-instance inbox rings.

Counterpart of ``tools/microbench_pallas_append.py``'s ``merge_xla``
(the A-pass one-hot merge of ``net._append_messages_bounded``) and
``merge_pallas`` (its TPU kernel, ``_merge_kernel``). The kernel this
module dispatches to is ``testground_tpu_torch/csrc/ring_merge.cu``; its
build and ctypes binding are ``testground_tpu_torch/kernels/ring_merge.py``.

- ``merge_plain``: the merge in plain torch, A dense ``torch.where``
  passes over the ring;
- ``merge``: the dispatch. A CUDA tensor launches the kernel (or
  raises) and bumps ``merge.launches``; a CPU tensor takes
  ``merge_plain``.

Both write a new ring and leave the input as it was.
"""

from __future__ import annotations

import torch


def merge_plain(ring, w, k_eff, arr):
    """For each row of ``ring`` ``[N, CAP, W]``: the staged record
    ``arr[a*N + row]`` (``arr`` is the flat rank-major ``[A*N, W]``
    staging) lands at slot ``(w + a) mod CAP`` for every ``a < k_eff``,
    later passes winning. Every other slot keeps its value."""
    N, cap, _ = ring.shape
    A = arr.shape[0] // N
    slots = torch.arange(cap, device=ring.device)
    for a in range(A):
        pos = torch.remainder(w + a, cap)
        mask = (slots[None, :] == pos[:, None]) & (a < k_eff)[:, None]
        ring = torch.where(
            mask[:, :, None], arr[a * N:(a + 1) * N, None, :], ring
        )
    return ring


def merge(ring, w, k_eff, arr):
    """``merge_plain``'s function: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if ring.is_cuda:
        from ..kernels import ring_merge as kern

        out = kern.launch(ring, w, k_eff, arr)
        merge.launches += 1
        return out
    return merge_plain(ring, w, k_eff, arr)


merge.launches = 0
