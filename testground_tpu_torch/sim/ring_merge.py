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

The dispatch is one ``torch.library`` custom op,
``testground_tpu_torch::ring_merge``, whose vmap rule (``_fold``) lets a
sweep's batched tick (sim/sweep.py) carry it: the S scenarios' rings
fold into one ``[S*N, CAP, W]`` ring (scenario *s*'s row *r* is row
``s * N + r``), the staging into the matching rank-major ``[A*S*N, W]``,
and one call merges them. Rows are independent, so each scenario's part
is bit-equal to a serial merge.
"""

from __future__ import annotations

import torch

from ..kernels import LaunchCount


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


@torch.library.custom_op("testground_tpu_torch::ring_merge",
                         mutates_args=())
def _ring_merge(ring: torch.Tensor, w: torch.Tensor, k_eff: torch.Tensor,
                arr: torch.Tensor) -> torch.Tensor:
    if ring.is_cuda:
        from ..kernels import ring_merge as kern

        out = kern.launch(ring, w, k_eff, arr)
        merge.launches.bump(ring.device)
        return out
    return merge_plain(ring, w, k_eff, arr)


def _fold(info, in_dims, ring, w, k_eff, arr):
    """The op's vmap rule: the S scenarios' rings as one ring of S*N
    rows, their rank-major stagings interleaved to match, one call."""
    S = info.batch_size
    ring, w, k_eff, arr = (
        x.movedim(d, 0) if d is not None else x.expand(S, *x.shape)
        for x, d in zip((ring, w, k_eff, arr), in_dims)
    )
    _, N, cap, width = ring.shape
    A = arr.shape[1] // N
    farr = arr.reshape(S, A, N, width).transpose(0, 1).reshape(
        A * S * N, width)
    out = _ring_merge(ring.reshape(S * N, cap, width).contiguous(),
                      w.reshape(-1).contiguous(),
                      k_eff.reshape(-1).contiguous(), farr.contiguous())
    return out.reshape(S, N, cap, width), 0


torch.library.register_vmap("testground_tpu_torch::ring_merge", _fold)


def merge(ring, w, k_eff, arr):
    """``merge_plain``'s function: the kernel on CUDA tensors, the plain
    version on CPU tensors, through the batchable custom op."""
    return _ring_merge(ring, w, k_eff, arr)


merge.launches = LaunchCount()
