"""The count-mode scatter-add: ``[count, bytes]`` rows of this tick's
deliveries added into the staging row or the delay wheel.

Counterpart of the JAX package's ``buf.at[safe_dest].add`` and
``buf.at[b, safe_dest].add`` (``testground_tpu/sim/net.py`` deliver,
count mode). XLA's CPU scatter adds each destination's updates in lane
order, so a float sum depends on that order; CUDA's ``index_add_``
adds with float atomics, whose order changes from run to run. The port
therefore adds in lane order on every device:

- ``scatter_add_plain``: ``index_add_`` on the CPU, which adds in lane
  order (held to a sequential loop in tests/test_torch_count.py);
- ``scatter_add``: the dispatch. A CUDA tensor launches the kernel
  ``testground_tpu_torch/csrc/count_scatter.cu`` (or raises), which
  orders the kept lanes by destination itself, lane order within a
  destination, and bumps ``scatter_add.launches`` once a call; a CPU
  tensor takes the plain version. There is no fallback from the card to
  the plain version.

Both return a new buffer and leave the input as it was (the tick loop's
guard selects the old state back past the end of a run).

The dispatch is one ``torch.library`` custom op,
``testground_tpu_torch::count_scatter``, so that a sweep's batched tick
(``torch.func.vmap`` over the scenario axis, sim/sweep.py) can carry it:
its vmap rule (``_fold``) folds scenario *s*'s row *r* into row
``s * R + r`` and orders the lanes scenario by scenario, then makes ONE
call of the op at the folded shape. Each folded row still adds its lanes
in lane order, so scenario *s* of the result is bit-equal to a serial
call on scenario *s*'s inputs; a dropped lane (``idx >= R``) goes to the
folded drop row ``S * R``, never into the next scenario's row 0.
"""

from __future__ import annotations

import torch

from ..kernels import LaunchCount


def scatter_add_plain(buf, idx, upd):
    """``buf`` ``[R, 2]`` with ``upd[i]`` added into row ``idx[i]`` for
    every lane with ``idx[i] < R``, lane by lane in increasing order;
    lanes with ``idx[i] >= R`` are dropped. On the CPU only."""
    R = buf.shape[0]
    ext = torch.cat([buf, buf.new_zeros((1, buf.shape[1]))])
    ext.index_add_(0, torch.clamp(idx, max=R), upd)  # row R is dropped
    return ext[:R]


@torch.library.custom_op("testground_tpu_torch::count_scatter",
                         mutates_args=())
def _count_scatter(buf: torch.Tensor, idx: torch.Tensor,
                   upd: torch.Tensor) -> torch.Tensor:
    if buf.is_cuda:
        from ..kernels import count_scatter as kern

        out = kern.launch(buf, idx, upd)
        scatter_add.launches.bump(buf.device)
        return out
    return scatter_add_plain(buf, idx, upd)


def _fold(info, in_dims, buf, idx, upd):
    """The op's vmap rule: the S scenarios' ``[R, 2]`` buffers as one
    ``[S*R, 2]`` buffer, their lanes concatenated scenario by scenario
    with each kept index moved to its scenario's rows, one call."""
    S = info.batch_size
    buf, idx, upd = (
        x.movedim(d, 0) if d is not None else x.expand(S, *x.shape)
        for x, d in zip((buf, idx, upd), in_dims)
    )
    R = buf.shape[1]
    base = torch.arange(S, dtype=idx.dtype, device=idx.device)[:, None] * R
    fidx = torch.where(idx < R, idx + base, S * R)
    out = _count_scatter(buf.reshape(S * R, buf.shape[2]).contiguous(),
                         fidx.reshape(-1).contiguous(),
                         upd.reshape(-1, upd.shape[2]).contiguous())
    return out.reshape(S, R, -1), 0


torch.library.register_vmap("testground_tpu_torch::count_scatter", _fold)


def scatter_add(buf, idx, upd):
    """``scatter_add_plain``'s function: the kernel on CUDA tensors, the
    plain version on CPU tensors, through the batchable custom op."""
    return _count_scatter(buf, idx, upd)


scatter_add.launches = LaunchCount()
