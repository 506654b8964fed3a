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


def scatter_add(buf, idx, upd):
    """``scatter_add_plain``'s function: the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if buf.is_cuda:
        from ..kernels import count_scatter as kern

        out = kern.launch(buf, idx, upd)
        scatter_add.launches.bump(buf.device)
        return out
    return scatter_add_plain(buf, idx, upd)


scatter_add.launches = LaunchCount()
