"""ctypes binding of ``csrc/count_scatter.cu`` (the count-mode ordered
scatter-add; the port's own kernel, with no TPU kernel behind it).

``launch`` checks every tensor (device, dtype, shape, contiguity),
sorts the lane ids by destination (stable: lane order within a
destination), copies ``buf`` and enqueues one launch on the current
stream that adds each destination's updates into the copy in lane
order. It never synchronises and reads nothing back to the host. The
function and its plain version are
``testground_tpu_torch/sim/count_scatter.py``."""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import check as _check
from .build import load

NAME = "count_scatter"


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = load(NAME)
    lib.count_scatter_launch.argtypes = (
        [ctypes.c_longlong, ctypes.c_longlong] + [ctypes.c_void_p] * 5
    )
    lib.count_scatter_launch.restype = ctypes.c_int
    return lib


def sort_lanes(idx, rows):
    """(destination keys in ascending order, their lane ids) for CUDA
    ``idx`` int32 ``[L]``: dropped lanes (``idx >= rows``) key ``rows``
    and sort last."""
    key = torch.clamp(idx, max=rows)
    return torch.sort(key, stable=True)


def launch_sorted(out, keys, lanes, upd):
    """The kernel alone: adds ``upd[lanes[j]]`` into ``out[keys[j]]`` in
    place, for each destination in the order of ``j``."""
    dev = out.device
    rows = out.shape[0]
    L = keys.shape[0]
    ptrs = [
        _check(keys, "keys", torch.int32, (L,), dev),
        _check(lanes, "lanes", torch.int64, (L,), dev),
        _check(upd, "upd", torch.float32, (L, 2), dev),
        _check(out, "out", torch.float32, (rows, 2), dev),
    ]
    err = library().count_scatter_launch(
        L, rows, *ptrs, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"count_scatter launch failed: cudaError {err}")
    return out


def launch(buf, idx, upd):
    """A new ``[R, 2]`` buffer: ``buf`` with ``upd[i]`` added into row
    ``idx[i]`` for every lane with ``idx[i] < R``, each row's additions
    in increasing lane order, for CUDA tensors ``buf`` f32 ``[R, 2]``,
    ``idx`` int32 ``[L]`` and ``upd`` f32 ``[L, 2]``."""
    dev = buf.device
    if dev.type != "cuda":
        raise ValueError(f"count_scatter kernel needs CUDA tensors, got {dev}")
    if buf.dim() != 2:
        raise ValueError(f"buf: expected [R, 2], got {tuple(buf.shape)}")
    if idx.dim() != 1:
        raise ValueError(f"idx: expected [L], got {tuple(idx.shape)}")
    rows, L = buf.shape[0], idx.shape[0]
    _check(buf, "buf", torch.float32, (rows, 2), dev)
    _check(idx, "idx", torch.int32, (L,), dev)
    _check(upd, "upd", torch.float32, (L, 2), dev)
    keys, lanes = sort_lanes(idx, rows)
    return launch_sorted(buf.clone(), keys, lanes, upd)
