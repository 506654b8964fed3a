"""ctypes binding of ``csrc/ring_merge.cu`` (the inbox-ring merge, which
replaces ``tools/microbench_pallas_append.py:_merge_kernel``).

``launch`` checks every tensor (device, dtype, shape, contiguity),
allocates the merged ring with ``torch.empty_like``, enqueues one launch
on the current stream and never synchronises. The function and its
plain torch version are ``testground_tpu_torch/sim/ring_merge.py``."""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import check as _check
from .build import load

NAME = "ring_merge"


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = load(NAME)
    lib.ring_merge_launch.argtypes = (
        [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 6
    )
    lib.ring_merge_launch.restype = ctypes.c_int
    return lib


def launch(ring, w, k_eff, arr):
    """The merged ring (a new tensor) for CUDA tensors ``ring`` f32
    ``[N, CAP, W]``, ``w``/``k_eff`` int32 ``[N]`` and the flat
    rank-major staging ``arr`` f32 ``[A*N, W]``."""
    dev = ring.device
    if dev.type != "cuda":
        raise ValueError(f"ring_merge kernel needs CUDA tensors, got {dev}")
    if ring.dim() != 3:
        raise ValueError(f"ring: expected [N, CAP, W], got {tuple(ring.shape)}")
    n, cap, width = ring.shape
    if arr.dim() != 2 or n == 0 or arr.shape[0] % n:
        raise ValueError(
            f"arr: shape {tuple(arr.shape)} is not [A*N, W] for N = {n}")
    a_slots = arr.shape[0] // n
    i32, f32 = torch.int32, torch.float32
    ptrs = [
        _check(ring, "ring", f32, (n, cap, width), dev),
        _check(w, "w", i32, (n,), dev),
        _check(k_eff, "k_eff", i32, (n,), dev),
        _check(arr, "arr", f32, (a_slots * n, width), dev),
    ]
    out = torch.empty_like(ring)
    err = library().ring_merge_launch(
        n, cap, width, a_slots, *ptrs, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ring_merge launch failed: cudaError {err}")
    return out
