"""ctypes binding of ``csrc/count_scatter.cu`` (the count-mode ordered
scatter-add; the port's own kernel, with no TPU kernel behind it).

``launch`` checks every tensor (device, dtype, shape, contiguity),
allocates the result (and, for the large plan, the index scratch) with
``torch.empty`` and enqueues the plan that ``plan(L, R)`` names on the
current stream: the small plan is one launch (each block a share of the
rows), the large plan six. It never synchronises, reads nothing back to
the host and sorts nothing on the device as a whole: the kernel orders
the kept lanes itself. The function and its plain version are
``testground_tpu_torch/sim/count_scatter.py``."""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import check as _check
from .build import load

NAME = "count_scatter"
SMALL_MAX = 12_288  # lanes one ordering block holds (kSmallMax)
SHORT = 32  # a row of at most this many lanes is ordered by one thread
_INT_MAX = 2**31 - 1
TRACE_STAMPS = 8  # uint64 a small-plan block stamps (-DSCATTER_TRACE)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    return bind(load(NAME))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Argument types of a build of the kernel (the plain one, or the
    -DSCATTER_TRACE one with its phase timestamps), checked against the
    wrapper's constants; sets the kernels' shared-memory limit."""
    lib.count_scatter_launch.argtypes = (
        [ctypes.c_longlong, ctypes.c_longlong] + [ctypes.c_void_p] * 7
    )
    lib.count_scatter_launch.restype = ctypes.c_int
    for fn in ("count_scatter_init", "count_scatter_small_max",
               "count_scatter_short"):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = ctypes.c_int
    lib.count_scatter_small_grid.argtypes = [ctypes.c_longlong]
    lib.count_scatter_small_grid.restype = ctypes.c_int
    if (lib.count_scatter_small_max(), lib.count_scatter_short()) != (
            SMALL_MAX, SHORT):
        raise RuntimeError(
            "count_scatter: kernel and wrapper constants differ")
    err = lib.count_scatter_init()
    if err != 0:
        raise RuntimeError(f"count_scatter init failed: cudaError {err}")
    return lib


def plan(lanes: int, rows: int) -> str:
    """The plan for ``lanes`` lanes into ``rows`` rows: ``"small"`` (one
    launch, each block a share of the rows) when the lanes fit one
    block's shared memory, else ``"large"``. A function of the shapes
    alone: no host read."""
    del rows  # the small plan takes any row count
    return "small" if lanes <= SMALL_MAX else "large"


def scratch_ints(lanes: int, rows: int) -> int:
    """int32 scratch of the large plan: per-row (count, segment base),
    per-lane ranks and segments, the long-row list and four counters."""
    if plan(lanes, rows) == "small":
        return 0
    return 2 * rows + 2 * lanes + lanes // (SHORT + 1) + 5


def launch(buf, idx, upd, *, lib=None, trace=None):
    """A new ``[R, 2]`` buffer: ``buf`` with ``upd[i]`` added into row
    ``idx[i]`` for every lane with ``idx[i] < R``, each row's additions
    in increasing lane order, for CUDA tensors ``buf`` f32 ``[R, 2]``,
    ``idx`` int32 ``[L]`` and ``upd`` f32 ``[L, 2]``. ``lib``: a
    ``bind``-ed build other than the default; ``trace``: with the
    -DSCATTER_TRACE build, an int64 CUDA tensor of ``TRACE_STAMPS`` a
    small-plan block, for the phase timestamps."""
    dev = buf.device
    if dev.type != "cuda":
        raise ValueError(f"count_scatter kernel needs CUDA tensors, got {dev}")
    if buf.dim() != 2:
        raise ValueError(f"buf: expected [R, 2], got {tuple(buf.shape)}")
    if idx.dim() != 1:
        raise ValueError(f"idx: expected [L], got {tuple(idx.shape)}")
    rows, L = buf.shape[0], idx.shape[0]
    if rows >= _INT_MAX or L >= _INT_MAX:
        raise ValueError(f"count_scatter: {rows} rows, {L} lanes: past int32")
    ptrs = [
        _check(idx, "idx", torch.int32, (L,), dev),
        _check(upd, "upd", torch.float32, (L, 2), dev),
        _check(buf, "buf", torch.float32, (rows, 2), dev),
    ]
    lib = lib or library()
    out = torch.empty_like(buf)
    n_scratch = scratch_ints(L, rows)
    scratch = (torch.empty(n_scratch, dtype=torch.int32, device=dev)
               if n_scratch else None)
    err = lib.count_scatter_launch(
        L, rows, *ptrs, out.data_ptr(),
        scratch.data_ptr() if scratch is not None else None,
        trace.data_ptr() if trace is not None else None,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"count_scatter launch failed: cudaError {err}")
    return out
