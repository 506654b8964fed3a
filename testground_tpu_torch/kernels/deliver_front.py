"""ctypes binding of ``csrc/deliver_front.cu`` (the deliver-front kernel,
which replaces ``testground_tpu/sim/pallas_front.py:_kernel`` together
with its admission glue and its ``lax.cond``).

``launch`` checks every tensor (device, dtype, shape, contiguity; the
send lanes may be strided, as a phase's constant send field arrives as
an expanded view), allocates the outputs with ``torch.empty``, enqueues
the kernel's one launch on the current stream and never synchronises.
The kernel's scratch (grid barrier, histograms, each block's own
histogram row) is one buffer per device, allocated with ``torch.empty``
and cleared once by the library when it is allocated; every launch
leaves it as it found it, so no launch needs a memset. Launches that
share a device must therefore not run concurrently on two streams. The
kernel's function and its plain torch version are documented at
``testground_tpu_torch/sim/deliver_front.py:front_lanes_plain``."""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import check as _check
from .build import load

NAME = "deliver_front"
_N_PTRS = 17 + 15  # inputs (tick included), outputs + counters + scratch
_N_INTS = 10
_scratch: dict = {}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    return bind(load(NAME))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures on a build of ``csrc/deliver_front.cu``."""
    lib.deliver_front_launch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p,
    ]
    lib.deliver_front_launch.restype = ctypes.c_int
    lib.deliver_front_scratch_bytes.argtypes = []
    lib.deliver_front_scratch_bytes.restype = ctypes.c_int
    lib.deliver_front_scratch_init.argtypes = [ctypes.c_void_p,
                                               ctypes.c_void_p]
    lib.deliver_front_scratch_init.restype = ctypes.c_int
    lib.deliver_front_plan.argtypes = [ctypes.c_int, ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_int)]
    lib.deliver_front_plan.restype = ctypes.c_int
    return lib


def _raise(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"deliver_front {what} failed: cudaError {err}")


def scratch(dev: torch.device, stream: int, lib=None) -> torch.Tensor:
    """The device's persistent scratch for a build of the kernel,
    allocated and cleared on first use."""
    lib = lib or library()
    buf = _scratch.get((lib._name, dev.index))
    if buf is None:
        buf = torch.empty(lib.deliver_front_scratch_bytes(),
                          dtype=torch.uint8, device=dev)
        _raise(lib.deliver_front_scratch_init(buf.data_ptr(), stream),
               "scratch clear")
        _scratch[(lib._name, dev.index)] = buf
    return buf


def plan(n: int, lanes_per_block: int = 0, device=None) -> dict:
    """The launch plan the kernel takes for ``n`` lanes: grid size, lanes
    a block, tiles of 512 lanes a block, whether the block's lanes fit
    its shared-memory cache, and whether it is the small plan (one lane
    a thread, its inputs held in registers across the barrier)."""
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        _raise(library().deliver_front_plan(n, lanes_per_block, out), "plan")
    return {"grid": out[0], "lanes_per_block": out[1], "tiles": out[2],
            "cache": bool(out[3]), "small": bool(out[4])}


def _strided(t, name, dtype, shape, device):
    """A send lane's pointer and element strides: any non-negative
    strides (a constant field arrives expanded, stride 0)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if any(s < 0 for s in t.stride()):
        raise ValueError(f"{name}: negative stride {t.stride()}")
    return t.data_ptr(), list(t.stride())


def launch(pend, send, running, net_enabled, eg_latency, eg_loss, u_loss,
           tick, send_slots, *, lanes_per_block=0, lib=None):
    """Launch the kernel on CUDA tensors; same contract and return value
    as ``sim.deliver_front.front_lanes_plain``. ``lanes_per_block`` (0:
    the kernel's default; a test takes blocks too large for the shared
    cache) and ``lib`` (the -DFRONT_TRACE build, ``bind``-ed, for
    chip_smoke.py's phase timestamps) are for tests and measurements."""
    send_dest, send_tag, send_port, send_size, send_pay = send
    dev = running.device
    if dev.type != "cuda":
        raise ValueError(f"deliver_front kernel needs CUDA tensors, got {dev}")
    n = running.shape[0] if running.dim() == 1 else -1
    P = send_pay.shape[1] if send_pay.dim() == 2 else -1
    if n < 1:
        raise ValueError(f"running: shape {tuple(running.shape)}, "
                         "expected [n], n >= 1")
    if not 1 <= P <= 8:
        raise ValueError(f"payload width {P} outside 1..8")
    if n >= 2**24:
        raise ValueError(f"n = {n}: the front takes n < 2**24")
    if (eg_loss is None) != (u_loss is None):
        raise ValueError("eg_loss and u_loss come together")
    if not 0 <= int(send_slots) < 2**31:
        raise ValueError(f"send_slots {send_slots} outside 0..2**31-1")
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    lane, pay = (n,), (n, P)
    strides = []
    send_ptrs = []
    for t, name, dt, shape in (
        (send_dest, "send_dest", i32, lane), (send_tag, "send_tag", i32, lane),
        (send_port, "send_port", i32, lane),
        (send_size, "send_size", f32, lane),
        (send_pay, "send_payload", f32, pay),
    ):
        ptr, st = _strided(t, name, dt, shape, dev)
        send_ptrs.append(ptr)
        strides += st
    if tuple(tick.shape) not in ((), (1,)):
        raise ValueError(f"tick: shape {tuple(tick.shape)}, expected ()")
    ptrs = [
        _check(pend["pend_dest"], "pend_dest", i32, lane, dev),
        _check(pend["pend_tick"], "pend_tick", i32, lane, dev),
        _check(pend["pend_tag"], "pend_tag", i32, lane, dev),
        _check(pend["pend_port"], "pend_port", i32, lane, dev),
        _check(pend["pend_size"], "pend_size", f32, lane, dev),
        _check(pend["pend_pay"], "pend_pay", f32, pay, dev),
        *send_ptrs,
        _check(running, "running", b8, lane, dev),
        _check(net_enabled, "net_enabled", i32, lane, dev),
        None if eg_latency is None
        else _check(eg_latency, "eg_latency", f32, lane, dev),
        None if eg_loss is None else _check(eg_loss, "eg_loss", f32, lane, dev),
        None if u_loss is None else _check(u_loss, "u_loss", f32, lane, dev),
        _check(tick, "tick", i32, tuple(tick.shape), dev),
    ]

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = {
        "pend_dest": empty(lane, i32),
        "pend_tick": empty(lane, i32),
        "pend_tag": empty(lane, i32),
        "pend_port": empty(lane, i32),
        "pend_size": empty(lane, f32),
        "pend_pay": empty(pay, f32),
    }
    sd2, eff_tag, eff_port = empty(lane, i32), empty(lane, i32), \
        empty(lane, i32)
    eff_size, eff_pay, visible = empty(lane, f32), empty(pay, f32), \
        empty(lane, f32)
    data_ok = empty(lane, b8)
    counters = empty((3,), i32)  # zeroed by the kernel
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = lib or library()
    with torch.cuda.device(dev):
        buf = scratch(dev, stream, lib)
        ptrs += [
            out["pend_dest"].data_ptr(), out["pend_tick"].data_ptr(),
            out["pend_tag"].data_ptr(), out["pend_port"].data_ptr(),
            out["pend_size"].data_ptr(), out["pend_pay"].data_ptr(),
            sd2.data_ptr(), eff_tag.data_ptr(), eff_port.data_ptr(),
            eff_size.data_ptr(), eff_pay.data_ptr(), visible.data_ptr(),
            data_ok.data_ptr(), counters.data_ptr(), buf.data_ptr(),
        ]
        ints = [n, P, int(send_slots), int(lanes_per_block)] + strides
        assert len(ptrs) == _N_PTRS and len(ints) == _N_INTS
        err = lib.deliver_front_launch(
            (ctypes.c_void_p * _N_PTRS)(*ptrs), _N_PTRS,
            (ctypes.c_longlong * _N_INTS)(*ints), _N_INTS, stream,
        )
    _raise(err, "launch")
    return (out, sd2, eff_tag, eff_port, eff_size, eff_pay, visible, data_ok,
            counters)
