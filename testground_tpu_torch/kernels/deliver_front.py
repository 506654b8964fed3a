"""ctypes binding of ``csrc/deliver_front.cu`` (the deliver-front kernel,
which replaces ``testground_tpu/sim/pallas_front.py:_kernel``).

``launch`` checks every tensor (device, dtype, shape, contiguity),
allocates the outputs with ``torch.empty``, enqueues the kernel's two
launches on the current stream and never synchronises. The kernel's
function and its plain torch version are documented at
``testground_tpu_torch/sim/deliver_front.py:front_lanes_plain``."""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import load

NAME = "deliver_front"
_N_PTRS = 17 + 15 + 1  # inputs, outputs + scratch, stream


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = load(NAME)
    lib.deliver_front_launch.argtypes = (
        [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * _N_PTRS
    )
    lib.deliver_front_launch.restype = ctypes.c_int
    lib.deliver_front_blocks.argtypes = [ctypes.c_int]
    lib.deliver_front_blocks.restype = ctypes.c_int
    return lib


def _check(t, name, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return t.data_ptr()


def launch(pend, send, running, enab_ok, eg_latency, eg_loss, u_loss,
           adm_scal):
    """Launch the kernel on CUDA tensors; same contract and return value
    as ``sim.deliver_front.front_lanes_plain``."""
    send_dest, send_tag, send_port, send_size, send_pay = send
    dev = running.device
    if dev.type != "cuda":
        raise ValueError(f"deliver_front kernel needs CUDA tensors, got {dev}")
    n = send_dest.shape[0]
    P = send_pay.shape[1] if send_pay.dim() == 2 else -1
    if not 1 <= P <= 8:
        raise ValueError(f"payload width {P} outside 1..8")
    if (eg_loss is None) != (u_loss is None):
        raise ValueError("eg_loss and u_loss come together")
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    lane, pay = (n,), (n, P)
    ptrs = [
        _check(pend["pend_dest"], "pend_dest", i32, lane, dev),
        _check(pend["pend_tick"], "pend_tick", i32, lane, dev),
        _check(pend["pend_tag"], "pend_tag", i32, lane, dev),
        _check(pend["pend_port"], "pend_port", i32, lane, dev),
        _check(pend["pend_size"], "pend_size", f32, lane, dev),
        _check(pend["pend_pay"], "pend_pay", f32, pay, dev),
        _check(send_dest, "send_dest", i32, lane, dev),
        _check(send_tag, "send_tag", i32, lane, dev),
        _check(send_port, "send_port", i32, lane, dev),
        _check(send_size, "send_size", f32, lane, dev),
        _check(send_pay, "send_payload", f32, pay, dev),
        _check(running, "running", b8, lane, dev),
        _check(enab_ok, "enab_ok", b8, lane, dev),
        None if eg_latency is None
        else _check(eg_latency, "eg_latency", f32, lane, dev),
        None if eg_loss is None else _check(eg_loss, "eg_loss", f32, lane, dev),
        None if u_loss is None else _check(u_loss, "u_loss", f32, lane, dev),
        _check(adm_scal, "adm_scal", i32, (4,), dev),
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
    counters = torch.zeros(3, dtype=i32, device=dev)
    lib = library()
    block_counts = empty((max(lib.deliver_front_blocks(n), 1),), i32)
    ptrs += [
        out["pend_dest"].data_ptr(), out["pend_tick"].data_ptr(),
        out["pend_tag"].data_ptr(), out["pend_port"].data_ptr(),
        out["pend_size"].data_ptr(), out["pend_pay"].data_ptr(),
        sd2.data_ptr(), eff_tag.data_ptr(), eff_port.data_ptr(),
        eff_size.data_ptr(), eff_pay.data_ptr(), visible.data_ptr(),
        data_ok.data_ptr(), counters.data_ptr(), block_counts.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    ]
    err = lib.deliver_front_launch(n, P, *ptrs)
    if err != 0:
        raise RuntimeError(f"deliver_front launch failed: cudaError {err}")
    return (out, sd2, eff_tag, eff_port, eff_size, eff_pay, visible, data_ok,
            counters)
