"""Hand-written CUDA kernels of the port: their nvcc build and ctypes
bindings. Sources live in ``testground_tpu_torch/csrc/``; the build runs
at first use into ``testground_tpu_torch/build/`` (listed in
``.gitignore``). Nothing here is built until a kernel is launched on a
CUDA tensor.

``LaunchCount`` is the launch count each kernel wrapper keeps."""

from __future__ import annotations

import torch


class LaunchCount:
    """How many times a wrapper's kernel ran on the device. An eager
    launch adds one on the host. A launch made while a CUDA graph is
    being captured is only recorded, so it adds nothing there; it adds
    one to a counter on the device, an op captured with it, so that every
    replay of the graph counts the launch it makes."""

    def __init__(self) -> None:
        self._host = 0
        self._dev: dict = {}

    def bump(self, device) -> None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            if device not in self._dev:
                raise RuntimeError(
                    "a kernel wrapper was first called while a CUDA graph "
                    "was being captured: warm it up eagerly first"
                )
            self._dev[device].add_(1)
            return
        self._host += 1
        if device.type == "cuda" and device not in self._dev:
            self._dev[device] = torch.zeros((), dtype=torch.int64,
                                            device=device)

    def __int__(self) -> int:
        return self._host + sum(int(t) for t in self._dev.values())

    def reset(self) -> None:
        """Zero the count (before a measured run)."""
        self._host = 0
        for t in self._dev.values():
            t.zero_()
