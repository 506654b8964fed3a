"""Caps torch's CPU threads in the port's tests (tests/test_torch_*.py
import this module first).

Under pytest-xdist every worker process runs its own torch, and torch
defaults to one intra-op thread a core: with W workers on C cores that
is W x C threads, next to JAX's own, and the port's parity tests then
spend most of their time contending. Each worker gets at most
``max(1, cpu_count // W)`` intra-op and inter-op threads, W being
``PYTEST_XDIST_WORKER_COUNT`` (1 without xdist). The parity results do
not depend on it: the port's float reductions have a fixed order."""

import os

import torch


def thread_cap() -> int:
    """The thread count a test process may use."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1") or 1)
    return max(1, (os.cpu_count() or 1) // max(1, workers))


CAP = thread_cap()
if torch.get_num_threads() > CAP:
    torch.set_num_threads(CAP)
try:
    if torch.get_num_interop_threads() > CAP:
        torch.set_num_interop_threads(CAP)
except RuntimeError:
    # inter-op work already started in this process: its pool stays
    pass
