"""The inbox-ring merge of the bounded entry-mode append, timed on the
card: the plain torch merge against the ring-merge kernel. A port of
``tools/microbench_pallas_append.py`` (which timed the XLA merge against
its Pallas kernel on a TPU).

    python -m testground_tpu_torch.tools.microbench_append [N ...]

Per N (default 100,000 and 1,000,000; CAP 64, W 8, A 8, the tool's
shapes), on one CUDA card:

- the level-1 staging both variants share: M = max(N // 8, 1024)
  messages ranked by destination and scattered into the flat
  ``[A*N, W]`` rank-major staging, plus per-destination counts;
- "merge alone": the merge on a fixed staging, plain vs kernel;
- "pair": staging + merge + the read half (the one-hot K=1 head read),
  plain vs kernel;
- the exactness assertion: one step, both merges, identical bits.

Times come from CUDA events around a loop of ``iters`` steps, divided by
``iters``: one wall per call would time the launch, not the work.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..sim import ring_merge

CAP = 64
W = 8  # header 5 + payload 3, padded to 8 lanes
A = 8  # arrival_slots


def staging(dest0, recs, i: int, n: int):
    """The level-1 scatter: messages to ``(dest0 + i) % n`` ranked among
    same-destination senders (stable, by message index) into the flat
    ``[A*n, W]`` staging, and the per-destination counts capped at A."""
    dev = dest0.device
    M = dest0.shape[0]
    d = torch.remainder(dest0 + i, n)
    ds, order = torch.sort(d, stable=True)
    idx = torch.arange(M, dtype=torch.int64, device=dev)
    is_start = torch.ones(M, dtype=torch.bool, device=dev)
    is_start[1:] = ds[1:] != ds[:-1]
    seg = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    rank = torch.empty_like(idx)
    rank[order] = idx - seg
    ok = rank < A
    flat = torch.clamp(rank, max=A - 1) * n + torch.clamp(d, max=n - 1)
    arr = torch.zeros((A * n + 1, W), dtype=torch.float32, device=dev)
    arr[torch.where(ok, flat, A * n)] = recs  # row A*n is the drop row
    k = torch.zeros(n, dtype=torch.int32, device=dev)
    k.index_add_(0, d, torch.ones_like(d, dtype=torch.int32))
    return arr[:A * n], torch.clamp(k, max=A)


def _time_loop(body, state, iters: int) -> float:
    """ms per step of ``state = body(state, i)``, from CUDA events around
    ``iters`` steps (after one warm step)."""
    state = body(state, 0)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for i in range(iters):
        state = body(state, i)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def bench(n: int, iters: int = 20, seed: int = 0, log=print) -> dict:
    """Time and check the two merges at N = ``n`` on the current card."""
    if not torch.cuda.is_available():
        raise RuntimeError("microbench_append times the card: no CUDA")
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(seed)
    M = max(n // 8, 1024)
    ring0 = torch.zeros((n, CAP, W), dtype=torch.float32, device=dev)
    w0 = torch.as_tensor(rng.integers(0, CAP, n).astype(np.int32),
                         device=dev)
    dest0 = torch.as_tensor(rng.integers(0, n, M), device=dev)
    recs = torch.as_tensor(rng.random((M, W)).astype(np.float32), device=dev)
    arr_fix, k_fix = staging(dest0, recs, 0, n)
    slots = torch.arange(CAP, device=dev)

    def merge_only(merge):
        def body(st, i):
            ring, w = st
            ring = merge(ring, w, k_fix, arr_fix)
            return ring, torch.remainder(w + k_fix, CAP)
        return body

    def pair(merge):
        def body(st, i):
            ring, w, acc = st
            arr, k = staging(dest0, recs, i, n)
            ring = merge(ring, w, k, arr)
            w = torch.remainder(w + k, CAP)
            # the read half: the one-hot head row (K = 1)
            pos = torch.remainder(w, CAP)
            head = torch.sum(
                torch.where(slots[None, :, None] == pos[:, None, None], ring,
                            0.0), dim=1)
            return ring, w, acc + torch.sum(head, dim=1)
        return body

    acc0 = torch.zeros(n, dtype=torch.float32, device=dev)
    out = {"n": n, "cap": CAP, "width": W, "arrival_slots": A,
           "messages": M, "iters": iters}
    for name, body, st0 in (
        ("merge_plain_ms", merge_only(ring_merge.merge_plain), (ring0, w0)),
        ("merge_kernel_ms", merge_only(ring_merge.merge), (ring0, w0)),
        ("pair_plain_ms", pair(ring_merge.merge_plain), (ring0, w0, acc0)),
        ("pair_kernel_ms", pair(ring_merge.merge), (ring0, w0, acc0)),
    ):
        out[name] = _time_loop(body, st0, iters)
    log(f"  N = {n:,d}: merge alone plain {out['merge_plain_ms']:.3f} ms, "
        f"kernel {out['merge_kernel_ms']:.3f} ms; pair plain "
        f"{out['pair_plain_ms']:.3f} ms, kernel {out['pair_kernel_ms']:.3f}"
        f" ms ({out['pair_plain_ms'] / out['pair_kernel_ms']:.2f}x)")

    # exactness: one step, both merges, identical bits
    arr, k = staging(dest0, recs, 0, n)
    a = ring_merge.merge_plain(ring0, w0, k, arr)
    b = ring_merge.merge(ring0, w0, k, arr)
    out["exact"] = bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))
    log(f"  exact: {out['exact']}")
    assert out["exact"], "the ring-merge kernel diverged from merge_plain"
    return out


def main(argv=None) -> int:
    ns = [int(x) for x in (argv if argv is not None else sys.argv[1:])]
    for n in ns or [100_000, 1_000_000]:
        bench(n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
