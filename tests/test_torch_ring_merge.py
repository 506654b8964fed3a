"""The port's inbox-ring merge (testground_tpu_torch/sim/ring_merge.py)
against the JAX package's microbenchmark tool
(tools/microbench_pallas_append.py): its production merge ``merge_xla``
and its Pallas kernel ``merge_pallas`` (interpret mode on the CPU), at
the tool's shapes (CAP 64, W 8, A 8) with the tool's own staging; and
the edge cases the card check covers, at small N. Exact equality, floats
by their bits. (The CUDA kernel against ``merge_plain`` is
tests/test_torch_cuda.py, on a card.)"""

import _torch_threads  # noqa: F401  (caps torch's CPU threads)
import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from testground_tpu_torch.sim import ring_merge as rm

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


def _tool():
    spec = importlib.util.spec_from_file_location(
        "microbench_pallas_append_reference",
        REPO / "tools" / "microbench_pallas_append.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _tool()


def _bits_equal(got, want, msg=""):
    g = got.numpy()
    w = np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (msg, g.shape, w.shape)
    np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32),
                                  err_msg=msg)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _tool_inputs(n, seed):
    """The tool's bench state and one step of its level-1 staging (ranks
    and the flat [A*N, W] staging built as ``bench.staging`` builds
    them), with a random ring so kept slots are visible."""
    rng = np.random.default_rng(seed)
    A, W, CAP = TOOL.A, TOOL.W, TOOL.CAP
    M = max(n // 8, 64)
    ring = rng.random((n, CAP, W)).astype(np.float32)
    w = rng.integers(0, CAP, n).astype(np.int32)
    dest = rng.integers(0, n // 4, M).astype(np.int32)  # fan-in > A too
    recs = rng.random((M, W)).astype(np.float32)
    order = np.argsort(dest, kind="stable")
    ds = dest[order]
    start = np.r_[True, ds[1:] != ds[:-1]]
    seg = np.maximum.accumulate(np.where(start, np.arange(M), 0))
    rank = np.empty(M, np.int64)
    rank[order] = np.arange(M) - seg
    arr = np.zeros((A * n + 1, W), np.float32)
    flat = np.where(rank < A, np.minimum(rank, A - 1) * n + dest, A * n)
    arr[flat] = recs
    k = np.minimum(np.bincount(dest, minlength=n), A).astype(np.int32)
    return ring, w, k, arr[:A * n]


@pytest.mark.parametrize("n", [512, 700])
def test_merge_plain_equals_the_tools_merges(n):
    ring, w, k, arr = _tool_inputs(n, n)
    got = rm.merge(*map(_t, (ring, w, k, arr)))
    jargs = tuple(map(jnp.asarray, (ring, w, k, arr)))
    _bits_equal(got, TOOL.merge_xla(*jargs), "merge_xla")
    _bits_equal(got, TOOL.merge_pallas(*jargs), "merge_pallas")
    _bits_equal(rm.merge_plain(*map(_t, (ring, w, k, arr))), got)


EDGE_CASES = [
    ("k_zero", {}),
    ("k_random", {}),
    ("k_all", {}),
    ("full_ring", {"cap": 4, "width": 7, "A": 8}),
    ("w_near_2_30", {}),
    ("a_over_cap", {"cap": 4, "width": 8, "A": 8}),
]


def edge_case(name, n, seed, **kw):
    """chip_smoke.py's merge-case generator run on the CPU at small N,
    as numpy arrays for the JAX reference."""
    return tuple(a.numpy() for a in cs.merge_case_on(
        torch, "cpu", name, n, seed, **kw))


@pytest.mark.parametrize("name,kw", EDGE_CASES)
def test_merge_edge_cases(name, kw):
    ring, w, k, arr = edge_case(name, 257, 3, **kw)
    got = rm.merge(*map(_t, (ring, w, k, arr)))
    assert TOOL.A == kw.get("A", 8)  # merge_xla runs the tool's A passes
    want = TOOL.merge_xla(*map(jnp.asarray, (ring, w, k, arr)))
    _bits_equal(got, want, name)
    if name == "k_zero":
        _bits_equal(got, ring)


def test_merge_writes_out_of_place():
    ring, w, k, arr = edge_case("k_all", 64, 5)
    t_ring = _t(ring)
    out = rm.merge(t_ring, _t(w), _t(k), _t(arr))
    assert out.data_ptr() != t_ring.data_ptr()
    _bits_equal(t_ring, ring)  # the input ring is untouched
