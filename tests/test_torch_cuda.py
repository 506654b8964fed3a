"""Card-only checks of the port (marked ``cuda``; they skip without a
GPU): the deliver-front CUDA kernel against its plain torch version on
the same tensors, and the dht slice on the card against the port's CPU
path. This file imports no jax, so it runs on the GPU machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from testground_tpu_torch.sim import deliver_front as df  # noqa: E402
from testground_tpu_torch.sim.state_io import (  # noqa: E402
    flatten,
    state_to_numpy,
)

pytestmark = pytest.mark.cuda


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [257, 10_000])
@pytest.mark.parametrize("name,seed,kwargs", cs.REGIMES)
def test_kernel_matches_plain(name, seed, kwargs, n):
    dev = _cuda()
    net, spec, send, running, tick, key = cs.front_case(
        torch, np, n, seed, dev, **kwargs)
    ins = cs.lane_inputs(torch, net, spec, send, running, tick, key, n)
    launches = df.front_lanes.launches
    got = df.front_lanes(*ins)
    assert df.front_lanes.launches == launches + 1
    want = df.front_lanes_plain(*ins)
    torch.cuda.synchronize()
    same, err = cs.bit_equal(torch, cs.flat_outputs(got),
                             cs.flat_outputs(want))
    assert same, (name, n, err)


def test_dht_gpu_matches_cpu():
    dev = _cuda()
    n = 200
    a = flatten(state_to_numpy(cs.dht_exec(n, dev).run().state))
    b = flatten(state_to_numpy(cs.dht_exec(n, "cpu").run().state))
    assert set(a) == set(b)
    for k in sorted(a):
        x, y = a[k], b[k]
        assert x.dtype == y.dtype and x.shape == y.shape, k
        if x.dtype.kind == "f":
            x, y = x.view(np.int32), y.view(np.int32)
        np.testing.assert_array_equal(x, y, err_msg=k)
