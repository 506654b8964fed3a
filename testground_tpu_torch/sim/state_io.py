"""Carrying a run's state between the two packages.

The JAX package's loop-carried state is a pytree of arrays; the port's
is a nested ``dict`` of tensors with the same keys, shapes and dtypes.
``state_from_numpy`` takes the JAX state as numpy arrays (what
``jax.device_get`` returns) and gives the port's state on ``device``;
``state_to_numpy`` goes back. With them a run can start in one package
and go on in the other, bit for bit (tests/test_torch_dht.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def state_from_numpy(np_state: dict, device="cuda") -> dict:
    """A nested dict of numpy arrays (or numpy scalars) as the port's
    state dict of tensors on ``device``. Dtypes are kept as they are."""
    dev = resolve_device(device)

    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return torch.from_numpy(np.array(v, copy=True)).to(dev)

    return conv(np_state)


def state_to_numpy(state: dict) -> dict:
    """The port's state dict as a nested dict of numpy arrays."""
    if isinstance(state, dict):
        return {k: state_to_numpy(v) for k, v in state.items()}
    return state.detach().cpu().numpy()


def flatten(tree: dict, prefix: str = "") -> dict:
    """``{"net/inbox": array, ...}``: the leaves of a nested state dict
    keyed by their path, for leaf-by-leaf comparisons."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, path + "/"))
        else:
            out[path] = v
    return out


def compare_leaves(a: dict, b: dict, what: str = "", skip=()) -> int:
    """Assert every leaf of two flattened numpy states bit-equal (floats
    by their bits), but the leaves whose last path component is in
    ``skip``; returns the number of leaves compared."""
    a = {k: v for k, v in a.items() if k.split("/")[-1] not in skip}
    b = {k: v for k, v in b.items() if k.split("/")[-1] not in skip}
    assert set(a) == set(b), (what, set(a) ^ set(b))
    for k in sorted(a):
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (what, k)
        if x.dtype.kind == "f":
            x, y = x.view(np.int32), y.view(np.int32)
        assert np.array_equal(x, y), f"{what}: differ at leaf {k}"
    return len(a)
