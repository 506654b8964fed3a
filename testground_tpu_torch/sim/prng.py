"""Threefry-2x32 counter-based PRNG, bit-exact with ``jax.random``.

The JAX package draws every random number through ``jax.random`` with its
default threefry2x32 implementation; the port must draw the very same
bits, so this module re-derives them from torch integer ops. A key is an
int64 tensor of shape ``[..., 2]`` holding two uint32 words (values in
``[0, 2**32)``); every uint32 operation is done in int64 and masked back
to 32 bits, so nothing depends on signed overflow.

Layout notes (jax 0.9.0, ``jax_threefry_partitionable=True``):

- ``random_bits`` for a shape draws element ``i`` (row-major flat index)
  from the counter pair ``(i >> 32, i & 0xffffffff)`` and keeps
  ``y0 ^ y1`` of the hashed pair;
- ``split(key)`` makes subkey ``j`` from the hashed counter ``(0, j)``;
- ``fold_in(key, d)`` hashes the counter ``(0, d as uint32)``.

``uniform`` builds its float from the top 23 bits (``bits >> 9 |
0x3f800000``, minus 1.0) and ``randint`` uses jax's two-draw modular
construction. All functions are plain tensor code, so they run under
``torch.func.vmap`` (per-instance keys) and on any device.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_INT32_MIN, _INT32_MAX = -(2**31), 2**31 - 1


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & _M32


def _mul32(a, b):
    """(a * b) mod 2**32 for a, b in [0, 2**32), without int64 overflow."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & _M32


def threefry2x32(k1, k2, x0, x1):
    """The 20-round Threefry-2x32 hash of the counter pair (x0, x1) under
    the key (k1, k2). All arguments are int64 tensors (broadcastable)
    holding uint32 values; returns the hashed pair."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r)
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a seed in the int32 range: the
    key words are (seed >> 32 logical on int32 = 0, seed as uint32)."""
    seed = int(seed)
    if not _INT32_MIN <= seed <= _INT32_MAX:
        raise ValueError(f"seed {seed} outside the int32 range")
    return torch.tensor([0, seed & _M32], dtype=torch.int64, device=device)


def _scalar(v: int, like: torch.Tensor) -> torch.Tensor:
    """An int64 scalar on ``like``'s device, made by a fill on the device
    (no host-to-device copy, so a tick that draws can be captured in a
    CUDA graph)."""
    return torch.full((), v, dtype=torch.int64, device=like.device)


def _as_u32(data, like: torch.Tensor) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        return data.to(torch.int64) & _M32
    return _scalar(int(data) & _M32, like)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``; ``data`` (int32 values, as a Python int or
    a tensor of any shape) broadcasts against the key's batch dims."""
    d = _as_u32(data, key)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable layout): ``[..., num, 2]``."""
    j = torch.arange(num, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(
        key[..., 0, None], key[..., 1, None], torch.zeros_like(j), j
    )
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element of ``shape`` (int64 values in
    ``[0, 2**32)``), the partitionable counter layout."""
    shape = tuple(shape)
    size = int(np.prod(shape)) if shape else 1
    if size >= 2**32:
        raise NotImplementedError("random bits beyond 2**32 elements")
    lo = torch.arange(size, dtype=torch.int64, device=key.device).reshape(shape)
    extra = (1,) * len(shape)
    k1 = key[..., 0].reshape(key.shape[:-1] + extra)
    k2 = key[..., 1].reshape(key.shape[:-1] + extra)
    y0, y1 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return y0 ^ y1


def uniform(key: torch.Tensor, shape=(), minval=0.0, maxval=1.0):
    """``jax.random.uniform`` in float32 over ``[minval, maxval)``."""
    bits = random_bits(key, shape)
    float_bits = (bits >> 9) | 0x3F800000  # < 2**31: fits int32
    floats = float_bits.to(torch.int32).view(torch.float32) - 1.0
    lo = np.float32(minval)
    span = np.float32(maxval) - lo
    return torch.clamp(floats * float(span) + float(lo), min=float(lo))


def _int_operand(v, like: torch.Tensor) -> torch.Tensor:
    """An int32-valued randint bound as int64, clipped to the int32 range
    (jax's _convert_and_clip_integer)."""
    if isinstance(v, torch.Tensor):
        t = v.to(torch.int64)
    else:
        t = _scalar(int(v), like)
    return torch.clamp(t, _INT32_MIN, _INT32_MAX)


def randint(key: torch.Tensor, shape, minval, maxval) -> torch.Tensor:
    """``jax.random.randint`` with dtype int32: two 32-bit draws from the
    split key folded into the span with jax's modular construction."""
    shape = tuple(shape)
    lo_v = _int_operand(minval, key)
    hi_v = _int_operand(maxval, key)
    keys = split(key, 2)
    higher = random_bits(keys[..., 0, :], shape)
    lower = random_bits(keys[..., 1, :], shape)
    span = (hi_v - lo_v) & _M32
    span = torch.where(hi_v <= lo_v, torch.ones_like(span), span)
    mult = (2**16) % span
    mult = _mul32(mult, mult) % span
    off = (_mul32(higher % span, mult) + lower % span) & _M32
    off = off % span
    res = (lo_v + off) & _M32
    res = torch.where(res > _INT32_MAX, res - 2**32, res)
    return res.to(torch.int32)
