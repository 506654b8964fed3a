"""The port's threefry PRNG (testground_tpu_torch/sim/prng.py) against
jax.random, value for value: keys, chained fold_in, uniform and randint,
per lane under vmap as the tick does it. Exact equality (floats by their
bits)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from testground_tpu_torch.sim import prng


def _key_np(k):
    return np.asarray(k).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 42, 12345, 2**31 - 1, -1, -(2**31)])
def test_prng_key(seed):
    np.testing.assert_array_equal(
        _key_np(jax.random.PRNGKey(seed)), prng.PRNGKey(seed).numpy()
    )


@pytest.mark.parametrize("seed", [0, 7, 99])
def test_fold_in_chain(seed):
    kj, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for d in (0, 7, 1, 12345, 2**31 - 1, -5, -(2**31)):
        kj = jax.random.fold_in(kj, np.int32(d))
        kt = prng.fold_in(kt, d)
        np.testing.assert_array_equal(_key_np(kj), kt.numpy())


def test_fold_in_batched_matches_vmap():
    key = jax.random.PRNGKey(3)
    ids = np.arange(-50, 700, dtype=np.int32)
    want = jax.vmap(lambda i: jax.random.fold_in(key, i))(ids)
    got = prng.fold_in(prng.PRNGKey(3), torch.from_numpy(ids))
    np.testing.assert_array_equal(_key_np(want), got.numpy())


@pytest.mark.parametrize("shape", [(), (1,), (5,), (1000,), (3, 4)])
def test_uniform(shape):
    for seed in (0, 11):
        kj = jax.random.fold_in(jax.random.PRNGKey(seed), 7)
        kt = prng.fold_in(prng.PRNGKey(seed), 7)
        want = np.asarray(jax.random.uniform(kj, shape))
        got = prng.uniform(kt, shape).numpy()
        assert want.dtype == got.dtype == np.float32
        np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))


def test_uniform_under_jit():
    """The tick draws under jit (XLA may rewrite the float ops); the
    bits must not move."""
    kj = jax.random.PRNGKey(5)
    want = np.asarray(jax.jit(lambda k: jax.random.uniform(k, (4096,)))(kj))
    got = prng.uniform(prng.PRNGKey(5), (4096,)).numpy()
    np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))


@pytest.mark.parametrize("hi", [1, 2, 3, 7, 300, 10_000, 2**20 + 1,
                                2**31 - 1])
@pytest.mark.parametrize("shape", [(), (64,)])
def test_randint(hi, shape):
    for seed in (0, 5):
        kj, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
        want = np.asarray(jax.random.randint(kj, shape, 0, hi))
        got = prng.randint(kt, shape, 0, hi).numpy()
        assert want.dtype == got.dtype == np.int32
        np.testing.assert_array_equal(want, got)


def test_randint_negative_and_empty_range():
    kj, kt = jax.random.PRNGKey(9), prng.PRNGKey(9)
    for lo, hi in ((-3, 300), (-(2**31), 2**31 - 1), (5, 5), (7, 2)):
        want = np.asarray(jax.random.randint(kj, (32,), lo, hi))
        got = prng.randint(kt, (32,), lo, hi).numpy()
        np.testing.assert_array_equal(want, got)


def test_randint_per_lane_under_vmap():
    """The dht setup phase: randint(fold_in(fold_in(base, tick), lane))
    per lane, batched with vmap on both sides."""
    n = 300
    base = jax.random.fold_in(jax.random.PRNGKey(0), jnp.int32(4))
    ids = np.arange(n, dtype=np.int32)
    want = jax.jit(jax.vmap(
        lambda i: jax.random.randint(
            jax.random.fold_in(base, i), (), 0, jnp.maximum(n, 1))
    ))(ids)
    keys = prng.fold_in(prng.fold_in(prng.PRNGKey(0), 4),
                        torch.from_numpy(ids))
    got = torch.func.vmap(lambda k: prng.randint(k, (), 0, n))(keys)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
