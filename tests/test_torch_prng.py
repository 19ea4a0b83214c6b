"""The port's threefry2x32 key chain against ``jax.random``, bit for bit.

The reference's keyed policy (``random``) and its policy carry draw from
``jax.random`` (jax 0.9.0, ``jax_threefry_partitionable=True``, 64-bit
types off); ``repro_torch.core.prng`` must return the same ``uint32`` words
for the same key: keys from seeds, splits, fold-ins, raw bits and
``randint`` over the spans and shapes the policies use, and the fleet's key
grid.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as R  # noqa: E402

import repro_torch.core as P  # noqa: E402
from repro_torch.core import prng  # noqa: E402

SEEDS = (0, 1, 2, 2**31 - 1, 2**31, 2**32 + 5, 2**40 + 3, -1)
SPANS = (1, 10, 21, 1024)
SHAPES = ((0,), (1,), (4,), (256,), (3, 5))


def jkey(seed):
    return np.asarray(jax.random.PRNGKey(seed))


def assert_words(got, want):
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_threefry_partitionable_is_on():
    """The reference's key chain is the partitionable one; the port
    reproduces that mode only."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_from_seed(seed):
    assert_words(prng.PRNGKey(seed), jkey(seed))


@pytest.mark.parametrize("n", [1, 2, 3, 7, 100, 16 * 10])
@pytest.mark.parametrize("seed", SEEDS)
def test_split(seed, n):
    assert_words(prng.split(jkey(seed), n), jax.random.split(jkey(seed), n))


@pytest.mark.parametrize("data", [0, 1, 5, 2**31 - 1, 2**32 - 1])
@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in(seed, data):
    assert_words(prng.fold_in(jkey(seed), data), jax.random.fold_in(jkey(seed), data))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", (0, 1, 2**31 - 1))
def test_random_bits(seed, shape):
    assert_words(prng.random_bits(jkey(seed), shape), jax.random.bits(jkey(seed), shape))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("seed", (0, 1, 2**31 - 1))
def test_randint(seed, span, shape):
    key = jkey(seed)
    assert_words(prng.randint(key, shape, 0, span), jax.random.randint(key, shape, 0, span))
    # an offset range, and an empty one (returns minval)
    assert_words(prng.randint(key, shape, -3, span - 3),
                 jax.random.randint(key, shape, -3, span - 3))
    assert_words(prng.randint(key, shape, 4, 4), jax.random.randint(key, shape, 4, 4))


def test_batched_keys_match_one_key_at_a_time():
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(3), 6))
    want = np.stack([np.asarray(jax.random.randint(k, (9,), 0, 10)) for k in keys])
    assert_words(prng.randint(keys, (9,), 0, 10), want)
    assert_words(prng.split(keys, 4), np.stack([np.asarray(jax.random.split(k, 4)) for k in keys]))


@pytest.mark.parametrize("seed", (0, 7))
def test_fleet_key_grid(seed):
    """The dense fleet's one key per (replication, frame) and the carry's
    per-replication chain ``fold_in(PRNGKey(seed), r)``."""
    n_rep, T = 5, 10
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), n_rep * T)).reshape(n_rep, T, -1)
    assert_words(prng.split(prng.PRNGKey(seed), n_rep * T).reshape(n_rep, T, 2), want)
    ref = R.fleet_policy_carry(n_rep, 4, seed=seed)
    got = P.fleet_policy_carry(n_rep, 4, seed=seed, device="cpu")
    assert_words(got.key.numpy(), ref.key)
    assert_words(P.init_policy_carry(4, seed=seed, device="cpu").key.numpy(),
                 R.init_policy_carry(4, seed=seed).key)
