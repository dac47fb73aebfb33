"""Bit-exactness of the vectorized hash primitives vs scalar oracles."""

import numpy as np
import jax.numpy as jnp

from cuda_selection_criteria.ops import hashes
import refmodels as rm

RNG = np.random.default_rng(0xC0FFEE)


def _rand_u64(n):
    return RNG.integers(0, 1 << 64, size=n, dtype=np.uint64)


def test_wang_hash64():
    x = _rand_u64(4096)
    got = np.asarray(hashes.wang_hash64(jnp.asarray(x)))
    want = np.array([rm.wang(int(v)) for v in x], dtype=np.uint64)
    np.testing.assert_array_equal(got, want)


def test_wang_hash_edge_values():
    x = np.array([0, 1, (1 << 64) - 1, 1 << 63, 0xDEADBEEF], dtype=np.uint64)
    got = np.asarray(hashes.wang_hash64(jnp.asarray(x)))
    want = np.array([rm.wang(int(v)) for v in x], dtype=np.uint64)
    np.testing.assert_array_equal(got, want)


def test_canonical_kmer():
    kmask = (1 << 62) - 1
    x = _rand_u64(4096) & np.uint64(kmask)
    got = np.asarray(hashes.canonical_kmer(jnp.asarray(x), 31))
    want = np.array([rm.canonical(int(v), 31) for v in x], dtype=np.uint64)
    np.testing.assert_array_equal(got, want)


def test_canonical_kmer_other_k():
    for k in (15, 21, 32):
        kmask = (1 << (2 * k)) - 1 if k < 32 else (1 << 64) - 1
        x = _rand_u64(512) & np.uint64(kmask)
        got = np.asarray(hashes.canonical_kmer(jnp.asarray(x), k))
        want = np.array([rm.canonical(int(v), k) for v in x], dtype=np.uint64)
        np.testing.assert_array_equal(got, want)


def test_umul128_fold():
    a = _rand_u64(2048)
    b = _rand_u64(2048)
    got = np.asarray(hashes.umul128_fold(jnp.asarray(a), jnp.asarray(b)))
    want = np.array(
        [rm.wymum(int(x), int(y)) for x, y in zip(a, b)], dtype=np.uint64
    )
    np.testing.assert_array_equal(got, want)


def test_wyrand_draws_match_sequential():
    seeds = np.concatenate([_rand_u64(64), np.array([0], np.uint64)])
    n_draws = 9
    got = np.asarray(hashes.wyrand_draws(jnp.asarray(seeds), n_draws))
    for si, s in enumerate(seeds):
        state = int(s) if s != 0 else 1337
        for j in range(n_draws):
            state = (state + rm.WYC) & rm.M64
            draw = rm.wymum(state ^ rm.WYX, state)
            assert got[si, j] == draw, (si, j)


def test_clz64():
    x = np.array([0, 1, 2, (1 << 64) - 1, 1 << 63, 1 << 13], dtype=np.uint64)
    got = np.asarray(hashes.clz64(jnp.asarray(x)))
    want = np.array([rm.clz64(int(v)) for v in x], dtype=np.uint32)
    np.testing.assert_array_equal(got, want)
