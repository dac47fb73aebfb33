"""CDF-matmul union histograms vs direct max-merge histograms."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from cuda_selection_criteria.ops import pairwise
from cuda_selection_criteria.utils import formats
import refmodels as rm
from conftest import REFERENCE, reference_available

RNG = np.random.default_rng(5)


def _rand_regs(n, p, max_val=None):
    q = 64 - p
    max_val = max_val or (q + 1)
    return RNG.integers(0, max_val + 1, size=(n, 1 << p), dtype=np.uint8)


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_union_histograms_exact(precision):
    p = 8
    a = _rand_regs(6, p)
    b = _rand_regs(5, p)
    got = np.asarray(
        pairwise.union_histograms(jnp.asarray(a), jnp.asarray(b), p, precision)
    )
    for i in range(6):
        for j in range(5):
            want = rm.sum_counts(np.maximum(a[i], b[j]))[: 64 - p + 2]
            np.testing.assert_array_equal(got[i, j], want)


def test_union_cardinality_matches_scalar():
    p = 14
    a = _rand_regs(3, p, max_val=20)
    b = _rand_regs(3, p, max_val=20)
    got = np.asarray(pairwise.union_cardinality(jnp.asarray(a), jnp.asarray(b), p))
    for i in range(3):
        for j in range(3):
            want = rm.union_size(a[i], b[j], p)
            assert got[i, j] == want


@pytest.mark.skipif(not reference_available(), reason="reference not mounted")
def test_union_on_committed_sketches():
    files = [
        line.strip()
        for line in open(os.path.join(REFERENCE, "test_influeza_filelist.txt"))
        if line.strip()
    ][:4]
    cores = np.stack(
        [formats.read_hll(os.path.join(REFERENCE, f) + ".hll")[1] for f in files]
    )
    got = np.asarray(
        pairwise.union_cardinality(jnp.asarray(cores), jnp.asarray(cores), 14)
    )
    for i in range(4):
        for j in range(4):
            want = rm.union_size(cores[i], cores[j], 14)
            assert got[i, j] == want


def test_cdf_matmul_sharding_decomposition():
    """Partial CDFs over register slices must sum to the full CDF (the
    correctness basis for the 'regs' mesh axis psum)."""
    p = 8
    r = 1 << p
    a = _rand_regs(4, p)
    b = _rand_regs(4, p)
    full = np.asarray(pairwise.cdf_matmul(jnp.asarray(a), jnp.asarray(b), p))
    half = r // 2
    part = np.asarray(
        pairwise.cdf_matmul(jnp.asarray(a[:, :half]), jnp.asarray(b[:, :half]), p)
    ) + np.asarray(
        pairwise.cdf_matmul(jnp.asarray(a[:, half:]), jnp.asarray(b[:, half:]), p)
    )
    np.testing.assert_array_equal(full, part)
