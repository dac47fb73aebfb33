"""HLL construction bit-exactness vs scalar oracle and committed sketches."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from cuda_selection_criteria.models import HllSketch
from cuda_selection_criteria.ops import hll_build
from cuda_selection_criteria.utils import fasta, formats
import refmodels as rm
from conftest import REFERENCE, reference_available

RNG = np.random.default_rng(42)


def _files():
    return [
        line.strip()
        for line in open(os.path.join(REFERENCE, "test_influeza_filelist.txt"))
        if line.strip()
    ]


def test_hll_build_random_vs_oracle():
    kms = RNG.integers(0, 1 << 62, size=5000, dtype=np.uint64)
    for p in (8, 14):
        want = rm.build_hll([int(x) for x in kms], p)
        got = np.asarray(
            hll_build.hll_build_batch(
                jnp.asarray(kms),
                jnp.ones(kms.shape, bool),
                jnp.zeros(kms.shape, jnp.int32),
                p,
                1,
            )[0]
        )
        np.testing.assert_array_equal(got, want)


def test_hll_build_multi_genome_batch():
    kms = RNG.integers(0, 1 << 62, size=6000, dtype=np.uint64)
    gids = RNG.integers(0, 3, size=6000).astype(np.int32)
    got = np.asarray(
        hll_build.hll_build_batch(
            jnp.asarray(kms), jnp.ones(kms.shape, bool), jnp.asarray(gids), 10, 3
        )
    )
    for g in range(3):
        want = rm.build_hll([int(x) for x in kms[gids == g]], 10)
        np.testing.assert_array_equal(got[g], want)


def test_hll_streaming_merge_equals_oneshot():
    kms = RNG.integers(0, 1 << 62, size=4000, dtype=np.uint64)
    ones = jnp.ones(2000, bool)
    zeros = jnp.zeros(2000, jnp.int32)
    a = hll_build.hll_build_batch(jnp.asarray(kms[:2000]), ones, zeros, 12, 1)[0]
    b = hll_build.hll_build_batch(jnp.asarray(kms[2000:]), ones, zeros, 12, 1)[0]
    merged = np.asarray(hll_build.hll_merge_max(a, b))
    full = np.asarray(
        hll_build.hll_build_batch(
            jnp.asarray(kms), jnp.ones(4000, bool), jnp.zeros(4000, jnp.int32), 12, 1
        )[0]
    )
    np.testing.assert_array_equal(merged, full)


@pytest.mark.skipif(not reference_available(), reason="reference not mounted")
def test_hll_from_fasta_matches_committed_sketches():
    for f in _files()[:2]:
        path = os.path.join(REFERENCE, f)
        codes = fasta.fasta_codes(path)
        for p, suffix in ((14, ".hll"), (8, ".hll_8")):
            sk = HllSketch.from_codes(codes, p)
            _, ref_core, _ = formats.read_hll(path + suffix)
            np.testing.assert_array_equal(sk.core, ref_core)


@pytest.mark.skipif(not reference_available(), reason="reference not mounted")
def test_report_matches_scalar_oracle_on_committed():
    f = _files()[0]
    path = os.path.join(REFERENCE, f)
    sk = HllSketch.from_file(path + ".hll")
    want = rm.report(sk.core, 14)
    got = sk.report()
    assert got == want  # bit-identical f64
