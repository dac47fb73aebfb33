"""SuperMinHash: the parallel min-reduce formulation must equal the
sequential reference algorithm (with its a_/b_ early exit) bit-for-bit."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from cuda_selection_criteria.models import SuperMinHashSketch
from cuda_selection_criteria.models.smh import vecsize
from cuda_selection_criteria.ops import smh_build
from cuda_selection_criteria.utils import fasta, formats
import refmodels as rm
from conftest import REFERENCE, reference_available

RNG = np.random.default_rng(1234)


def test_vecsize_matches_pow2_policy():
    # SizePow2Policy::arg2vecsize (policy.h:15-19)
    for arg, want in [(1, 1), (2, 2), (3, 4), (4, 4), (5, 8), (31, 32),
                      (32, 32), (33, 64), (64, 64)]:
        assert vecsize(arg) == want


@pytest.mark.parametrize("m", [4, 8, 32])
def test_parallel_equals_sequential(m):
    kms = RNG.integers(0, 1 << 62, size=800, dtype=np.uint64)
    want = rm.build_smh_sequential([int(x) for x in kms], m)
    got = np.asarray(
        smh_build.smh_build_batch(
            jnp.asarray(kms),
            jnp.ones(kms.shape, bool),
            jnp.zeros(kms.shape, jnp.int32),
            m,
            1,
        )[0]
    )
    np.testing.assert_array_equal(got, want)


def test_parallel_with_zero_seed_item():
    # kmer == 0 must use WyRand's seed remap 0 -> 1337
    kms = np.array([0, 5, 9], dtype=np.uint64)
    want = rm.build_smh_sequential([0, 5, 9], 8)
    got = np.asarray(
        smh_build.smh_build_batch(
            jnp.asarray(kms), jnp.ones(3, bool), jnp.zeros(3, jnp.int32), 8, 1
        )[0]
    )
    np.testing.assert_array_equal(got, want)


def test_merge_min_equals_oneshot():
    kms = RNG.integers(0, 1 << 62, size=600, dtype=np.uint64)
    ones = jnp.ones(300, bool)
    zeros = jnp.zeros(300, jnp.int32)
    a = smh_build.smh_build_batch(jnp.asarray(kms[:300]), ones, zeros, 16, 1)[0]
    b = smh_build.smh_build_batch(jnp.asarray(kms[300:]), ones, zeros, 16, 1)[0]
    merged = np.asarray(smh_build.smh_merge_min(a, b))
    full = rm.build_smh_sequential([int(x) for x in kms], 16)
    np.testing.assert_array_equal(merged, full)


@pytest.mark.skipif(not reference_available(), reason="reference not mounted")
@pytest.mark.parametrize("m", [4, 64])
def test_smh_from_fasta_matches_committed_sketches(m):
    files = [
        line.strip()
        for line in open(os.path.join(REFERENCE, "test_influeza_filelist.txt"))
        if line.strip()
    ][:2]
    for f in files:
        path = os.path.join(REFERENCE, f)
        codes = fasta.fasta_codes(path)
        sk = SuperMinHashSketch.from_codes(codes, m)
        ref_h = formats.read_smh(path + f".smh{m}")
        np.testing.assert_array_equal(sk.h, ref_h)


def test_chunked_j0_min_merge_equals_full_single_pass():
    """sketch_codes_device's piece-wise SuperMinHash (j0 fast path per
    piece, elementwise min merge) must equal the single-pass full build:
    j0 candidates always beat j>0, so a j0-complete piece's min IS its
    unbounded candidate min, and mins compose across pieces."""
    import numpy as np
    import jax.numpy as jnp
    from cuda_selection_criteria.models import bank as B
    from cuda_selection_criteria.ops import kmers as kmer_ops, smh_build

    rng = np.random.default_rng(5)
    codes = np.concatenate(
        [[4], rng.integers(0, 4, size=200_000, dtype=np.uint8)]
    ).astype(np.uint8)
    # emulate the chunked path with a tiny 64k piece budget
    pos, overlap, mc = 0, 30, 65536
    aux = None
    while pos == 0 or pos < codes.size:
        lo = max(0, pos - overlap)
        piece = codes[lo:pos + mc]
        pos += mc
        blen = B._bucket_len(piece.size)
        if piece.size < blen:
            piece = np.concatenate(
                [piece, np.full(blen - piece.size, 4, np.uint8)])
        kms, valid = kmer_ops.canonical_kmers(jnp.asarray(piece), 31)
        zeros = jnp.zeros(kms.shape, jnp.int32)
        a_j0, comp = smh_build.smh_build_batch_j0(kms, valid, zeros, 32, 1)
        a = (a_j0[0] if bool(comp)
             else smh_build.smh_build_batch_full(kms, valid, zeros, 32, 1)[0])
        aux = a if aux is None else jnp.minimum(aux, a)
    kms, valid = kmer_ops.canonical_kmers(jnp.asarray(codes), 31)
    want = smh_build.smh_build_batch(
        kms, valid, jnp.zeros(kms.shape, jnp.int32), 32, 1)[0]
    np.testing.assert_array_equal(np.asarray(aux), np.asarray(want))
