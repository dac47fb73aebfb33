"""Batched ERTL-MLE bit-exactness vs the scalar oracle, plus statistical
accuracy checks in the style of the vendored library's hlltest.cpp."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from cuda_selection_criteria.ops import estimators, hll_build
from cuda_selection_criteria.utils import formats
import refmodels as rm
from conftest import REFERENCE, reference_available

RNG = np.random.default_rng(99)


def _random_histograms(p, n, max_card_exp=24):
    """Histograms from synthetic register banks of varied cardinality."""
    hists = []
    for i in range(n):
        card = int(RNG.integers(1, 1 << int(RNG.integers(4, max_card_exp))))
        kms = RNG.integers(0, 1 << 63, size=min(card, 200000), dtype=np.uint64)
        core = rm.build_hll([int(x) for x in kms], p)
        hists.append(rm.sum_counts(core))
    return np.stack(hists)


@pytest.mark.parametrize("p", [8, 14])
def test_mle_bit_exact_vs_oracle(p):
    hists = _random_histograms(p, 12)
    got = np.asarray(estimators.ertl_mle(jnp.asarray(hists), p))
    want = np.array([rm.ertl_ml_estimate(h, p) for h in hists])
    np.testing.assert_array_equal(got, want)


def test_mle_empty_sketch_is_zero():
    p = 10
    c = np.zeros((1, 64))
    c[0, 0] = 1 << p
    got = np.asarray(estimators.ertl_mle(jnp.asarray(c), p))
    assert got[0] == 0.0


def test_mle_saturated_sketch_is_inf():
    p = 6
    q = 64 - p
    c = np.zeros((1, 64))
    c[0, q + 1] = 1 << p
    got = np.asarray(estimators.ertl_mle(jnp.asarray(c), p))
    assert np.isinf(got[0])


def test_mle_mixed_batch_convergence_isolated():
    """Elements with different iteration counts must not perturb each other."""
    p = 12
    hists = _random_histograms(p, 6)
    batch = np.asarray(estimators.ertl_mle(jnp.asarray(hists), p))
    singles = np.array(
        [np.asarray(estimators.ertl_mle(jnp.asarray(h[None]), p))[0] for h in hists]
    )
    np.testing.assert_array_equal(batch, singles)


def test_statistical_accuracy():
    """|report() - n| <= 2 * est_err, style of sketch/testsrc/hlltest.cpp:80."""
    p = 14
    n_items = 50000
    kms = RNG.integers(0, 1 << 63, size=n_items, dtype=np.uint64)
    regs = hll_build.hll_build_batch(
        jnp.asarray(kms),
        jnp.ones(kms.shape, bool),
        jnp.zeros(kms.shape, jnp.int32),
        p,
        1,
    )
    est = float(estimators.ertl_mle_from_regs(regs, p)[0])
    rel_err = 1.03896 / np.sqrt(1 << p)
    assert abs(est - n_items) <= 2 * rel_err * n_items


def test_original_estimator_matches_device_model():
    """ORIGINAL estimator vs a scalar transcription of
    criteria_sketch_cuda.cuh:30-65."""
    p = 14
    m = 1 << p
    hists = _random_histograms(p, 8)
    got = np.asarray(estimators.original_estimate(jnp.asarray(hists), p))
    import math

    for hi, h in enumerate(hists):
        zeros = h[0]
        s = float(zeros)
        for r_val in range(1, 64 - p + 2):
            s += math.ldexp(float(h[r_val]), -r_val)
        alpha = 0.7213 / (1 + 1.079 / m)
        raw = alpha * m * m / s
        if raw < 2.5 * m and zeros:
            raw = m * math.log(m / zeros)
        elif raw > (1 << 32) / 30.0:
            raw = -(1 << 32) * math.log1p(-raw / (1 << 32))
        assert got[hi] == pytest.approx(raw, rel=0, abs=1e-9)


@pytest.mark.skipif(not reference_available(), reason="reference not mounted")
def test_mle_on_committed_sketches():
    files = [
        line.strip()
        for line in open(os.path.join(REFERENCE, "test_influeza_filelist.txt"))
        if line.strip()
    ]
    cores = np.stack(
        [formats.read_hll(os.path.join(REFERENCE, f) + ".hll")[1] for f in files]
    )
    got = np.asarray(estimators.ertl_mle_from_regs(jnp.asarray(cores), 14))
    want = np.array([rm.report(c, 14) for c in cores])
    np.testing.assert_array_equal(got, want)
