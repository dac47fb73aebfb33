"""Criteria masks vs scalar transcriptions of criteria_sketch.hpp."""

import math

import numpy as np
import jax.numpy as jnp

from cuda_selection_criteria.ops import criteria, estimators
import refmodels as rm

RNG = np.random.default_rng(77)


def test_effective_tau_is_f32_widened():
    assert criteria.effective_tau(0.9) == np.float64(np.float32(0.9))
    assert criteria.effective_tau(0.9) != 0.9


def test_sigma_table():
    # criteria_sketch.hpp:7-20
    for p, coeff in [(4, 1.106), (5, 1.07), (6, 1.054), (7, 1.046), (8, 1.039),
                     (14, 1.039)]:
        assert estimators.sigma(p) == np.float32(coeff / math.sqrt(1 << p))


def test_cb_mask():
    e1 = np.array([10.0, 50.0, 100.0])
    e2 = np.array([100.0, 100.0, 100.0])
    got = np.asarray(criteria.cb_mask(jnp.asarray(e1), jnp.asarray(e2), 0.5))
    for i in range(3):
        for j in range(3):
            assert got[i, j] == (e1[i] / e2[j] >= 0.5)


def test_smh_band_params_reference_cases():
    # m=4: bands enumerate 1,2,4; m=32: reference divisor scan
    for m in (4, 8, 32, 64, 512):
        n_rows, n_bands = criteria.smh_band_params(m, 0.9)
        assert n_rows * n_bands == m
        # recompute with the reference float mixing
        exp_rows, exp_bands = 1, 1
        t32 = np.float32(0.9)
        for band in range(1, m + 1):
            if m % band:
                continue
            exp_bands, exp_rows = band, m // band
            inner = np.power(t32, np.float32(m) / np.float32(band))
            p_r = 1.0 - np.power(np.float64(1.0) - np.float64(inner),
                                 np.float64(np.float32(band)))
            if p_r >= 0.95:
                break
        assert (n_rows, n_bands) == (exp_rows, exp_bands)


def test_smh_a_mask_vs_scalar():
    m, n_rows, n_bands = 8, 2, 4
    a = RNG.integers(0, 4, size=(5, m)).astype(np.uint64)
    b = RNG.integers(0, 4, size=(6, m)).astype(np.uint64)
    got = np.asarray(
        criteria.smh_a_mask(jnp.asarray(a), jnp.asarray(b), n_rows, n_bands)
    )
    for i in range(5):
        for j in range(6):
            want = any(
                np.array_equal(
                    a[i, band * n_rows : (band + 1) * n_rows],
                    b[j, band * n_rows : (band + 1) * n_rows],
                )
                for band in range(n_bands)
            )
            assert got[i, j] == want


def _scalar_hll_a(tau, e1, e2, core_a, core_b, p, z=1.96):
    # criteria_sketch.hpp:36-43,60-64 with exact float mixing
    t_hat = int(rm.union_size(core_a, core_b, p))  # size_t truncation
    zs = np.float64(np.float32(z) * np.float32(estimators.sigma(p)))
    t_hat_mas = t_hat / (1.0 + zs)
    gamma = e1 / e2
    k_mas = ((1.0 + gamma) * e2 - t_hat_mas) / t_hat_mas
    return k_mas >= tau


def _scalar_hll_an(tau, e1, e2, core_a, core_b, p, z=1.96, order_n=1):
    # criteria_sketch.hpp:22-34,52-58
    t_hat = rm.union_size(core_a, core_b, p)
    gamma = e1 / e2
    j_hat = (e1 + e2 - t_hat) / t_hat
    zs = np.float64(np.float32(z) * np.float32(estimators.sigma(p)))
    s = 0.0
    num = 1.0
    for _ in range(order_n):
        num *= zs
        s += num
    minimo = min(1.0, (1.0 + zs) * e2 / t_hat)
    c = minimo * (1 + gamma) * s
    return (j_hat + c) >= tau


def test_hll_a_and_an_masks_vs_scalar():
    p = 8
    n = 4
    cores = []
    cards = []
    for _ in range(n):
        kms = RNG.integers(0, 1 << 63, size=int(RNG.integers(100, 5000)),
                           dtype=np.uint64)
        core = rm.build_hll([int(x) for x in kms], p)
        cores.append(core)
        cards.append(float(int(rm.report(core, p))))
    cores = np.stack(cores)
    cards = np.array(cards)
    tau = criteria.effective_tau(0.5)
    zs = criteria.z_sigma(1.96, p)

    got_a = np.asarray(
        criteria.hll_a_mask(
            jnp.asarray(cores), jnp.asarray(cores), jnp.asarray(cards),
            jnp.asarray(cards), tau, zs, p,
        )
    )
    got_an = np.asarray(
        criteria.hll_an_mask(
            jnp.asarray(cores), jnp.asarray(cores), jnp.asarray(cards),
            jnp.asarray(cards), tau, zs, p, 1,
        )
    )
    for i in range(n):
        for j in range(n):
            assert got_a[i, j] == _scalar_hll_a(
                tau, cards[i], cards[j], cores[i], cores[j], p
            ), (i, j)
            assert got_an[i, j] == _scalar_hll_an(
                tau, cards[i], cards[j], cores[i], cores[j], p
            ), (i, j)
