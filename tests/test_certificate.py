"""Machine check of the screen certificate (DESIGN.md "Screen certificate").

The screened engines drop a pair without host confirmation only via the
statistic  t_lb(S, Z) = 2m(m-Z)/(3S-Z)  computed from the fused kernel's
harmonic sum S and zero count Z. The exactness contract needs

    t_lb  <=  ertl_mle(histogram)        (the implemented f64 MLE)

for EVERY reachable histogram at EVERY precision — a theorem, not a
measured margin (VERDICT r4 missing #1; the reference's CPU path IS the
MLE, sketch/include/sketch/hll.h:629-688). The proof has three legs,
each machine-checked here:

  (A) exact-rational algebra: m*x0_weak >= t_lb where x0_weak =
      m'/(g0/2 + a) is Ertl's weak secant start. In Fraction arithmetic
      the difference of the two denominators is exactly
      c[q+1]*2^-(q+2) >= 0, so the check is exhaustive over the bins the
      formulas depend on: (c[0], c[q+1]) lattice x z_e extremes (the
      z_e terms cancel identically — asserted too).
  (B) strong-branch dominance: when the implementation starts from
      x0_strong = (m'/g0)*log1p(g0/a) (g0 > 1.5a), x0_strong >= x0_weak
      by the Pade bound log(1+r) >= 2r/(2+r); checked on a dense grid of
      the only free variable r = g0/a over its full branch domain.
  (C) secant monotonicity: ops/estimators.ertl_mle only ever steps UP
      from x0 (the update (g-m')/(gprev-g) is taken only when
      gprev < g <= m', making it >= 0); asserted as est >= m*x0 >= t_lb
      against the real f64 implementation over adversarial + simulated
      histogram families at every p in 5..14.

Plus (D): the f32 kernel-side evaluation of t_lb deviates from the exact
rational value by orders of magnitude less than the SCREEN_DELTA_DEFAULT
slack folded into tau_scr, and (E) the truncated-telescope direction
(truncation raises S, t_lb decreasing in S => superset).
"""

import math
from fractions import Fraction

import numpy as np
import jax.numpy as jnp
import pytest

from cuda_selection_criteria.ops import estimators, screen
from cuda_selection_criteria.parallel.screened import (
    SCREEN_DELTA_DEFAULT,
    SCREEN_DELTA_AUX,
)


def _x0_weak_q(m, q, c0, cq1, z_e):
    """Ertl's weak secant start m'/(g0/2 + a), exact rational.

    a = z_e + c0, g0 = z_e + cq1*2^-q, m' = m - c0
    (ops/estimators.py:130-137, reference hll.h:662-666).
    """
    a = z_e + c0
    g0 = z_e + Fraction(cq1, 2**q)
    m_prime = m - c0
    denom = Fraction(g0, 2) + a
    if denom == 0:
        return None  # empty sketch: x0 = 0/0 guarded upstream (c0 == m)
    return Fraction(m_prime, 1) / denom


def _t_lb_q(m, q, c0, cq1, z_e):
    s = c0 + z_e + Fraction(cq1, 2 ** (q + 1))
    denom = 3 * s - c0
    if denom == 0:
        return Fraction(0)
    return Fraction(2 * m * (m - c0), 1) / denom


@pytest.mark.parametrize("p", [5, 6, 8, 11, 14])
def test_A_weak_start_dominates_t_lb_exact_rational(p):
    """(A) m*x0_weak >= t_lb, exhaustively over the bins both formulas
    depend on, in exact rational arithmetic (no float rounding at all).

    Both sides depend on the histogram ONLY through (c0, cq1, z_e) where
    z_e = sum_{k=1..q} c[k] 2^-k; the z_e terms of the two denominators
    are identical (1.5*z_e each), so the lattice over (c0, cq1) with the
    z_e extremes is a complete case analysis."""
    m = 1 << p
    q = 64 - p
    # every (c0, cq1) with c0 + cq1 <= m, c0 stride keeps p=14 fast while
    # still exact (the inequality is affine in c0 on each branch)
    step = max(1, m // 64)
    c0s = sorted(set(list(range(0, m + 1, step)) + [0, 1, m - 1, m]))
    for c0 in c0s:
        for cq1 in sorted({0, 1, (m - c0) // 2, m - c0}):
            if cq1 < 0 or c0 + cq1 > m:
                continue
            rest = m - c0 - cq1
            # z_e extremes: all remaining mass at k=1 (max) or k=q (min),
            # plus an uneven two-bin split
            z_es = {Fraction(rest, 2), Fraction(rest, 2**q)}
            if rest >= 2:
                z_es.add(Fraction(1, 2) + Fraction(rest - 1, 2**q))
            for z_e in z_es:
                t_lb = _t_lb_q(m, q, c0, cq1, z_e)
                if c0 == m:
                    assert t_lb == 0  # empty union: screen passes, e=0
                    continue           # masks drop the pair downstream
                x0 = _x0_weak_q(m, q, c0, cq1, z_e)
                assert x0 is not None
                diff = m * x0 - t_lb
                assert diff >= 0, (p, c0, cq1, z_e, float(diff))
                if cq1 == 0:
                    # the bound is exactly Ertl's start when nothing is
                    # saturated — no slack was given away
                    assert diff == 0, (p, c0, cq1, z_e)


def test_A_denominator_identity():
    """(A) cont.: the two denominators differ by exactly cq1*2^-(q+2),
    independent of z_e and c0 — the algebraic heart of the certificate."""
    for p in (5, 14):
        q = 64 - p
        m = 1 << p
        for c0, cq1 in [(0, 0), (3, 5), (m // 2, m // 4), (0, m)]:
            for z_e in (Fraction(0), Fraction(7, 64), Fraction(m, 2)):
                a = z_e + c0
                g0 = z_e + Fraction(cq1, 2**q)
                d_weak = Fraction(g0, 2) + a            # x0_weak denominator
                s = c0 + z_e + Fraction(cq1, 2 ** (q + 1))
                d_lb = Fraction(3 * s - c0, 2)          # t_lb denominator
                assert d_lb - d_weak == Fraction(cq1, 2 ** (q + 2))


def test_B_strong_branch_dominates_weak():
    """(B) (m'/g0)*log1p(g0/a) >= m'/(g0/2 + a) over the strong branch's
    whole domain <=> log(1+r) >= 2r/(2+r) for r = g0/a > 1.5 (the Pade
    [1/1] lower bound of log; the gap at the branch point r=1.5 is ~7%,
    so float evaluation is nowhere near the margin)."""
    r = np.concatenate([
        np.linspace(1.5, 10.0, 20001),
        np.logspace(1, 18, 20001),  # up to r ~ 1e18 (g0 <= m, a >= 2^-q)
    ])
    lhs = np.log1p(r)
    rhs = 2.0 * r / (2.0 + r)
    assert np.all(lhs >= rhs * (1.0 + 1e-9))
    # and the bound also holds from r=0 (weak branch never lies above the
    # root either way): derivative check 4(1+r) <= (2+r)^2 <=> r^2 >= 0
    r0 = np.linspace(0.0, 1.5, 5001)
    assert np.all(np.log1p(r0) + 1e-15 >= 2.0 * r0 / (2.0 + r0))


def _hist_families(p, rng):
    """Adversarial + simulated register-value histograms, shape (B, q+2)."""
    q = 64 - p
    m = 1 << p
    rows = []
    # single-bin histograms: all mass at k, for every k
    for k in range(q + 2):
        h = np.zeros(q + 2, np.int64)
        h[k] = m
        rows.append(h)
    # two-bin splits incl. the adversarial zero+saturated mix
    for k1, k2 in [(0, 1), (0, q), (0, q + 1), (1, q + 1), (q, q + 1),
                   (1, 2), (2, 40)]:
        for f in (1, m // 4, m // 2, m - 1):
            h = np.zeros(q + 2, np.int64)
            h[k1] = f
            h[k2] = m - f
            rows.append(h)
    # simulated HLL(p) registers across the full cardinality range:
    # each register sees K ~ Binomial(n, 1/m) items, value = max of K
    # geometric ranks, capped at q+1
    for n_items in [1, 10, 100, 10**3, 10**4, 10**5, 10**7, 10**9]:
        ks = rng.binomial(min(n_items, 2**31 - 1), 1.0 / m, size=(4, m))
        u = rng.random((4, m))
        with np.errstate(divide="ignore"):
            vals = np.ceil(-np.log2(1.0 - u ** (1.0 / np.maximum(ks, 1))))
        vals = np.where(ks == 0, 0.0, np.clip(vals, 1, q + 1))
        for row in vals.astype(np.int64):
            rows.append(np.bincount(row, minlength=q + 2)[: q + 2])
    # random multinomials over random supports
    for _ in range(32):
        support = rng.choice(q + 2, size=rng.integers(1, 8), replace=False)
        w = rng.random(len(support))
        h = np.zeros(q + 2, np.int64)
        alloc = rng.multinomial(m, w / w.sum())
        h[support] = alloc
        rows.append(h)
    return np.stack(rows)


@pytest.mark.parametrize("p", [5, 6, 7, 8, 10, 12, 14])
def test_C_implemented_mle_never_below_t_lb(p):
    """(C) est = ertl_mle(hist) >= m*x0 >= t_lb against the REAL f64
    implementation, over adversarial + simulated families. This is the
    end-to-end certificate the screen relies on, covering both the
    primary precision and every aux precision (p_aux in 5..8)."""
    q = 64 - p
    m = 1 << p
    hists = _hist_families(p, np.random.default_rng(2026 + p))
    est = np.asarray(estimators.ertl_mle(jnp.asarray(hists), p))

    k = np.arange(q + 2)
    s = (hists * np.ldexp(1.0, -k)[None, :]).sum(-1)  # f64 exact-ish
    z = hists[:, 0].astype(np.float64)
    t_lb = 2.0 * m * (m - z) / (3.0 * s - z)

    # x0 exactly as ops/estimators.py:130-137 computes it
    z_e = (hists[:, 1:q + 1] * np.ldexp(1.0, -k[1:q + 1])[None, :]).sum(-1)
    a = z_e + hists[:, 0]
    g0 = z_e + hists[:, q + 1] * math.ldexp(1.0, -q)
    m_prime = m - hists[:, 0].astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        x0 = np.where(
            g0 <= 1.5 * a,
            m_prime / (0.5 * g0 + a),
            (m_prime / np.maximum(g0, 1e-300)) * np.log1p(g0 / a),
        )
    sat = hists[:, q + 1] == m  # est = inf: anything passes
    emp = hists[:, 0] == m      # empty union: t_lb = 0
    ok = ~sat & ~emp
    assert np.all(t_lb[emp] == 0.0)
    # 1e-12 absorbs this test's own f64 evaluation of t_lb/x0 (the
    # implementation's f64 rounding is covered by the 1e-3 screen slack,
    # ~1e11 times larger than f64 eps)
    assert np.all(m * x0[ok] >= t_lb[ok] * (1.0 - 1e-12)), p
    assert np.all(est[ok] >= m * x0[ok] * (1.0 - 1e-12)), p
    assert np.all(est[ok] >= t_lb[ok] * (1.0 - 1e-12)), p


@pytest.mark.parametrize("p", [8, 14])
def test_D_f32_evaluation_error_within_slack(p):
    """(D) kernel-side f32 t_lb vs exact rational t_lb: the relative
    error is orders of magnitude inside the 1e-3 tau_scr slack."""
    assert SCREEN_DELTA_DEFAULT >= 1e-3 and SCREEN_DELTA_AUX >= 1e-3
    q = 64 - p
    m = 1 << p
    hists = _hist_families(p, np.random.default_rng(7 * p))
    # exact rational t_lb
    exact = []
    for h in hists:
        s = sum(Fraction(int(c), 2**k) for k, c in enumerate(h))
        c0 = int(h[0])
        if c0 == m:
            exact.append(0.0)
        else:
            exact.append(float(Fraction(2 * m * (m - c0), 1) / (3 * s - c0)))
    exact = np.array(exact)
    # f32 path exactly as make_device_hist_fn computes it
    w = np.ldexp(np.ones(q + 2, np.float32), -np.arange(q + 2))
    s32 = (hists.astype(np.float32) * w[None, :].astype(np.float32)).sum(
        -1, dtype=np.float32)
    got = np.asarray(screen.mle_lower_bound(
        jnp.asarray(s32, jnp.float32),
        jnp.asarray(hists[:, 0], jnp.float32), p))
    ok = exact > 0
    rel = np.abs(got[ok] / exact[ok] - 1.0)
    assert rel.max() < SCREEN_DELTA_DEFAULT / 50, rel.max()


def test_E_truncation_is_conservative():
    """(E) truncate_values() only raises S, and t_lb is strictly
    decreasing in S — so a truncated screen passes a superset."""
    p, n = 8, 64
    rng = np.random.default_rng(3)
    regs = rng.integers(0, 30, size=(n, 1 << p), dtype=np.uint8)
    vals = screen.bank_values(regs)
    rows = jnp.asarray(np.zeros(1, np.int32))
    cols = jnp.asarray(np.zeros(1, np.int32))
    s_full, z_full = screen.screen_s_z(
        jnp.asarray(regs), rows, cols, p, vals, ti=n, tj=n)
    s_cut, z_cut = screen.screen_s_z(
        jnp.asarray(regs), rows, cols, p, vals[: len(vals) // 2],
        ti=n, tj=n)
    assert np.all(np.asarray(s_cut) >= np.asarray(s_full) - 1e-6)
    t_full = np.asarray(screen.mle_lower_bound(s_full, z_full, p))
    t_cut = np.asarray(screen.mle_lower_bound(s_cut, z_cut, p))
    assert np.all(t_cut <= t_full * (1.0 + 1e-6))


def test_mle_lower_bound_z_none_matches_z_zero():
    s = jnp.asarray(np.linspace(0.5, 256.0, 64), jnp.float32)
    a = np.asarray(screen.mle_lower_bound(s, None, 8))
    b = np.asarray(screen.mle_lower_bound(s, jnp.zeros_like(s), 8))
    np.testing.assert_array_equal(a, b)
