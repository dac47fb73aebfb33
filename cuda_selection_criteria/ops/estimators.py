"""Batched HyperLogLog cardinality estimators (bit-exact, f64).

* ertl_mle:  Ertl's maximum-likelihood estimator (Algorithm 8), the default
  estimator of the reference for both report() and union_size()
  (reference: sketch/include/sketch/hll.h:629-688, dispatched at :211-263).
  The reference's scalar secant loop has data-dependent trip counts; here it
  is vectorized over a batch of register histograms with per-element
  freeze masks so every element performs exactly the same f64 operation
  sequence as the scalar loop - bit-identical results (tests/test_estimators.py).

* original_estimate: the Flajolet-et-al. ORIGINAL estimator with linear
  counting and large-range corrections, used by the reference's CUDA kernels
  (reference: include/criteria_sketch_cuda.cuh:30-65, host twin hll.h:217-237).
  Provided for GPU-parity experiments.

Histograms use bins 0..q+1 (q = 64 - p); counts arrays may be longer.
"""

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .fpx import rounded

# Exact powers of two, built host-side. XLA's exp2 is NOT exact even
# for integer arguments (off by 1 ulp for many exponents, verified on CPU),
# so scaling by 2^e goes through this table: a gather plus one multiply by
# an exact power of two is correctly rounded, identical to C ldexp. The
# table covers |e| <= 120, far beyond any exponent the estimators see.
_POW2_LO = -120
_POW2_HI = 120
_POW2 = np.ldexp(1.0, np.arange(_POW2_LO, _POW2_HI + 1)).astype(np.float64)


def pow2_exact(e, dtype=jnp.float64):
    """2.0**e for integer e in [-120, 120] (clamped), exact (also exact in
    f32 within its exponent range)."""
    idx = jnp.clip(e - _POW2_LO, 0, _POW2_HI - _POW2_LO)
    return jnp.asarray(_POW2).astype(dtype)[idx]


def ldexp_exact(x, e):
    """x * 2^e, correctly rounded (== C ldexp for |e| <= 120)."""
    return x * pow2_exact(e, x.dtype)


def frexp_exponent(x):
    """C frexp's exponent e (x = m * 2^e, m in [0.5, 1)) for positive x.

    log2 guess corrected against exact powers of two - exact for positive
    x within the pow2 table range on every backend (frexp(0) returns 0,
    like C).
    """
    e = jnp.floor(jnp.log2(x)).astype(jnp.int32) + 1
    e = jnp.where(x >= pow2_exact(e, x.dtype), e + 1, e)
    e = jnp.where(x < pow2_exact(e - 1, x.dtype), e - 1, e)
    return jnp.where(x > 0, e, 0)


def hll_histogram(regs, p):
    """Register-value histogram c[v] = #{r : regs[r] == v}.

    Batched equivalent of sum_counts (reference: hll.h:564-583). Returns
    float64 (..., q+2) counts for bins 0..q+1.
    """
    nbins = 64 - p + 2
    v = jnp.arange(nbins, dtype=regs.dtype)
    onehot = regs[..., None] == v  # (..., m, nbins)
    # f32 storage is exact: counts <= 2^p < 2^24.
    return jnp.sum(onehot, axis=-2, dtype=jnp.float32)


@partial(jax.jit, static_argnames=("p", "dtype"))
def ertl_mle(counts, p, relerr=1e-2, dtype=jnp.float64):
    """Batched Ertl ML cardinality estimate from register histograms.

    Args:
      counts: (..., >= q+2) register-value histogram (c[0..q+1] used).
      p: static HLL precision.
      relerr: relative error target (reference default 1e-2).
      dtype: compute dtype. float64 is bit-identical to the reference's
        scalar loop (CPU and GPU). float32 is a screening mode: ~1e-6
        relative accuracy, covered by the dense engine's screen margin +
        host adjudication.

    Returns:
      `dtype` (...) cardinality estimates (inf where c[q+1] == m).
    """
    q = 64 - p
    m = 1 << p
    # Histograms are stored f32 (exact for counts <= 2^p < 2^24) to halve the
    # memory footprint of large pair blocks; arithmetic runs in `dtype`,
    # with columns widened at each use - in f64 this is the identical
    # operation sequence to the reference.
    c = jnp.asarray(counts)[..., : q + 2].astype(jnp.float32)
    batch_shape = c.shape[:-1]
    c = c.reshape(-1, q + 2)

    def col(k):
        """c[:, k] widened to the compute dtype (exact)."""
        return c[:, k].astype(dtype)

    is_inf = c[:, q + 1] == m

    nz = c > 0
    k_min = jnp.argmax(nz, axis=1)  # first nonzero bin
    k_min_p = jnp.maximum(1, k_min)
    k_max = (q + 1) - jnp.argmax(nz[:, ::-1], axis=1)  # last nonzero bin
    k_max = jnp.where(jnp.any(nz, axis=1), k_max, 0)
    k_max_p = jnp.minimum(q, k_max)

    # z = sum_{k=kMinP..kMaxP} c[k] * 2^-k, accumulated high-to-low exactly
    # like the reference loop (hll.h:671-673).
    def z_body(i, z):
        k = q - i  # k runs q..1
        in_range = (k >= k_min_p) & (k <= k_max_p)
        ck = jax.lax.dynamic_index_in_dim(c, k, axis=1, keepdims=False)
        return jnp.where(in_range, 0.5 * z + ck.astype(dtype), z)

    z = jax.lax.fori_loop(0, q, z_body, jnp.zeros(c.shape[0], dtype))
    z = ldexp_exact(z, -k_min_p)

    c_prime = col(q + 1)
    if q:  # static
        c_prime = c_prime + c[jnp.arange(c.shape[0]), k_max_p].astype(dtype)
    a = z + col(0)
    m_prime = m - col(0)
    g0 = z + col(q + 1) * dtype(math.ldexp(1.0, -q))  # static exact 2^-q
    x = jnp.where(
        g0 <= 1.5 * a,
        m_prime / (0.5 * g0 + a),
        (m_prime / g0) * jnp.log1p(g0 / a),
    )
    delta_x = x
    eps = dtype(relerr) / jnp.sqrt(dtype(m))
    g_prev = jnp.zeros_like(x)

    def cond(state):
        x, delta_x, g_prev = state
        return jnp.any(delta_x > x * eps)

    # Static upper bound for the fused inner loops: kappa-1 <= 63 for any
    # f64 x < 2^64, and kMaxP-1 <= q-1. A static unroll with per-element
    # masks keeps every element's operation sequence identical to the
    # reference while letting XLA fuse the whole chain (no dynamic trip
    # counts, no per-step gathers).
    k_inner_max = 64

    def body(state):
        x, delta_x, g_prev = state
        active = delta_x > x * eps

        kappa_m1 = frexp_exponent(x)
        x_prime = ldexp_exact(x, -jnp.maximum(k_max_p + 1, kappa_m1 + 2))
        x_pp = x_prime * x_prime
        # rounded(): block FMA contraction so every product rounds once,
        # exactly like the reference's scalar f64 ops (see ops/fpx.py).
        h = (
            x_prime
            - rounded(x_pp / 3)
            + rounded((x_pp * x_pp) * (1.0 / 45.0 - rounded(x_pp / 472.5)))
        )

        # Fused inner loops (hll.h:667-680): h/x_prime update for
        # k in [kMinP, max(kappa-1, kMaxP-1)] descending; g accumulates
        # c[k]*h for k in [kMinP, kMaxP-1] (the second loop's range).
        # The reference computes g = cPrime * h AFTER its first loop
        # (updates for k >= kMaxP), so g is seeded at the fused-loop moment
        # when exactly those updates have run: the start of iteration
        # k = kMaxP-1, or after the loop when kMaxP <= 1 never reaches it.
        h_hi = jnp.maximum(kappa_m1, k_max_p - 1)
        g = jnp.zeros_like(x)

        def inner(i, carry):
            h, x_prime, g = carry
            k = k_inner_max - i  # k runs k_inner_max..1, masked per element
            g = jnp.where(k == k_max_p - 1, rounded(c_prime * h), g)
            upd = (k <= h_hi) & (k >= k_min_p)
            h_prime = 1.0 - h
            h_new = (x_prime + rounded(h * h_prime)) / (x_prime + h_prime)
            h = jnp.where(upd, h_new, h)
            x_prime = jnp.where(upd, x_prime + x_prime, x_prime)
            # dynamic column slice (NOT a gather): accumulation is masked to
            # k <= kMaxP-1 <= q-1, so the clipped index never matters.
            ck = jax.lax.dynamic_index_in_dim(
                c, jnp.clip(k, 0, q + 1), axis=1, keepdims=False
            )
            acc = upd & (k <= k_max_p - 1)
            g = jnp.where(acc, g + rounded(ck.astype(dtype) * h), g)
            return h, x_prime, g

        h, x_prime, g = jax.lax.fori_loop(
            0, k_inner_max, inner, (h, x_prime, g)
        )
        g = jnp.where(k_max_p <= 1, rounded(c_prime * h), g)
        g = g + rounded(x * a)

        # NB: deltaX *= (g - mPrime) / (gprev - g) - the division happens
        # first in the reference (hll.h:683); keep that association.
        step = jnp.where(
            (g_prev < g) & (g <= m_prime),
            rounded(delta_x * ((g - m_prime) / (g_prev - g))),
            0.0,
        )
        x_new = x + step
        return (
            jnp.where(active, x_new, x),
            jnp.where(active, step, delta_x),
            jnp.where(active, g, g_prev),
        )

    x, _, _ = jax.lax.while_loop(cond, body, (x, delta_x, g_prev))
    est = x * m
    est = jnp.where(is_inf, jnp.inf, est)
    return est.reshape(batch_shape)


@partial(jax.jit, static_argnames=("p",))
def ertl_mle_from_regs(regs, p, relerr=1e-2):
    """Cardinality estimate directly from register banks (..., 2^p)."""
    return ertl_mle(hll_histogram(regs.astype(jnp.int32), p), p, relerr)


def make_alpha(m):
    """HLL alpha constant (reference: hll.h:755-762)."""
    if m == 16:
        return 0.673
    if m == 32:
        return 0.697
    if m == 64:
        return 0.709
    return 0.7213 / (1 + 1.079 / m)


@partial(jax.jit, static_argnames=("p",))
def original_estimate(counts, p):
    """Flajolet ORIGINAL estimator with corrections, batched.

    Matches the reference's device implementation
    (include/criteria_sketch_cuda.cuh:30-65): raw = alpha*m^2 / sum(2^-r),
    linear counting when raw < 2.5m and zeros > 0, large-range correction
    when raw > 2^32/30.
    """
    q = 64 - p
    m = 1 << p
    c = jnp.asarray(counts, jnp.float64)[..., : q + 2]
    zeros = c[..., 0]
    inv_pow2 = jnp.asarray(np.ldexp(1.0, -np.arange(1, q + 2)))  # exact host table
    ssum = zeros + jnp.sum(c[..., 1:] * inv_pow2, axis=-1)
    alpha = make_alpha(m)
    raw = alpha * m * m / ssum
    two32 = jnp.float64(2.0**32)
    lin = m * jnp.log(m / jnp.maximum(zeros, 1.0))
    large = -two32 * jnp.log1p(-raw / two32)
    out = jnp.where(
        (raw < 2.5 * m) & (zeros > 0),
        lin,
        jnp.where(raw > two32 / 30.0, large, raw),
    )
    return out


def sigma(p):
    """HLL standard-error table, f32 like the reference
    (include/criteria_sketch.hpp:7-20)."""
    import numpy as np

    if p == 4:
        v = 1.106 / np.sqrt(np.float64(1 << p))
    elif p == 5:
        v = 1.07 / np.sqrt(np.float64(1 << p))
    elif p == 6:
        v = 1.054 / np.sqrt(np.float64(1 << p))
    elif p == 7:
        v = 1.046 / np.sqrt(np.float64(1 << p))
    else:
        v = 1.039 / np.sqrt(np.float64(1 << p))
    return np.float32(v)
