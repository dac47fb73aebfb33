"""Pairwise HLL-union histograms and Jaccard estimates as matmuls.

The reference computes, per candidate pair, an element-wise max of two
2^p-register arrays followed by a value histogram and an estimator
(CPU: sketch/include/sketch/hll.h:1188-1210; GPU: one thread per pair,
include/criteria_sketch_cuda.cuh:30-65). That is a scalar, bandwidth-bound
formulation.

Matmul reformulation: for register values v, the cumulative histogram of
the max-merged registers factorizes as

    CDF[i,j,v] = #{r : max(a_ir, b_jr) <= v} = sum_r [a_ir <= v] * [b_jr <= v]

i.e. one (Bi, R) x (R, Bj) matrix product per value v over 0/1 indicator
matrices - pure tensor-core work, ~2*R*V flops/pair, exact in bf16xbf16->f32
(indicators are 0/1; sums <= R < 2^24). The per-value histogram is the
first difference of the CDF along v, and feeds the same batched ERTL-MLE
as everything else. No atomics, no histogram scatters, deterministic.
"""

from functools import partial

import jax
import jax.numpy as jnp

from .estimators import ertl_mle


def cdf_matmul(regs_a, regs_b, p, precision="bf16"):
    """Partial CDF sums: out[i,j,v] = sum_r [a_ir <= v][b_jr <= v], v < q+1.

    This is the matmul contraction over whatever register slice is passed in;
    with registers sharded across a mesh axis, psum of this output over that
    axis gives the full CDF (contraction/tensor parallelism).

    Returns float32 (Bi, Bj, q+1) - exact, counts <= 2^p < 2^24.
    """
    nbins = 64 - p + 2
    ra = regs_a.astype(jnp.int32)
    rb = regs_b.astype(jnp.int32)

    if precision == "int8":
        in_dt, acc_dt = jnp.int8, jnp.int32
    else:
        in_dt, acc_dt = jnp.bfloat16, jnp.float32

    def step(v):
        ia = (ra <= v).astype(in_dt)
        ib = (rb <= v).astype(in_dt)
        return jax.lax.dot_general(
            ia,
            ib,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=acc_dt,
        )

    # v = 0..nbins-2; the top bin (== R) is appended by counts_from_cdf.
    cdf = jax.lax.map(step, jnp.arange(nbins - 1))  # (nbins-1, Bi, Bj)
    return jnp.moveaxis(cdf, 0, -1).astype(jnp.float32)


def counts_from_cdf(cdf, r_total):
    """Histogram from the cumulative sums; r_total is the full register
    count 2^p (the top CDF bin)."""
    top = jnp.full(cdf.shape[:-1] + (1,), float(r_total), jnp.float32)
    cdf_full = jnp.concatenate([cdf, top], axis=-1)
    return jnp.diff(cdf_full, axis=-1, prepend=jnp.float32(0.0))


@partial(jax.jit, static_argnames=("p", "precision"))
def union_histograms(regs_a, regs_b, p, precision="bf16"):
    """Histograms of max(a, b) register values for all pairs of two banks.

    Args:
      regs_a: uint8 (Bi, R) register bank rows.
      regs_b: uint8 (Bj, R) register bank columns.
      p: static HLL precision (R == 2^p).
      precision: "bf16" (f32 accumulate) or "int8" (int32 accumulate); both
        are exact for indicator sums up to R.

    Returns:
      float32 (Bi, Bj, q+2) histograms (bins 0..q+1, q = 64-p) - exact
      integer counts.
    """
    return counts_from_cdf(
        cdf_matmul(regs_a, regs_b, p, precision), regs_a.shape[-1]
    )


@partial(jax.jit, static_argnames=("p", "precision", "mle_dtype"))
def union_cardinality(regs_a, regs_b, p, precision="bf16",
                      mle_dtype=jnp.float64):
    """ERTL-MLE union-cardinality estimates for all pairs of two banks.

    Equivalent to hll_t::union_size (reference: hll.h:1188-1210) evaluated
    on the Bi x Bj grid. mle_dtype=float64 is bit-exact (CPU); float32 is
    the fast accelerator screening mode. Returns `mle_dtype` (Bi, Bj).
    """
    counts = union_histograms(regs_a, regs_b, p, precision)
    return ertl_mle(counts, p, dtype=mle_dtype)


@partial(jax.jit, static_argnames=("p", "precision", "mle_dtype"))
def pairwise_jaccard(regs_a, regs_b, cards_a, cards_b, p, precision="bf16",
                     mle_dtype=jnp.float64):
    """Jaccard estimates J = (e1 + e2 - t) / t for all pairs of two banks.

    cards_* are the f64 report() values; they are truncated to integers
    exactly like the reference's `size_t e1 = card_name[i].second`
    (src/selection.cpp:157,162).

    Returns (jacc, t): `mle_dtype` (Bi, Bj) each.
    """
    t = union_cardinality(regs_a, regs_b, p, precision, mle_dtype)
    e1 = jnp.trunc(jnp.asarray(cards_a, mle_dtype))[:, None]
    e2 = jnp.trunc(jnp.asarray(cards_b, mle_dtype))[None, :]
    jacc = (e1 + e2 - t) / t
    return jacc, t
