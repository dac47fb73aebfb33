"""Screen of pairwise HLL unions: harmonic sums as indicator matmuls.

The exact confirm path (ops/pairwise.py) computes a full 52-bin union
histogram plus the iterative ERTL-MLE per pair. For *screening* the
N^2 pair space that is overkill: the certified MLE lower bound
(mle_lower_bound below) needs only two scalars per pair:

    S[i,j] = sum_r 2^-max(a_ir, b_jr)      (the harmonic sum)
    Z[i,j] = #{r : max(a_ir, b_jr) == 0}   (the zero-register count)

Both reduce to matrix products over 0/1 indicators. With
CDF[v] = sum_r [a_ir <= v][b_jr <= v] and vmax an upper bound on every
register value (so CDF[vmax] == R), the dyadic telescope

    2^-x = 2^-vmax + sum_{v=x}^{vmax-1} 2^-(v+1)        (x <= vmax)

gives

    S = R * 2^-vmax + sum_{v=0}^{vmax-1} 2^-(v+1) * CDF[v],
    Z = CDF[0].

Every CDF[v] is an int8 x int8 -> int32 matmul (XLA dot_general with
preferred_element_type=int32), which the GPU runs on its tensor cores.
Each weighted term is an exact multiple of 2^-vmax and S < 2^14, so for
vmax <= 39 (truncate_values keeps it far below) the weighted sum is
accumulated in f64 exactly and rounded to f32 once: S is the correctly
rounded harmonic sum whatever order the terms are added in.

This plain XLA form is the screen on every backend. A hand-written Pallas
kernel on the Triton route (indicators built in registers, S/Z and the
certificate in the epilogue, bit-identical output) measured 0.09-0.13x
its speed on an H100 and was removed (PERF.md, "Bring-up findings").
The selection engine screens with a conservative relative margin delta
and re-confirms survivors with the exact estimator, so emitted pairs are
bit-identical to the reference.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp


def _telescope(p, values):
    """(items, tail): f64 weights w_i = 2^-b_i - 2^-b_{i+1} per present
    value except the last, and the closed-form tail R * 2^-b_{K-1}."""
    values = tuple(sorted(values))
    items = tuple(
        (b, float(np.ldexp(1.0, -b) - np.ldexp(1.0, -values[i + 1])))
        for i, b in enumerate(values[:-1]))
    return items, float(np.ldexp(float(1 << p), -values[-1]))


def _indicator_dot(a, b, v):
    """CDF_v block: int8 indicators [a <= v] . [b <= v]^T, int32 exact."""
    return jax.lax.dot_general(
        (a <= v).astype(jnp.int8), (b <= v).astype(jnp.int8),
        (((1,), (1,)), ((), ())), preferred_element_type=jnp.int32)


def _weighted_cdf_sum_jnp(regs, regs_cols, row_tiles, col_tiles, items,
                          tail, ti, tj, want_z):
    """Plain XLA screen: lax.scan over tiles, one int8 indicator matmul
    per present value, f64-exact weighted sum rounded once to f32."""
    r_cols = regs_cols.shape[1]

    def body(carry, rc):
        r0, c0 = rc
        zero = jnp.int32(0)
        a = jax.lax.dynamic_slice(regs, (r0 * ti, zero), (ti, regs.shape[1]))
        b = jax.lax.dynamic_slice(regs_cols, (c0 * tj, zero), (tj, r_cols))
        s = jnp.full((ti, tj), tail, jnp.float64)
        z = None
        for v, w in items:
            d = _indicator_dot(a, b, v)
            s = s + np.float64(w) * d.astype(jnp.float64)
            if v == 0:
                z = d.astype(jnp.float32)
        s = s.astype(jnp.float32)
        return carry, ((s, z) if want_z else s)

    _, out = jax.lax.scan(
        body, 0,
        (row_tiles.astype(jnp.int32), col_tiles.astype(jnp.int32)),
    )
    return out if want_z else (out, None)


def bank_values(regs):
    """Sorted tuple of the distinct register values present in the bank.

    The screen only needs one CDF matmul per PRESENT value: for any absent
    value v, [a <= v] == [a <= prev present value], so absent bins fold
    into their predecessor's weight exactly (see screen_s_z). Real banks
    have a handful of present values (a zero bin plus a band around
    log2(n/m)), typically halving the matmul count vs a dense 0..vmax scan.
    """
    a = np.asarray(regs)
    if a.dtype == np.uint8:
        # Single-pass presence scan, native when built; np.unique would
        # SORT the full bank (minutes at multi-GiB sizes).
        if a.flags.c_contiguous:
            try:
                from ..native import fastx

                present = fastx.value_presence(a)
                return tuple(int(v) for v in np.nonzero(present)[0])
            except (ImportError, OSError):
                pass
        present = np.zeros(256, bool)
        flat = a.reshape(-1)
        step = 1 << 24
        for c0 in range(0, flat.size, step):
            present[flat[c0:c0 + step]] = True
        return tuple(int(v) for v in np.nonzero(present)[0])
    return tuple(int(v) for v in np.unique(a))


def truncate_values(values, max_card, p, fp_band_log2=8):
    """Drop telescope bins above a cutoff - a one-sided screen speedup.

    With the value list truncated at v_c, screen_s_z's closed-form tail
    R * 2^-b_last counts every register with x > b_last as 2^-b_last
    >= 2^-x, so the computed harmonic sum OVERESTIMATES the true S -
    which can only ADD screen candidates (the exact host confirmation
    absorbs them), never lose one. The cutoff places the overestimate
    band at ~2^-fp_band_log2 of the screen threshold:

        eps = R * 2^-v_c,  s_thresh = alpha*m^2*(1+tau')/e_sum,
        eps/s_thresh <~ 2^(1-v_c) * max_card / m
        ==> v_c = ceil(log2(max_card/m)) + 1 + fp_band_log2.

    Registers cluster a few ranks above log2(n/m), so this typically cuts
    the matmul count ~3x while adding only a ~0.4% borderline-candidate
    band at the default fp_band_log2=8.
    """
    m = 1 << p
    v_c = int(np.ceil(np.log2(max(float(max_card), 1.0) / m))
              ) + 1 + fp_band_log2
    kept = tuple(v for v in values if v <= v_c)
    if len(kept) < 1:
        return tuple(values[:1])
    return kept


@partial(jax.jit, static_argnames=("p", "values", "ti", "tj"))
def screen_s_z(regs, row_tiles, col_tiles, p, values, ti=512, tj=512,
               regs_cols=None):
    """Pairwise harmonic sums / zero counts for a list of (row, col) tiles.

    Exact dyadic telescope over PRESENT register values only: for sorted
    present values b_0 < ... < b_{K-1} (every register of every real row
    is one of them - padded rows are masked downstream so their values
    don't matter), max(a, b) is itself always a present value, hence

        S = R * 2^-b_{K-1} + sum_{i<K-1} (2^-b_i - 2^-b_{i+1}) * CDF[b_i]

    with one indicator matmul per b_i - absent bins cost nothing.

    Args:
      regs: uint8 (N, 2^p) register bank; N a multiple of ti and tj.
      row_tiles: int32 (T,) row-block index per tile (units of ti rows).
      col_tiles: int32 (T,) col-block index per tile (units of tj rows).
      p: static HLL precision.
      values: static sorted tuple of distinct register values present in
        the real rows (bank_values(regs)) - or a truncate_values() prefix
        of it, in which case S is a guaranteed OVERESTIMATE (registers
        above the last value count as the last value); screening callers
        rely on exactly that one-sidedness.
      regs_cols: optional separate column bank (row_tiles index `regs`,
        col_tiles index `regs_cols`); None = both sides from `regs`. Used
        by the ring-sharded engine, where the column strip circulates
        while the row strip stays resident (parallel/ring.py).

    Returns:
      (S, Z): float32 (T, ti, tj) harmonic sums and zero-register counts;
      Z is None when 0 is not a present value (no zero registers exist).
    """
    if regs_cols is None:
        regs_cols = regs
    items, tail = _telescope(p, values)
    want_z = min(values) == 0
    n_tiles = row_tiles.shape[0]
    if not items:  # single present value: S/Z are constants
        s = jnp.full((n_tiles, ti, tj), tail, jnp.float32)
        z = (jnp.full((n_tiles, ti, tj), float(1 << p), jnp.float32)
             if want_z else None)
        return s, z
    return _weighted_cdf_sum_jnp(regs, regs_cols, row_tiles, col_tiles,
                                 items, tail, ti, tj, want_z)


def mle_lower_bound(s, z, p):
    """CERTIFIED lower bound of the ERTL-MLE cardinality from the screen's
    (S, Z) alone:

        t_lb(s, z) = 2m(m - z) / (3s - z)  <=  t_mle   (always)

    where s = sum_r 2^-reg_r and z = #zero registers of the union.
    Unlike the ORIGINAL-estimator screen this inequality is a theorem,
    not a measured deviation (DESIGN.md "Screen certificate"): t_lb is
    the coth-bound root enclosure of the Poisson-MLE equation, it equals
    Ertl's secant starting point when no register is saturated and lower-
    bounds it otherwise, and the implemented secant only ever steps UP
    (ops/estimators.ertl_mle; reference hll.h:629-688) - so the
    implemented MLE can never fall below t_lb. Screening on
    t_lb <= e_sum/(1+tau) therefore needs only a tiny numeric slack
    (f32 rounding), not the old 8%/75% ORIGINAL-vs-MLE margins.

    z=None means "no zero registers anywhere in the bank" (0 absent from
    the present-value set). Conservative under the truncated telescope:
    truncation only raises S, and t_lb is decreasing in S.
    """
    m = np.float32(1 << p)
    if z is None:
        return 2.0 * m * m / (3.0 * s)
    return 2.0 * m * (m - z) / (3.0 * s - z)


def original_from_s_z(s, z, p):
    """Flajolet ORIGINAL union-cardinality estimate from (S, Z), f32.

    Elementwise twin of estimators.original_estimate
    (reference: include/criteria_sketch_cuda.cuh:30-65) for the screen path.
    z=None means "no zero registers anywhere" (the v_lo > 0 fast path).
    """
    from .estimators import make_alpha

    m = 1 << p
    alpha = np.float32(make_alpha(m))
    raw = alpha * np.float32(m) * np.float32(m) / s
    two32 = np.float32(2.0**32)
    large = -two32 * jnp.log1p(-raw / two32)
    out = jnp.where(raw > two32 / 30.0, large, raw)
    if z is None:
        return out
    lin = np.float32(m) * jnp.log(np.float32(m) / jnp.maximum(z, 1.0))
    return jnp.where((raw < 2.5 * m) & (z > 0), lin, out)
