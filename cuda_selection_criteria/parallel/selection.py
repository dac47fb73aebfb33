"""All-pairs similar-genome selection engines.

Replaces the reference's OpenMP row loops (src/selection.cpp:134-291) and the
CUDA one-thread-per-pair kernels (src/selection_kernels.cu) with tiled,
fully-deterministic device computations:

  per (row-block, col-block) tile:
      CB mask (outer-product compare)
    & auxiliary-criterion mask (smh_a band equality / hll_a / hll_an)
    & triangle + zero-cardinality masks
    -> gated pairs -> matmul union histograms -> batched ERTL-MLE -> J >= tau.

Two confirmation strategies:
  * "fused":   compute union/J for every pair in a CB-surviving tile (the
               matmuls make this cheap; best when gates are not very selective).
  * "cascade": evaluate gates first, then compute unions only for gathered
               survivor pairs, padded to fixed capacity (best at scale when
               gates kill almost everything; mirrors the reference cascade).

Results are deterministic and emitted in exactly the reference's order
(sorted-row-major), unlike the CUDA atomicAdd append
(src/selection_kernels.cu:58-59).
"""

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import criteria, pairwise
from ..utils.hostref import PairOracle
from . import scheduler

Z_SCORE_DEFAULT = 1.96  # src/selection.cpp:76
ORDER_N_DEFAULT = 1  # src/selection.cpp:77


@dataclass(frozen=True)
class SelectionParams:
    tau: float  # raw user threshold; effective f32->f64 applied internally
    # smh_a | hll_a | hll_an | cb | baseline | smh_only (smh gate without CB,
    # the reference's smh_a-only timing sweep - time_smh.cpp:228-257)
    criterion: str = "smh_a"
    aux_bytes: int = 256
    z_score: float = Z_SCORE_DEFAULT
    order_n: int = ORDER_N_DEFAULT
    block: int = 512
    precision: str = "bf16"
    confirm: str = "fused"  # fused | cascade
    # Safety margin for the dense engine's device cascade: every threshold
    # comparison on device is relaxed by this amount and the surviving
    # candidates are re-evaluated exactly on the host
    # (utils.hostref.PairOracle), so the emitted pair set does not depend
    # on the device cascade's matmul precision.
    screen_margin: float = 1e-4
    adjudicate: bool = True
    # Numeric slack on the certified screen threshold (parallel.screened):
    # the screen statistic t_lb = 2m(m-Z)/(3S-Z) provably lower-bounds the
    # implemented ERTL-MLE (ops/screen.mle_lower_bound, DESIGN.md "Screen
    # certificate"), so this covers only f32 rounding (~1e-5 budget).
    screen_delta: float = 1e-3
    # Engine choice: "auto" uses the screened engine on the GPU
    # (escalating to the bank-sharded ring engine when the bank outgrows
    # one card and several are present) and this dense engine on the CPU;
    # "dense" / "screened" / "ring" force one.
    engine: str = "auto"

    @property
    def tau_eff(self):
        return criteria.effective_tau(self.tau)


# --------------------------------------------------------------------------
# Per-tile jitted steps (one per criterion family)
# --------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("p", "precision", "mle_dtype"))
def _tile_no_aux(regs_a, regs_b, e_a, e_b, idx_a, idx_b, tau, p, precision,
                 mle_dtype, apply_cb):
    tri = (
        (idx_a[:, None] < idx_b[None, :])
        & (idx_a[:, None] >= 0)
        & (idx_b[None, :] >= 0)
    )
    nz = e_b[None, :] != 0
    gate = tri & nz
    gate = jnp.where(apply_cb, gate & criteria.cb_mask(e_a, e_b, tau), gate)
    jacc, _ = pairwise.pairwise_jaccard(regs_a, regs_b, e_a, e_b, p, precision,
                                        mle_dtype)
    hits = gate & (jacc >= tau)
    return hits, jacc


@partial(jax.jit, static_argnames=("p", "n_rows", "n_bands", "precision",
                                   "mle_dtype"))
def _tile_smh(regs_a, regs_b, aux_a, aux_b, e_a, e_b, idx_a, idx_b, tau,
              p, n_rows, n_bands, precision, mle_dtype, apply_cb):
    tri = (
        (idx_a[:, None] < idx_b[None, :])
        & (idx_a[:, None] >= 0)
        & (idx_b[None, :] >= 0)
    )
    nz = e_b[None, :] != 0
    gate = (
        tri
        & nz
        & criteria.smh_a_mask(aux_a, aux_b, n_rows, n_bands)
    )
    gate = jnp.where(apply_cb, gate & criteria.cb_mask(e_a, e_b, tau), gate)
    jacc, _ = pairwise.pairwise_jaccard(regs_a, regs_b, e_a, e_b, p, precision,
                                        mle_dtype)
    hits = gate & (jacc >= tau)
    return hits, jacc


@partial(jax.jit, static_argnames=("p", "p_aux", "kind", "order_n",
                                   "precision", "mle_dtype"))
def _tile_hll_aux(regs_a, regs_b, aux_a, aux_b, e_a, e_b, idx_a, idx_b, tau,
                  zs, p, p_aux, kind, order_n, precision,
                  mle_dtype=jnp.float64):
    tri = (
        (idx_a[:, None] < idx_b[None, :])
        & (idx_a[:, None] >= 0)
        & (idx_b[None, :] >= 0)
    )
    nz = e_b[None, :] != 0
    gate = tri & nz & criteria.cb_mask(e_a, e_b, tau)
    if kind == "hll_a":
        aux_gate = criteria.hll_a_mask(
            aux_a, aux_b, e_a, e_b, tau, zs, p_aux, precision, mle_dtype
        )
    else:
        aux_gate = criteria.hll_an_mask(
            aux_a, aux_b, e_a, e_b, tau, zs, p_aux, order_n, precision,
            mle_dtype,
        )
    gate = gate & aux_gate
    jacc, _ = pairwise.pairwise_jaccard(regs_a, regs_b, e_a, e_b, p, precision,
                                        mle_dtype)
    hits = gate & (jacc >= tau)
    return hits, jacc


# --------------------------------------------------------------------------
# Engine
# --------------------------------------------------------------------------


def _device_bytes_limit():
    """Memory JAX may allocate on one device, for the auto-engine ring
    threshold. An accelerator that does not report it is an error: no
    size is assumed."""
    stats = jax.devices()[0].memory_stats() or {}
    if not stats.get("bytes_limit"):
        raise RuntimeError(
            f"device {jax.devices()[0]} reports no memory bytes_limit")
    return int(stats["bytes_limit"])


def _pad_rows(arr, lo, hi, block, fill=0):
    """Slice rows [lo, hi) padded up to `block` rows."""
    sl = arr[lo:hi]
    if sl.shape[0] == block:
        return sl
    pad = [(0, block - sl.shape[0])] + [(0, 0)] * (sl.ndim - 1)
    return np.pad(sl, pad, constant_values=fill)


def resolve_engine(bank, params):
    """The engine select_pairs runs for this bank and params: "auto"
    becomes "screened" on an accelerator and "dense" on the CPU, and
    "ring" when several devices are present and the register bank would
    not leave one of them its working headroom (bank + upload slab +
    hit-mask buffers)."""
    engine = params.engine
    if engine != "auto":
        return engine
    if jax.default_backend() == "cpu" or not params.adjudicate:
        return "dense"
    if jax.device_count() > 1:
        bank_bytes = bank.n * bank.regs.shape[1]
        if bank_bytes > 0.55 * _device_bytes_limit():
            return "ring"
    return "screened"


def select_pairs(bank, params, checkpoint=None, stats=None):
    """All-pairs selection on a SketchBank; returns reference-ordered results.

    stats: optional dict the screened and ring engines fill with their
    per-stage wall seconds and counts.

    Returns:
      list of (name_i, name_j, jacc) with jacc as float; ordering matches the
      reference's row-major sorted emission (src/selection.cpp:297-300).
    """
    n = bank.n
    if n < 2:
        return []

    engine = resolve_engine(bank, params)
    if engine == "ring":
        from .ring import select_pairs_ring  # noqa: PLC0415 (cycle)

        return select_pairs_ring(bank, params, stats=stats)
    if engine == "screened":
        from .screened import select_pairs_screened  # noqa: PLC0415 (cycle)

        return select_pairs_screened(bank, params, checkpoint=checkpoint,
                                     stats=stats)

    tau = params.tau_eff
    # Device screen threshold: relaxed by the margin; candidates are
    # re-adjudicated exactly on the host below.
    tau_dev = tau - params.screen_margin if params.adjudicate else tau
    order = bank.sorted_by_cardinality()
    e_s = np.trunc(bank.cards[order])  # size_t truncation semantics
    regs_s = bank.regs[order]
    aux_s = bank.aux[order] if bank.aux is not None else None

    block = min(params.block, max(8, n))
    crit = params.criterion
    use_cb = crit not in ("baseline", "smh_only")
    tiles = scheduler.triangle_blocks(e_s, tau_dev, block, use_cb_skip=use_cb)

    if crit in ("smh_a", "smh_only"):
        m = bank.aux_param
        n_rows, n_bands = criteria.smh_band_params(m, params.tau)
    elif crit in ("hll_a", "hll_an"):
        zs = criteria.z_sigma(params.z_score, bank.aux_param)
    mle_dtype = jnp.float64

    results = []
    for (r0, r1), (c0, c1) in tiles:
        ra = _pad_rows(regs_s, r0, r1, block)
        rb = _pad_rows(regs_s, c0, c1, block)
        ea = _pad_rows(e_s, r0, r1, block)
        eb = _pad_rows(e_s, c0, c1, block)
        ia = _pad_rows(np.arange(r0, r1), r0 - r0, r1 - r0, block, fill=-1)
        ib = _pad_rows(np.arange(c0, c1), 0, c1 - c0, block, fill=-1)

        if crit in ("cb", "baseline"):
            hits, jacc = _tile_no_aux(
                ra, rb, ea, eb, ia, ib, tau_dev, bank.p, params.precision,
                mle_dtype=mle_dtype, apply_cb=use_cb,
            )
        elif crit in ("smh_a", "smh_only"):
            aa = _pad_rows(aux_s, r0, r1, block)
            ab = _pad_rows(aux_s, c0, c1, block)
            hits, jacc = _tile_smh(
                ra, rb, aa, ab, ea, eb, ia, ib, tau_dev, bank.p,
                n_rows, n_bands, params.precision, mle_dtype=mle_dtype,
                apply_cb=use_cb,
            )
        elif crit in ("hll_a", "hll_an"):
            aa = _pad_rows(aux_s, r0, r1, block)
            ab = _pad_rows(aux_s, c0, c1, block)
            hits, jacc = _tile_hll_aux(
                ra, rb, aa, ab, ea, eb, ia, ib, tau_dev, zs, bank.p,
                bank.aux_param, crit, params.order_n, params.precision,
                mle_dtype=mle_dtype,
            )
        else:
            raise ValueError(f"unknown criterion {crit!r}")

        hits = np.asarray(hits)
        if hits.any():
            jacc = np.asarray(jacc)
            ii, jj = np.nonzero(hits)
            for i_loc, j_loc in zip(ii, jj):
                results.append((r0 + i_loc, c0 + j_loc, float(jacc[i_loc, j_loc])))

    results.sort(key=lambda t: (t[0], t[1]))
    names = bank.names
    if params.adjudicate:
        oracle = PairOracle(
            bank.p, regs_s, e_s, aux=aux_s, aux_param=bank.aux_param,
            criterion=crit, tau=params.tau, z_score=params.z_score,
            order_n=params.order_n, apply_cb=use_cb,
        )
        final = []
        for i, j, _ in results:
            selected, jacc_exact = oracle.evaluate(i, j)
            if selected:
                final.append((names[order[i]], names[order[j]], jacc_exact))
        return final
    return [
        (names[order[i]], names[order[j]], j_val) for i, j, j_val in results
    ]


def format_results(results):
    """Output lines exactly like the reference: `fileA fileB J` with
    std::to_string's fixed 6 decimals (src/selection.cpp:170)."""
    return [f"{a} {b} {j:.6f}" for a, b, j in results]
