"""Device-mesh construction and the multi-chip sharded selection step.

The reference has no distributed layer at all (single process; OpenMP shared
memory + cudaMemcpy are its only "communication" - SURVEY.md section 2.3).
The scaling design:

  * mesh axis "rows": pair-block data parallelism - each device owns a strip
    of the ascending-cardinality-sorted genome rows and compares it against
    the full column bank.
  * mesh axis "regs": contraction parallelism - the 2^14-register axis of
    the primary HLL bank is sharded; each device computes partial CDF
    matmuls over its register slice and the full histograms are assembled
    with a psum over "regs" (a device all-reduce, not a host gather).

Both axes compose in one shard_map; collectives are XLA-inserted psums.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import criteria, pairwise, estimators


def make_mesh(n_rows=None, n_regs=None, devices=None):
    """Build a ("rows", "regs") mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n_rows is None and n_regs is None:
        # Prefer splitting both axes when possible.
        n_regs = 2 if n % 2 == 0 and n > 1 else 1
        n_rows = n // n_regs
    elif n_rows is None:
        n_rows = n // n_regs
    elif n_regs is None:
        n_regs = n // n_rows
    if n_rows * n_regs != n:
        raise ValueError(f"mesh {n_rows}x{n_regs} != {n} devices")
    dev_array = np.array(devices).reshape(n_rows, n_regs)
    return Mesh(dev_array, axis_names=("rows", "regs"))


def sharded_selection_step(mesh, p, criterion, n_rows_band=1, n_bands=1,
                           p_aux=None, precision="bf16"):
    """Build the jitted multi-chip dense selection step for any criterion
    (reference coverage: src/selection.cpp:122-291).

    Array layout (N = padded genome count, R = 2^p, m = aux width):
      regs_rows (N, R)  sharded P("rows", "regs")   - row strip x reg slice
      regs_cols (N, R)  sharded P(None,  "regs")    - full bank x reg slice
      aux       (N, m)  replicated - SMH buckets or aux-HLL registers (small)
      e         (N,)    replicated                   - truncated cards, sorted
      idx       (N,)    sharded P("rows") / repl     - global sorted positions
      coef_aux  scalar  replicated - hll_a/hll_an conservative aux-gate
                        coefficient (<= 0 disables the aux gate)

    For hll_a/hll_an the device gate is the conservative threshold form
    t_aux <= coef*(e1+e2) + slack (screened.hll_aux_threshold_coef): a
    strict superset of the exact gate, adjudicated on the host.

    Returns hits (N, N) bool and jacc (N, N) f64, both sharded P("rows", None).
    """
    r_total = 1 << p
    use_cb = criterion not in ("baseline", "smh_only")
    use_smh = criterion in ("smh_a", "smh_only")
    use_hllaux = criterion in ("hll_a", "hll_an")

    def step(regs_rows, regs_cols, aux_rows, aux_cols, e_rows, e_cols,
             idx_rows, idx_cols, tau, coef_aux):
        # Partial CDF over the local register slice; full CDF via psum
        # over the "regs" mesh axis (a device all-reduce).
        cdf = pairwise.cdf_matmul(regs_rows, regs_cols, p, precision)
        cdf = jax.lax.psum(cdf, axis_name="regs")
        counts = pairwise.counts_from_cdf(cdf, r_total)
        t = estimators.ertl_mle(counts, p)

        e1 = jnp.trunc(e_rows)[:, None]
        e2 = jnp.trunc(e_cols)[None, :]
        jacc = (e1 + e2 - t) / t

        tri = (
            (idx_rows[:, None] < idx_cols[None, :])
            & (idx_rows[:, None] >= 0)
            & (idx_cols[None, :] >= 0)
        )
        gate = tri & (e2 != 0)
        if use_cb:
            gate &= (e1 / e2) >= tau
        if use_smh:
            gate &= criteria.smh_a_mask(aux_rows, aux_cols, n_rows_band,
                                        n_bands)
        if use_hllaux:
            # Dense aux union at p_aux (aux bank replicated - it is ~1% of
            # the primary): conservative threshold gate, +1 absolute slack
            # for the exact gate's size_t truncation plus a small relative
            # margin for the device MLE's emulated f64.
            cdf_a = pairwise.cdf_matmul(aux_rows, aux_cols, p_aux,
                                        precision)
            counts_a = pairwise.counts_from_cdf(cdf_a, 1 << p_aux)
            t_a = estimators.ertl_mle(counts_a, p_aux)
            thresh = (coef_aux * (e1 + e2) + 1.0) * (1.0 + 1e-6)
            gate &= jnp.where(coef_aux > 0, t_a <= thresh, True)
        hits = gate & (jacc >= tau)
        return hits, jacc

    sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(
            P("rows", "regs"),  # regs_rows
            P(None, "regs"),  # regs_cols
            P("rows", None),  # aux_rows
            P(None, None),  # aux_cols
            P("rows"),  # e_rows
            P(None),  # e_cols
            P("rows"),  # idx_rows
            P(None),  # idx_cols
            P(),  # tau
            P(),  # coef_aux
        ),
        out_specs=(P("rows", None), P("rows", None)),
        check_vma=False,
    )
    return jax.jit(sharded)


def sharded_smh_selection_step(mesh, p, n_rows_band, n_bands, precision="bf16"):
    """CB+smh_a specialization of sharded_selection_step (legacy 9-arg
    signature, kept for the driver entry point and existing tests)."""
    inner = sharded_selection_step(mesh, p, "smh_a", n_rows_band, n_bands,
                                   precision=precision)

    def step(regs_rows, regs_cols, aux_rows, aux_cols, e_rows, e_cols,
             idx_rows, idx_cols, tau):
        return inner(regs_rows, regs_cols, aux_rows, aux_cols, e_rows,
                     e_cols, idx_rows, idx_cols, tau, jnp.float64(0.0))

    return step


def select_pairs_sharded(bank, params, mesh=None):
    """Multi-chip dense all-pairs selection, every criterion.

    Pads the sorted bank to the row-axis size, runs the sharded step, and
    extracts results host-side in reference order. Suitable when the full
    (N, N) mask fits in memory; the tiled screened engine handles larger N
    per chip (parallel/screened.select_pairs_screened_sharded).
    """
    from .screened import hll_aux_threshold_coef

    if mesh is None:
        mesh = make_mesh()
    crit = params.criterion
    valid = ("smh_a", "smh_only", "cb", "baseline", "hll_a", "hll_an")
    if crit not in valid:
        raise ValueError(f"sharded engine does not support criterion {crit!r}")
    use_cb = crit not in ("baseline", "smh_only")
    use_smh = crit in ("smh_a", "smh_only")
    use_hllaux = crit in ("hll_a", "hll_an")
    # The device aux gate for hll_a/hll_an is a conservative SUPERSET of
    # the exact aux threshold (coef slack), so without host adjudication
    # the emitted set would not be reference-exact for these criteria -
    # force the exact pass (smh/cb gates are exact on device, so their
    # non-adjudicated f64 path stays reference-exact).
    adjudicate = bool(params.adjudicate or use_hllaux)
    if use_smh and bank.aux_kind != "smh":
        raise ValueError("smh criteria require an smh aux bank")
    if use_hllaux and bank.aux_kind != "hll":
        raise ValueError("hll_a/hll_an require an hll aux bank")

    tau = params.tau_eff
    order = bank.sorted_by_cardinality()
    n = bank.n
    d_rows = mesh.shape["rows"]
    n_pad = -(-n // d_rows) * d_rows

    def pad(a, fill=0):
        if a.shape[0] == n_pad:
            return a
        width = [(0, n_pad - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
        return np.pad(a, width, constant_values=fill)

    regs_s = pad(bank.regs[order])
    aux_s = (pad(bank.aux[order]) if bank.aux is not None
             else np.zeros((n_pad, 8), np.uint8))
    e_s = pad(np.trunc(bank.cards[order]))
    idx = pad(np.arange(n), fill=-1)

    tau_dev = tau - params.screen_margin if adjudicate else tau
    nrb = nbd = 1
    if use_smh:
        nrb, nbd = criteria.smh_band_params(bank.aux_param, params.tau)
    coef = 0.0
    if use_hllaux:
        zs = criteria.z_sigma(params.z_score, bank.aux_param)
        c = hll_aux_threshold_coef(crit, tau, zs, params.order_n)
        coef = 0.0 if c is None else c * (1.0 + 1e-6)
    step = sharded_selection_step(
        mesh, bank.p, crit, nrb, nbd,
        p_aux=(bank.aux_param if use_hllaux else None),
        precision=params.precision,
    )
    hits, jacc = step(
        regs_s, regs_s, aux_s, aux_s, e_s, e_s, idx, idx,
        jnp.float64(tau_dev), jnp.float64(coef),
    )
    hits = np.asarray(hits)
    jacc = np.asarray(jacc)
    ii, jj = np.nonzero(hits)
    triples = sorted(zip(ii.tolist(), jj.tolist()))
    names = bank.names
    if adjudicate:
        from ..utils.hostref import PairOracle

        oracle = PairOracle(
            bank.p, regs_s, e_s,
            aux=(aux_s if bank.aux is not None else None),
            aux_param=bank.aux_param, criterion=crit, tau=params.tau,
            z_score=params.z_score, order_n=params.order_n,
            apply_cb=use_cb,
        )
        out = []
        for i, j in triples:
            selected, jacc_exact = oracle.evaluate(i, j)
            if selected:
                out.append((names[order[i]], names[order[j]], jacc_exact))
        return out
    return [
        (names[order[i]], names[order[j]], float(jacc[i, j])) for i, j in triples
    ]
