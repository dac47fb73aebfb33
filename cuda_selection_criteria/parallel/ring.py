"""Ring-rotated row-sharded screened engine: banks beyond replication.

The tile-sharded engine (parallel/screened.select_pairs_screened_sharded)
replicates the register bank on every device - the right trade while
the bank fits one device (16 KiB/genome at p=14: ~3.9M genomes in the
60 GB JAX takes of an 80 GB card). Past that, the bank itself must be
sharded. This engine is the systolic answer:

  * each device owns a contiguous STRIP of the ascending-cardinality-
    sorted bank: registers (N/D, R), cardinalities, LSH fingerprints -
    P("rows") sharding, nothing replicated;
  * a copy of the strip circulates around the ring: at ring step s,
    device d screens (resident strip d) x (circulating strip
    (d - s) mod D) with the same screen (ops/screen.py with a separate
    column bank), then the circulating strip moves to
    device (d+1) via jax.lax.ppermute - one peer-to-peer transfer per
    device (NCCL on GPUs);
  * after D steps every ordered strip pair has been screened exactly
    once on exactly one device; the global i<j triangle mask keeps each
    genome pair exactly once.

Memory model (per device): the two bank strips are O(2 * N/D * 2^p)
HBM; the hit masks are STREAMED - each ring step's strip-pair tile grid
is dispatched in chunks of `chunk_tiles` tiles, so the transient mask
buffer is O(chunk_tiles * ti^2) bytes per dispatch, independent of N
(asserted in tests/test_ring.py) and fetched counts-first per chunk.
Earlier revisions buffered all D steps' masks in the loop carry -
O(N^2/D) per device, which at pod scale dwarfed the strips themselves;
nothing like that remains. Comms per full sweep: each device sends its
strip D times = N * 16 KiB total, peer to peer; the host loop syncs
once per ring step (~D blocking fetches per sweep).

Three scheduling prunes run on the host, all exact supersets:
  * a ring STEP is skipped entirely when no device's (resident,
    circulating) strip pair can contain an i<j pair passing the
    cardinality bound (strip-level CB bound on the sorted order -
    the reference's row break, src/selection.cpp:164-165, lifted to
    strip granularity);
  * within a live step, the dispatched tile list is the union over live
    devices of the CB-block-live local tiles (the screened scheduler's
    bound per strip pair) - a 131k single-strip diagonal step dispatches
    the live band, not nt^2/2 tiles;
  * the diagonal step (s=0) screens only the upper-triangle tiles of
    each strip (a <= b), since i<j kills the rest.

Scale hygiene matches the screened engine's: the sorted bank is
NEVER materialized on the host - each device's strip arrives via the
shared slab-pipelined upload (screened.upload_sorted_rows, host peak =
2 gather slabs) into one row-sharded global array - and the exact confirm
is device-assisted through that sharded bank (flag-first certain-reject
fetch, screened.make_device_hist_fn; regs[ii] gathers compile to SPMD
collective gathers), with the host register copy resolved lazily only
on the CPU, where the confirm histograms run on the host.

The screen math, margins, and the exact host confirmation are shared
with the other engines (conservative superset screen -> PairOracle), so
output stays bit-identical to the reference. Every criterion is
supported: for hll_a/hll_an the aux-HLL registers circulate as a second
(tiny) strip and the conservative aux-union gate runs per chunk.
"""

import time
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import criteria, screen
from ..utils.hostref import PairOracle
from .screened import (band_fingerprints_np, band_hits,
                       extract_hit_coords, make_device_hist_fn,
                       reject_delta_for, screen_tau, upload_sorted_rows)

# Gate-stage dispatch width (tiles per padded gate call): one compiled
# shape for the whole sweep, warmed before the timed step loop.
RING_GATE_CHUNK = 512


def make_ring_fns(mesh, p, values, ti, strip, n_bands, use_cb, use_smh,
                  aux=None):
    """Build the two jitted ring primitives over a ("rows",) mesh.

    screen_step(resident..., circ..., r_tiles, c_tiles, scalars...)
      -> (hits (D*C, ti, ti) P("rows"), counts (D*C,) P("rows"))
      where r_tiles/c_tiles are REPLICATED (C,) int32 LOCAL tile indices
      (units of ti rows within a strip): every device screens the same
      local tile list of its own (resident x circulating) strip pair.

    rotate(circ...) -> circ... moved one hop around the ring (ppermute).

    aux: None, or (p_aux, values_aux) - adds the second circulating strip
    (aux-HLL registers) and the conservative aux-union gate of
    hll_a/hll_an.
    """
    from jax.sharding import PartitionSpec as P

    n_dev = mesh.shape["rows"]
    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    p_aux, values_aux = aux if aux is not None else (None, None)

    def step(regs_mine, aux_mine, e_mine, fp_mine, base_mine,
             col_regs, col_aux, col_e, col_fp, col_base,
             r_tiles, c_tiles, n_real, tau_scr, tau_cb, coef_aux):
        ss, zz = screen.screen_s_z(
            regs_mine, r_tiles, c_tiles, p, values, ti=ti, tj=ti,
            regs_cols=col_regs,
        )
        h = _ring_post(
            ss, zz, e_mine, col_e, fp_mine, col_fp, base_mine[0],
            col_base[0], r_tiles, c_tiles, n_real, tau_scr, tau_cb, p,
            n_bands, ti, use_cb, use_smh,
        )
        if aux is not None:
            s_a, z_a = screen.screen_s_z(
                aux_mine, r_tiles, c_tiles, p_aux, values_aux, ti=ti,
                tj=ti, regs_cols=col_aux,
            )
            h &= _ring_aux_pass(s_a, z_a, e_mine, col_e, r_tiles, c_tiles,
                                coef_aux, p_aux, ti)
        return h, jnp.sum(h, axis=(1, 2), dtype=jnp.int32)

    res_specs = (
        P("rows", None),  # regs strip
        P("rows", None),  # aux strip (dummy when aux is None)
        P("rows"),  # e
        P("rows", None),  # fp
        P("rows"),  # base (1 scalar per device)
    )
    screen_step = jax.jit(jax.shard_map(
        step,
        mesh=mesh,
        in_specs=res_specs + res_specs + (
            P(),  # r_tiles (replicated local tile list)
            P(),  # c_tiles
            P(),  # n_real
            P(),  # tau_scr
            P(),  # tau_cb
            P(),  # coef_aux
        ),
        out_specs=(P("rows"), P("rows")),
        check_vma=False,
    ))

    def rot(col_regs, col_aux, col_e, col_fp, col_base):
        out = [jax.lax.ppermute(x, "rows", perm)
               for x in (col_regs, col_e, col_fp, col_base)]
        if aux is not None:
            col_aux = jax.lax.ppermute(col_aux, "rows", perm)
        return out[0], col_aux, out[1], out[2], out[3]

    rotate = jax.jit(jax.shard_map(
        rot, mesh=mesh, in_specs=res_specs, out_specs=res_specs,
        check_vma=False,
    ))

    def gate(regs_mine, aux_mine, e_mine, fp_mine, base_mine,
             col_regs, col_aux, col_e, col_fp, col_base,
             r_tiles, c_tiles, n_real, tau_cb):
        return _ring_gate_counts(
            e_mine, col_e, fp_mine, col_fp, base_mine[0], col_base[0],
            r_tiles, c_tiles, n_real, tau_cb, n_bands, ti, use_cb,
            use_smh)

    gate_step = jax.jit(jax.shard_map(
        gate,
        mesh=mesh,
        in_specs=res_specs + res_specs + (P(), P(), P(), P()),
        out_specs=P("rows"),
        check_vma=False,
    ))

    # Diagonal-step variants: step 0 screens each strip against ITSELF
    # (circ is resident), but the general programs take the two strips as
    # two separate parameters and XLA budgets device memory for both -
    # twice the strip for a one-device mesh. These take the strip ONCE, restoring the screened engine's
    # single-bank memory footprint on the diagonal.
    def step_diag(regs_mine, aux_mine, e_mine, fp_mine, base_mine,
                  r_tiles, c_tiles, n_real, tau_scr, tau_cb, coef_aux):
        return step(regs_mine, aux_mine, e_mine, fp_mine, base_mine,
                    regs_mine, aux_mine, e_mine, fp_mine, base_mine,
                    r_tiles, c_tiles, n_real, tau_scr, tau_cb, coef_aux)

    screen_step_diag = jax.jit(jax.shard_map(
        step_diag,
        mesh=mesh,
        in_specs=res_specs + (P(), P(), P(), P(), P(), P()),
        out_specs=(P("rows"), P("rows")),
        check_vma=False,
    ))

    def gate_diag(regs_mine, aux_mine, e_mine, fp_mine, base_mine,
                  r_tiles, c_tiles, n_real, tau_cb):
        return gate(regs_mine, aux_mine, e_mine, fp_mine, base_mine,
                    regs_mine, aux_mine, e_mine, fp_mine, base_mine,
                    r_tiles, c_tiles, n_real, tau_cb)

    gate_step_diag = jax.jit(jax.shard_map(
        gate_diag,
        mesh=mesh,
        in_specs=res_specs + (P(), P(), P(), P()),
        out_specs=P("rows"),
        check_vma=False,
    ))
    return (screen_step, rotate, gate_step, screen_step_diag,
            gate_step_diag)


@partial(jax.jit, static_argnames=("n_bands", "ti", "use_cb", "use_smh"))
def _ring_gate_counts(e_rows, e_cols, fp_rows, fp_cols, row_base, col_base,
                      r_tiles, c_tiles, n_real, tau_cb, n_bands, ti,
                      use_cb, use_smh):
    """Strip-pair twin of screened._gate_counts: per-tile count of pairs
    passing the cheap gates (triangle + real-row + CB + LSH fingerprint
    equality) - elementwise work, so dead tiles never pay for the
    screen matmuls. Same conservative-superset contract as the screen gates."""
    lane = jnp.arange(ti, dtype=jnp.int32)[None, :]
    rl = r_tiles[:, None] * ti + lane
    cl = c_tiles[:, None] * ti + lane
    gi = row_base + rl
    gj = col_base + cl
    e_a = e_rows[rl]
    e_b = e_cols[cl]
    gate = (gi[:, :, None] < gj[:, None, :]) & (gj[:, None, :] < n_real)
    gate &= e_b[:, None, :] > 0
    if use_cb:
        gate &= e_a[:, :, None] >= tau_cb * e_b[:, None, :]
    if use_smh:
        gate &= band_hits(fp_rows[rl, :n_bands], fp_cols[cl, :n_bands])
    return jnp.sum(gate, axis=(1, 2), dtype=jnp.int32)


@partial(jax.jit, static_argnames=("p_aux", "ti"))
def _ring_aux_pass(s_a, z_a, e_rows, e_cols, r_tiles, c_tiles, coef_aux,
                   p_aux, ti):
    """Strip-pair variant of the hll-aux union gate
    (screened._screen_chunk_hllaux): certified MLE lower bound vs the
    threshold t_aux <= coef*(e1+e2) + slack, division-free."""
    from .screened import SCREEN_DELTA_AUX

    m_a = np.float32(1 << p_aux)
    lane = jnp.arange(ti, dtype=jnp.int32)[None, :]
    rl = r_tiles[:, None] * ti + lane
    cl = c_tiles[:, None] * ti + lane
    e_a = e_rows[rl]
    e_b = e_cols[cl]
    e_sum = e_a[:, :, None] + e_b[:, None, :]
    c32 = coef_aux.astype(jnp.float32)
    slack = np.float32(1.0 + SCREEN_DELTA_AUX)
    thresh = e_sum * c32 + slack  # > 0 always (slack >= 1)
    if z_a is None:
        return 2.0 * m_a * m_a <= 3.0 * s_a * thresh
    return 2.0 * m_a * (m_a - z_a) <= (3.0 * s_a - z_a) * thresh


@partial(jax.jit, static_argnames=("p", "n_bands", "ti", "use_cb",
                                   "use_smh"))
def _ring_post(s, z, e_rows, e_cols, fp_rows, fp_cols, row_base, col_base,
               r_tiles, c_tiles, n_real, tau_scr, tau_cb, p, n_bands, ti,
               use_cb, use_smh):
    """Strip-pair variant of screened._screen_post: identical gate and
    certified-MLE-bound screen math, but rows/cols come from two
    different strips with global offsets (row_base / col_base) for the
    triangle and real-row masks. Same conservative-superset contract."""
    m = np.float32(1 << p)
    one_tau = np.float32(1.0) + tau_scr.astype(jnp.float32)

    lane = jnp.arange(ti, dtype=jnp.int32)[None, :]
    rl = r_tiles[:, None] * ti + lane  # (C, ti) local row indices
    cl = c_tiles[:, None] * ti + lane
    gi = row_base + rl  # global row index
    gj = col_base + cl
    e_a = e_rows[rl]
    e_b = e_cols[cl]

    e_sum = e_a[:, :, None] + e_b[:, None, :]
    if z is None:
        hits = 3.0 * s * e_sum >= 2.0 * m * m * one_tau
    else:
        hits = (3.0 * s - z) * e_sum >= 2.0 * m * (m - z) * one_tau

    hits &= (gi[:, :, None] < gj[:, None, :]) & (gj[:, None, :] < n_real)
    hits &= e_b[:, None, :] > 0
    if use_cb:
        hits &= e_a[:, :, None] >= tau_cb * e_b[:, None, :]
    if use_smh:
        hits &= band_hits(fp_rows[rl, :n_bands], fp_cols[cl, :n_bands])
    return hits


def _strip_profile(e_p, n, n_dev, strip):
    """Per-strip (has_real, e_max, e_min_pos) from the sorted+padded
    cardinalities - the inputs of the strip-level CB liveness bound."""
    has_real = np.zeros(n_dev, bool)
    e_max = np.zeros(n_dev)
    e_min_pos = np.full(n_dev, np.inf)
    for d in range(n_dev):
        lo, hi = d * strip, min(n, (d + 1) * strip)
        if lo >= hi:
            continue
        has_real[d] = True
        seg = e_p[lo:hi]
        e_max[d] = float(seg[-1])  # ascending within the real rows
        pos = seg[seg > 0]
        if pos.size:
            e_min_pos[d] = float(pos[0])
    return has_real, e_max, e_min_pos


def select_pairs_ring(bank, params, mesh=None, ti=None, chunk_tiles=None,
                      stats=None):
    """All-pairs selection with the bank SHARDED across devices (ring
    systolic sweep). Same exact-output contract as the other engines;
    every criterion supported.

    ti/chunk_tiles default to the screened engine's rule for the
    per-strip size (screened.auto_tile/auto_chunk). chunk_tiles bounds the
    transient per-device hit-mask memory at chunk_tiles * ti^2 bytes
    regardless of bank size. stats: optional dict, filled with the
    sweep's memory / skip accounting (used by tests to assert the
    memory bound).
    """
    from jax.sharding import Mesh
    from .screened import auto_chunk, auto_tile

    if mesh is None:
        devices = np.array(jax.devices())
        mesh = Mesh(devices.reshape(len(devices)), axis_names=("rows",))
    if ti is None:
        ti = auto_tile(-(-bank.n // mesh.shape["rows"]))
    if chunk_tiles is None:
        chunk_tiles = auto_chunk(ti)
    crit = params.criterion
    valid = ("smh_a", "smh_only", "cb", "baseline", "hll_a", "hll_an")
    if crit not in valid:
        raise ValueError(f"ring engine does not support criterion {crit!r}")
    n = bank.n
    if n < 2:
        return []
    n_dev = mesh.shape["rows"]

    tau = params.tau_eff
    use_cb = crit not in ("baseline", "smh_only")
    use_smh = crit in ("smh_a", "smh_only")
    use_hllaux = crit in ("hll_a", "hll_an")

    order = bank.sorted_by_cardinality()
    e_s = np.trunc(bank.cards[order])
    # The sorted multi-GiB register copy is never materialized on the
    # host: strips upload via the slab-pipelined gather below, and the
    # exact confirm resolves its host copy lazily (device-assisted
    # confirm never touches it) - the same scale hygiene as ScreenPlan.
    aux_s = bank.aux[order] if bank.aux is not None else None

    # Pad to D * ti multiple so every strip is a whole number of tiles.
    quantum = n_dev * ti
    n_pad = -(-n // quantum) * quantum
    strip = n_pad // n_dev
    nt = strip // ti
    e_p = np.zeros(n_pad, np.float32)
    e_p[:n] = e_s

    if use_smh:
        n_rows_b, n_bands = criteria.smh_band_params(bank.aux_param,
                                                     params.tau)
        aux_p = np.zeros((n_pad, aux_s.shape[1]), aux_s.dtype)
        aux_p[:n] = aux_s
        fp = band_fingerprints_np(aux_p, n_rows_b, n_bands)
    else:
        n_bands = 1
        fp = np.zeros((n_pad, 1), np.int32)

    # hll-aux: the aux-HLL registers become a second circulating strip;
    # coef <= 0 disables the gate (screen stays a superset either way).
    from .screened import hll_aux_threshold_coef, SCREEN_DELTA_AUX

    aux_spec = None
    coef = 0.0
    aux_regs_p = np.zeros((n_pad, 8), np.uint8)  # dummy when unused
    if use_hllaux:
        zs = criteria.z_sigma(params.z_score, bank.aux_param)
        c = hll_aux_threshold_coef(crit, tau, zs, params.order_n)
        if c is not None:
            coef = c * (1.0 + SCREEN_DELTA_AUX)
            aux_regs_p = np.zeros((n_pad, aux_s.shape[1]), np.uint8)
            aux_regs_p[:n] = aux_s
            values_aux = screen.truncate_values(
                screen.bank_values(aux_s), float(e_s.max(initial=1.0)),
                bank.aux_param)
            aux_spec = (bank.aux_param, values_aux)

    # present values are permutation-invariant: scan the UNSORTED bank so
    # no sorted host copy is ever built
    values_all = screen.bank_values(bank.regs)
    values = screen.truncate_values(
        values_all, float(e_s.max(initial=1.0)), bank.p)
    from ..ops import regpack

    pack_plan = regpack.plan_pack(values_all)
    tau_scr = jnp.float32(screen_tau(tau, params.screen_delta))
    tau_cb = jnp.float32(tau * (1.0 - 1e-5))
    base = np.arange(n_dev, dtype=np.int32) * strip

    (screen_step, rotate, gate_step, screen_step_diag,
     gate_step_diag) = make_ring_fns(
        mesh, bank.p, values, ti, strip, n_bands, use_cb, use_smh,
        aux=aux_spec)

    # Sorted strips go to their devices via the shared slab-pipelined
    # upload (device peak per device = strip + one slab; the host never
    # holds a full sorted copy), assembled into ONE row-sharded global
    # array; the small per-row arrays ride plain puts and are resharded
    # by the jitted steps.
    from jax.sharding import NamedSharding, PartitionSpec as P

    t0 = time.perf_counter()
    sharding = NamedSharding(mesh, P("rows", None))
    r_regs = bank.regs.shape[1]
    upload_ph = {}
    shards = []
    for dev, idx in sorted(
            sharding.addressable_devices_indices_map(
                (n_pad, r_regs)).items(),
            key=lambda kv: kv[1][0].start or 0):
        lo = idx[0].start or 0
        shards.append(upload_sorted_rows(
            bank.regs, order, lo, strip, device=dev, stats=upload_ph,
            pack=pack_plan))
    d_regs_global = jax.make_array_from_single_device_arrays(
        (n_pad, r_regs), sharding, shards)
    if stats is not None:
        stats["upload_secs"] = round(time.perf_counter() - t0, 2)
        stats["upload_stats"] = {
            k: (round(v, 2) if isinstance(v, float) else v)
            for k, v in upload_ph.items()}

    # Pin every resident strip array to its P("rows") sharding once so
    # the per-step jits never re-scatter them (see the tile-sharded
    # engine's replication note).
    row1 = NamedSharding(mesh, P("rows"))
    row2 = NamedSharding(mesh, P("rows", None))
    d_e_global = jax.device_put(jnp.asarray(e_p), row1)
    resident = (d_regs_global,
                jax.device_put(jnp.asarray(aux_regs_p), row2),
                d_e_global,
                jax.device_put(jnp.asarray(fp), row2),
                jax.device_put(jnp.asarray(base), row1))
    circ = resident  # step 0: each device vs its own strip
    n_real = jnp.int32(n)
    coef_j = jnp.float32(coef)

    # Strip-level liveness: a ring step runs only if SOME device's
    # (resident d, circulating src=(d-s)%D) pair can hold an i<j pair
    # passing CB (one-sided bound in f64, relaxed like tau_cb).
    has_real, seg_max, seg_minpos = _strip_profile(e_p, n, n_dev, strip)
    tau_cb_host = float(tau) * (1.0 - 1e-5)

    def pair_live(d, src):
        if not (has_real[d] and has_real[src]):
            return False
        if src < d:
            return False  # gi < gj impossible across these strips
        if np.isinf(seg_minpos[src]):
            return False  # no positive-cardinality columns
        if use_cb and not (seg_max[d] / seg_minpos[src] >= tau_cb_host):
            return False
        return True

    # Per-step tile scheduling at CB-block granularity (the screened
    # engine's scheduler bound, lifted to strip-local tiles - without it
    # a 131k single-strip diagonal step would dispatch nt^2/2 tiles where
    # a handful are live). The dispatched list is the UNION over live
    # devices of their live local tiles (the step's tile list is
    # replicated across the mesh); per-pair masks inside the kernel keep
    # every device's output an exact superset as before.
    t0 = time.perf_counter()
    k0_pos = int(np.searchsorted(e_s, 0.0, side="right"))
    g_starts = np.arange(n_dev * nt, dtype=np.int64) * ti
    first_idx = np.maximum(g_starts, k0_pos)
    has_pos = first_idx < np.minimum(g_starts + ti, n)
    tile_minpos = np.where(
        has_pos, e_p[np.minimum(first_idx, n_pad - 1)].astype(np.float64),
        np.inf).reshape(n_dev, nt)
    tile_emax = e_p.reshape(n_dev, nt, ti).astype(np.float64).max(-1)
    tile_row_live = (g_starts < n).reshape(n_dev, nt)
    triu = (np.arange(nt)[:, None] <= np.arange(nt)[None, :])

    def step_tiles(s, live):
        """Union of live (resident-tile, circulating-tile) pairs for ring
        step s: conservative block-level CB + positive-column + real-row
        bounds, exactly the scheduler's tile semantics per strip pair."""
        union = np.zeros((nt, nt), bool)
        for d in live:
            src = (d - s) % n_dev
            m = (tile_row_live[d][:, None]
                 & np.isfinite(tile_minpos[src])[None, :])
            if use_cb:
                with np.errstate(invalid="ignore"):
                    m &= (tile_emax[d][:, None]
                          >= tau_cb_host * tile_minpos[src][None, :])
            if src == d:  # diagonal step: i<j kills below-diagonal tiles
                m &= triu
            union |= m
        rr, cc = np.nonzero(union)
        return rr.astype(np.int32), cc.astype(np.int32)

    if stats is not None:
        stats["schedule_secs"] = round(time.perf_counter() - t0, 3)

    chunk_tiles = max(1, min(chunk_tiles, nt * nt))
    if stats is not None:
        stats.update(steps_total=n_dev, steps_run=0, dispatches=0,
                     max_device_mask_bytes=0,
                     strip=strip, chunk_tiles=chunk_tiles)

    # Warm the gate/screen executables at their production shapes before
    # the timed loop: one-time compiles are a per-process cost, amortized
    # by the persistent cache, and report separately so the step loop
    # times steady state. Step 0 is the diagonal (circ IS resident): warm
    # the single-strip diag programs; the two-strip programs are warmed
    # only when the mesh has off-diagonal steps (n_dev > 1), against a
    # rotated throwaway copy - on a single device they would double the
    # device-memory footprint for nothing.
    if use_cb or use_smh:
        r_w = jnp.zeros(RING_GATE_CHUNK, jnp.int32)
        t_w = time.perf_counter()
        np.asarray(gate_step_diag(*resident, r_w, r_w, n_real, tau_cb))
        if n_dev > 1:
            np.asarray(gate_step(*resident, *rotate(*resident), r_w, r_w,
                                 n_real, tau_cb))
        if stats is not None:
            stats["gate_compile_secs"] = round(
                time.perf_counter() - t_w, 2)
    r_w = jnp.zeros(chunk_tiles, jnp.int32)
    t_w = time.perf_counter()
    hits_w, counts_w = screen_step_diag(
        *resident, r_w, r_w, n_real, tau_scr, tau_cb, coef_j)
    np.asarray(counts_w)
    if n_dev > 1:
        hits_w, counts_w = screen_step(
            *resident, *rotate(*resident), r_w, r_w, n_real, tau_scr,
            tau_cb, coef_j)
        np.asarray(counts_w)
    del hits_w, counts_w
    if stats is not None:
        stats["screen_compile_secs"] = round(time.perf_counter() - t_w, 2)

    cand = []
    gate_wall = 0.0
    t_screen0 = time.perf_counter()
    for s in range(n_dev):
        # diagonal step: single-strip programs (the strip is ONE operand,
        # not two - the two-strip programs double the HBM budget)
        if s == 0:
            def gate_call(r, c):
                return gate_step_diag(*resident, r, c, n_real, tau_cb)

            def screen_call(r, c):
                return screen_step_diag(*resident, r, c, n_real, tau_scr,
                                        tau_cb, coef_j)
        else:
            def gate_call(r, c, circ=circ):
                return gate_step(*resident, *circ, r, c, n_real, tau_cb)

            def screen_call(r, c, circ=circ):
                return screen_step(*resident, *circ, r, c, n_real,
                                   tau_scr, tau_cb, coef_j)
        live = [d for d in range(n_dev) if pair_live(d, (d - s) % n_dev)]
        if live:
            r_all, c_all = step_tiles(s, live)
            n_tiles = len(r_all)
            if stats is not None:
                stats["tiles_dispatched"] = (
                    stats.get("tiles_dispatched", 0) + n_tiles)
            t_gate0 = time.perf_counter()
            if n_tiles and (use_cb or use_smh):
                # Stage-1 gate prune over the step's tile list
                # (elementwise only, one concatenated count fetch): tiles
                # with no gate-passing pair on ANY device never pay for
                # the screen matmuls - the screened engine's cascade
                # stage 1, on the ring.
                gchunk = RING_GATE_CHUNK
                gpend = []
                for c0 in range(0, n_tiles, gchunk):
                    pad = max(0, gchunk - (n_tiles - c0))
                    r_g = np.pad(r_all[c0:c0 + gchunk], (0, pad),
                                 constant_values=r_all[-1])
                    c_g = np.pad(c_all[c0:c0 + gchunk], (0, pad),
                                 constant_values=c_all[-1])
                    gpend.append(gate_call(jnp.asarray(r_g),
                                           jnp.asarray(c_g)))
                gc = (np.asarray(gpend[0]) if len(gpend) == 1 else
                      np.asarray(jnp.concatenate(gpend)))
                live_mask = np.zeros(n_tiles, bool)
                pos = 0
                for c0 in range(0, n_tiles, gchunk):
                    take = min(gchunk, n_tiles - c0)
                    sub = gc[pos:pos + n_dev * gchunk].reshape(
                        n_dev, gchunk)
                    live_mask[c0:c0 + take] = sub[:, :take].any(0)
                    pos += n_dev * gchunk
                r_all = r_all[live_mask]
                c_all = c_all[live_mask]
                n_tiles = len(r_all)
                gate_wall += time.perf_counter() - t_gate0
                if stats is not None:
                    stats["tiles_gate_live"] = (
                        stats.get("tiles_gate_live", 0) + n_tiles)
                    # steady-state gate wall (the executable is warmed
                    # above; the compile reports separately)
                    stats["gate_secs"] = round(gate_wall, 2)
        if live and n_tiles:
            # Chunked dispatch with power-of-two remainder buckets
            # (repeat-padded, deduped at extraction) to bound the
            # compiled-shape count.
            spans = [(c0, chunk_tiles) for c0 in
                     range(0, n_tiles - chunk_tiles + 1, chunk_tiles)]
            rem = n_tiles - len(spans) * chunk_tiles
            if rem:
                bucket = min(chunk_tiles,
                             max(1, 1 << (rem - 1).bit_length()))
                spans.append((n_tiles - rem, bucket))
            pending = []
            for c0, width in spans:
                take = min(width, n_tiles - c0)
                r_chunk = np.pad(r_all[c0:c0 + take], (0, width - take),
                                 constant_values=r_all[-1])
                c_chunk = np.pad(c_all[c0:c0 + take], (0, width - take),
                                 constant_values=c_all[-1])
                hits, counts = screen_call(jnp.asarray(r_chunk),
                                           jnp.asarray(c_chunk))
                pending.append((r_chunk, c_chunk, hits, counts))
                if stats is not None:
                    stats["dispatches"] += 1
                    stats["max_device_mask_bytes"] = max(
                        stats["max_device_mask_bytes"],
                        width * ti * ti * hits.dtype.itemsize)
            # Counts-first fetch for the whole step's pipeline, then only
            # the hit coordinates of tiles that actually hit cross to the
            # host - gathered in ONE fetch per dispatch.
            counts = np.asarray(
                jnp.concatenate([cn for _, _, _, cn in pending]))
            pos = 0
            for r_chunk, c_chunk, hits, _ in pending:
                width = len(r_chunk)
                cslice = counts[pos:pos + width * n_dev]
                ts = np.nonzero(cslice)[0]
                if ts.size:
                    for t, ri, cj in extract_hit_coords(
                            hits, ts, cslice[ts], ti):
                        d = t // width
                        tl = t % width
                        src = (d - s) % n_dev
                        gi = d * strip + int(r_chunk[tl]) * ti + ri
                        gj = src * strip + int(c_chunk[tl]) * ti + cj
                        cand.extend(zip(gi.tolist(), gj.tolist()))
                pos += width * n_dev
            if stats is not None:
                stats["steps_run"] += 1
        if s < n_dev - 1:
            circ = rotate(*circ)
    cand = sorted(set(cand))
    if stats is not None:
        # screen wall, DISJOINT from gate_secs (both sit inside the
        # step loop)
        stats["screen_secs"] = round(
            time.perf_counter() - t_screen0 - gate_wall, 2)
        stats["candidates"] = len(cand)

    # Exact confirm: device-assisted through the row-sharded global bank
    # (regs[ii]/regs[kk] gathers compile to SPMD collective gathers under
    # jit; only flags + survivor histograms cross the host link, with the
    # certain-reject bound) - the host register copy is resolved lazily,
    # only on the CPU backend.
    t0 = time.perf_counter()
    hist_fn = None
    if jax.default_backend() != "cpu":
        hist_fn = make_device_hist_fn(
            lambda: d_regs_global, lambda: d_e_global, bank.p,
            float(params.tau),
            reject_delta_for(bank.p, params.screen_delta))
    oracle = PairOracle(
        bank.p, (lambda: bank.regs[order]), e_s, aux=aux_s,
        aux_param=bank.aux_param, criterion=crit, tau=params.tau,
        z_score=params.z_score, order_n=params.order_n, apply_cb=use_cb,
        hist_fn=hist_fn,
    )
    names = bank.names
    out = [
        (names[order[i]], names[order[j]], jacc)
        for i, j, jacc in oracle.confirm_pairs(cand)
    ]
    if stats is not None:
        stats["confirm_secs"] = round(time.perf_counter() - t0, 2)
    return out
