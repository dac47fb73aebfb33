"""Screened all-pairs selection engine (the GPU hot path).

Three-stage cascade, mirroring the reference's prune-then-confirm design
(src/selection.cpp:270-291) but restructured as dense device work:

  1. SCHEDULE (host): sort by cardinality, tile the i<j triangle, drop
     tiles the block-level cardinality bound kills (parallel.scheduler).
  2. SCREEN (device, one dispatch per tile chunk): int8 indicator matmuls
     (ops/screen.py) compute per-pair harmonic sums / zero counts; the
     certified MLE-lower-bound Jaccard screen, the CB gate, and the
     criterion gate are applied in the same jit. Everything here is a
     *superset* filter BY THEOREM: the screen statistic
     t_lb = 2m(m-Z)/(3S-Z) provably lower-bounds the implemented ERTL-MLE
     (ops/screen.mle_lower_bound; proof in DESIGN.md "Screen
     certificate"; machine-checked in tests/test_certificate.py), so no
     pair the reference would emit can be dropped.
  3. CONFIRM (host, exact): every surviving candidate is re-evaluated by
     the scalar f64 oracle (utils/hostref.PairOracle) - the exact
     reference cascade (CB, aux criterion, ERTL-MLE union, J >= tau) - so
     the emitted pair set and Jaccard values are bit-identical to the
     reference on every backend.

The screen-vs-exact margin `delta` covers only f32 rounding of the
screen statistic (~1e-5 budget; default 1e-3). Screening at
tau_scr = (1+tau)/(1+delta) - 1 passes every pair with J_mle >= tau.
"""

import time
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import criteria, regpack, screen
from ..utils.hostref import PairOracle
from . import scheduler

# Numeric slack on the CERTIFIED screen threshold. The screen statistic
# t_lb = 2m(m-z)/(3s-z) is a PROVEN lower bound of the implemented
# ERTL-MLE at every precision (ops/screen.mle_lower_bound; DESIGN.md
# "Screen certificate"), so the margin covers only floating point: the
# f32 rounding of the harmonic sum (one rounding, ops/screen.py), the f32
# cardinalities and threshold products (~1e-7 each). 1e-3 is ~100x that
# budget.
SCREEN_DELTA_DEFAULT = 1e-3
# Same certificate, same slack, for the small AUX sketches (p_aux 5..8):
# the bound is precision-independent, so the old 0.75 ORIGINAL-vs-MLE
# margin (27% measured deviation at p=6, generously widened) collapses
# to the numeric slack - a large selectivity win for hll_a/hll_an.
SCREEN_DELTA_AUX = 1e-3


def screen_tau(tau, delta=SCREEN_DELTA_DEFAULT):
    """Conservative screen threshold: t_lb <= e_sum/(1+screen_tau(tau))
    whenever t_mle <= e_sum/(1+tau), given t_lb <= (1+delta)*t_mle.
    The certificate gives t_lb <= t_mle exactly; delta only absorbs f32
    rounding of the kernel-side statistic."""
    return (1.0 + float(tau)) / (1.0 + float(delta)) - 1.0


def hll_aux_threshold_coef(criterion, tau, zs, order_n):
    """Coefficient c with: the exact aux gate passes only if
    t_aux <= c * (e1 + e2).

    hll_a (criteria_sketch.hpp:60-64): K+ >= tau with t+ = t/(1+Z*sigma)
    and (1+gamma)*e2 = e1+e2, so pass <=> t <= (1+zs)(e1+e2)/(1+tau).

    hll_an (criteria_sketch.hpp:52-58): J + C >= tau with
    C = min(1, (1+zs)e2/t) * (1+gamma) * s, s = sum_{k<=n} (zs)^k.
      - min != 1 case: pass <=> t <= (e1+e2)(1 + (1+zs)s)/(1+tau);
      - min == 1 case: C <= 2s (gamma <= 1 after the sort), so
        pass => t <= (e1+e2)/(1+tau-2s)  (None = gate can't prune when
        1+tau-2s <= 0).
    The max of the two cases is a valid one-sided bound for the screen.
    """
    tau = float(tau)
    zs = float(zs)
    if criterion == "hll_a":
        return (1.0 + zs) / (1.0 + tau)
    s = 0.0
    num = 1.0
    for _ in range(order_n):
        num *= zs
        s += num
    c_b = (1.0 + (1.0 + zs) * s) / (1.0 + tau)
    if 1.0 + tau - 2.0 * s <= 0.0:
        return None  # gate passes everything at this tau/Z - skip screening
    return max(c_b, 1.0 / (1.0 + tau - 2.0 * s))


def band_fingerprints(aux, n_rows, n_bands):
    """int32 (N, n_bands) FNV-mix fingerprints of the LSH bands.

    Band equality implies fingerprint equality, so screening on
    fingerprints is a superset of the exact smh_a gate (collisions are
    rare false positives absorbed by the exact confirmation); one i32
    compare per band replaces n_rows emulated-u64 compares per pair.
    """
    aux = jnp.asarray(aux, jnp.uint64)
    lo = (aux & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
    hi = (aux >> 32).astype(jnp.uint32)
    limbs = jnp.stack([lo, hi], -1).reshape(
        aux.shape[0], n_bands, n_rows * 2
    )
    fp = jnp.full(limbs.shape[:2], 2166136261, jnp.uint32)
    for k in range(n_rows * 2):
        fp = (fp ^ limbs[..., k]) * jnp.uint32(16777619)
    return fp.astype(jnp.int32)


def band_fingerprints_np(aux, n_rows, n_bands):
    """Host twin of band_fingerprints, bit-identical (same FNV limb walk
    in uint32 numpy). At bank scale this replaces shipping the full
    (N, m) uint64 aux array to the device (131 MB at N=524k) with a
    (N, n_bands) int32 put (16 MB): the fingerprint math is ~0.2 s of
    host vector ops, well under the wire time it saves."""
    aux = np.asarray(aux, np.uint64)
    lo = (aux & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (aux >> np.uint64(32)).astype(np.uint32)
    limbs = np.stack([lo, hi], -1).reshape(aux.shape[0], n_bands,
                                           n_rows * 2)
    fp = np.full(limbs.shape[:2], 2166136261, np.uint32)
    mult = np.uint32(16777619)
    with np.errstate(over="ignore"):
        for k in range(n_rows * 2):
            fp = (fp ^ limbs[..., k]) * mult
    return fp.astype(np.int32)


@partial(jax.jit, static_argnames=("p", "values", "ti", "n_bands",
                                   "use_cb", "use_smh"))
def _screen_chunk(regs, r_tiles, c_tiles, e, fp, n_real, tau_scr, tau_cb,
                  p, values, ti, n_bands, use_cb, use_smh):
    """One screen dispatch over a chunk of tiles: (hits, per-tile counts).

    The plain XLA screen (ops/screen.screen_s_z: int8 indicator matmuls,
    f64-exact weighted sum) followed by the certificate and gates of
    _screen_post, in one jitted program."""
    s, z = screen.screen_s_z(regs, r_tiles, c_tiles, p, values, ti=ti, tj=ti)
    hits = _screen_post(
        s, z, e, fp, r_tiles * ti, c_tiles * ti, n_real, tau_scr, tau_cb,
        p, n_bands, ti, ti, use_cb, use_smh,
    )
    return hits, jnp.sum(hits, axis=(1, 2), dtype=jnp.int32)


@partial(jax.jit, static_argnames=("p", "values", "p_aux", "values_aux",
                                   "ti"))
def _screen_chunk_hllaux(regs, aux_regs, r_tiles, c_tiles, e, n_real,
                         tau_scr, tau_cb, coef_aux, p, values, p_aux,
                         values_aux, ti):
    """Screen dispatch for hll_a/hll_an: primary screen + aux-union gate.

    The aux gate is the same harmonic-sum machinery at p_aux (registers
    32..256 long, ~1% of the primary cost): the exact gate only passes
    when t_aux <= coef * (e1+e2)
    (hll_aux_threshold_coef), so the screen tests the certified MLE lower
    bound against that threshold (ops/screen.mle_lower_bound - valid at
    every p_aux), division-free."""
    hits, _ = _screen_chunk(
        regs, r_tiles, c_tiles, e, None, n_real, tau_scr, tau_cb, p,
        values, ti, 1, True, False)
    s_a, z_a = screen.screen_s_z(aux_regs, r_tiles, c_tiles, p_aux,
                                 values_aux, ti=ti, tj=ti)
    m_a = np.float32(1 << p_aux)
    row0 = r_tiles * ti
    col0 = c_tiles * ti
    ii = row0[:, None] + jnp.arange(ti, dtype=jnp.int32)[None, :]
    jj = col0[:, None] + jnp.arange(ti, dtype=jnp.int32)[None, :]
    e_sum = e[ii][:, :, None] + e[jj][:, None, :]
    c32 = coef_aux.astype(jnp.float32)
    # Absolute slack on top of the multiplicative margin: the exact hll_a
    # gate truncates t_hat to an integer (size_t cast), which can admit up
    # to +1 beyond the continuous bound; +(1+delta) covers that for every
    # union size, making the one-sided bound rigorous even for t ~ 1.
    slack = np.float32(1.0 + SCREEN_DELTA_AUX)
    thresh = e_sum * c32 + slack  # > 0 always (slack >= 1)
    if z_a is None:
        aux_pass = 2.0 * m_a * m_a <= 3.0 * s_a * thresh
    else:
        aux_pass = 2.0 * m_a * (m_a - z_a) <= (3.0 * s_a - z_a) * thresh
    hits &= aux_pass
    return hits, jnp.sum(hits, axis=(1, 2), dtype=jnp.int32)


def band_hits(fp_a, fp_b):
    """(T, ti, tj) bool: some LSH band fingerprint of row i equals that of
    column j, from (T, ti, n_bands) and (T, tj, n_bands) fingerprints.

    One band per loop step, so the mask is materialized between bands.
    Fusing every band's columns into the consumer instead gives XLA:GPU
    one reduce fusion with 2 * n_bands + operands, which at ti=1024 took
    13 minutes to compile on an H100 and then failed autotuning."""
    def body(b, acc):
        fa = jax.lax.dynamic_index_in_dim(fp_a, b, axis=2, keepdims=False)
        fb = jax.lax.dynamic_index_in_dim(fp_b, b, axis=2, keepdims=False)
        return acc | (fa[:, :, None] == fb[:, None, :])

    first = fp_a[:, :, None, 0] == fp_b[:, None, :, 0]
    return jax.lax.fori_loop(1, fp_a.shape[2], body, first)


@partial(jax.jit, static_argnames=("n_bands", "ti", "use_cb", "use_smh"))
def _gate_counts(e, fp, r_tiles, c_tiles, n_real, tau_cb, n_bands, ti,
                 use_cb, use_smh):
    """Per-tile count of pairs passing the cheap gates (CB + LSH
    fingerprints + triangle) - the cascade's first stage, no matmuls.

    Tiles with zero gate-passing pairs never pay for the harmonic-sum
    kernel, exactly like the reference's `continue` past gate-failing
    pairs before the union (src/selection.cpp:282-286)."""
    row0 = r_tiles * ti
    col0 = c_tiles * ti
    ii = row0[:, None] + jnp.arange(ti, dtype=jnp.int32)[None, :]
    jj = col0[:, None] + jnp.arange(ti, dtype=jnp.int32)[None, :]
    e_a = e[ii]
    e_b = e[jj]
    gate = (ii[:, :, None] < jj[:, None, :]) & (jj[:, None, :] < n_real)
    gate &= e_b[:, None, :] > 0
    if use_cb:
        gate &= e_a[:, :, None] >= tau_cb * e_b[:, None, :]
    if use_smh:
        gate &= band_hits(fp[ii, :n_bands], fp[jj, :n_bands])
    return jnp.sum(gate, axis=(1, 2), dtype=jnp.int32)


@partial(jax.jit, static_argnames=("p", "n_bands", "ti", "tj", "use_cb",
                                   "use_smh"))
def _screen_post(s, z, e, fp, row0, col0, n_real, tau_scr, tau_cb, p,
                 n_bands, ti, tj, use_cb, use_smh):
    """Gates + certified-MLE-bound Jaccard screen over a chunk of tiles.

    Every comparison is a conservative superset of the exact cascade
    (numeric slack folded into tau_scr / tau_cb; fingerprint collisions
    only ADD candidates); survivors go to exact host confirmation. The
    estimator screen uses the CERTIFIED lower bound of the MLE
    (ops/screen.mle_lower_bound: t_lb = 2m(m-Z)/(3S-Z) <= t_mle, a
    theorem - DESIGN.md "Screen certificate"), evaluated without
    per-pair division or transcendentals:

      t_lb <= (e1+e2)/(1+tau_scr)
        <=>  (3S - Z)*(e1+e2) >= 2m(m-Z)*(1+tau_scr)

    (3S - Z >= 2Z >= 0 always, since every zero register contributes 1
    to S, so the cross-multiplication never flips.) Exact pass
    t_mle <= (e1+e2)/(1+tau) implies it because t_lb <= t_mle and
    tau_scr relaxes tau by the f32 slack.
    """
    m = np.float32(1 << p)
    one_tau = np.float32(1.0) + tau_scr.astype(jnp.float32)

    ii = row0[:, None] + jnp.arange(ti, dtype=jnp.int32)[None, :]  # (T, ti)
    jj = col0[:, None] + jnp.arange(tj, dtype=jnp.int32)[None, :]  # (T, tj)
    e_a = e[ii]  # (T, ti) f32
    e_b = e[jj]

    e_sum = e_a[:, :, None] + e_b[:, None, :]
    if z is None:  # no zero registers anywhere in the bank
        hits = 3.0 * s * e_sum >= 2.0 * m * m * one_tau
    else:
        hits = (3.0 * s - z) * e_sum >= 2.0 * m * (m - z) * one_tau

    hits &= (ii[:, :, None] < jj[:, None, :]) & (jj[:, None, :] < n_real)
    hits &= e_b[:, None, :] > 0
    if use_cb:
        hits &= e_a[:, :, None] >= tau_cb * e_b[:, None, :]
    if use_smh:
        hits &= band_hits(fp[ii, :n_bands], fp[jj, :n_bands])
    return hits


# ---------------------------------------------------------------------------
# Shared screen pipeline (single-chip, sharded, and multi-host engines)
# ---------------------------------------------------------------------------


class _SweepCheckpoint:
    """Append-only JSONL progress log for long screen sweeps.

    Line 0: a header binding the file to one exact run (bank size,
    criterion, tau, and a hash of the tile schedule) - resuming against a
    different run errors instead of silently mixing results. Each further
    line: {"span": [c0, width], "cand": [[i, j], ...]} for one completed
    dispatch chunk. A torn final line (crash mid-write) is ignored; its
    span simply recomputes. fsync per wave bounds lost work.
    """

    def __init__(self, fh, done_spans, done_candidates):
        self._fh = fh
        self.done_spans = done_spans
        self.done_candidates = done_candidates
        self._since_sync = 0

    @classmethod
    def open(cls, path, plan, rows, cols, chunk):
        if path is None:
            return None
        import hashlib
        import json
        import os

        header = {
            "schedule_hash": hashlib.sha1(
                rows.tobytes() + cols.tobytes()).hexdigest()[:16],
            "n": int(plan.n),
            "criterion": plan.crit,
            "tau": float(plan.params.tau),
            "ti": int(plan.ti),
            # Spans are a function of the chunk size; binding it makes a
            # mismatched resume error out instead of silently recomputing
            # every span while still prepending the old candidates.
            "chunk": int(chunk),
        }
        done_spans = set()
        done_cand = []
        if os.path.exists(path) and os.path.getsize(path):
            with open(path) as fh:
                first = fh.readline()
                try:
                    if json.loads(first) != header:
                        raise ValueError(
                            f"checkpoint {path!r} belongs to a different "
                            "run (bank/params/schedule changed)")
                except json.JSONDecodeError as exc:
                    raise ValueError(
                        f"corrupt checkpoint header in {path!r}") from exc
                for line in fh:
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        break  # torn tail line: recompute that span
                    done_spans.add(tuple(rec["span"]))
                    done_cand.extend(map(tuple, rec["cand"]))
            fh = open(path, "a")
        else:
            fh = open(path, "w")
            fh.write(json.dumps(header) + "\n")
            fh.flush()
        return cls(fh, done_spans, done_cand)

    def record(self, span, cand):
        import json
        import os

        self._fh.write(json.dumps(
            {"span": list(span), "cand": [list(c) for c in cand]}) + "\n")
        self._since_sync += 1
        if self._since_sync >= 64:
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._since_sync = 0

    def close(self):
        import os

        self._fh.flush()
        os.fsync(self._fh.fileno())
        self._fh.close()


@partial(jax.jit, donate_argnums=(0,))
def _place_rows(buf, slab, i0):
    """In-place (donated) row placement for the slab-pipelined bank
    upload: buf[i0:i0+len(slab)] = slab without a second bank-sized
    device allocation. The scalar token is NOT donated, so the host can
    block on it to learn this placement consumed its slab (the buf chain
    itself is donated away and cannot be blocked on)."""
    out = jax.lax.dynamic_update_slice(buf, slab, (i0, jnp.int32(0)))
    return out, out[i0, 0].astype(jnp.int32)


def upload_sorted_rows(bank_regs, order, lo, rows_out, device=None,
                       slab_bytes=128 << 20, stats=None, pack=None):
    """Slab-pipelined upload of sorted bank rows [lo, lo+rows_out) to one
    device: (rows_out, R) uint8 array, rows past len(order) zero-padded.

    The host gathers a bounded slab of `bank_regs[order[...]]` into one of
    two reused arenas (first-touch page faults are paid for 2 slabs, not
    the whole bank), ships it with an async device_put, and places it
    into a donated device buffer with one compiled dynamic_update_slice -
    device peak = buffer + one slab, and the gather of slab k+1 overlaps
    the transfer of slab k. Shared by the single-device ScreenPlan upload
    and the ring engine's per-device strip uploads.

    pack: optional ops.regpack.plan_pack triple - ships k/8 of the dense
    bytes as bit-planes of the value index and decodes on device
    (bit-exact roundtrip). Both engines pass it whenever plan_pack returns
    a plan: the native threaded gather+pack beats the plain path's numpy
    row gather (4 GiB bank on an H100 host: 1.34-1.51 s packed vs
    3.45-3.61 s plain, PERF.md). None ships raw bytes."""
    from ..ops import regpack

    r = bank_regs.shape[1]
    slab = max(1, slab_bytes // max(r, 1))
    ctx = jax.default_device(device) if device is not None else None
    if ctx is not None:
        ctx.__enter__()
    try:
        buf = jnp.zeros((rows_out, r), jnp.uint8)
        count = max(0, min(len(order) - lo, rows_out))
        if count == 0:
            buf.block_until_ready()
            return buf
        arenas = [np.empty((min(slab, count), r), np.uint8)
                  for _ in range(2)]
        if pack is not None:
            lut256, table, kbits = pack
            d_table = jax.device_put(table, device)
            packs = [np.empty((min(slab, count), kbits, r // 8), np.uint8)
                     for _ in range(2)]
            pack_scratch = {}
        tokens = [None, None]
        ph = stats if stats is not None else {}
        ph.setdefault("slabs", 0)
        ph["pack_bits"] = 0 if pack is None else kbits
        for key in ("gather_secs", "put_ret_secs", "token_wait_secs",
                    "pack_secs"):
            ph.setdefault(key, 0.0)
        for idx, k0 in enumerate(range(0, count, slab)):
            a = arenas[idx % 2]
            tp = time.perf_counter()
            if tokens[idx % 2] is not None:
                tokens[idx % 2].block_until_ready()
            ph["token_wait_secs"] += time.perf_counter() - tp
            rows = order[lo + k0: lo + min(k0 + slab, count)]
            if pack is not None:
                # fused native gather+pack straight from the unsorted
                # bank (one read per row; the two-step form streamed the
                # slab through DRAM twice more)
                tp = time.perf_counter()
                pk = regpack.gather_pack_rows(
                    bank_regs, rows, lut256, kbits,
                    out=packs[idx % 2][: len(rows)],
                    scratch=pack_scratch)
                ph["pack_secs"] += time.perf_counter() - tp
                tp = time.perf_counter()
                d_slab = jax.device_put(pk, device)
                ph["put_ret_secs"] += time.perf_counter() - tp
                buf, tokens[idx % 2] = regpack.unpack_place(
                    buf, d_slab, d_table, jnp.int32(k0), kbits)
                ph["slabs"] += 1
                continue
            tp = time.perf_counter()
            np.take(bank_regs, rows, axis=0, out=a[: len(rows)])
            ph["gather_secs"] += time.perf_counter() - tp
            tp = time.perf_counter()
            d_slab = jax.device_put(a[: len(rows)], device)
            ph["put_ret_secs"] += time.perf_counter() - tp
            buf, tokens[idx % 2] = _place_rows(buf, d_slab, jnp.int32(k0))
            ph["slabs"] += 1
        # blocking on the placed-buffer computation output forces the
        # whole chain of asynchronous puts and placements
        buf.block_until_ready()
        return buf
    finally:
        if ctx is not None:
            ctx.__exit__(None, None, None)


def reject_delta_for(p, screen_delta):
    """Certain-reject margin for a primary precision p.

    With the certified MLE lower bound (ops/screen.mle_lower_bound) the
    reject test t_lb > (1+delta)(e1+e2)/(1+tau) is rigorous at EVERY
    precision - t_lb <= t_mle is a theorem - so no p-dependent widening
    remains (through round 4 this widened to 0.75 below p=10 to cover
    the measured ORIGINAL-vs-MLE deviation); delta is the f32 slack."""
    return float(screen_delta)


@partial(jax.jit, static_argnames=("k",))
def _hit_coords(hits, ts, k):
    sub = jnp.take(hits, ts, axis=0)
    ri, cj = jax.vmap(
        lambda m: jnp.nonzero(m, size=k, fill_value=-1))(sub)
    return jnp.stack([ri.astype(jnp.int32), cj.astype(jnp.int32)], 1)


def extract_hit_coords(hits, ts, counts_ts, ti):
    """[(tile_pos, rows, cols)] for the hit tiles of one dispatch chunk.

    Device-side compaction: a vmapped fixed-size nonzero ships 8*K bytes
    per hit tile instead of the raw ti^2 mask (1 MB at ti=1024 - the mask
    fetch was the last per-candidate O(tile-area) transfer on the link).
    K is the smallest pow2 covering the chunk's max per-tile count
    (counts are already fetched); dense tiles (K beyond ti^2/16) fall
    back to the mask fetch, which is smaller at that point."""
    cmax = int(counts_ts.max())
    if cmax > ti * ti // 16:
        masks = jax.device_get(hits[jnp.asarray(np.asarray(ts))])
        return [(int(t), *np.nonzero(m)) for t, m in zip(ts, masks)]
    k = max(8, 1 << int(cmax - 1).bit_length()) if cmax > 1 else 8
    h_pad = max(1, 1 << int(len(ts) - 1).bit_length()) if len(ts) > 1 else 1
    tp = np.pad(np.asarray(ts, np.int32), (0, h_pad - len(ts)))
    out = np.asarray(_hit_coords(hits, jnp.asarray(tp), k))
    res = []
    for i, t in enumerate(ts):
        ri = out[i, 0]
        good = ri >= 0
        res.append((int(t), ri[good], out[i, 1][good]))
    return res


def make_device_hist_fn(get_regs, get_e, p, tau, delta, chunk=8192):
    """Standalone device-histogram provider with the certain-reject bound
    (shared by ScreenPlan.device_hist_fn and the ring engine's confirm).

    get_regs/get_e: zero-arg callables resolving to the device register
    bank (sorted+padded, any sharding jit accepts) and the f32 sorted
    cardinalities - callables so a deferred upload stays deferred until
    the first confirm batch actually dispatches."""
    from ..ops.estimators import hll_histogram
    from ..ops.screen import mle_lower_bound

    q = 64 - p
    m = 1 << p
    # f32 slop: s is a <= q+2-term f32 sum of exact products
    # (c_k * 2^-k, both exactly representable), ~6e-6 relative; e1+e2
    # rounds once. 1e-4 covers both with two orders to spare.
    coef = np.float32((1.0 + delta) * (1.0 + 1e-4))
    one_tau = np.float32(1.0 + tau)
    out_t = jnp.int16 if p <= 14 else jnp.int32

    @partial(jax.jit, static_argnames=("pp",))
    def hist_flag(bank_regs, e, ii, kk, pp):
        merged = jnp.maximum(bank_regs[ii], bank_regs[kk])
        h = hll_histogram(merged.astype(jnp.int32), pp)  # (B, q+2) ints
        # exact-count f32 telescope: certified MLE lower bound of the
        # union (t_lb <= t_mle is a theorem - DESIGN.md, so a reject on
        # t_lb can never be a false reject)
        w = np.ldexp(np.ones(q + 2, np.float32),
                     -np.arange(q + 2)).astype(np.float32)
        s = jnp.sum(h.astype(jnp.float32) * w[None, :], axis=-1)
        t_lb = mle_lower_bound(s, h[:, 0].astype(jnp.float32), pp)
        e_sum = e[ii] + e[kk]
        # certain reject <=> tau < t_lb(1+...)/(e1+e2) - 1 <= J_mle bound
        reject = one_tau * t_lb > coef * e_sum
        return h.astype(out_t), reject

    def dispatch(ii, kk):
        """Async: returns (pending device (hist, reject) pairs, nb)."""
        nb = len(ii)
        n_pad = -(-max(nb, 1) // chunk) * chunk
        ip = np.pad(np.asarray(ii, np.int32), (0, n_pad - nb))
        kp = np.pad(np.asarray(kk, np.int32), (0, n_pad - nb))
        d_regs = get_regs()
        d_e = get_e()
        pending = [
            hist_flag(d_regs, d_e, jnp.asarray(ip[c0:c0 + chunk]),
                      jnp.asarray(kp[c0:c0 + chunk]), p)
            for c0 in range(0, n_pad, chunk)
        ]
        return pending, nb

    def fetch(handle):
        pending, nb = handle
        if one_tau <= 0.0:  # bound can never reject: plain hist fetch
            return np.concatenate(
                [np.asarray(h) for h, _ in pending])[:nb]
        # 1 byte/pair first; full (q+2)-bin rows only for survivors.
        d_rej = (pending[0][1] if len(pending) == 1 else
                 jnp.concatenate([r for _, r in pending]))
        rej = np.asarray(d_rej)[:nb]
        out = np.zeros((nb, q + 2), np.int32)
        out[:, q + 1] = m  # sentinel: MLE inf -> jacc NaN -> dropped
        surv = np.nonzero(~rej)[0]
        if surv.size:
            # one gathered fetch, survivor list padded to a pow2 bucket
            # so compiled shapes stay bounded
            n_pad = max(8, 1 << int(surv.size - 1).bit_length())
            sp = np.pad(surv, (0, n_pad - surv.size))
            d_all = (pending[0][0] if len(pending) == 1 else
                     jnp.concatenate([h for h, _ in pending]))
            got = np.asarray(jnp.take(d_all, jnp.asarray(sp), axis=0))
            out[surv] = got[: surv.size]
        return out

    def fn(ii, kk):
        return fetch(dispatch(ii, kk))

    fn.dispatch = dispatch
    fn.fetch = fetch
    # consumers (PairOracle) assert their threshold is >= this one: a
    # hist provider rejecting above the oracle's tau silently loses pairs
    fn.tau = float(tau)
    return fn


class ScreenPlan:
    """Everything the screen cascade needs, prepared once per bank/params:
    the sorted+padded host arrays, the device-resident bank, and the
    conservative thresholds. Shared by the single-chip chunk loop, the
    shard_map multi-device step, and the multi-host tile-slice engine so
    the three paths cannot drift."""

    VALID = ("smh_a", "smh_only", "cb", "baseline", "hll_a", "hll_an")

    def __init__(self, bank, params, ti):
        crit = params.criterion
        if crit not in self.VALID:
            raise ValueError(
                f"screened engine does not support criterion {crit!r}")
        self.bank = bank
        self.params = params
        self.ti = ti
        self.crit = crit
        self.n = bank.n
        self.tau = params.tau_eff
        self.use_cb = crit not in ("baseline", "smh_only")
        self.use_smh = crit in ("smh_a", "smh_only")

        order = bank.sorted_by_cardinality()
        self.order = order
        self.e_s = np.trunc(bank.cards[order])
        self.aux_s = bank.aux[order] if bank.aux is not None else None
        # The SORTED multi-GiB register copy is built lazily: the device
        # path uploads sorted slabs (regs_s is only touched by the host
        # confirm on the CPU backend and by tests), so a large bank never
        # pays a whole host-side gather (utils/hostmem).
        self._regs_s = None

        # Pad the sorted bank to a tile multiple; padded rows have e == 0
        # and are masked out by the n_real / e_b > 0 gates.
        n = self.n
        n_pad = -(-n // ti) * ti
        self.n_pad = n_pad
        if n_pad != n:
            e_p = np.zeros(n_pad, self.e_s.dtype)
            e_p[:n] = self.e_s
            if self.aux_s is not None:
                aux_p = np.zeros((n_pad, self.aux_s.shape[1]),
                                 self.aux_s.dtype)
                aux_p[:n] = self.aux_s
            else:
                aux_p = None
        else:
            e_p, aux_p = self.e_s, self.aux_s
        self.e_p = e_p

        if self.use_smh:
            n_rows_b, self.n_bands = criteria.smh_band_params(
                bank.aux_param, params.tau)
            self.d_fp = jnp.asarray(band_fingerprints_np(
                aux_p, n_rows_b, self.n_bands))
        else:
            self.n_bands = 1
            self.d_fp = jnp.zeros((n_pad, 1), jnp.int32)

        # Device aux-union gate for the HLL-aux criteria: the exact gate
        # only passes when t_aux <= coef * (e1+e2), so the aux sketches get
        # the same harmonic-sum screen at p_aux (~1% of the primary cost).
        # coef is inflated by the aux estimator-deviation margin here.
        self.coef_aux = self.values_aux = self._aux_p = None
        if crit in ("hll_a", "hll_an"):
            zs = criteria.z_sigma(params.z_score, bank.aux_param)
            coef = hll_aux_threshold_coef(crit, self.tau, zs, params.order_n)
            if coef is not None:
                self.coef_aux = jnp.float32(coef * (1.0 + SCREEN_DELTA_AUX))
                self.values_aux = screen.truncate_values(
                    screen.bank_values(self.aux_s),
                    float(np.trunc(bank.cards).max(initial=1.0)),
                    bank.aux_param)
                self._aux_p = aux_p

        # The register bank upload is DEFERRED to the first screen/confirm
        # touch: the schedule and stage-1 gate prune only need e (4 B/row)
        # and the band fingerprints, and queueing a multi-GiB register
        # transfer ahead of them would serialize the prune behind an
        # upload it never reads.
        self._d_regs = self._d_aux_regs = None
        self.upload_secs = 0.0
        self.upload_stats = {}
        self.d_e = jnp.asarray(e_p.astype(np.float32))
        # Truncated telescope: a one-sided (overestimating) harmonic sum
        # with ~2-3x fewer matmuls; extra borderline candidates go to
        # the exact confirmation (ops/screen.truncate_values).
        # Present values are permutation-invariant: scan the UNSORTED
        # bank so the lazy sorted copy stays untouched.
        max_card = float(self.e_s.max(initial=1.0))
        values_all = screen.bank_values(bank.regs)
        self.values = screen.truncate_values(values_all, max_card, bank.p)
        # Bit-plane packed upload plan (ops/regpack): ships k/8 of the
        # dense bank bytes; None (raw-byte upload) when the alphabet is
        # too wide to save anything.
        self._pack_plan = regpack.plan_pack(values_all)
        self.tau_scr = np.float32(screen_tau(self.tau, params.screen_delta))
        # CB margin: the screen divides in f32; relax by 1e-5 relative and
        # let the oracle apply the exact f64 comparison.
        self.tau_cb = np.float32(self.tau * (1.0 - 1e-5))

    @property
    def regs_s(self):
        """Sorted host register copy, gathered on first touch (only the
        pure-host confirm fallback and tests need it)."""
        if self._regs_s is None:
            self._regs_s = self.bank.regs[self.order]
        return self._regs_s

    @property
    def d_regs(self):
        """Device register bank: sorted + padded, assembled lazily on
        first screen/confirm touch (blocking; wall in self.upload_secs).

        Slab-pipelined sorted upload: the host gathers a bounded slab of
        sorted rows (the malloc arena re-backs the same pages every
        iteration - utils/hostmem), ships it with an async device_put,
        and places it into a donated device buffer with one compiled
        dynamic_update_slice. Device peak = bank + one slab (a whole-bank
        device gather would hold raw + gathered = 2x bank bytes), and the
        host gather of slab k+1 overlaps the transfer of slab k."""
        if self._d_regs is None:
            t0 = time.perf_counter()
            self.upload_stats = {}
            if self._regs_s is not None:
                # host sorted copy already exists (host confirm touched
                # it first): pad host-side, one upload
                rp = self._regs_s
                if self.n_pad != self.n:
                    rp2 = np.zeros((self.n_pad, rp.shape[1]), rp.dtype)
                    rp2[: self.n] = rp
                    rp = rp2
                self._d_regs = jnp.asarray(rp)
            else:
                ph = {}
                self._d_regs = upload_sorted_rows(
                    self.bank.regs, self.order, 0, self.n_pad,
                    slab_bytes=getattr(self, "upload_slab_bytes",
                                       128 << 20),
                    stats=ph,
                    pack=self._pack_plan)
                self.upload_stats = ph
            self._d_regs.block_until_ready()
            self.upload_secs += time.perf_counter() - t0
            if self.upload_stats:
                # transfer wait = wall minus the host-side stages (gather
                # OR pack fills depending on the path; token_wait is
                # already transfer time so it stays in)
                self.upload_stats["wire_wait_secs"] = round(
                    self.upload_secs - self.upload_stats["gather_secs"]
                    - self.upload_stats["pack_secs"]
                    - self.upload_stats["put_ret_secs"], 2)
        return self._d_regs

    @property
    def d_aux_regs(self):
        if self._aux_p is None:
            return None
        if self._d_aux_regs is None:
            t0 = time.perf_counter()
            self._d_aux_regs = jnp.asarray(self._aux_p)
            self._d_aux_regs.block_until_ready()
            self.upload_secs += time.perf_counter() - t0
        return self._d_aux_regs

    def schedule(self):
        """Block-level schedule: (rows, cols) tile indices the CB bound
        cannot rule out (vectorized; 22.6 s -> ms at N=524,288)."""
        rows, cols = scheduler.triangle_block_ids(
            self.e_p[: self.n], self.tau, self.ti,
            use_cb_skip=self.use_cb)
        return rows.astype(np.int32), cols.astype(np.int32)

    def prune_tiles(self, rows, cols, chunk=256, stats=None):
        """Cascade stage 1: the cheap gates alone (CB outer compare +,
        for smh criteria, LSH fingerprint equality - elementwise work, no
        harmonic sums) decide which tiles can contain candidates at all.
        Tiles with zero gate-passing pairs never pay for the screen,
        for EVERY gated criterion - the reference skips the union for
        gate-failing pairs the same way (src/selection.cpp:164-167,282-286).

        stats: optional dict, filled with the stage's wall split
        (first dispatch = compile, steady dispatch, fetch) so at-scale
        runs can tell compile cost from compute.
        """
        if len(rows) <= 1 or not (self.use_cb or self.use_smh):
            return rows, cols
        gpend = []
        gchunk = max(chunk, 256)
        t0 = time.perf_counter()
        t_first = None
        for c0 in range(0, len(rows), gchunk):
            r_g = np.pad(rows[c0:c0 + gchunk],
                         (0, max(0, gchunk - (len(rows) - c0))),
                         constant_values=rows[-1])
            c_g = np.pad(cols[c0:c0 + gchunk],
                         (0, max(0, gchunk - (len(rows) - c0))),
                         constant_values=cols[-1])
            gpend.append(_gate_counts(
                self.d_e, self.d_fp, jnp.asarray(r_g), jnp.asarray(c_g),
                jnp.int32(self.n), self.tau_cb, self.n_bands, self.ti,
                self.use_cb, self.use_smh,
            ))
            if t_first is None:
                t_first = time.perf_counter() - t0
        t_disp = time.perf_counter() - t0
        # ONE blocking fetch for the whole stage (a per-chunk fetch loop
        # would stall the dispatch pipeline once per chunk). The
        # device-side concatenate is a single trivial dispatch.
        gate_counts = (np.asarray(gpend[0]) if len(gpend) == 1 else
                       np.asarray(jnp.concatenate(gpend)))
        if stats is not None:
            stats.update(
                gate_chunks=len(gpend),
                gate_first_dispatch_secs=round(t_first or 0.0, 2),
                gate_dispatch_secs=round(t_disp, 2),
                gate_fetch_secs=round(time.perf_counter() - t0 - t_disp, 2),
            )
        live = gate_counts[: len(rows)] > 0
        return rows[live], cols[live]

    def screen_chunk(self, r_chunk, c_chunk):
        """One fused screen dispatch over a chunk of tiles:
        (hits (T,ti,ti), per-tile counts (T,))."""
        if self.coef_aux is not None:
            return _screen_chunk_hllaux(
                self.d_regs, self.d_aux_regs, jnp.asarray(r_chunk),
                jnp.asarray(c_chunk), self.d_e, jnp.int32(self.n),
                self.tau_scr, self.tau_cb, self.coef_aux, self.bank.p,
                self.values, self.bank.aux_param, self.values_aux, self.ti,
            )
        return _screen_chunk(
            self.d_regs, jnp.asarray(r_chunk), jnp.asarray(c_chunk),
            self.d_e, self.d_fp, jnp.int32(self.n), self.tau_scr,
            self.tau_cb, self.bank.p, self.values, self.ti, self.n_bands,
            self.use_cb, self.use_smh,
        )

    def screen_tiles(self, rows, cols, chunk=64, checkpoint=None, wave=64,
                     screen_fn=None, quantum=1):
        """Cascade stage 2 over a live-tile list: candidate (i, j) pairs.

        Dispatches every chunk before fetching any result (the device
        pipelines the screen kernels back-to-back), then fetches ONE small
        array of PER-TILE hit counts and pulls hit masks only for the
        individual tiles that actually contain candidates - the N^2 mask
        bytes never cross the host link, and a lone hit no longer drags
        its whole chunk's masks with it.

        checkpoint: optional path for long sweeps - per-chunk progress
        (span + its candidates) is appended and fsynced after every wave,
        and a restarted run with the same bank/params/schedule skips
        completed spans (SURVEY section 5 failure recovery; the sketch
        files already checkpoint the build stage).

        screen_fn: optional (r_chunk, c_chunk) -> (hits, counts) override.
        The multi-device engine passes its shard_map step here, so the
        sharded path gets the identical chunk/wave/checkpoint loop instead
        of one monolithic dispatch; quantum (= device count there) forces
        every dispatched width to stay shardable.
        """
        n_live = len(rows)
        if n_live == 0:
            return []
        if screen_fn is None:
            screen_fn = self.screen_chunk
        # Full chunks reuse one compiled shape; the remainder is padded to
        # a small power-of-two bucket (repeats of the last tile, deduped
        # below) instead of a whole extra chunk - chunk-padding repeats
        # are wasted matmul work, not just wasted dispatch.
        if quantum > 1:
            chunk = max(quantum, (chunk // quantum) * quantum)
        else:
            chunk = min(chunk, n_live)
        ti = self.ti
        spans = [(c0, chunk) for c0 in range(0, n_live - chunk + 1, chunk)]
        rem = n_live - len(spans) * chunk
        if rem:
            bucket = min(chunk, max(8, 1 << (rem - 1).bit_length()))
            if quantum > 1:
                bucket = min(chunk, max(quantum,
                                        -(-bucket // quantum) * quantum))
            spans.append((n_live - rem, bucket))

        cand = []
        ckpt = _SweepCheckpoint.open(checkpoint, self, rows, cols, chunk)
        if ckpt is not None:
            cand.extend(ckpt.done_candidates)
            spans = [sp for sp in spans if sp not in ckpt.done_spans]

        # Waves bound how much undone work a fault can lose while keeping
        # the dispatch pipeline deep within a wave.
        for w0 in range(0, len(spans), wave):
            pending = []
            for c0, width in spans[w0:w0 + wave]:
                take = min(width, n_live - c0)
                r_chunk = np.pad(rows[c0:c0 + take], (0, width - take),
                                 constant_values=rows[-1])
                c_chunk = np.pad(cols[c0:c0 + take], (0, width - take),
                                 constant_values=cols[-1])
                hits, cnt = screen_fn(r_chunk, c_chunk)
                pending.append(((c0, width), r_chunk, c_chunk, hits, cnt))

            counts = np.asarray(
                jnp.concatenate([c for _, _, _, _, c in pending]))
            pos = 0
            for span, r_chunk, c_chunk, hits, _ in pending:
                width = len(r_chunk)
                span_cand = []
                ts = np.nonzero(counts[pos:pos + width])[0]
                if ts.size:
                    # One gathered compacted fetch per dispatch:
                    # coordinates are ~8K bytes/tile vs the 1 MB mask.
                    for t, ri, cj in extract_hit_coords(
                            hits, ts, counts[pos:pos + width][ts], ti):
                        gi = r_chunk[t] * ti + ri
                        gj = c_chunk[t] * ti + cj
                        span_cand.extend(zip(gi.tolist(), gj.tolist()))
                pos += width
                cand.extend(span_cand)
                if ckpt is not None:
                    ckpt.record(span, span_cand)
        if ckpt is not None:
            ckpt.close()
        return sorted(set(cand))

    def device_hist_fn(self, chunk=8192, tau=None, reject_delta=None):
        """Batched (ii, kk) -> exact union histograms, computed on the
        device bank (the 32 KiB/pair register scan stays in device memory;
        only exact integer counts cross to the host). The f64 MLE on those
        counts stays on the host, so confirmed output is unchanged.

        Device-side reject bound: most confirm candidates
        at scale are rejects, so the kernel also evaluates a conservative
        J upper bound per pair - the certified MLE lower bound t_lb from
        the union histogram (t_lb <= t_mle by theorem, so the bound is
        rigorous at every precision), rejecting only when
        (1+delta)(e1+e2)/t_lb - 1 < tau can be guaranteed. The host
        fetches ONE flag byte per pair and gathers full histograms only
        for the maybe-pass pairs; certain rejects get a sentinel
        histogram (c[q+1] = m -> MLE inf -> jacc NaN) that the oracle's
        jacc >= tau filter drops exactly like a computed reject, so the
        emitted pair set and Jaccard strings are unchanged (fuzz-checked
        in tests/test_screen.py).

        tau defaults to this plan's threshold; callers that run the
        oracle at a DIFFERENT tau (e.g. a tau=-100 worst-case protocol)
        must pass theirs, or a non-positive 1+tau disables rejection
        altogether.

        The returned callable also carries .dispatch/.fetch halves so the
        oracle can pipeline device work against the host MLE: chunks are
        large and fetches overlap the next batch's compute.
        """
        if tau is None:
            tau = float(self.params.tau)
        delta = (reject_delta_for(self.bank.p, self.params.screen_delta)
                 if reject_delta is None else float(reject_delta))
        return make_device_hist_fn(
            lambda: self.d_regs, lambda: self.d_e, self.bank.p, tau, delta,
            chunk=chunk)

    def confirm(self, cand):
        """Cascade stage 3: exact host adjudication of the candidates.
        Returns [(i, j, jacc)] in sorted-position order."""
        hist_fn = None
        if jax.default_backend() != "cpu":
            hist_fn = self.device_hist_fn()
        oracle = PairOracle(
            self.bank.p, (lambda: self.regs_s), self.e_s, aux=self.aux_s,
            aux_param=self.bank.aux_param, criterion=self.crit,
            tau=self.params.tau, z_score=self.params.z_score,
            order_n=self.params.order_n, apply_cb=self.use_cb,
            hist_fn=hist_fn,
        )
        return oracle.confirm_pairs(cand)


def auto_tile(n):
    """Tile size: ti=1024 once the bank spans several tiles, else 512
    (padding waste dominates small banks).

    On an H100 (700 W) at N=262,144, tau=0.9, the screen stage took
    2.53 / 2.27 / 2.29 s for cb and 1.14 / 1.46 / 1.89 s for smh_a at
    ti = 512 / 1024 / 2048 (PERF.md): 1024 is best or within noise of it
    for the CB-only sweep, where the screen does the most work."""
    return 1024 if n >= 4096 else 512


def auto_chunk(ti):
    """Tiles per dispatch, at ~64 MiB of hit masks per dispatch. The
    screen stage is flat in the chunk at ti=1024 on an H100 (cb,
    N=262,144: 2.26 / 2.27 / 2.25 s at 32 / 64 / 128 tiles, PERF.md)."""
    return 64 if ti >= 1024 else 132


def select_pairs_screened(bank, params, ti=None, chunk=None,
                          checkpoint=None, stats=None):
    """All-pairs selection via the screen cascade + exact confirmation.

    ti/chunk default to the measured optimum for the bank size
    (auto_tile/auto_chunk); mask memory per dispatch stays bounded at
    chunk*ti^2 bytes.

    Supports every criterion: smh_a bands are screened on device via LSH
    fingerprints; hll_a/hll_an get the device aux-union gate; the exact
    host confirmation keeps outputs bit-identical to the reference CPU
    path for all criteria. Returns reference-ordered [(name_i, name_j,
    jacc)].

    stats: optional dict, filled with the wall seconds of each stage
    (plan, upload, gate, screen, confirm - disjoint, each ending in a
    blocking fetch) and the tile and candidate counts.
    """
    if bank.n < 2:
        return []
    if ti is None:
        ti = auto_tile(bank.n)
    if chunk is None:
        chunk = auto_chunk(ti)
    st = {} if stats is None else stats
    t0 = time.perf_counter()
    plan = ScreenPlan(bank, params, ti)
    rows, cols = plan.schedule()
    st.update(ti=ti, chunk=chunk, tiles_scheduled=len(rows))
    t1 = time.perf_counter()
    st["plan_secs"] = t1 - t0
    if not len(rows):
        return []
    rows, cols = plan.prune_tiles(rows, cols, chunk=max(chunk, 256))
    t2 = time.perf_counter()
    st.update(gate_secs=t2 - t1, tiles_live=len(rows))
    plan.d_regs  # noqa: B018 - the deferred upload, timed on its own
    t3 = time.perf_counter()
    st["upload_secs"] = t3 - t2
    cand = plan.screen_tiles(rows, cols, chunk=chunk, checkpoint=checkpoint)
    t4 = time.perf_counter()
    st.update(screen_secs=t4 - t3, candidates=len(cand))
    names = bank.names
    order = plan.order
    out = [
        (names[order[i]], names[order[j]], jacc)
        for i, j, jacc in plan.confirm(cand)
    ]
    st["confirm_secs"] = time.perf_counter() - t4
    return out


# ---------------------------------------------------------------------------
# Multi-chip sharding: tile-list data parallelism over a ("rows",) mesh axis
# ---------------------------------------------------------------------------


def make_sharded_screen_step(mesh, p, values, ti, n_bands, use_cb,
                             use_smh, aux=None):
    """Build the jitted multi-device screened step.

    The live-tile list is the unit of data parallelism: each device owns a
    strip of tiles (P("rows")) and screens it against the replicated
    register bank with the same screen as the single-device engine. No
    collectives are needed in the screen itself - survivors are
    independent per tile - so scaling is embarrassingly parallel;
    only the tiny per-TILE count vector is gathered (counts-first fetch:
    full hit masks are pulled per live tile only, never the whole array).

    aux: None for the smh/cb/baseline cascade, or (p_aux, values_aux) to
    add the device aux-union gate of the hll_a/hll_an criteria (the same
    kernel at p_aux over the aux register bank).

    Bank replication is the right trade while the bank fits one device
    (16 KiB/genome); beyond that, parallel/ring.py shards the bank and
    ring-rotates column strips (ppermute).
    """
    from jax.sharding import PartitionSpec as P

    if aux is None:
        def step(regs, r_tiles, c_tiles, e, fp, n_real, tau_scr, tau_cb):
            hits, _ = _screen_chunk(
                regs, r_tiles, c_tiles, e, fp, n_real, tau_scr, tau_cb,
                p, values, ti, n_bands, use_cb, use_smh,
            )
            return hits, jnp.sum(hits, axis=(1, 2), dtype=jnp.int32)

        in_specs = (
            P(None, None),  # regs: replicated bank
            P("rows"),  # r_tiles strip
            P("rows"),  # c_tiles strip
            P(None),  # e
            P(None, None),  # fp
            P(),  # n_real
            P(),  # tau_scr
            P(),  # tau_cb
        )
    else:
        p_aux, values_aux = aux

        def step(regs, aux_regs, r_tiles, c_tiles, e, n_real, tau_scr,
                 tau_cb, coef_aux):
            hits, _ = _screen_chunk_hllaux(
                regs, aux_regs, r_tiles, c_tiles, e, n_real, tau_scr,
                tau_cb, coef_aux, p, values, p_aux, values_aux, ti,
            )
            return hits, jnp.sum(hits, axis=(1, 2), dtype=jnp.int32)

        in_specs = (
            P(None, None),  # regs: replicated primary bank
            P(None, None),  # aux_regs: replicated aux bank
            P("rows"),  # r_tiles strip
            P("rows"),  # c_tiles strip
            P(None),  # e
            P(),  # n_real
            P(),  # tau_scr
            P(),  # tau_cb
            P(),  # coef_aux
        )

    sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=(P("rows"), P("rows")),
        check_vma=False,
    )
    return jax.jit(sharded)


def select_pairs_screened_sharded(bank, params, mesh=None, ti=512, chunk=64,
                                  checkpoint=None, wave=64):
    """Multi-device screened all-pairs selection (same exact-output contract
    as select_pairs_screened; tiles sharded across the mesh "rows" axis).

    Supports every criterion, including hll_a/hll_an via the replicated
    aux-bank union gate (reference coverage: src/selection.cpp:122-227).

    The schedule is driven through the SAME chunk/wave/checkpoint loop as
    the single-chip engine (ScreenPlan.screen_tiles with the shard_map
    step as screen_fn): per-dispatch device memory is bounded by
    chunk/n_dev tiles of hit masks regardless of schedule length, faults
    lose at most one un-checkpointed wave, and a resumed run skips
    completed spans - matching the reference cascade's incremental row
    processing (src/selection.cpp:270-291) instead of one monolithic
    launch."""
    from jax.sharding import Mesh

    if mesh is None:
        devices = np.array(jax.devices())
        mesh = Mesh(devices.reshape(len(devices)), axis_names=("rows",))
    if bank.n < 2:
        return []
    plan = ScreenPlan(bank, params, ti)
    rows, cols = plan.schedule()
    if not len(rows):
        return []
    rows, cols = plan.prune_tiles(rows, cols)
    if not len(rows):
        return []

    n_dev = mesh.shape["rows"]
    aux_spec = None
    if plan.coef_aux is not None:
        aux_spec = (bank.aux_param, plan.values_aux)
    step = make_sharded_screen_step(
        mesh, bank.p, plan.values, ti, plan.n_bands, plan.use_cb,
        plan.use_smh, aux=aux_spec,
    )
    # Pin the replicated operands to their mesh sharding ONCE: a
    # single-device-committed bank entering a shard_map jit would be
    # re-broadcast on EVERY dispatch (8 GiB per chunk on a real pod);
    # after this put the input sharding matches in_specs and dispatches
    # are zero-copy.
    from jax.sharding import NamedSharding, PartitionSpec as P

    repl2 = NamedSharding(mesh, P(None, None))
    repl1 = NamedSharding(mesh, P(None))
    d_regs = jax.device_put(plan.d_regs, repl2)
    d_e = jax.device_put(plan.d_e, repl1)
    if aux_spec is not None:
        d_aux = jax.device_put(plan.d_aux_regs, repl2)

        def screen_fn(r_chunk, c_chunk):
            return step(
                d_regs, d_aux, jnp.asarray(r_chunk),
                jnp.asarray(c_chunk), d_e, jnp.int32(plan.n),
                jnp.float32(plan.tau_scr), jnp.float32(plan.tau_cb),
                plan.coef_aux,
            )
    else:
        d_fp = jax.device_put(plan.d_fp, repl2)

        def screen_fn(r_chunk, c_chunk):
            return step(
                d_regs, jnp.asarray(r_chunk), jnp.asarray(c_chunk),
                d_e, d_fp, jnp.int32(plan.n),
                jnp.float32(plan.tau_scr), jnp.float32(plan.tau_cb),
            )

    cand = plan.screen_tiles(rows, cols, chunk=chunk, checkpoint=checkpoint,
                             wave=wave, screen_fn=screen_fn, quantum=n_dev)
    names = bank.names
    order = plan.order
    return [
        (names[order[i]], names[order[j]], jacc)
        for i, j, jacc in plan.confirm(cand)
    ]
