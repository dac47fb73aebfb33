"""Ring-rotated row-sharded engine (bank sharded across the 8 virtual
devices, column strips circulating via ppermute): output must equal the
host reference and the replicated-bank engines exactly."""

import numpy as np
import pytest

from cuda_selection_criteria.parallel.ring import select_pairs_ring
from cuda_selection_criteria.parallel.screened import (
    select_pairs_screened,
)
from cuda_selection_criteria.parallel.selection import SelectionParams
from cuda_selection_criteria.utils.hostref import select_pairs_host
from tests.test_screen import _make_bank


def _round(results):
    return [(a, b, round(j, 12)) for a, b, j in results]


@pytest.mark.parametrize("crit,tau", [
    ("smh_a", 0.15), ("cb", 0.25), ("baseline", 0.3), ("smh_only", 0.15),
])
def test_ring_matches_host_and_replicated(crit, tau):
    rng = np.random.default_rng(47)
    bank = _make_bank(24, 10, 16, rng)
    params = SelectionParams(tau=tau, criterion=crit)
    host = select_pairs_host(
        bank, tau, crit, apply_cb=(crit not in ("baseline", "smh_only"))
    )
    repl = select_pairs_screened(bank, params, ti=128, chunk=4)
    ring = select_pairs_ring(bank, params, ti=32)
    assert _round(host) == _round(ring)
    assert _round(repl) == _round(ring)


def test_ring_pair_coverage_is_exhaustive():
    """Every i<j pair must be screened exactly once across devices/steps:
    with the screen thresholds fully open (tau'=-inf semantics via tiny
    tau and no gates), the candidate set must be the FULL triangle."""
    rng = np.random.default_rng(13)
    bank = _make_bank(16, 10, 16, rng)
    # baseline (no gates) at a tau small enough that every pair's screen
    # bound passes -> candidates == all pairs -> host confirm sees all.
    params = SelectionParams(tau=1e-6, criterion="baseline")
    got = select_pairs_ring(bank, params, ti=32)
    want = select_pairs_host(bank, 1e-6, "baseline", apply_cb=False)
    assert _round(want) == _round(got)
    assert len(got) > 0


def _ladder_bank(n, rng, n_dups=40, m=64, base_hi=9, bump_hi=4.0):
    """Synthetic (n, m) uint8 register bank with a cardinality ladder
    (so the strip-level CB bound can kill ring steps) and planted
    near-duplicate pairs (so some pairs pass a high tau exactly)."""
    base = rng.integers(1, base_hi, size=(n, m)).astype(np.uint8)
    bump = np.linspace(0.0, bump_hi, n).astype(np.uint8)
    regs = np.minimum(base + bump[:, None], 20).astype(np.uint8)
    picks = rng.choice(n - 1, size=n_dups, replace=False)
    for i in picks:
        regs[i + 1] = regs[i]
        regs[i + 1, rng.integers(0, m)] += 1  # near-duplicate
    from cuda_selection_criteria.models.bank import SketchBank

    names = [f"g{i:06d}" for i in range(n)]
    return SketchBank(names=names, p=int(np.log2(m)), regs=regs)


def test_ring_streams_masks_and_skips_dead_steps():
    """Per-dispatch device mask memory must be bounded by
    chunk_tiles * ti^2 (the O(N^2/D) all-steps buffer of earlier
    revisions is gone), and CB-dead ring steps must not run at all."""
    rng = np.random.default_rng(3)
    bank = _ladder_bank(512, rng, n_dups=12)
    params = SelectionParams(tau=0.8, criterion="cb")
    stats = {}
    ring = select_pairs_ring(bank, params, ti=32, chunk_tiles=2,
                             stats=stats)
    host = select_pairs_host(bank, 0.8, "cb")
    assert _round(host) == _round(ring)
    assert len(ring) > 0
    # memory bound: chunk_tiles * ti^2 bytes of bool masks per device
    assert stats["max_device_mask_bytes"] <= 2 * 32 * 32
    # the cardinality ladder makes far-apart strip pairs CB-dead
    assert 0 < stats["steps_run"] < stats["steps_total"]


@pytest.mark.slow
def test_ring_scale_65536_bounded_memory():
    """VERDICT r2 #1: a 65,536-row bank screened on the 8-virtual-device
    mesh with per-device transient mask memory O(chunk_tiles * ti^2)
    (asserted), output exact vs the replicated screened engine."""
    n, ti, chunk_tiles = 65536, 256, 64
    rng = np.random.default_rng(7)
    bank = _ladder_bank(n, rng, n_dups=48)
    params = SelectionParams(tau=0.8, criterion="cb")
    stats = {}
    ring = select_pairs_ring(bank, params, ti=ti, chunk_tiles=chunk_tiles,
                             stats=stats)
    repl = select_pairs_screened(bank, params, ti=512, chunk=16)
    assert _round(repl) == _round(ring)
    assert len(ring) >= 40  # the planted near-duplicates survive exactly
    # Transient masks: chunk_tiles*ti^2 per device per dispatch - far
    # below the old all-steps carry (strip^2 = 64 MiB/device here).
    assert stats["max_device_mask_bytes"] <= chunk_tiles * ti * ti
    assert stats["max_device_mask_bytes"] * 8 <= stats["strip"] ** 2
    assert 0 < stats["steps_run"] < stats["steps_total"]


@pytest.mark.parametrize("crit", ["hll_a", "hll_an"])
def test_ring_hll_aux_matches_host(crit):
    """hll_a/hll_an on the ring engine: the aux-HLL registers circulate
    as a second strip; output must equal the host reference exactly."""
    from tests.test_screen import _make_bank_hll_aux

    rng = np.random.default_rng(31)
    bank = _make_bank_hll_aux(24, 10, 6, rng)
    params = SelectionParams(tau=0.2, criterion=crit)
    host = select_pairs_host(bank, 0.2, crit)
    ring = select_pairs_ring(bank, params, ti=32)
    assert _round(host) == _round(ring)
    assert len(ring) > 0


def test_ring_stats_compile_walls_split_from_steady_state():
    """The gate/screen executables are warmed BEFORE the timed step loop
    (a cold compile would otherwise be buried inside gate_secs); stats
    must report the compile walls separately and keep
    gate_secs/screen_secs disjoint steady-state walls."""
    rng = np.random.default_rng(11)
    bank = _ladder_bank(256, rng, n_dups=8)
    params = SelectionParams(tau=0.8, criterion="cb")
    stats = {}
    ring = select_pairs_ring(bank, params, ti=32, chunk_tiles=2,
                             stats=stats)
    host = select_pairs_host(bank, 0.8, "cb")
    assert _round(host) == _round(ring)
    assert stats["gate_compile_secs"] >= 0.0
    assert stats["screen_compile_secs"] >= 0.0
    # disjoint stage walls: the gate wall is subtracted from the loop
    # wall, so both are non-negative and neither includes the other
    assert stats["gate_secs"] >= 0.0
    assert stats["screen_secs"] >= 0.0


def test_ring_gate_prune_kills_all_tiles_exactly():
    """When the LSH fingerprint gate rejects every pair (all-distinct aux
    buckets at high tau), the ring's per-step gate prune must drop every
    tile - and the output must still equal the host reference (empty or
    not) with stats proving the screen never ran."""
    rng = np.random.default_rng(53)
    bank = _make_bank(24, 10, 16, rng)
    # make every aux row unique and band-distinct
    bank.aux[:] = rng.integers(0, 1 << 63,
                               size=bank.aux.shape, dtype=np.uint64)
    params = SelectionParams(tau=0.9, criterion="smh_a")
    host = select_pairs_host(bank, 0.9, "smh_a")
    stats = {}
    ring = select_pairs_ring(bank, params, ti=32, stats=stats)
    assert _round(host) == _round(ring)
    assert stats.get("tiles_gate_live", 0) == 0
    assert stats["dispatches"] == 0  # no screen work at all


def test_fused_strips_matches_ring_post():
    """The ring step's screen (screen_s_z with a separate column strip +
    _ring_post) == a direct numpy evaluation of the contract, bit for
    bit, with distinct row/col strips and nonzero global offsets."""
    import jax.numpy as jnp
    from cuda_selection_criteria.ops import screen
    from cuda_selection_criteria.parallel.ring import _ring_post

    p, ti = 8, 32
    rng = np.random.default_rng(77)
    strip = 96
    regs_r = rng.integers(0, 11, size=(strip, 1 << p), dtype=np.uint8)
    regs_c = rng.integers(0, 11, size=(strip, 1 << p), dtype=np.uint8)
    e_r = np.sort(rng.uniform(0, 4000, strip)).astype(np.float32)
    e_c = np.sort(rng.uniform(0, 4000, strip)).astype(np.float32)
    e_c[:2] = 0.0
    # few distinct fingerprints per band, so band hits are common
    fp_r = rng.integers(0, 3, size=(strip, 4)).astype(np.int32)
    fp_c = rng.integers(0, 3, size=(strip, 4)).astype(np.int32)
    vals = tuple(sorted(set(screen.bank_values(regs_r))
                        | set(screen.bank_values(regs_c))))
    r_np, c_np = np.array([0, 1, 2], np.int32), np.array([1, 0, 2], np.int32)
    row_base, col_base, n_real = 96, 192, 280
    tau_scr, tau_cb = np.float32(-0.5), np.float32(0.25)

    ss, zz = screen.screen_s_z(
        jnp.asarray(regs_r), jnp.asarray(r_np), jnp.asarray(c_np), p, vals,
        ti=ti, tj=ti, regs_cols=jnp.asarray(regs_c))
    got = np.asarray(_ring_post(
        ss, zz, jnp.asarray(e_r), jnp.asarray(e_c), jnp.asarray(fp_r),
        jnp.asarray(fp_c), jnp.int32(row_base), jnp.int32(col_base),
        jnp.asarray(r_np), jnp.asarray(c_np), jnp.int32(n_real),
        jnp.float32(tau_scr), jnp.float32(tau_cb), p, 4, ti, True, True))

    m = np.float32(1 << p)
    for t, (r, c) in enumerate(zip(r_np, c_np)):
        rl = r * ti + np.arange(ti)
        cl = c * ti + np.arange(ti)
        mx = np.maximum(regs_r[rl][:, None, :], regs_c[cl][None, :, :])
        s_ref = np.ldexp(1.0, -mx.astype(np.int64)).sum(-1).astype(
            np.float32)
        z_ref = (mx == 0).sum(-1).astype(np.float32)
        np.testing.assert_array_equal(np.asarray(ss)[t], s_ref)
        np.testing.assert_array_equal(np.asarray(zz)[t], z_ref)
        ea, eb = e_r[rl][:, None], e_c[cl][None, :]
        gi, gj = row_base + rl, col_base + cl
        h = ((np.float32(3) * s_ref - z_ref) * (ea + eb)
             >= np.float32(2) * m * (m - z_ref) * (np.float32(1) + tau_scr))
        h &= (gi[:, None] < gj[None, :]) & (gj[None, :] < n_real) & (eb > 0)
        h &= ea >= tau_cb * eb
        h &= (fp_r[rl][:, None, :] == fp_c[cl][None, :, :]).any(-1)
        np.testing.assert_array_equal(got[t], h)
    assert got.sum() > 0
