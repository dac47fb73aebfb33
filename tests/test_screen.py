"""Tests for the pair screen and the screened engine.

Covers (SURVEY.md section 4 test pyramid):
  * bit-level exactness of the harmonic-sum / zero-count kernel vs numpy;
  * present-value bin folding (absent bins cost no matmuls);
  * the screen-threshold formula's conservativeness (the certified
    t_lb <= t_mle bound itself is machine-checked in
    tests/test_certificate.py);
  * end-to-end: screened engine == sequential host reference engine
    (the control-flow twin of src/selection.cpp:152-291).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from cuda_selection_criteria.ops import screen, estimators, hll_build, smh_build
from cuda_selection_criteria.parallel.screened import (
    SCREEN_DELTA_DEFAULT,
    select_pairs_screened,
    screen_tau,
)
from cuda_selection_criteria.parallel.selection import SelectionParams
from cuda_selection_criteria.models.bank import SketchBank
from cuda_selection_criteria.utils.hostref import select_pairs_host


def _ref_s_z(ra, rb):
    mx = np.maximum(ra[:, None, :], rb[None, :, :]).astype(np.int64)
    return np.ldexp(1.0, -mx).sum(-1), (mx == 0).sum(-1)


def test_screen_s_z_matches_numpy():
    p, r = 8, 256
    rng = np.random.default_rng(11)
    regs = rng.integers(0, 13, size=(512, r), dtype=np.uint8)
    vals = screen.bank_values(regs)
    rows = jnp.asarray(np.array([0, 0, 1], np.int32))
    cols = jnp.asarray(np.array([0, 1, 1], np.int32))
    s, z = screen.screen_s_z(jnp.asarray(regs), rows, cols, p, vals, ti=256,
                             tj=256)
    s, z = np.asarray(s), np.asarray(z)
    for t, (bi, bj) in enumerate([(0, 0), (0, 1), (1, 1)]):
        s_ref, z_ref = _ref_s_z(
            regs[bi * 256:(bi + 1) * 256], regs[bj * 256:(bj + 1) * 256]
        )
        np.testing.assert_allclose(s[t], s_ref, rtol=1e-6)
        np.testing.assert_array_equal(z[t], z_ref)


def test_screen_present_value_bins_are_exact():
    """Sparse value sets (gaps, no zeros) fold absent bins exactly."""
    p, r = 8, 256
    rng = np.random.default_rng(5)
    # values only in {9..18} with gaps: 0 absent -> Z omitted
    regs = (rng.integers(0, 5, size=(256, r), dtype=np.uint8) * 2 + 9)
    vals = screen.bank_values(regs)
    assert 0 not in vals and len(vals) == 5
    rows = jnp.asarray(np.array([0], np.int32))
    cols = jnp.asarray(np.array([0], np.int32))
    dense = tuple(range(int(regs.max()) + 1))
    s_dense, z_dense = screen.screen_s_z(jnp.asarray(regs), rows, cols, p,
                                         dense, ti=256, tj=256)
    s_sparse, z_sparse = screen.screen_s_z(
        jnp.asarray(regs), rows, cols, p, vals, ti=256, tj=256
    )
    np.testing.assert_allclose(np.asarray(s_sparse), np.asarray(s_dense),
                               rtol=1e-6)
    # numpy ground truth too
    s_ref, _ = _ref_s_z(regs, regs)
    np.testing.assert_allclose(np.asarray(s_sparse)[0], s_ref, rtol=1e-6)
    assert z_sparse is None  # no zero registers anywhere => Z omitted
    assert np.all(np.asarray(z_dense) == 0.0)


def test_original_from_s_z_matches_original_estimate():
    p = 10
    rng = np.random.default_rng(3)
    regs = rng.integers(0, 16, size=(64, 1 << p), dtype=np.uint8)
    mx = np.maximum(regs[:32, None, :], regs[None, 32:, :])
    counts = np.stack([
        np.bincount(row, minlength=64 - p + 2)[: 64 - p + 2]
        for row in mx.reshape(-1, 1 << p)
    ]).reshape(32, 32, -1)
    want = np.asarray(estimators.original_estimate(jnp.asarray(counts), p))
    s = np.ldexp(1.0, -mx.astype(np.int64)).sum(-1)
    z = (mx == 0).sum(-1).astype(np.float64)
    got = np.asarray(
        screen.original_from_s_z(
            jnp.asarray(s, jnp.float32), jnp.asarray(z, jnp.float32), p
        )
    )
    np.testing.assert_allclose(got, want, rtol=2e-5)


def test_screen_tau_is_conservative():
    """The threshold formula: a statistic within (1+delta) of t_mle at
    the J == tau boundary still clears screen_tau(tau, delta)."""
    tau = 0.9
    delta = SCREEN_DELTA_DEFAULT
    t_mle = 1000.0
    e_sum = (1 + tau) * t_mle  # exactly at the J == tau boundary
    t_stat = t_mle * (1 + delta)  # worst allowed overestimate
    j_stat = (e_sum - t_stat) / t_stat
    assert j_stat >= screen_tau(tau, delta) - 1e-12


@pytest.mark.parametrize("use_cb,use_smh", [
    (True, True), (True, False), (False, True), (False, False),
])
@pytest.mark.parametrize("with_zeros", [True, False])
def test_fused_kernel_matches_post(use_cb, use_smh, with_zeros):
    """The screen the engines run (screened._screen_chunk: screen_s_z +
    _screen_post in one jit) must equal a direct numpy evaluation of the
    same contract - S and Z from the max-merged registers, the certified
    compare and every gate - bit for bit, with hits present."""
    from cuda_selection_criteria.parallel.screened import (
        _screen_chunk, _screen_post)

    p, ti, n = 8, 64, 192
    rng = np.random.default_rng(31 + use_cb + 2 * use_smh)
    lo = 0 if with_zeros else 2
    regs = rng.integers(lo, 11, size=(n, 1 << p), dtype=np.uint8)
    e = np.sort(rng.uniform(0, 5000, n)).astype(np.float32)
    e[:3] = 0.0  # empty rows exercise the e_b > 0 mask
    # few distinct fingerprints per band, so band hits are common
    fp = rng.integers(0, 3, size=(n, 4)).astype(np.int32)
    vals = screen.bank_values(regs)
    rows_np = np.array([0, 0, 1, 2], np.int32)
    cols_np = np.array([0, 2, 1, 2], np.int32)
    rows, cols = jnp.asarray(rows_np), jnp.asarray(cols_np)
    n_real = n - 5  # also exercise the tail mask
    tau_scr, tau_cb = np.float32(-0.5), np.float32(0.35)

    got_h, got_c = _screen_chunk(
        jnp.asarray(regs), rows, cols, jnp.asarray(e), jnp.asarray(fp),
        jnp.int32(n_real), jnp.float32(tau_scr), jnp.float32(tau_cb), p,
        vals, ti, 4, use_cb, use_smh)
    s, z = screen.screen_s_z(jnp.asarray(regs), rows, cols, p, vals,
                             ti=ti, tj=ti)
    post = np.asarray(_screen_post(
        s, z, jnp.asarray(e), jnp.asarray(fp), rows * ti, cols * ti,
        jnp.int32(n_real), jnp.float32(tau_scr), jnp.float32(tau_cb), p, 4,
        ti, ti, use_cb, use_smh))

    m = np.float32(1 << p)
    want = np.zeros((4, ti, ti), bool)
    for t, (r, c) in enumerate(zip(rows_np, cols_np)):
        ii = r * ti + np.arange(ti)
        jj = c * ti + np.arange(ti)
        mx = np.maximum(regs[ii][:, None, :], regs[jj][None, :, :])
        s_ref = np.ldexp(1.0, -mx.astype(np.int64)).sum(-1).astype(
            np.float32)
        z_ref = (mx == 0).sum(-1).astype(np.float32)
        np.testing.assert_array_equal(np.asarray(s)[t], s_ref)
        if with_zeros:
            np.testing.assert_array_equal(np.asarray(z)[t], z_ref)
        ea, eb = e[ii][:, None], e[jj][None, :]
        h = ((np.float32(3) * s_ref - z_ref) * (ea + eb)
             >= np.float32(2) * m * (m - z_ref) * (np.float32(1) + tau_scr))
        h &= (ii[:, None] < jj[None, :]) & (jj[None, :] < n_real) & (eb > 0)
        if use_cb:
            h &= ea >= tau_cb * eb
        if use_smh:
            h &= (fp[ii][:, None, :] == fp[jj][None, :, :]).any(-1)
        want[t] = h
    if not with_zeros:
        assert z is None
    np.testing.assert_array_equal(post, want)
    np.testing.assert_array_equal(np.asarray(got_h), want)
    np.testing.assert_array_equal(np.asarray(got_c), want.sum((1, 2)))
    assert want.sum() > 0


def _planted_items(n, rng, pool_size, cap=2560):
    """Per-genome item draws from a shared pool, padded to ONE static
    shape so the whole suite compiles each build kernel once (padding is
    masked out by `valid`; sketches are identical to unpadded builds)."""
    pool = rng.integers(0, 1 << 63, size=pool_size, dtype=np.uint64)
    buf = np.zeros((n, cap), np.uint64)
    valid = np.zeros((n, cap), bool)
    for i in range(n):
        k = int(rng.integers(300, 2500))
        buf[i, :k] = rng.choice(pool, size=k, replace=False)
        valid[i, :k] = True
    gids = np.repeat(np.arange(n, dtype=np.int32), cap)
    return (jnp.asarray(buf.ravel()), jnp.asarray(valid.ravel()),
            jnp.asarray(gids))


def _make_bank(n, p, m, rng, pool_size=8000):
    items, valid, gids = _planted_items(n, rng, pool_size)
    regs = np.array(hll_build.hll_build_batch(items, valid, gids, p, n))
    aux = np.array(smh_build.smh_build_batch(items, valid, gids, m, n))
    cards = np.asarray(estimators.ertl_mle_from_regs(jnp.asarray(regs), p))
    names = [f"g{i:03d}" for i in range(n)]
    return SketchBank(names=names, p=p, regs=regs, cards=cards, aux=aux,
                      aux_kind="smh", aux_param=m)


@pytest.mark.parametrize("crit,tau", [
    ("smh_a", 0.2), ("cb", 0.2), ("baseline", 0.3), ("smh_only", 0.2),
    ("smh_a", 0.02),  # the comparison experiment's low-tau regime
])
def test_screened_engine_matches_host(crit, tau):
    rng = np.random.default_rng(17)
    bank = _make_bank(20, 10, 16, rng)
    params = SelectionParams(tau=tau, criterion=crit, block=64)
    host = select_pairs_host(
        bank, tau, crit, apply_cb=(crit not in ("baseline", "smh_only"))
    )
    got = select_pairs_screened(bank, params, ti=256, chunk=4)
    assert [(a, b, round(j, 12)) for a, b, j in host] == [
        (a, b, round(j, 12)) for a, b, j in got
    ]


def test_screened_sharded_matches_host():
    """Tile-sharded multi-device screened engine == host reference, on the
    virtual 8-device CPU mesh (the fake multi-device backend, SURVEY.md
    s4)."""
    import jax
    from jax.sharding import Mesh
    from cuda_selection_criteria.parallel.screened import (
        select_pairs_screened_sharded,
    )

    rng = np.random.default_rng(23)
    bank = _make_bank(20, 10, 16, rng)
    params = SelectionParams(tau=0.2, criterion="smh_a", block=64)
    host = select_pairs_host(bank, 0.2, "smh_a")
    devices = np.array(jax.devices())
    mesh = Mesh(devices.reshape(len(devices)), axis_names=("rows",))
    got = select_pairs_screened_sharded(bank, params, mesh=mesh, ti=256)
    assert [(a, b, round(j, 12)) for a, b, j in host] == [
        (a, b, round(j, 12)) for a, b, j in got
    ]


def _make_bank_hll_aux(n, p, p_aux, rng, pool_size=8000):
    items, valid, gids = _planted_items(n, rng, pool_size)
    regs = np.array(hll_build.hll_build_batch(items, valid, gids, p, n))
    aux = np.array(hll_build.hll_build_batch(items, valid, gids, p_aux, n))
    cards = np.asarray(estimators.ertl_mle_from_regs(jnp.asarray(regs), p))
    names = [f"g{i:03d}" for i in range(n)]
    return SketchBank(names=names, p=p, regs=regs, cards=cards, aux=aux,
                      aux_kind="hll", aux_param=p_aux)


@pytest.mark.parametrize("crit", ["hll_a", "hll_an"])
def test_screened_engine_matches_host_hll_aux(crit):
    """hll_a/hll_an through the screened engine: the device screen is CB +
    the primary Jaccard bound; the exact aux gate runs in the host
    confirmation - outputs must equal the sequential host reference."""
    rng = np.random.default_rng(31)
    bank = _make_bank_hll_aux(20, 10, 6, rng)
    params = SelectionParams(tau=0.2, criterion=crit, block=64)
    host = select_pairs_host(bank, 0.2, crit)
    got = select_pairs_screened(bank, params, ti=256, chunk=4)
    assert [(a, b, round(j, 12)) for a, b, j in host] == [
        (a, b, round(j, 12)) for a, b, j in got
    ]


def test_hll_aux_threshold_coef_is_one_sided():
    """Exact-gate pass implies the threshold test, across a tau/zs sweep."""
    from cuda_selection_criteria.parallel.screened import (
        hll_aux_threshold_coef,
    )

    rng = np.random.default_rng(3)
    for crit in ("hll_a", "hll_an"):
        for tau in (0.1, 0.5, 0.9):
            for zs in (0.05, 0.12, 0.2):
                coef = hll_aux_threshold_coef(crit, tau, zs, order_n=1)
                if coef is None:
                    continue
                for _ in range(300):
                    e2 = rng.uniform(10, 1e6)
                    e1 = rng.uniform(1, e2)  # sorted: e1 <= e2
                    t = rng.uniform(1, 3 * (e1 + e2))
                    if crit == "hll_a":
                        t_hat_mas = t / (1.0 + zs)
                        passes = ((1 + e1 / e2) * e2 - t_hat_mas) / t_hat_mas >= tau
                    else:
                        j_hat = (e1 + e2 - t) / t
                        c = min(1.0, (1 + zs) * e2 / t) * (1 + e1 / e2) * zs
                        passes = j_hat + c >= tau
                    if passes:
                        assert t <= coef * (e1 + e2) * (1 + 1e-12), (
                            crit, tau, zs, t / (e1 + e2), coef
                        )


def test_screened_engine_edge_cases():
    """n=2, zero-cardinality genomes, and exact tile-multiple banks."""
    rng = np.random.default_rng(53)
    bank = _make_bank(2, 10, 16, rng)
    params = SelectionParams(tau=0.1, criterion="smh_a")
    host = select_pairs_host(bank, 0.1, "smh_a")
    got = select_pairs_screened(bank, params, ti=256, chunk=2)
    assert [(a, b) for a, b, _ in host] == [(a, b) for a, b, _ in got]

    # a bank with empty genomes (zero registers, cardinality 0)
    bank2 = _make_bank(10, 10, 16, rng)
    bank2.regs[3] = 0
    bank2.aux[3] = np.uint64(0xFFFFFFFFFFFFFFFF)
    bank2.regs[7] = 0
    bank2.aux[7] = np.uint64(0xFFFFFFFFFFFFFFFF)
    bank2.compute_cards()
    host2 = select_pairs_host(bank2, 0.1, "smh_a")
    got2 = select_pairs_screened(bank2, SelectionParams(tau=0.1,
                                                        criterion="smh_a"),
                                 ti=256, chunk=2)
    assert [(a, b, round(j, 12)) for a, b, j in host2] == [
        (a, b, round(j, 12)) for a, b, j in got2
    ]


@pytest.mark.slow
def test_screened_engine_fuzz_matches_host():
    """Randomized differential fuzz: random overlap structures and taus."""
    for seed, tau, crit in [
        (101, 0.35, "smh_a"), (102, 0.6, "cb"), (103, 0.05, "smh_a"),
        (104, 0.45, "hll_a"), (105, 0.25, "hll_an"),
    ]:
        rng = np.random.default_rng(seed)
        if crit in ("hll_a", "hll_an"):
            bank = _make_bank_hll_aux(16, 10, 6, rng)
        else:
            bank = _make_bank(16, 10, 16, rng)
        host = select_pairs_host(bank, tau, crit)
        got = select_pairs_screened(
            bank, SelectionParams(tau=tau, criterion=crit), ti=256, chunk=3
        )
        assert [(a, b, round(j, 12)) for a, b, j in host] == [
            (a, b, round(j, 12)) for a, b, j in got
        ], (seed, tau, crit)


def test_truncated_telescope_is_one_sided_overestimate():
    """screen_s_z with truncate_values must OVERESTIMATE the true harmonic
    sum for every pair (the conservative direction), match it exactly for
    registers within the kept range, and keep Z exact."""
    p, r = 8, 256
    rng = np.random.default_rng(21)
    regs = rng.integers(0, 26, size=(512, r), dtype=np.uint8)
    full = screen.bank_values(regs)
    trunc = screen.truncate_values(full, max_card=40.0, p=p)
    assert trunc[-1] < full[-1] and len(trunc) < len(full)

    rows = jnp.asarray(np.array([0, 1], np.int32))
    cols = jnp.asarray(np.array([1, 1], np.int32))
    s_full, z_full = screen.screen_s_z(jnp.asarray(regs), rows, cols, p,
                                       full, ti=256, tj=256)
    s_tr, z_tr = screen.screen_s_z(jnp.asarray(regs), rows, cols, p,
                                   trunc, ti=256, tj=256)
    s_full, s_tr = np.asarray(s_full), np.asarray(s_tr)
    assert (s_tr >= s_full - 1e-4).all()  # one-sided (tolerance: f32)
    assert (s_tr > s_full + 1e-6).any()  # and actually truncating
    # error bounded by the tail mass R * 2^-v_c
    assert (s_tr - s_full <= r * 2.0 ** -float(trunc[-1]) + 1e-3).all()
    np.testing.assert_array_equal(np.asarray(z_full), np.asarray(z_tr))

    # cutoff formula: v_c grows with cardinality, never empties the list
    assert screen.truncate_values((0, 1, 2), 1e9, 14) == (0, 1, 2)
    assert len(screen.truncate_values((30, 40), 10.0, 14)) >= 1


@pytest.mark.parametrize("tau", [0.02, 0.2, 0.6, 0.9])
def test_device_hist_fn_reject_bound_exact(tau):
    """The confirm stage's device reject bound (flag byte + survivor-only
    histogram gather) must leave the emitted pair set and Jaccard values
    bit-identical: certain rejects get the sentinel histogram, everything
    else the exact integer counts the host path would compute."""
    from cuda_selection_criteria.parallel.screened import ScreenPlan
    from cuda_selection_criteria.utils.hostref import PairOracle

    rng = np.random.default_rng(41)
    bank = _make_bank(24, 10, 16, rng)
    params = SelectionParams(tau=tau, criterion="baseline", block=64)
    plan = ScreenPlan(bank, params, 256)
    n = bank.n
    pairs = [(i, k) for i in range(n) for k in range(i + 1, n)]

    def oracle(hist_fn=None, t=tau):
        return PairOracle(bank.p, plan.regs_s, plan.e_s,
                          criterion="baseline", tau=t, apply_cb=False,
                          hist_fn=hist_fn)

    want = oracle().confirm_pairs(pairs)
    got = oracle(plan.device_hist_fn(chunk=64, tau=tau)).confirm_pairs(pairs)
    assert want == got
    # rejection actually fires at high tau on this bank (not a no-op test)
    if tau >= 0.6:
        flags_fn = plan.device_hist_fn(chunk=64, tau=tau)
        pend, nb = flags_fn.dispatch([p_[0] for p_ in pairs],
                                     [p_[1] for p_ in pairs])
        import jax.numpy as jnp
        rej = np.asarray(jnp.concatenate([r for _, r in pend]))[:nb]
        assert rej.any()


def test_device_hist_fn_negative_tau_never_rejects():
    """1+tau <= 0 (the tau=-100 worst-case throughput protocol) must
    disable the reject bound and return plain exact histograms."""
    from cuda_selection_criteria.parallel.screened import ScreenPlan
    from cuda_selection_criteria.utils.hostref import PairOracle

    rng = np.random.default_rng(43)
    bank = _make_bank(16, 10, 16, rng)
    params = SelectionParams(tau=0.9, criterion="baseline", block=64)
    plan = ScreenPlan(bank, params, 256)
    pairs = [(i, k) for i in range(bank.n) for k in range(i + 1, bank.n)]
    want = PairOracle(bank.p, plan.regs_s, plan.e_s, criterion="baseline",
                      tau=-100.0, apply_cb=False).confirm_pairs(pairs)
    got = PairOracle(
        bank.p, plan.regs_s, plan.e_s, criterion="baseline", tau=-100.0,
        apply_cb=False,
        hist_fn=plan.device_hist_fn(chunk=64, tau=-100.0),
    ).confirm_pairs(pairs)
    assert want == got
    assert len(want) == len(pairs)  # every pair emitted at tau=-100


def test_band_fingerprints_np_matches_device():
    """The host FNV fingerprint twin must be bit-identical to the jnp
    original for every (n_rows, n_bands) shape in use."""
    from cuda_selection_criteria.parallel.screened import (
        band_fingerprints, band_fingerprints_np)

    rng = np.random.default_rng(7)
    for n_rows, n_bands in ((4, 8), (2, 16), (8, 4), (1, 32)):
        aux = rng.integers(0, 1 << 63, size=(37, n_rows * n_bands),
                           dtype=np.uint64)
        want = np.asarray(band_fingerprints(jnp.asarray(aux), n_rows,
                                            n_bands))
        got = band_fingerprints_np(aux, n_rows, n_bands)
        np.testing.assert_array_equal(want, got)


def test_regpack_roundtrip_and_packed_upload():
    """Bit-plane packed upload must reproduce the dense path byte-exactly
    for any present-value alphabet, including the sorted+padded layout."""
    from cuda_selection_criteria.ops import regpack, screen as sc
    from cuda_selection_criteria.parallel.screened import (
        upload_sorted_rows)

    rng = np.random.default_rng(77)
    # alphabets of different widths (k = 1..6 bits) incl. value 0 absent
    for vals in ([0, 3], [1, 2, 5, 9], list(range(0, 40, 3)),
                 list(rng.choice(200, size=50, replace=False))):
        vals = sorted(int(v) for v in vals)
        plan = regpack.plan_pack(vals)
        assert plan is not None
        lut256, table, k = plan
        rows = rng.choice(np.array(vals, np.uint8), size=(9, 256))
        packed = regpack.pack_rows(rows, lut256, k)
        buf = jnp.zeros((16, 256), jnp.uint8)
        out, tok = regpack.unpack_place(buf, jnp.asarray(packed),
                                        jnp.asarray(table),
                                        jnp.int32(4), k)
        np.testing.assert_array_equal(np.asarray(out)[4:13], rows)
        assert not np.asarray(out)[:4].any()

    # full upload path: packed == dense, including zero padding
    regs = rng.choice(np.array([0, 2, 3, 7, 11], np.uint8),
                      size=(37, 512))
    order = rng.permutation(37)
    plan = regpack.plan_pack(sc.bank_values(regs))
    dense = np.asarray(upload_sorted_rows(regs, order, 0, 48,
                                          slab_bytes=4096))
    packed = np.asarray(upload_sorted_rows(regs, order, 0, 48,
                                           slab_bytes=4096, pack=plan))
    np.testing.assert_array_equal(dense, packed)
    assert regpack.plan_pack(range(300)) is None  # >255 values
    assert regpack.plan_pack(range(200)) is None  # k >= 8: no saving


@pytest.mark.parametrize("platform,engine", [
    ("gpu", "screened"), ("cpu", "dense"),
])
def test_resolve_engine_by_platform(monkeypatch, platform, engine):
    """engine="auto" runs the screened engine on the GPU and the dense
    engine on the CPU; a forced engine is kept as given."""
    import jax

    from cuda_selection_criteria.parallel import selection

    rng = np.random.default_rng(5)
    bank = _make_bank(8, 10, 16, rng)
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    assert selection.resolve_engine(
        bank, SelectionParams(tau=0.5)) == engine
    assert selection.resolve_engine(
        bank, SelectionParams(tau=0.5, engine="ring")) == "ring"


def test_resolve_engine_ring_needs_device_memory_limit(monkeypatch):
    """With several devices, a bank above 0.55x one device's bytes_limit
    goes to the ring engine; a device that reports no limit is an error
    (no size is assumed)."""
    import jax

    from cuda_selection_criteria.parallel import selection

    rng = np.random.default_rng(6)
    bank = _make_bank(8, 10, 16, rng)
    bank_bytes = bank.regs.nbytes

    class Dev:
        def __init__(self, limit):
            self.limit = limit

        def memory_stats(self):
            return None if self.limit is None else {"bytes_limit": self.limit}

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(jax, "device_count", lambda: 4)
    for limit, want in ((bank_bytes, "ring"), (4 * bank_bytes, "screened")):
        monkeypatch.setattr(jax, "devices", lambda limit=limit: [Dev(limit)])
        assert selection.resolve_engine(bank, SelectionParams(tau=0.5)) \
            == want
    monkeypatch.setattr(jax, "devices", lambda: [Dev(None)])
    with pytest.raises(RuntimeError, match="bytes_limit"):
        selection.resolve_engine(bank, SelectionParams(tau=0.5))


@pytest.mark.parametrize("backend,env", [
    ("gpu", None), ("gpu", "custom"), ("cpu", None),
])
def test_compile_cache_dir(monkeypatch, tmp_path, backend, env):
    """On the GPU, enable_compile_cache puts the persistent cache in one
    fixed directory inside the checkout (which .gitignore lists) unless
    JAX_COMPILATION_CACHE_DIR names one - JAX reads that variable itself,
    so no other directory is set in code. The CPU stays uncached."""
    import os

    import jax

    import cuda_selection_criteria as csc

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / env))
    try:
        csc.enable_compile_cache()
        got = jax.config.jax_compilation_cache_dir
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    if backend == "gpu" and env is None:
        assert got == os.path.join(root, ".jax_cache")
        assert got == csc.DEFAULT_COMPILE_CACHE
        assert ".jax_cache/" in open(os.path.join(root, ".gitignore")).read()
    else:
        assert got == before
