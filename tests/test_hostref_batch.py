"""Vectorized host confirmation: bit-exactness + throughput sanity.

The exact-confirmation stage (utils/hostref.PairOracle.confirm_pairs) is
the last cascade stage for every engine; round 1 ran a scalar f64 secant
loop per candidate pair, which dominates at low-tau selectivities
(reference protocol: run_comparison_experiment.sh:62-70 compares at
tau=0.01). The vectorized ertl_mle_batch must match the scalar reference
loop bit-for-bit on every histogram, including the degenerate uniform-
register histograms where the secant's first inner loop actually runs.
"""

import sys
import time

import numpy as np
import pytest

from cuda_selection_criteria.utils import hostref

sys.path.insert(0, "tests")
import refmodels as rm  # noqa: E402


def _rand_histograms(rng, p, n):
    m = 1 << p
    regs = rng.integers(0, 30, size=(n, m), dtype=np.uint8)
    return np.stack([hostref.histogram(r) for r in regs])


@pytest.mark.parametrize("p", [6, 8, 10, 14])
def test_mle_batch_bit_exact_vs_scalar(p):
    rng = np.random.default_rng(11)
    hists = _rand_histograms(rng, p, 40)
    got = hostref.ertl_mle_batch(hists, p)
    want = np.array([hostref.ertl_mle_scalar(c, p) for c in hists])
    np.testing.assert_array_equal(got, want)


def test_mle_batch_degenerate_histograms():
    """Uniform registers (kappa >= kMaxP: the reference secant's FIRST
    inner loop is non-empty), all-zero, and saturated registers."""
    p = 10
    m = 1 << p
    cases = []
    for v in (1, 2, 3, 7):
        c = np.zeros(64, np.int64)
        c[v] = m
        cases.append(c)
    c = np.zeros(64, np.int64)
    c[0] = m  # empty sketch
    cases.append(c)
    c = np.zeros(64, np.int64)
    c[64 - p + 1] = m  # saturated -> inf
    cases.append(c)
    c = np.zeros(64, np.int64)  # mixed low ranks
    c[1] = m // 2
    c[2] = m - m // 2
    cases.append(c)
    hists = np.stack(cases)
    got = hostref.ertl_mle_batch(hists, p)
    want = np.array([hostref.ertl_mle_scalar(c, p) for c in hists])
    np.testing.assert_array_equal(got, want)
    assert np.isinf(got[-2])


@pytest.mark.parametrize("p", [10])
def test_device_mle_matches_scalar_on_degenerates(p):
    """The jit batched estimator (ops/estimators) must agree with the
    scalar reference on uniform-register histograms too (round-2 fix:
    the fused loop's g seeding point)."""
    import jax.numpy as jnp
    from cuda_selection_criteria.ops import estimators

    m = 1 << p
    for v in (1, 2, 3):
        regs = np.full(m, v, np.uint8)
        want = rm.report(regs, p)
        got = float(estimators.ertl_mle_from_regs(jnp.asarray(regs), p))
        assert got == want


@pytest.mark.parametrize("crit", ["smh_a", "cb", "baseline", "hll_a", "hll_an"])
def test_confirm_pairs_matches_scalar_evaluate(crit):
    """Vectorized confirm_pairs == per-pair scalar evaluate() on every
    criterion (pair set AND f64 Jaccard values)."""
    rng = np.random.default_rng(23)
    n, p = 30, 8
    regs = rng.integers(0, 25, size=(n, 1 << p), dtype=np.uint8)
    cards = np.sort(rng.uniform(500, 5000, n))
    if crit in ("hll_a", "hll_an"):
        aux = rng.integers(0, 20, size=(n, 1 << 5), dtype=np.uint8)
        aux_param, aux_kind = 5, "hll"
    else:
        aux = rng.integers(0, 1 << 40, size=(n, 16), dtype=np.uint64)
        # plant collisions so some smh bands match
        aux[1::3] = aux[0]
        aux_param, aux_kind = 16, "smh"
    oracle = hostref.PairOracle(
        p, regs, np.trunc(cards), aux=aux, aux_param=aux_param,
        criterion=crit, tau=0.3, apply_cb=(crit not in ("baseline",)),
    )
    pairs = [(i, k) for i in range(n - 1) for k in range(i + 1, n)]
    got = oracle.confirm_pairs(pairs)
    want = []
    for i, k in pairs:
        selected, jacc = oracle.evaluate(i, k)
        if selected:
            want.append((i, k, jacc))
    assert got == want


def test_confirm_full_mle_smoke():
    """Every candidate pair gets a full batched MLE (tau=-100 selects all
    finite Jaccards) - a correctness smoke for the batch plumbing at
    non-trivial size. Wall-clock throughput is NOT asserted (CI-host
    memory bandwidth here is erratic); measured confirm rates belong in
    PERF.md."""
    rng = np.random.default_rng(5)
    n, p = 48, 12
    regs = rng.integers(0, 30, size=(n, 1 << p), dtype=np.uint8)
    cards = np.sort(rng.uniform(1e5, 2e5, n))
    oracle = hostref.PairOracle(
        p, regs, np.trunc(cards), criterion="baseline", tau=-100.0,
        apply_cb=False,
    )
    pairs = [(i, k) for i in range(n - 1) for k in range(i + 1, n)]
    out = oracle.confirm_pairs(pairs)
    assert len(out) == len(pairs)
    # spot-check three pairs against the scalar path
    for i, k, j in (out[0], out[len(out) // 2], out[-1]):
        sel, jacc = oracle.evaluate(i, k)
        assert sel and jacc == j


def test_device_hist_fn_matches_numpy():
    """ScreenPlan.device_hist_fn (device max-merge + histogram, exact
    integer counts) must equal the numpy pair_union_histograms path."""
    from cuda_selection_criteria.models.bank import SketchBank
    from cuda_selection_criteria.parallel.screened import ScreenPlan
    from cuda_selection_criteria.parallel.selection import SelectionParams

    rng = np.random.default_rng(3)
    n, p = 40, 8
    regs = rng.integers(0, 25, size=(n, 1 << p), dtype=np.uint8)
    cards = np.sort(rng.uniform(500, 5000, n))
    bank = SketchBank(names=[f"g{i}" for i in range(n)], regs=regs, p=p,
                      cards=cards)
    plan = ScreenPlan(bank, SelectionParams(tau=0.3, criterion="cb"), ti=64)
    fn = plan.device_hist_fn(chunk=16, tau=-100.0)  # reject bound off
    ii = rng.integers(0, n, 50)
    kk = rng.integers(0, n, 50)
    got = fn(ii, kk)
    want = hostref.pair_union_histograms(plan.regs_s, ii, kk)
    np.testing.assert_array_equal(got[:, : want.shape[1]],
                                  want[:, : got.shape[1]])
    # and the MLE over device counts is identical
    np.testing.assert_array_equal(
        hostref.ertl_mle_batch(got, p), hostref.ertl_mle_batch(want, p)
    )
    # with the reject bound ON, every non-sentinel row still matches the
    # numpy counts exactly, and every sentinel row is a TRUE reject
    # (exact f64 jacc < tau)
    q = 64 - p
    tau = 0.3
    got_rb = plan.device_hist_fn(chunk=16, tau=tau)(ii, kk)
    sentinel = got_rb[:, q + 1] == (1 << p)
    np.testing.assert_array_equal(got_rb[~sentinel][:, : want.shape[1]],
                                  want[~sentinel][:, : got_rb.shape[1]])
    if sentinel.any():
        t = hostref.ertl_mle_batch(want[sentinel], p)
        e = np.asarray(plan.e_s, np.float64)
        jacc = (e[ii[sentinel]] + e[kk[sentinel]] - t) / t
        assert (jacc < tau).all()


def test_d_regs_device_gather_matches_host_sort():
    """ScreenPlan.d_regs assembled by the device-side gather (raw upload
    + on-chip cardinality sort + pad) must equal the host-sorted padded
    bank byte-for-byte, including the n -> n_pad zero rows."""
    from cuda_selection_criteria.models.bank import SketchBank
    from cuda_selection_criteria.parallel.screened import ScreenPlan
    from cuda_selection_criteria.parallel.selection import SelectionParams

    rng = np.random.default_rng(11)
    n, p = 37, 8  # deliberately not a tile multiple
    regs = rng.integers(0, 25, size=(n, 1 << p), dtype=np.uint8)
    cards = rng.uniform(500, 5000, n)  # unsorted: the gather must sort
    bank = SketchBank(names=[f"g{i}" for i in range(n)], regs=regs, p=p,
                      cards=cards)
    params = SelectionParams(tau=0.3, criterion="cb")

    plan = ScreenPlan(bank, params, ti=16)
    assert plan._regs_s is None  # device path must not need the host sort
    got = np.asarray(plan.d_regs)

    want = np.zeros((plan.n_pad, 1 << p), np.uint8)
    want[:n] = regs[bank.sorted_by_cardinality()]
    np.testing.assert_array_equal(got, want)

    # host-sort-first branch: touching regs_s before d_regs must give
    # the identical device bank
    plan2 = ScreenPlan(bank, params, ti=16)
    _ = plan2.regs_s
    np.testing.assert_array_equal(np.asarray(plan2.d_regs), want)

    # multi-slab pipelined upload (the >HBM/2 bank path, slab size forced
    # tiny): several donated dynamic_update_slice placements, including a
    # short final slab, must assemble the identical bank
    plan3 = ScreenPlan(bank, params, ti=16)
    plan3.upload_slab_bytes = 16 * (1 << p)  # 16 rows/slab, 3 slabs
    np.testing.assert_array_equal(np.asarray(plan3.d_regs), want)


def test_native_pair_union_hist_matches_numpy():
    """The native fused gather+max+histogram (native/fastx
    fastx_pair_union_hist - the host confirm stage's hot loop) must equal
    the numpy widen+bincount path bin-for-bin, including odd register
    widths (vector tail) and repeated/self pairs; out-of-range register
    values and row indices must raise instead of corrupting counts."""
    from cuda_selection_criteria.native import fastx as native

    if not native.available():
        pytest.skip("libfastx.so unavailable")
    rng = np.random.default_rng(7)
    for n, m in ((40, 1 << 8), (16, 1001), (8, 3)):
        regs = rng.integers(0, 51, size=(n, m), dtype=np.uint8)
        ii = rng.integers(0, n, 300)
        kk = rng.integers(0, n, 300)
        ii[:4] = kk[:4] = 0  # self pairs
        got = native.pair_union_hist(regs, ii, kk)
        want = hostref.pair_union_histograms_np(regs, ii, kk)
        np.testing.assert_array_equal(got, want)
    # dispatcher prefers the native path for uint8 banks
    np.testing.assert_array_equal(
        hostref.pair_union_histograms(regs, ii, kk), want)
    # the thread pool partitions pairs identically (atomic work queue)
    np.testing.assert_array_equal(
        native.pair_union_hist(regs, ii, kk, threads=4), want)
    bad = regs.copy()
    bad[0, 0] = 200  # not a legal HLL rank; bincount would misfile it
    with pytest.raises(ValueError):
        native.pair_union_hist(bad, np.zeros(1, np.int64),
                               np.ones(1, np.int64))
    with pytest.raises(ValueError):
        native.pair_union_hist(regs, np.array([n], np.int64),
                               np.zeros(1, np.int64))


def test_confirm_falls_back_to_host_when_device_hist_dies():
    """There is no host fallback: if the device-backed histogram provider
    dies mid-run, confirm_pairs raises instead of finishing on the host
    (a silent fallback would hide a device fault such as running out of
    memory). The same provider, healthy, gives the host result exactly."""
    rng = np.random.default_rng(9)
    n, p = 64, 10
    regs = rng.integers(0, 30, size=(n, 1 << p), dtype=np.uint8)
    e = np.trunc(np.sort(rng.uniform(1e4, 2e4, n)))
    pairs = [(i, k) for i in range(n - 1) for k in range(i + 1, n)]
    want = hostref.PairOracle(
        p, regs, e, criterion="baseline", tau=-100.0, apply_cb=False
    ).confirm_pairs(pairs, batch=256)
    assert len(want) == len(pairs)

    def provider(fail_after):
        calls = {"n": 0}

        def dispatch(ii, kk):
            calls["n"] += 1
            if calls["n"] > fail_after:
                raise RuntimeError("device lost")
            return np.stack([
                np.bincount(np.maximum(regs[i], regs[k]).astype(np.int64),
                            minlength=64)
                for i, k in zip(ii, kk)
            ])

        def fetch(handle):
            return handle

        def fn(ii, kk):
            return fetch(dispatch(ii, kk))

        fn.dispatch = dispatch
        fn.fetch = fetch
        return fn, calls

    def run(fn):
        return hostref.PairOracle(
            p, regs, e, criterion="baseline", tau=-100.0, apply_cb=False,
            hist_fn=fn,
        ).confirm_pairs(pairs, batch=256)

    healthy, _ = provider(fail_after=10**9)
    assert run(healthy) == want
    dying, calls = provider(fail_after=2)
    with pytest.raises(RuntimeError, match="device lost"):
        run(dying)
    assert calls["n"] == 3  # two good batches, then the fault surfaces
