"""Sweep checkpoint/resume, and device faults that must surface (SURVEY
section 5 failure recovery - the reference has none: unchecked CUDA rc's,
NDEBUG'd error peeks)."""

import numpy as np
import pytest

from cuda_selection_criteria.parallel import screened
from cuda_selection_criteria.parallel.screened import (
    ScreenPlan,
    select_pairs_screened,
)
from cuda_selection_criteria.parallel.selection import SelectionParams
from cuda_selection_criteria.utils.hostref import PairOracle
from tests.test_screen import _make_bank


def test_checkpointed_sweep_matches_and_resumes(tmp_path):
    rng = np.random.default_rng(71)
    bank = _make_bank(24, 10, 16, rng)
    params = SelectionParams(tau=0.15, criterion="smh_a")
    ckpt = str(tmp_path / "sweep.jsonl")

    plain = select_pairs_screened(bank, params, ti=8, chunk=1)
    with_ckpt = select_pairs_screened(bank, params, ti=8, chunk=1,
                                      checkpoint=ckpt)
    assert plain == with_ckpt
    lines = open(ckpt).read().strip().splitlines()
    assert len(lines) > 2  # header + several span records

    # Simulate a crash: keep the header and the first 2 span records plus
    # a TORN final line; the resumed run must skip the recorded spans,
    # recompute the rest, and produce the identical result.
    with open(ckpt, "w") as fh:
        fh.write("\n".join(lines[:3]) + "\n")
        fh.write('{"span": [999')  # torn write
    calls = []
    orig = ScreenPlan.screen_chunk

    def counting(self, r_chunk, c_chunk):
        calls.append(len(r_chunk))
        return orig(self, r_chunk, c_chunk)

    ScreenPlan.screen_chunk = counting
    try:
        resumed = select_pairs_screened(bank, params, ti=8, chunk=1,
                                        checkpoint=ckpt)
    finally:
        ScreenPlan.screen_chunk = orig
    assert resumed == plain
    # prune_tiles dispatches gate counts too; the screen dispatches must
    # cover strictly fewer spans than a fresh run would (2 were resumed).
    n_screen_calls = sum(1 for c in calls if c <= 1)
    full_spans = len([ln for ln in lines[1:]])
    assert n_screen_calls <= full_spans - 2

    # A different run must refuse the old checkpoint.
    params2 = SelectionParams(tau=0.2, criterion="smh_a")
    with pytest.raises(ValueError, match="different run"):
        select_pairs_screened(bank, params2, ti=8, chunk=1,
                              checkpoint=ckpt)


def test_device_hist_failure_raises():
    """A device histogram provider that fails mid-confirm must raise out
    of PairOracle.confirm_pairs - no host fallback that finishes the run
    and exits 0 - whether it fails on dispatch or on fetch."""
    rng = np.random.default_rng(73)
    bank = _make_bank(12, 10, 16, rng)
    plan = ScreenPlan(bank, SelectionParams(tau=0.1, criterion="baseline"),
                      256)
    pairs = [(i, k) for i in range(bank.n) for k in range(i + 1, bank.n)]
    good = plan.device_hist_fn(chunk=16, tau=0.1)

    class DeviceFault(RuntimeError):
        pass

    def broken(where):
        calls = []

        def fn(ii, kk):
            raise DeviceFault("hist")

        def dispatch(ii, kk):
            calls.append(1)
            if where == "dispatch" and len(calls) > 1:
                raise DeviceFault("dispatch")
            return good.dispatch(ii, kk)

        def fetch(handle):
            if where == "fetch":
                raise DeviceFault("fetch")
            return good.fetch(handle)

        fn.dispatch, fn.fetch, fn.tau = dispatch, fetch, good.tau
        return fn

    for where in ("dispatch", "fetch"):
        oracle = PairOracle(bank.p, plan.regs_s, plan.e_s,
                            criterion="baseline", tau=0.1, apply_cb=False,
                            hist_fn=broken(where))
        with pytest.raises(DeviceFault, match=where):
            oracle.confirm_pairs(pairs, batch=8)
