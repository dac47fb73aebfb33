"""The collection-scale synthetic bank (utils/synth.py) and its oracle
checks, at small N on the CPU: the register law, the planted clusters, and
check_selection's three checks catching what they should."""

import numpy as np
import pytest

from cuda_selection_criteria.parallel.screened import select_pairs_screened
from cuda_selection_criteria.parallel.selection import SelectionParams
from cuda_selection_criteria.utils import synth


@pytest.fixture(scope="module")
def small_bank():
    return synth.synthetic_bank(600, seed=3, p=10, n_clusters=24,
                                card_range=(2e3, 2e5))


def test_register_law_matches_cardinality():
    """Registers drawn from the law give back their cardinality through the
    exact MLE within HLL's standard error (1.04/sqrt(m))."""
    import jax
    import jax.numpy as jnp

    from cuda_selection_criteria.ops import estimators

    p = 12
    cards = np.array([3e3, 1e4, 1e5, 1e6, 1e7], np.float32)
    regs = synth._law_bank(jax.random.PRNGKey(5), np.repeat(cards, 40), p,
                           block=64)
    assert regs.dtype == np.uint8 and regs.shape == (200, 1 << p)
    est = np.asarray(estimators.ertl_mle_from_regs(jnp.asarray(regs), p))
    rel = est.reshape(5, 40) / cards[:, None] - 1.0
    se = 1.04 / np.sqrt(1 << p)
    assert np.all(np.abs(rel.mean(1)) < 3 * se / np.sqrt(40) + 1e-3)
    assert np.all(np.abs(rel.std(1) / se - 1.0) < 0.5)


def test_synthetic_bank_layout_and_planted_jaccard(small_bank):
    bank, planted, twins = small_bank
    c = len(synth.DEFAULT_LADDER)
    assert bank.n == 600 and bank.regs.shape == (600, 1 << 10)
    assert bank.aux.shape == (600, 32) and bank.aux.dtype == np.uint64
    assert planted.shape == (24 * c * (c - 1) // 2, 2)
    assert (planted[:, 0] < planted[:, 1]).all()
    assert (planted // c)[:, 0].tolist() == (planted // c)[:, 1].tolist()
    # a member is the union of its cluster's core and its own private part
    i, k = planted[0]
    assert (bank.regs[i] > 0).sum() > 0
    # pair Jaccards straddle the 0.9 threshold across the ladder
    f = np.asarray(synth.DEFAULT_LADDER)
    jacc = 1.0 / (1.0 + f[:, None] + f[None, :])
    iu = np.triu_indices(c, 1)
    assert jacc[iu].min() < 0.9 < jacc[iu].max()
    # twins: 2 * n_clusters adjacent pairs right after the cluster rows
    assert twins.shape == (48, 2)
    assert twins[0, 0] == 24 * c and (twins[:, 1] == twins[:, 0] + 1).all()
    # same seed, same bank
    again, _, _ = synth.synthetic_bank(600, seed=3, p=10, n_clusters=24,
                                    card_range=(2e3, 2e5))
    np.testing.assert_array_equal(again.regs, bank.regs)
    np.testing.assert_array_equal(again.aux, bank.aux)


@pytest.mark.parametrize("crit", ["smh_a", "cb"])
def test_check_selection_accepts_engine_output(small_bank, crit):
    bank, planted, twins = small_bank
    res = select_pairs_screened(bank, SelectionParams(tau=0.9,
                                                      criterion=crit),
                                ti=128, chunk=8)
    got = synth.check_selection(bank, res, planted, twins, crit, 0.9, 4000)
    assert got["planted_pass"] > 0 and got["emitted"] >= got["planted_pass"]
    assert got["sampled"] > 3000
    # some twins pass and some fail: they straddle the threshold
    assert 0 < got["twins_pass"] < got["twins"]
    assert got["sampled_pass"] >= got["twins_pass"]


@pytest.mark.parametrize("fault", ["drop", "extra", "jacc", "drop_twin"])
def test_check_selection_catches_faults(small_bank, fault):
    """Each check fires: a lost planted pair (a), an emitted pair the
    oracle rejects or a wrong Jaccard (b), a lost twin (c)."""
    bank, planted, twins = small_bank
    res = select_pairs_screened(bank, SelectionParams(tau=0.9,
                                                      criterion="smh_a"),
                                ti=128, chunk=8)
    assert res
    if fault == "drop":
        bad = res[1:]
    elif fault == "extra":
        bad = res + [(bank.names[-1], bank.names[-2], 0.95)]
    elif fault == "jacc":
        bad = [(res[0][0], res[0][1], res[0][2] + 1e-9)] + res[1:]
    else:
        names = {bank.names[i] for i in twins.ravel()}
        bad = [r for r in res if r[0] not in names]
        assert len(bad) < len(res)
    with pytest.raises(AssertionError):
        synth.check_selection(bank, bad, planted, twins, "smh_a", 0.9, 1000)
