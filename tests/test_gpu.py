"""Checks that need the GPU: the compiled screen at the real width and the
device ERTL-MLE's bit-exactness. They skip on the CPU (the `gpu`
fixture); chip_smoke.py phases 5 and 6 run the same checks at scale."""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def test_screen_matches_numpy_at_p14(gpu):
    import jax.numpy as jnp

    from cuda_selection_criteria.ops import screen
    from cuda_selection_criteria.utils import synth

    bank, _, _ = synth.synthetic_bank(2048, seed=4, n_clusters=64)
    regs = bank.regs[bank.sorted_by_cardinality()]
    values = screen.truncate_values(screen.bank_values(regs),
                                    float(bank.cards.max()), 14)
    rows, cols = np.array([0, 0]), np.array([0, 1])
    s, z = screen.screen_s_z(jnp.asarray(regs), jnp.asarray(rows),
                             jnp.asarray(cols), 14, values, ti=1024,
                             tj=1024)
    w = np.ldexp(1.0, -np.arange(256, dtype=np.int64))
    for t, (r, c) in enumerate(zip(rows, cols)):
        a = regs[r * 1024: r * 1024 + 8]
        b = regs[c * 1024: (c + 1) * 1024]
        mx = np.minimum(np.maximum(a[:, None, :], b[None]), values[-1])
        np.testing.assert_array_equal(
            np.asarray(s)[t, :8], w[mx].sum(-1).astype(np.float32))
        np.testing.assert_array_equal(np.asarray(z)[t, :8],
                                      (mx == 0).sum(-1))


def test_device_mle_bit_exact(gpu):
    from cuda_selection_criteria.utils import synth
    from cuda_selection_criteria.utils.hostref import ertl_mle_batch

    bank, _, _ = synth.synthetic_bank(4096, seed=5, n_clusters=64)
    hist = np.stack([np.bincount(r, minlength=64) for r in bank.regs])
    np.testing.assert_array_equal(bank.cards, ertl_mle_batch(hist, 14))
