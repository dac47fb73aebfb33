"""The vectorized tile scheduler against its scalar twin."""

import numpy as np

from cuda_selection_criteria.parallel import scheduler


def test_triangle_block_ids_matches_scalar_oracle():
    """The vectorized scheduler must emit the scalar scan's tile list
    bit-for-bit (same f64 divisions/comparisons, same break/continue
    semantics around zero-cardinality blocks)."""
    rng = np.random.default_rng(0x5C4ED)
    for _ in range(200):
        n = int(rng.integers(0, 160))
        block = int(rng.integers(1, 33))
        tau = float(rng.choice([0.0, 0.3, 0.9, 0.999, 1.0]))
        nz = int(rng.integers(0, n + 1)) if n else 0
        vals = np.sort(rng.choice([1.0, 2.0, 3.0, 5.0, 1e3, 1e3 + 1],
                                  size=n - nz)) if n else np.zeros(0)
        e = np.concatenate([np.zeros(nz), vals])
        for cb in (True, False):
            got = scheduler.triangle_blocks(e, tau, block, use_cb_skip=cb)
            want = scheduler.triangle_blocks_scalar(
                e, tau, block, use_cb_skip=cb)
            assert got == want
