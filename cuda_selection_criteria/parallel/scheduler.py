"""Pair-block scheduler: tiles the i<j triangle and skips blocks the
cardinality bound (CB) rules out.

The reference exploits ascending-cardinality order with a per-row `break`
when CB first fails (src/selection.cpp:164-165,282-283). On device the same
asymptotic win is recovered at block granularity: gamma = e_i / e_j is
non-increasing along a sorted row, so a whole (row-block, col-block) tile is
dead iff its best pair fails CB:

    max_{i in rows} e_i / min_{j in cols, e_j > 0} e_j < tau  =>  skip tile.

Within surviving tiles CB is still applied per pair as a mask, which is
exactly equivalent to the sequential break given the sort (zero-cardinality
columns are `continue`-skipped, never break a row - src/selection.cpp:163).

The enumeration itself is vectorized numpy (triangle_block_ids): the
round-3 Python double loop measured 22.6 s at N=524,288 / ti=512 (~525k
tiles); the broadcast form is O(nb^2) flops on an nb x nb f64 grid
(nb = N/ti ~ 1k), milliseconds at the same size, and produces the
IDENTICAL tile list (same f64 divisions and comparisons; fuzz-checked
against the scalar loop in tests/test_scheduler.py).
"""

import numpy as np


def block_ranges(n, block):
    """[(start, stop)) ranges tiling [0, n) in chunks of `block`."""
    return [(s, min(s + block, n)) for s in range(0, n, block)]


def triangle_block_ids(e_sorted, tau, block, use_cb_skip=True):
    """Vectorized tile enumeration: (rows, cols) int64 block indices.

    Semantics are exactly the scalar scan's: for each row block bi, column
    blocks bj >= bi are visited in order; a block whose columns are all
    zero-cardinality is skipped (`continue` - never emitted, never breaks
    the row); the first positive block with gamma_ub < tau breaks the row.
    Because the bank is sorted ascending, all-zero blocks form a prefix,
    and the per-block first-positive value is non-decreasing - but the
    emitted set is computed from the same f64 divisions/comparisons as the
    scalar loop, not from a monotonicity shortcut, so borderline floats
    agree bit-for-bit.
    """
    n = int(e_sorted.shape[0])
    if n == 0:
        return (np.zeros(0, np.int64),) * 2
    nb = -(-n // block)
    ii = np.arange(nb)
    starts = ii * block
    ends = np.minimum(starts + block, n)
    upper = ii[None, :] >= ii[:, None]  # bj >= bi

    if not use_cb_skip:
        rows, cols = np.nonzero(upper)
        return rows, cols

    e = np.asarray(e_sorted, np.float64)
    e1_max = e[ends - 1]  # ascending within the block
    # first positive value per block (blocks are sorted, so it's the value
    # at max(start, first_global_positive)); +inf marks all-zero blocks
    k0 = int(np.searchsorted(e, 0.0, side="right"))
    first_pos_idx = np.maximum(starts, k0)
    has_pos = first_pos_idx < ends
    first_pos = np.where(has_pos, e[np.minimum(first_pos_idx, n - 1)],
                         np.inf)

    with np.errstate(divide="ignore", invalid="ignore"):
        gamma_ub = e1_max[:, None] / first_pos[None, :]
    live = gamma_ub >= tau  # the scalar loop's `not gamma_ub >= tau` break
    # break: first positive block (within bj >= bi) failing CB kills the
    # rest of the row, all-zero blocks never break
    fail = upper & has_pos[None, :] & ~live
    cut = np.where(fail.any(axis=1), fail.argmax(axis=1), nb)
    keep = upper & has_pos[None, :] & (ii[None, :] < cut[:, None])
    rows, cols = np.nonzero(keep)
    return rows, cols


def triangle_blocks(e_sorted, tau, block, use_cb_skip=True):
    """Enumerate (row_range, col_range) tiles of the upper triangle that can
    contain selected pairs.

    Args:
      e_sorted: float64 (N,) truncated cardinalities, ascending.
      tau: effective threshold (f64).
      block: tile edge length.
      use_cb_skip: apply the block-level CB bound (False for the baseline /
        no-criterion sweep).

    Returns:
      list of ((r0, r1), (c0, c1)) tile index ranges with c1 > r0 (tiles
      strictly below the diagonal are never yielded).
    """
    n = int(e_sorted.shape[0])
    rows, cols = triangle_block_ids(e_sorted, tau, block, use_cb_skip)
    r0 = rows * block
    c0 = cols * block
    r1 = np.minimum(r0 + block, n)
    c1 = np.minimum(c0 + block, n)
    return [((int(a), int(b)), (int(c), int(d)))
            for a, b, c, d in zip(r0, r1, c0, c1)]


def triangle_blocks_scalar(e_sorted, tau, block, use_cb_skip=True):
    """The original scalar scan - kept as the semantic oracle for
    fuzz-testing triangle_block_ids (the engines use the vectorized
    form)."""
    n = e_sorted.shape[0]
    ranges = block_ranges(n, block)
    tiles = []
    for bi, (r0, r1) in enumerate(ranges):
        e1_max = float(e_sorted[r1 - 1])
        for bj in range(bi, len(ranges)):
            c0, c1 = ranges[bj]
            if use_cb_skip:
                col = e_sorted[c0:c1]
                pos = col[col > 0]
                if pos.size == 0:
                    continue  # e2 == 0 pairs are skipped, never selected
                gamma_ub = e1_max / float(pos[0])  # first positive is min
                if not gamma_ub >= tau:
                    # No pair in this tile can pass CB; since gamma only
                    # shrinks for later col tiles, the rest of the row of
                    # tiles is dead too.
                    break
            tiles.append(((r0, r1), (c0, c1)))
    return tiles


def pair_count(tiles, n):
    """Number of i<j pairs covered by the scheduled tiles (for throughput
    accounting) - closed form per tile, no materialized index grids."""
    total = 0
    for (r0, r1), (c0, c1) in tiles:
        if c0 >= r1:  # strictly above the diagonal: full rectangle
            total += (r1 - r0) * (c1 - c0)
            continue
        # pairs with i in [r0,r1), j in [c0,c1), i < j:
        # sum over j of |{i : r0 <= i < min(r1, j)}|
        jj = np.arange(max(c0, r0 + 1), c1)
        total += int(np.sum(np.minimum(r1, jj) - r0))
    return total
