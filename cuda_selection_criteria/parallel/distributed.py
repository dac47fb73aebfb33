"""Multi-host orchestration: jax.distributed + tile-slice ownership.

The reference is single-process (OpenMP shared memory is its only
"communication" - SURVEY.md section 2.3). The scale-out story has three
independent levers, composable because the screen is
embarrassingly parallel over tiles:

  1. intra-host: tiles sharded over the local device mesh
     (parallel/screened.select_pairs_screened_sharded - XLA shard_map,
     zero collectives in the screen);
  2. inter-host: each process owns a contiguous slice
     of the live-tile list (deterministic given the shared cardinality
     sort), screens it on its local devices, and exact-confirms its own
     survivors; results are a disjoint union, merged by reference row
     order at the end;
  3. storage: row-sharded bank checkpoints (models/bank.SketchBank.save
     with shards=process_count) let each host read only its rows and
     all_gather the column strips it needs.

This module wires 2 (and the jax.distributed bootstrap); it is exercised
single-process in tests (process_count == 1 degenerates to the local
engine) - the same code path runs unchanged under
`jax.distributed.initialize` on real multi-host clusters.
"""

import numpy as np
import jax


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """Bootstrap jax.distributed (no-op when already initialized or when
    running single-process). Must run before anything touches the XLA
    backend."""
    if coordinator_address is None:
        return  # single-process run
    if jax.distributed.is_initialized():
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as exc:
        # Tolerate a racing/prior bootstrap; anything else is real.
        if "already initialized" not in str(exc):
            raise


def tile_slice(n_tiles, process_index=None, process_count=None):
    """Contiguous [lo, hi) slice of the live-tile list owned by a process.

    Deterministic given the (shared) ascending-cardinality sort, so every
    process computes the same global schedule and takes its own rows -
    no coordination traffic at all.
    """
    if process_index is None:
        process_index = jax.process_index()
    if process_count is None:
        process_count = jax.process_count()
    bounds = np.linspace(0, n_tiles, process_count + 1, dtype=np.int64)
    return int(bounds[process_index]), int(bounds[process_index + 1])


def select_pairs_multihost(bank, params, ti=512, chunk=64):
    """Per-process shard of the screened all-pairs selection.

    Every process runs the identical schedule computation (sort + block
    schedule) and owns a contiguous slice of the scheduled tile list; it
    then runs the SAME cascade as the single-host engine (stage-1 gate
    pruning, screen, exact confirmation - shared via
    screened.ScreenPlan, so the paths cannot drift) on its slice only.
    The returned lists are disjoint across processes and their
    concatenation, sorted by the global row order, equals the single-host
    result (tests/test_multichip.py, tests/test_distributed_procs.py).
    """
    from .screened import ScreenPlan

    if bank.n < 2:
        return []
    plan = ScreenPlan(bank, params, ti)
    rows, cols = plan.schedule()
    lo, hi = tile_slice(len(rows))
    rows, cols = rows[lo:hi], cols[lo:hi]
    if not len(rows):
        return []
    rows, cols = plan.prune_tiles(rows, cols, chunk=max(chunk, 256))
    cand = plan.screen_tiles(rows, cols, chunk=chunk)
    names = bank.names
    order = plan.order
    # Keys (i, j) are global sorted positions: concatenating shards and
    # sorting on them reproduces the single-host row order exactly.
    return [
        (i, j, names[order[i]], names[order[j]], jacc)
        for i, j, jacc in plan.confirm(cand)
    ]


def merge_multihost_results(shards):
    """Merge per-process result shards into the reference row order."""
    merged = sorted({t for shard in shards for t in shard})
    return [(a, b, j) for _, _, a, b, j in merged]
