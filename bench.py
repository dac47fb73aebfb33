"""Headline benchmark: pairwise sketch comparisons/sec/chip.

Runs the screened selection path's device stage - the harmonic-sum /
zero-count indicator matmuls (int8 tensor cores) plus the fused gate and
certified-estimator postprocess (CB mask + smh_a LSH banding +
conservative truncated-telescope Jaccard screen) - over the FULL i<j pair
triangle of a synthetic sketch bank, on the default JAX device, which
must be a GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device"}.

vs_baseline: the reference publishes no absolute numbers (BASELINE.md), so
the baseline is the reference CUDA kernel's speed-of-light on its target
hardware (Makefile:26 -arch=sm_86, RTX 3080-class): kernel_CBsmh reads both
16 KiB register arrays per surviving pair (selection_kernels.cu:78-116), so
at 760 GB/s DRAM the union stage tops out at 760e9 / 32768 = 2.32e7 pairs/s.
That DRAM-bound bound ignores the estimator math, so it flatters the
reference.
"""

import json
import subprocess
import time

import numpy as np

CUDA_BASELINE_PAIRS_PER_SEC = 2.32e7  # see module docstring

P = 14
M_SMH = 32  # aux_bytes=256 default -> m=32 buckets
TAU = 0.9
TI = 1024
CHUNK = 64  # dispatch chunk; remainders use small bucketed dispatches
N_GENOMES = 16384
ITEMS_PER_GENOME = 2048


def build_synthetic_bank(n_genomes=N_GENOMES, items=ITEMS_PER_GENOME):
    """Synthetic bank with the EXACT register distribution of the real
    build pipeline, constructed host-side.

    The bench measures the screen SWEEP, so bank fidelity means register
    fidelity: each genome gets `items` uniform 64-bit hashes (WangHash of
    distinct k-mers is uniform) pushed through the reference index/rank
    rule (hll.h:886-899) - index = top p bits, rank =
    clz(((h<<1)|1) << (p-1)) + 1 - and a register max-reduce. This yields
    the same present-value set / harmonic-sum statistics as the device
    build. Cardinalities are the true batched f64 MLE. SMH buckets are
    uniform u64 (band fingerprints of unrelated genomes collide ~never
    either way).
    """
    from cuda_selection_criteria.utils.hostref import ertl_mle_batch

    rng = np.random.default_rng(0xBE7C)
    regs = np.zeros((n_genomes, 1 << P), np.uint8)
    gchunk = min(1024, n_genomes)
    for g0 in range(0, n_genomes, gchunk):
        h = rng.integers(0, 1 << 64, size=(gchunk, items), dtype=np.uint64)
        idx = (h >> np.uint64(64 - P)).astype(np.int64)
        v = ((h << np.uint64(1)) | np.uint64(1)) << np.uint64(P - 1)
        # integer bit-length via shift halving: 6 vector ops, no float
        # rounding concerns (validated bit-exact vs the scalar clz rule)
        bl = np.zeros(v.shape, np.uint8)
        for sh in (32, 16, 8, 4, 2, 1):
            big = v >> np.uint64(sh)
            take = big != 0
            bl[take] += np.uint8(sh)
            v = np.where(take, big, v)
        rank = np.uint8(64) - bl  # lz + 1 = 64 - (bl_high_index) since v>0
        flat = np.arange(gchunk)[:, None] * (1 << P) + idx
        sub = np.zeros(gchunk * (1 << P), np.uint8)
        np.maximum.at(sub, flat.ravel(), rank.ravel())
        regs[g0:g0 + gchunk] = sub.reshape(gchunk, 1 << P)

    aux = rng.integers(0, 1 << 63, size=(n_genomes, M_SMH), dtype=np.uint64)

    # Per-row histograms in bounded chunks (the whole-bank int64 offset
    # array would be a multi-GB temporary).
    hists = np.zeros((n_genomes, 64), np.int64)
    hchunk = 2048
    for g0 in range(0, n_genomes, hchunk):
        sub = regs[g0:g0 + hchunk].astype(np.int32)
        sub += (np.arange(sub.shape[0], dtype=np.int32) * 64)[:, None]
        hists[g0:g0 + hchunk] = np.bincount(
            sub.ravel(), minlength=sub.shape[0] * 64
        ).reshape(sub.shape[0], 64)
    e = np.trunc(ertl_mle_batch(hists, P))
    return regs, aux, e


def _spans(n_tiles, chunk):
    """Full chunks + one small bucketed remainder (minimal padding)."""
    out = [(c0, chunk) for c0 in range(0, n_tiles - chunk + 1, chunk)]
    rem = n_tiles - len(out) * chunk
    if rem:
        out.append((n_tiles - rem,
                    min(chunk, max(8, 1 << (rem - 1).bit_length()))))
    return out


def measure(n_genomes=N_GENOMES, reps=3, items=ITEMS_PER_GENOME):
    """Screened all-pairs pairs/s at one N (bank resident on the device)."""
    import jax
    import jax.numpy as jnp
    from cuda_selection_criteria.ops import criteria, screen
    from cuda_selection_criteria.parallel import screened

    regs, aux, e = build_synthetic_bank(n_genomes, items)
    order = np.argsort(e, kind="stable")
    regs, aux, e = regs[order], aux[order], e[order]

    n_rows_b, n_bands = criteria.smh_band_params(M_SMH, TAU)
    tau = criteria.effective_tau(TAU)
    tau_scr = np.float32(screened.screen_tau(tau))
    tau_cb = np.float32(tau * (1.0 - 1e-5))
    # Truncated telescope (one-sided overestimate; see
    # ops/screen.truncate_values): same conservative screen, fewer matmuls.
    values = screen.truncate_values(
        screen.bank_values(regs), float(e.max()), P)

    # Device-resident bank (production holds the bank on the device across
    # queries; the upload is not part of the per-query cost).
    d_regs = jnp.asarray(regs)
    d_fp = screened.band_fingerprints(jnp.asarray(aux), n_rows_b, n_bands)
    d_e = jnp.asarray(e.astype(np.float32))

    nb = n_genomes // TI
    tiles = [(i, j) for i in range(nb) for j in range(i, nb)]
    rows = np.array([t[0] for t in tiles], np.int32)
    cols = np.array([t[1] for t in tiles], np.int32)
    spans = _spans(len(tiles), min(CHUNK, len(tiles)))

    def _chunk_args(c0, width):
        take = min(width, len(rows) - c0)
        r = np.pad(rows[c0:c0 + take], (0, width - take),
                   constant_values=rows[-1])
        c = np.pad(cols[c0:c0 + take], (0, width - take),
                   constant_values=cols[-1])
        return jnp.asarray(r), jnp.asarray(c)

    # The schedule is fixed across sweeps: device-resident chunk args,
    # built once.
    chunk_args = {span: _chunk_args(*span) for span in spans}

    def sweep_dispatch(tau_jitter):
        """Dispatch one full all-pairs screened pass (async handles),
        with the engine's fetch discipline (parallel/screened.py)."""
        tau_s = jnp.float32(tau_scr + tau_jitter)
        pending = []
        for span in spans:
            r_chunk, c_chunk = chunk_args[span]
            hits, cnt = screened._screen_chunk(
                d_regs, r_chunk, c_chunk, d_e, d_fp, jnp.int32(n_genomes),
                tau_s, tau_cb, P, values, TI, n_bands, True, True,
            )
            pending.append((hits, cnt))
        return pending

    def sweep_collect(pending):
        """Fetch ONE per-tile count array, pull hit masks only for tiles
        that contain candidates (the engine's extraction cost)."""
        counts = np.asarray(jnp.concatenate([c for _, c in pending]))
        pos = 0
        for h, cnt in pending:
            width = cnt.shape[0]
            for t in np.nonzero(counts[pos:pos + width])[0]:
                np.nonzero(np.asarray(h[t]))  # candidate-extraction cost
            pos += width
        return int(counts.sum())

    pairs = n_genomes * (n_genomes - 1) // 2
    sweep_collect(sweep_dispatch(0.0))  # warmup / compile
    # Sustained load: dispatch rep k+1 before collecting rep k, so the
    # device queue stays full; each rep's tau jitter keeps it distinct.
    t0 = time.perf_counter()
    inflight = sweep_dispatch(1e-7)
    for k in range(1, reps):
        nxt = sweep_dispatch((k + 1) * 1e-7)
        sweep_collect(inflight)
        inflight = nxt
    sweep_collect(inflight)
    dt = (time.perf_counter() - t0) / reps
    return pairs / dt


def main():
    import jax

    from cuda_selection_criteria import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures the GPU; the default JAX "
                         f"device is {dev.platform!r}")
    enable_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    pairs_per_sec = measure()
    print(json.dumps({
        "metric": "pair_comparisons_per_sec_per_chip",
        "value": round(pairs_per_sec, 1),
        "unit": "pairs/s",
        "vs_baseline": round(pairs_per_sec / CUDA_BASELINE_PAIRS_PER_SEC, 3),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "nvidia_smi": smi},
    }))


if __name__ == "__main__":
    main()
