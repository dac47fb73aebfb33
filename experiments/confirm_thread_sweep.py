"""Confirm-stage host parallelism sweep.

The confirm stage's host hot loop - the fused gather+max+histogram pass
(native/fastx.fastx_pair_union_hist) feeding the vectorized f64 MLE
(utils/hostref.ertl_mle_batch) - is pair-parallel via the native thread
pool (fastx.cpp batch_run). This measures pairs/s vs thread count on the
host it runs on and writes a CSV; a single-core host gives a flat line,
a multi-core host shows the scaling.

Usage: python experiments/confirm_thread_sweep.py [--out csv] [--pairs N]
"""

import argparse
import csv
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=100_000)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--p", type=int, default=14)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--threads", type=int, nargs="*",
                    default=[1, 2, 4, 8])
    ap.add_argument("--out", default="confirm_threads.csv")
    args = ap.parse_args(argv)

    from cuda_selection_criteria.native import fastx
    from cuda_selection_criteria.utils.hostref import ertl_mle_batch

    if not fastx.available():
        print("libfastx.so unavailable", file=sys.stderr)
        return 1

    rng = np.random.default_rng(42)
    m = 1 << args.p
    # register distribution of ~2k items per genome (bench bank shape)
    regs = rng.integers(0, 12, size=(args.n, m), dtype=np.uint8)
    ii = rng.integers(0, args.n, args.pairs).astype(np.int64)
    kk = rng.integers(0, args.n, args.pairs).astype(np.int64)

    ncpu = os.cpu_count() or 1
    rows = []
    for t in args.threads:
        best_hist = best_full = 0.0
        for _ in range(args.reps):
            t0 = time.perf_counter()
            h = fastx.pair_union_hist(regs, ii, kk, threads=t)
            dt_hist = time.perf_counter() - t0
            t1 = time.perf_counter()
            est = ertl_mle_batch(h, args.p)
            dt_mle = time.perf_counter() - t1
            assert np.all(np.isfinite(est))
            best_hist = max(best_hist, args.pairs / dt_hist)
            best_full = max(best_full,
                            args.pairs / (dt_hist + dt_mle))
        rows.append({
            "threads": t, "ncpu": ncpu, "pairs": args.pairs,
            "hist_pairs_per_sec": round(best_hist, 1),
            "hist_plus_mle_pairs_per_sec": round(best_full, 1),
        })
        print(rows[-1], flush=True)

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {args.out} (host has {ncpu} cpu)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
