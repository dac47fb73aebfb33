#!/usr/bin/env python
"""Differential harness: device engine vs scalar host engine
(parity: run_comparison_experiment.sh:57-113).

Runs the tiled device selection and the sequential numpy host engine on the
same sketch files at a low threshold (the reference compares at tau=0.01 to
surface many pairs, run_comparison_experiment.sh:62-64), joins on the pair
key, and reports per-pair |delta sim|. The reference tolerated 1e-6 between
its CPU and GPU (which used different estimators); our two engines follow
identical f64 math, so the expected delta is exactly 0.
"""

import argparse
import csv
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-l", dest="list_file", required=True)
    ap.add_argument("-a", dest="aux_bytes", type=int, default=32)
    ap.add_argument("-t", dest="tau", type=float, default=0.01)
    ap.add_argument("-c", dest="criterion", default="smh_a")
    ap.add_argument("-o", dest="out", default="comparacion_device_host.csv")
    ap.add_argument("--estimator-delta", action="store_true",
                    help="additionally report the ORIGINAL-vs-MLE "
                         "similarity delta over the emitted pairs - the "
                         "deviation the reference's own CPU (MLE) vs GPU "
                         "(ORIGINAL, criteria_sketch_cuda.cuh:30-65) pair "
                         "exhibits at EPS=1e-6 "
                         "(run_comparison_experiment.sh:70,101-106)")
    args = ap.parse_args()

    from cuda_selection_criteria.models import SketchBank
    from cuda_selection_criteria.parallel.selection import (
        SelectionParams, select_pairs,
    )
    from cuda_selection_criteria.utils.filelist import load_file_list
    from cuda_selection_criteria.utils import hostref

    files = load_file_list(args.list_file)
    bank = SketchBank.from_sketch_files(files, criterion=args.criterion,
                                        aux_bytes=args.aux_bytes)
    dev = select_pairs(bank, SelectionParams(tau=args.tau,
                                             criterion=args.criterion,
                                             aux_bytes=args.aux_bytes))
    host = hostref.select_pairs_host(bank, args.tau, args.criterion)

    def key(a, b):
        return (a, b) if a <= b else (b, a)

    dev_map = {key(a, b): j for a, b, j in dev}
    host_map = {key(a, b): j for a, b, j in host}
    all_keys = sorted(set(dev_map) | set(host_map))

    eps = 1e-6
    n_bad = 0
    with open(args.out, "w", newline="") as fh:
        w = csv.writer(fh, delimiter=";")
        w.writerow(["par", "sim_device", "sim_host", "delta", "ok"])
        for k in all_keys:
            a = dev_map.get(k)
            b = host_map.get(k)
            if a is None or b is None:
                n_bad += 1
                w.writerow(["|".join(k), a, b, "", "MISSING"])
                continue
            d = abs(a - b)
            ok = d <= eps
            n_bad += 0 if ok else 1
            w.writerow(["|".join(k), f"{a:.6f}", f"{b:.6f}", f"{d:.2e}",
                        "OK" if ok else "FAIL"])
    print(f"pairs={len(all_keys)} mismatches={n_bad} -> {args.out}")

    if args.estimator_delta and host:
        # The delta the reference's comparison script actually measures:
        # its CPU selection confirms with ERTL-MLE while its GPU kernels
        # use the Flajolet ORIGINAL estimator for the same union - so the
        # reference's own CPU<->GPU diff is estimator deviation, not a
        # bug in either engine. This framework emits MLE everywhere, so
        # the number below documents the deviation magnitude (reference
        # bug #4 in SURVEY.md) from this codebase's own machinery.
        import numpy as np
        from cuda_selection_criteria.ops import estimators
        import jax.numpy as jnp

        name_pos = {n: i for i, n in enumerate(bank.names)}
        e = np.trunc(bank.cards)
        deltas = []
        for a, b, j_mle in host:
            i, k = name_pos[a], name_pos[b]
            merged = jnp.asarray(
                np.maximum(bank.regs[i], bank.regs[k]).astype(np.int32))
            counts = estimators.hll_histogram(merged, bank.p)
            t_orig = float(estimators.original_estimate(counts, bank.p))
            j_orig = (e[i] + e[k] - t_orig) / t_orig
            deltas.append(abs(j_orig - j_mle))
        deltas = np.array(deltas)
        print(f"estimator-delta (ORIGINAL vs MLE similarity, "
              f"{len(deltas)} pairs): max={deltas.max():.3e} "
              f"mean={deltas.mean():.3e} "
              f"over_ref_eps={(deltas > eps).sum()}/{len(deltas)}")
    return 1 if n_bad else 0


if __name__ == "__main__":
    sys.exit(main())
