#!/usr/bin/env python
"""Timing-experiment orchestration (parity: run_time_experiment.sh).

Sweeps SuperMinHash sizes / tile sizes over the time_smh CLI and writes
experimento_smh_comparativo.csv with rows `impl,param,mh_size,rep,criterio,tiempo`
(same columns as run_time_experiment.sh:15-16). Like the reference's
script - which sweeps BOTH its CPU binary (time_smh) and its GPU binary
(time_smh_cuda) into one CSV (run_time_experiment.sh:19-42) - this emits
two implementation arms:

  gpu   - the time_smh CLI (device build + device-screened sweeps)
  host  - the all-host twin: the native C++ single-pass sketch builder
          (native/fastx.cpp, threaded like the reference's OpenMP loop)
          and the sequential scalar selection (utils/hostref
          .select_pairs_host, the reference CPU control flow)
"""

import argparse
import csv
import io
import os
import sys
from contextlib import redirect_stdout

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-l", dest="list_file", required=True)
    ap.add_argument("--threshold", type=float, default=0.9)
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--mh-sizes", type=int, nargs="+", default=[512])
    ap.add_argument("--blocks", type=int, nargs="+", default=[512])
    ap.add_argument("-o", dest="out", default="experimento_smh_comparativo.csv")
    ap.add_argument("--no-host", action="store_true",
                    help="skip the host arm (device rows only)")
    args = ap.parse_args()

    import jax

    from cuda_selection_criteria.cli import time_smh

    # honest arm label: "gpu" only when the device arm really ran on an
    # accelerator backend
    dev_impl = "gpu" if jax.default_backend() == "gpu" else "cpu-xla"
    rows = []
    if not args.no_host:
        rows += host_arm_rows(args)
    for block in args.blocks:
        for m in args.mh_sizes:
            for rep in range(1, args.reps + 1):
                buf = io.StringIO()
                with redirect_stdout(buf):
                    time_smh.main([
                        "-l", args.list_file, "-h", str(args.threshold),
                        "-m", str(m), "--block", str(block),
                    ])
                for line in buf.getvalue().splitlines():
                    parts = line.split(";")
                    if len(parts) >= 4:
                        rows.append(
                            [dev_impl, block, m, rep, parts[1], parts[3]]
                        )
    with open(args.out, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["impl", "block", "mh_size", "rep", "criterio", "tiempo"])
        w.writerows(rows)
    print(f"Listo, resultados en {args.out}")


def host_arm_rows(args):
    """impl="host" rows: native C++ sketch build + sequential scalar
    selection, timed with the same row schema as the device arm (the
    reference's CPU binary arm, run_time_experiment.sh:19-27)."""
    import time

    from cuda_selection_criteria.models.bank import (
        SketchBank, build_bank_from_files, load_hll_bank, PRIMARY_P)
    from cuda_selection_criteria.utils.filelist import load_file_list
    from cuda_selection_criteria.utils.hostref import select_pairs_host

    files = load_file_list(args.list_file)
    tau = args.threshold
    rows = []
    for m in args.mh_sizes:
        for rep in range(1, args.reps + 1):
            t0 = time.perf_counter()
            smh_bank = build_bank_from_files(
                files, criterion="smh_a", aux_bytes=8 * m,
                backend="native")
            regs = load_hll_bank([f + ".hll" for f in files], PRIMARY_P)
            bank = SketchBank(names=list(files), regs=regs,
                              aux_kind="smh", aux=smh_bank.aux,
                              aux_param=m)  # cards: __post_init__
            rows.append(["host", 0, m, rep, "build_smh",
                         time.perf_counter() - t0])

            t0 = time.perf_counter()
            select_pairs_host(bank, tau, "smh_a", apply_cb=False)
            rows.append(["host", 0, m, rep, "smh_a",
                         time.perf_counter() - t0])

            t0 = time.perf_counter()
            select_pairs_host(bank, tau, "smh_a", apply_cb=True)
            rows.append(["host", 0, m, rep, "CB+smh_a",
                         time.perf_counter() - t0])
    return rows


if __name__ == "__main__":
    main()
