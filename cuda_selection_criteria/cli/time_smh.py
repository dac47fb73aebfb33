"""time_smh CLI - criterion-timing experiment, CSV-row parity.

Reference protocol (experiments/src/time_smh.cpp:124-295): load prebuilt
.hll files, build SuperMinHash sketches in memory (NB: -m is a bucket COUNT
here, unlike -a aux BYTES in build_sketch/selection - the reference's units
trap, time_smh.cpp:156), then time two selection sweeps:

  smh_a     - the banding criterion + union confirm over the FULL triangle
  CB+smh_a  - the same with the cardinality bound + row truncation

emitting semicolon CSV rows consumed by run_time_experiment.sh:24-26:

  {list};build_smh;{tau};{seconds};m:{m}
  {list};smh_a;{tau};{seconds};r:{rows}_b:{bands}
  {list};CB+smh_a;{tau};{seconds};r:{rows}_b:{bands}

(The reference interleaves the build row with the timer output; the rows
here are well-formed with the same fields.) Device timings wrap
block_until_ready - unlike the reference GPU harness, which timed only the
kernel launch (time_smh_cuda.cpp:279-283).
"""

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="time_smh", description=__doc__,
                                 add_help=False)
    ap.add_argument("-x", action="store_true", dest="usage")
    ap.add_argument("--help", action="help")
    ap.add_argument("-l", dest="list_file", required=True)
    ap.add_argument("-t", dest="threads", type=int, default=8)
    ap.add_argument("-h", dest="threshold", type=float, default=0.9)
    ap.add_argument("-m", dest="mh_size", type=int, default=512,
                    help="SuperMinHash bucket COUNT (not bytes)")
    ap.add_argument("-R", dest="reps", type=int, default=1)
    ap.add_argument("--block", type=int, default=512)
    args = ap.parse_args(argv)
    if args.usage:
        print("Usage: -l -t -h -m")
        return 0

    import jax
    import numpy as np

    from .. import enable_compile_cache

    enable_compile_cache()

    from ..models.bank import (SketchBank, build_bank_from_files,
                               load_hll_bank, PRIMARY_P)
    from ..utils.filelist import load_file_list
    from ..ops import criteria
    from ..parallel.selection import SelectionParams, select_pairs

    files = load_file_list(args.list_file)
    tau = args.threshold
    m = args.mh_size

    # --- build: SMH in-memory (device), primary .hll from disk ---
    t0 = time.perf_counter()
    smh_bank = build_bank_from_files(
        files, criterion="smh_a", aux_bytes=8 * m, io_threads=args.threads
    )
    regs = load_hll_bank([f + ".hll" for f in files], PRIMARY_P,
                         io_threads=max(1, args.threads))
    bank = SketchBank(
        names=list(files), regs=regs, aux_kind="smh", aux=smh_bank.aux,
        aux_param=m,
    )
    jax.block_until_ready(bank.cards)
    build_secs = time.perf_counter() - t0
    print(f"{args.list_file};build_smh;{tau:g};{build_secs};m:{m}")

    n_rows, n_bands = criteria.smh_band_params(m, tau)
    for _ in range(args.reps):
        # --- sweep 1: smh_a only (full triangle, no CB) ---
        t0 = time.perf_counter()
        params = SelectionParams(tau=tau, criterion="smh_a", aux_bytes=8 * m,
                                 block=args.block)
        select_pairs(bank, _no_cb(params))
        secs = time.perf_counter() - t0
        print(f"{args.list_file};smh_a;{tau:g};{secs};r:{n_rows}_b:{n_bands}")

        # --- sweep 2: CB + smh_a ---
        t0 = time.perf_counter()
        select_pairs(bank, params)
        secs = time.perf_counter() - t0
        print(f"{args.list_file};CB+smh_a;{tau:g};{secs};r:{n_rows}_b:{n_bands}")

    # --- kernel-sweep rows: the device screen ONLY (bank resident on
    # device, schedule precomputed, host confirmation excluded) - the
    # reference's H2D-once kernel-timing protocol
    # (experiments/src/time_smh_cuda.cpp:181-307), but with the device
    # sync the reference forgot (its TIMERSTOP wraps only the async
    # launch, :279-283). One untimed warmup sweep absorbs compilation;
    # tile order is permuted per rep so no transparent result cache can
    # serve a repeat.
    import jax.numpy as jnp
    from ..parallel.screened import ScreenPlan
    from dataclasses import replace

    chunk = 64
    for label, crit in (("smh_a_kernel", "smh_only"),
                        ("CB+smh_a_kernel", "smh_a")):
        plan = ScreenPlan(bank, replace(params, criterion=crit), ti=512)
        rows, cols = plan.schedule()
        if not len(rows):
            continue

        def sweep(seed):
            perm = np.random.default_rng(seed).permutation(len(rows))
            r, c = rows[perm], cols[perm]
            n_s = -(-len(r) // chunk) * chunk
            r = np.pad(r, (0, n_s - len(r)), constant_values=r[-1])
            c = np.pad(c, (0, n_s - len(c)), constant_values=c[-1])
            cnts = []
            for c0 in range(0, n_s, chunk):
                _, cnt = plan.screen_chunk(r[c0:c0 + chunk],
                                           c[c0:c0 + chunk])
                cnts.append(cnt)
            np.asarray(jnp.stack(cnts))  # one blocking fetch = device sync

        sweep(0)  # warmup / compile
        for rep in range(args.reps):
            t0 = time.perf_counter()
            sweep(rep + 1)
            secs = time.perf_counter() - t0
            print(f"{args.list_file};{label};{tau:g};{secs};"
                  f"r:{n_rows}_b:{n_bands}")
    return 0


def _no_cb(params):
    """smh_a gate without the cardinality bound (the reference's smh_a-only
    sweep, time_smh.cpp:228-257)."""
    from dataclasses import replace

    return replace(params, criterion="smh_only")


if __name__ == "__main__":
    sys.exit(main())
