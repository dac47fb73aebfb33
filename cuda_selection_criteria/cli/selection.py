"""selection CLI - parity with the reference binaries.

Reference usage (README.md:57-66, src/selection.cpp:86-111):
    selection -l <filelist> -t <threads> -a <aux_bytes> -h <tau> -c <criterion>

Loads the persisted sketches, runs the CB + auxiliary-criterion cascade with
exact HLL-union confirmation, and prints `fileA fileB jaccard` lines in the
reference's sorted-row order. Extra criteria beyond the reference:
`cb` (CB-only cascade) and `baseline` (no pruning), covering the missing
baseline binary (SURVEY.md section 2 #17).

Defaults mirror src/selection.cpp:76-82: tau=0.9, aux=256 bytes, Z=1.96,
order_n=1.
"""

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="selection", description=__doc__,
                                 add_help=False)
    ap.add_argument("-x", action="store_true", dest="usage")
    ap.add_argument("--help", action="help")
    ap.add_argument("-l", dest="list_file", default="")
    ap.add_argument("-t", dest="threads", type=int, default=8)
    ap.add_argument("-a", dest="aux_bytes", type=int, default=256)
    ap.add_argument("-h", dest="threshold", type=float, default=0.9)
    ap.add_argument("-c", dest="criterion", default="")
    # -b: block size, flag-parity with selection_cuda (reference:
    # src/selection_cuda.cpp:68-88). Default None = the engine's measured
    # auto-rule (screened: parallel.screened.auto_tile; dense: 512).
    ap.add_argument("-b", "--block", type=int, default=None, dest="block")
    ap.add_argument("--precision", default="bf16", choices=["bf16", "int8"])
    ap.add_argument("--sharded", action="store_true",
                    help="use the dense multi-device mesh engine "
                         "(shorthand for --engine dense-sharded)")
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "screened", "dense", "sharded",
                             "dense-sharded", "ring"],
                    help="selection engine: auto (screened cascade on "
                         "the GPU), screened (screen-kernel cascade), "
                         "dense (blockwise exact-MLE), sharded (tile-"
                         "sharded multi-device cascade), dense-sharded "
                         "(rows x regs mesh with psum), ring (bank-"
                         "sharded systolic sweep)")
    ap.add_argument("--checkpoint", default=None,
                    help="sweep progress file: long runs resume here after "
                         "a fault instead of recomputing completed chunks")
    args = ap.parse_args(argv)
    if args.block is not None and args.block <= 0:
        print(f"Option -b invalid: block must be > 0 (got {args.block}).")
        return 0

    if args.usage:
        print("Usage: -l -t -a -h -c")
        return 0

    valid = ("hll_a", "hll_an", "smh_a", "cb", "baseline", "smh_only")
    if args.criterion not in valid:
        print("Option -c invalid. The accepted criteria are hll_a, hll_an and smh_a.")
        return 0

    from .. import enable_compile_cache

    enable_compile_cache()
    from ..models import SketchBank
    from ..parallel.selection import SelectionParams, select_pairs, format_results
    from ..utils.filelist import load_file_list

    files = load_file_list(args.list_file)
    load_crit = {
        "hll_a": "hll_a",
        "hll_an": "hll_an",
        "smh_a": "smh_a",
        "smh_only": "smh_a",
    }.get(args.criterion)
    # -t: the reference wires it to omp_set_num_threads
    # (src/selection.cpp:113-115); here the parallel work it governs is
    # the threaded sketch-file loading (the selection math is device-side).
    bank = SketchBank.from_sketch_files(
        files, criterion=load_crit, aux_bytes=args.aux_bytes,
        io_threads=max(1, args.threads),
    )
    params = SelectionParams(
        tau=args.threshold,
        criterion=args.criterion,
        aux_bytes=args.aux_bytes,
        # None (unset) falls back to 512 for the dense engines; the
        # screened/ring engines receive args.block directly and apply
        # their measured auto-rule when it is None.
        block=512 if args.block is None else args.block,
        precision=args.precision,
    )
    engine = "dense-sharded" if args.sharded else args.engine
    if engine == "dense-sharded":
        from ..parallel.mesh import select_pairs_sharded

        run = lambda: select_pairs_sharded(bank, params)  # noqa: E731
    elif engine == "sharded":
        from ..parallel.screened import select_pairs_screened_sharded

        # -b is the screen tile size here (the reference's -b is its CUDA
        # kernel block size - same knob, same default)
        run = lambda: select_pairs_screened_sharded(  # noqa: E731
            bank, params, ti=args.block or 512)
    elif engine == "ring":
        from ..parallel.ring import select_pairs_ring

        run = lambda: select_pairs_ring(bank, params)  # noqa: E731
    elif engine == "screened":
        from ..parallel.screened import select_pairs_screened

        run = lambda: select_pairs_screened(  # noqa: E731
            bank, params, ti=args.block, checkpoint=args.checkpoint)
    elif engine == "dense":
        from dataclasses import replace as _replace

        dense_params = _replace(params, engine="dense")
        run = lambda: select_pairs(bank, dense_params)  # noqa: E731
    else:
        run = lambda: select_pairs(  # noqa: E731
            bank, params, checkpoint=args.checkpoint)
    results = run()
    for line in format_results(results):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
