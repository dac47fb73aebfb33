"""build_sketch CLI - parity with the reference binary.

Reference usage (README.md:45-55, src/build_sketch.cpp:198-216):
    build_sketch -l <filelist> -t <threads> -a <aux_bytes> -c {hll_a,hll_an,smh_a}

Builds the primary p=14 HLL sketch for every FASTA in the list plus the
criterion's auxiliary sketch, and persists them next to the FASTA files in
the reference's gz formats (.hll, .hll_{p}, .smh{m}).

-a semantics match the reference: aux BYTES; p_aux = ctz(bytes) for hll_a /
hll_an, m = bytes/8 buckets for smh_a (src/build_sketch.cpp:242,258,274).
-t controls host FASTA-decode threads (device work is already batched).
"""

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="build_sketch", description=__doc__)
    ap.add_argument("-l", dest="list_file", required=True, help="file list")
    ap.add_argument("-t", dest="threads", type=int, default=8)
    ap.add_argument("-a", dest="aux_bytes", type=int, default=256)
    ap.add_argument("-c", dest="criterion", default="")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "device", "native"],
                    help="sketch builder: device pipeline, native C++ "
                         "single-pass, or auto (native when built)")
    ap.add_argument("--bank", dest="bank_out", default=None,
                    help="also save a stacked .npz sketch bank")
    args = ap.parse_args(argv)

    if args.criterion not in ("hll_a", "hll_an", "smh_a"):
        print("Option -c invalid. The accepted criteria are hll_a, hll_an and smh_a.")
        return 0

    from .. import enable_compile_cache

    enable_compile_cache()
    from ..models.bank import build_bank_from_files  # lazy: jax import cost
    from ..utils.filelist import load_file_list
    from ..utils import formats

    files = load_file_list(args.list_file)
    bank = build_bank_from_files(
        files, criterion=args.criterion, aux_bytes=args.aux_bytes,
        io_threads=args.threads, backend=args.backend,
    )
    bank.write_sketch_files()
    if args.bank_out:
        formats.save_bank(
            args.bank_out, bank.names, bank.regs, cards=bank.cards,
            aux=bank.aux, aux_kind=bank.aux_kind,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
