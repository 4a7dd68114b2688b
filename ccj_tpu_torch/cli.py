"""``ccj`` console entry point mirroring the reference CLI (PyTorch).

Counterpart of ``ccj_tpu/cli.py``, with the same flags and the same output
bytes.  Flags (reference: src/ccj.ggo:13-31): sequence as positional arg or
stdin, -i/--input-file, -d/--dangles (default 2), -P/--paramFile,
--noConv, --noGU; plus --pf / --samples / --PSplot (the partition function
the reference ships disabled) and --device (the torch device; default
``cuda``, which raises without a GPU).  Output format is byte-compatible
with the reference (src/CCJ.cc:107-108).  Any length folds: the dense fill
up to 128 nt, the segment-packed fill beyond (``api.fold``).

    python -m ccj_tpu_torch.cli GGGAAACGGGCGAUCCUUCCCGAAAGGGAUCGGGUUU
    python -m ccj_tpu_torch.cli --device cpu GCGCUUCGCCGCGCCA

Divergence (documented): the reference accepts ``-i`` but never reads the
file (src/CCJ.cc:68-72 — a known bug); here ``-i`` actually reads the first
line of the file as the sequence.
"""

from __future__ import annotations

import argparse
import sys

from .api import fold, partition


def _format_energy(e: float) -> str:
    # std::cout default formatting: up to 6 significant digits
    return f"{e:.6g}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="ccj",
        description="Pseudoknotted minimum free energy folding of RNAs",
    )
    ap.add_argument("sequence", nargs="?",
                    help="RNA/DNA sequence (or stdin); any length: the dense "
                         "fill up to 128 nt, the packed fill beyond")
    ap.add_argument("-i", "--input-file", help="read the sequence from a file")
    ap.add_argument("-d", "--dangles", type=int, default=2,
                    help="dangle model (0, 1 or 2; default 2)")
    ap.add_argument("-P", "--paramFile", help="energy parameter file")
    ap.add_argument("--noConv", action="store_true",
                    help="do not convert DNA (T) to RNA (U); uses DNA parameters")
    ap.add_argument("--noGU", action="store_true",
                    help="disallow G-U / U-G pairs")
    ap.add_argument("--pf", action="store_true",
                    help="also compute the partition function + Boltzmann "
                         "samples (the capability the reference ships "
                         "disabled)")
    ap.add_argument("--samples", type=int, default=1000,
                    help="number of Boltzmann samples with --pf")
    ap.add_argument("--PSplot", metavar="FILE", default=None,
                    help="write a PS base-pair-probability dot plot (with --pf)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to fold on (default cuda; 'cpu' runs "
                         "the plain PyTorch versions of the kernels)")
    args = ap.parse_args(argv)

    seq = args.sequence
    if seq is None:
        if args.input_file:
            with open(args.input_file) as fh:
                seq = fh.readline().strip()
        else:
            seq = sys.stdin.readline().strip()

    try:
        res = fold(
            seq,
            dangles=args.dangles,
            param_file=args.paramFile,
            no_gu=args.noGU,
            no_conv=args.noConv,
            device=args.device,
        )
    except ValueError as exc:
        print(exc)
        return 1

    print(res.seq)
    print(f"{res.structure} ({_format_energy(res.energy)})")

    if args.pf:
        pf = partition(
            seq,
            dangles=args.dangles,
            param_file=args.paramFile,
            no_gu=args.noGU,
            no_conv=args.noConv,
            num_samples=args.samples,
            ps_path=args.PSplot,
            device=args.device,
        )
        print(f"free energy of ensemble = {pf.ensemble_energy:.2f} kcal/mol")
    return 0


if __name__ == "__main__":
    sys.exit(main())
