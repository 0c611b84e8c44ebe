"""generate_dataset CLI (tools/generate_dataset/generate_dataset.c parity).

Same flags (`--num-patterns/--length/--length-diff/--error/--indels`),
same `.seq` output format (`>pattern\\n<text\\n`, generate_dataset.c:399-409).
`--seed` is an extension for reproducible datasets. The port's copy of
quicked_tpu/tools/generate_dataset.py: for the same flags and seed it
writes the same bytes. Run as
`python -m quicked_tpu_torch.tools.generate_dataset`.
"""

from __future__ import annotations

import argparse
import sys

from quicked_tpu_torch import generate


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="generate_dataset",
        description="Generate synthetic DNA sequence-pair datasets")
    p.add_argument("--output", "-o", default=None,
                   help="Output path of the generated sequences")
    p.add_argument("--num-patterns", "-n", type=int, required=True,
                   help="Total number of sequence-pairs generated")
    p.add_argument("--length", "-l", type=int, required=True,
                   help="Length of the pattern-sequence")
    p.add_argument("--length-diff", type=float, default=1.0,
                   help="Text length as a fraction of the pattern length")
    p.add_argument("--error", "-e", type=float, default=0.04,
                   help="Simulated errors as a fraction of pattern length")
    p.add_argument("--indels", default="0,0", metavar="NUM,LENGTH",
                   help="Insert up to NUM additional indels of LENGTH")
    p.add_argument("--seed", type=int, default=None,
                   help="Random seed (extension; default: nondeterministic)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        indels_num, indels_length = (int(x) for x in args.indels.split(","))
    except ValueError:
        print("ERROR: --indels expects NUM,LENGTH", file=sys.stderr)
        return 1
    out = open(args.output, "w") if args.output else sys.stdout
    # line-1 is always the pattern; the reference marks the shorter
    # sequence '>' and the longer '<' (generate_dataset.c:399-409).
    # One source of truth for the length math: generate.text_length_for.
    flipped = args.length > generate.text_length_for(args.length,
                                                     args.length_diff)
    p1, p2 = ("<", ">") if flipped else (">", "<")
    try:
        for pattern, text in generate.generate_pairs(
                args.num_patterns, args.length, error=args.error,
                length_diff=args.length_diff, indels_num=indels_num,
                indels_length=indels_length, seed=args.seed):
            out.write(f"{p1}{pattern}\n{p2}{text}\n")
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
