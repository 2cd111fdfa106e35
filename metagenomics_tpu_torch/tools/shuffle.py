"""Interleave separate R1/R2 mate files into the adjacent-mate layout the
assembler expects — behavioral twins of the reference's
shuffleSequences_fasta.pl / shuffleSequences_fastq.pl
(MetaGenomics/Debug/): lines pass through VERBATIM (multi-line FASTA
records stay multi-line), the FASTA record boundary is any line containing
'>' (the perl regex m/>/ is unanchored), FASTQ interleaves blind 4-line
groups, and an exhausted B-file contributes empty text exactly like perl's
undefined-line prints.

Usage: python -m metagenomics_tpu.tools.shuffle R1.fastx R2.fastx out.fastx
"""

import sys


def shuffle_fasta(fa, fb, out):
    """shuffleSequences_fasta.pl:22-37."""
    line_a = fa.readline()
    line_b = fb.readline()
    while line_a:
        out.write(line_a)
        line_a = fa.readline()
        while line_a and ">" not in line_a:
            out.write(line_a)
            line_a = fa.readline()
        out.write(line_b)
        line_b = fb.readline()
        while line_b and ">" not in line_b:
            out.write(line_b)
            line_b = fb.readline()


def shuffle_fastq(fa, fb, out):
    """shuffleSequences_fastq.pl:12-29 — blind 4-line groups; the loop
    stops when file A's group-leading line is EOF."""
    while True:
        line = fa.readline()
        if not line:
            return
        out.write(line)
        for _ in range(3):
            out.write(fa.readline())
        for _ in range(4):
            out.write(fb.readline())


def shuffle(path1, path2, out):
    with open(path1) as fa, open(path2) as fb:
        first = fa.read(1)
        fa.seek(0)
        if first == "@":
            shuffle_fastq(fa, fb, out)
        elif first == ">" or first == "":
            shuffle_fasta(fa, fb, out)
        else:
            raise ValueError("Unknown input file format: " + path1)


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        sys.stderr.write(__doc__)
        raise SystemExit(1)
    if len(argv) >= 3:
        with open(argv[2], "w") as out:
            shuffle(argv[0], argv[1], out)
    else:
        shuffle(argv[0], argv[1], sys.stdout)


if __name__ == "__main__":
    main()
