"""Flatten multi-line FASTA to one uppercase line per sequence — behavioral
twin of the reference's format_fasta.pl (MetaGenomics/Debug/format_fasta.pl):
leading junk before the first '>' is skipped, carriage returns are stripped,
only sequence text is uppercased, headers pass through verbatim, and the
final record flushes at EOF.

Usage: python -m metagenomics_tpu.tools.format_fasta in.fasta > out.fasta
"""

import sys


def format_fasta(infile, outfile):
    line = ""
    while not line.startswith(">"):
        line = infile.readline()
        if not line:
            return
    outfile.write(line.replace("\r", ""))
    prev = ""
    while True:
        line = infile.readline()
        if not line:
            outfile.write(prev + "\n")
            return
        line = line.replace("\r", "")
        while not line.startswith(">"):
            prev = (prev + line.rstrip("\n")).upper()
            line = infile.readline()
            if not line:
                outfile.write(prev + "\n")
                return
            line = line.replace("\r", "")
        outfile.write(prev + "\n")
        outfile.write(line)
        prev = ""


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if argv:
        with open(argv[0]) as f:
            format_fasta(f, sys.stdout)
    else:
        format_fasta(sys.stdin, sys.stdout)


if __name__ == "__main__":
    main()
