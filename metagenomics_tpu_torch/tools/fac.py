"""Assembly contiguity statistics (N50/N80/N20).

Semantics follow the reference's bundled abyss-fac
(MetaGenomics/Debug/abyss-fac.pl:44-109): sequences shorter than the
threshold (default 200) are counted but excluded; N-statistics walk the
length-sorted contigs from the largest until the cumulative sum crosses the
corresponding fraction of the total (or of --genome-size when given).

Usage: python -m metagenomics_tpu.tools.fac [-t N] [-g SIZE] contigs.fasta...
"""

import argparse
import sys


def fac_stats(path, threshold=200, genome_size=None):
    lengths = []
    short = 0
    total = 0
    seq_len = 0
    have = False
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith(">"):
                if have:
                    if seq_len < threshold:
                        short += 1
                    else:
                        lengths.append(seq_len)
                        total += seq_len
                have = True
                seq_len = 0
            else:
                seq_len += sum(1 for c in line.upper() if c in "ACGT")
    if have:
        if seq_len < threshold:
            short += 1
        else:
            lengths.append(seq_len)
            total += seq_len
    if not lengths:
        return None
    lengths.sort()
    target = genome_size if genome_size is not None else total
    n20 = n50 = n80 = None
    nn50 = 0
    n20sum = n50sum = n80sum = 0
    stack = list(lengths)
    while stack and n80sum < 0.8 * target:
        x = stack.pop()
        if n20sum < 0.2 * target:
            n20 = x
            n20sum += x
        if n50sum < 0.5 * target:
            nn50 += 1
            n50 = x
            n50sum += x
        if n80sum < 0.8 * target:
            n80 = x
            n80sum += x
    return {
        "n": short + len(lengths), "n_kept": len(lengths), "n_n50": nn50,
        "min": lengths[0], "N80": n80, "N50": n50, "N20": n20,
        "max": lengths[-1], "sum": total,
    }


def eng(x):
    """abyss-fac's eng() number shortening (abyss-fac.pl:17-23); perl
    stringifies floats as %.15g (integral values print without '.0')."""
    if x < 10000000:
        return str(x)
    if x < 1000000000:
        return ("%.15g" % (x / 1000000))[:5] + "e6"
    return ("%.15g" % (x / 1000000000))[:5] + "e9"


def format_row(st, path, jira=False):
    """One output row in the reference's perl-format layout: nine
    8-column left-justified fields then the path (abyss-fac.pl:100-109)."""
    vals = [eng(st["n"]), eng(st["n_kept"]), st["n_n50"], st["min"],
            st["N80"], st["N50"], st["N20"], st["max"], eng(st["sum"])]
    if jira:
        return "|" + "|".join("%-7.7s" % v for v in map(str, vals)) \
            + "|" + path + "|"
    return "".join("%-8.8s" % v for v in map(str, vals)) + path


def format_header(threshold, jira=False):
    if jira:
        return ("||n    ||n:%-4s||n:N50 ||min   ||N80   ||N50   ||N20   "
                "||max   ||sum   ||" % threshold)
    return ("n       n:%-5s n:N50   min     N80     N50     N20     max"
            "     sum" % threshold)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-t", "--threshold", type=int, default=200)
    p.add_argument("-g", "--genome-size", type=int, default=None)
    p.add_argument("-j", "--jira", action="store_true")
    p.add_argument("files", nargs="+")
    args = p.parse_args(argv)
    print(format_header(args.threshold, args.jira))
    for path in args.files:
        st = fac_stats(path, args.threshold, args.genome_size)
        if st is None:
            print("warning: `%s' is empty" % path, file=sys.stderr)
            continue
        print(format_row(st, path, args.jira))


if __name__ == "__main__":
    main()
