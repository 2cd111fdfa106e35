"""Share of a construction's unique reads that are contained in a longer
read: 100 x contained reads (counter assembler.contained_reads) over
unique reads (counter assembler.unique_reads), each the mean a
construction over the window's constructions."""

from omegabench.program_trace import count_sum


def read(run):
    unique = count_sum(run, "assembler.unique_reads")
    if unique <= 0:
        raise LookupError("no unique reads in the window")
    return 100.0 * count_sum(run, "assembler.contained_reads") / unique
