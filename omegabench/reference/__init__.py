"""Plain NumPy reference of the assembler's ingest and overlap semantics.

It reads the FASTA files that the benchmark wrote and the program read,
and imports nothing of the program (neither package) and no helper of its
tests: what it knows of reads and overlaps it works out again here.
"""
