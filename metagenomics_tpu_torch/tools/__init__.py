"""Offline evaluation / preparation tooling.

Python re-expressions of the reference's Debug/ perl scripts:
abyss-fac.pl (contiguity stats), format_fasta.pl, shuffleSequences_*.pl.
"""
