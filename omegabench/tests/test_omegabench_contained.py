"""The contained-read reference: the rule its docstring states, checked
by hand-made cases, by brute force, and against the assembler's own
_sortedReads.fasta on the mixed-length golden sets."""

import os

import numpy as np
import pytest

from omegabench.reference import contained, ingest
from omegabench_helpers import ROOT

BASES = np.frombuffer(b"ACGT", np.uint8)


def reads_of(seqs):
    """Reads as the ingest reference keeps them: canonical, sorted,
    unique."""
    lmax = max(len(s) for s in seqs)
    mat = np.zeros((len(seqs), lmax), np.uint8)
    for i, s in enumerate(seqs):
        mat[i, :len(s)] = np.frombuffer(s, np.uint8)
    lens = np.array([len(s) for s in seqs], np.int64)
    fwd = mat.view("S%d" % lmax).ravel()
    rev = ingest.reverse_complement(mat, lens).view("S%d" % lmax).ravel()
    uniq = np.unique(np.where(fwd <= rev, fwd, rev))
    out = uniq.view(np.uint8).reshape(len(uniq), lmax)
    return ingest.Reads(out, (out != 0).sum(axis=1).astype(np.int64))


def seq(rng, n):
    return BASES[rng.integers(0, 4, n)].tobytes()


def rc(s):
    return ingest.COMPLEMENT[np.frombuffer(s, np.uint8)[::-1]].tobytes()


def id_of(reads, s):
    """The id of a read, given either strand."""
    for i in range(reads.count):
        r = reads.fwd[i, :reads.lengths[i]].tobytes()
        if r in (s, rc(s)):
            return i + 1
    raise KeyError(s)


def brute_force(reads):
    """The rule by its words: b inside a strictly longer a, either strand,
    any placement; the lowest id among the longest containers."""
    strands = [(reads.fwd[i, :n].tobytes(), reads.rev[i, :n].tobytes())
               for i, n in enumerate(reads.lengths.tolist())]
    out = np.zeros(reads.count + 1, np.int64)
    for b, (bf, br) in enumerate(strands):
        best = None
        for a, (af, _) in enumerate(strands):
            if len(af) > len(bf) and (bf in af or br in af):
                if best is None or len(af) > len(strands[best][0]):
                    best = a
        out[b + 1] = 0 if best is None else best + 1
    return out


@pytest.mark.parametrize("place", ["prefix", "suffix", "inside"])
@pytest.mark.parametrize("strand", ["forward", "reverse"])
def test_every_placement_is_found(place, strand):
    """The probe never queries a read's own first or last l-mer: a read
    that is a prefix or a suffix of a longer one is found all the same."""
    rng = np.random.default_rng(5)
    a = seq(rng, 150)
    at = {"prefix": 0, "suffix": 90, "inside": 37}[place]
    b = a[at:at + 60]
    if strand == "reverse":
        b = rc(b)
    other = seq(rng, 100)
    reads = reads_of([a, b, other])
    sup = contained.supers(reads)
    assert sup[id_of(reads, b)] == id_of(reads, a)
    assert sup[id_of(reads, a)] == 0 and sup[id_of(reads, other)] == 0


def test_one_base_off_is_not_contained():
    rng = np.random.default_rng(6)
    a = seq(rng, 150)
    b = bytearray(a[0:60])
    b[59] = ord("A") if b[59] != ord("A") else ord("C")
    reads = reads_of([a, bytes(b)])
    assert (contained.supers(reads) == 0).all()


def test_super_is_the_lowest_of_the_longest():
    """The first container is replaced by a strictly longer one only: the
    super read is the lowest-numbered container of the greatest length,
    whatever the lower-numbered shorter ones."""
    rng = np.random.default_rng(7)
    g = seq(rng, 400)
    b = g[100:160]
    containers = [g[90:170], g[95:175], g[60:180], g[50:170], g[70:190]]
    reads = reads_of([b] + containers)
    sup = contained.supers(reads)
    longest = [id_of(reads, c) for c in containers if len(c) == 120]
    assert sup[id_of(reads, b)] == min(longest)
    # the shorter containers are contained themselves, in the longest
    assert sup[id_of(reads, g[90:170])] in longest
    first = contained.supers(reads, first_wins=True)
    assert first[id_of(reads, b)] == min(id_of(reads, c)
                                         for c in containers)


def test_one_length_has_none():
    rng = np.random.default_rng(8)
    g = seq(rng, 500)
    reads = reads_of([g[i:i + 100] for i in range(0, 400, 7)])
    assert (contained.supers(reads) == 0).all()


@pytest.mark.parametrize("seed", range(4))
def test_agrees_with_brute_force(seed):
    """Reads of random lengths from a small genome with a repeat, so that
    many are contained, some in several reads of several lengths."""
    rng = np.random.default_rng(seed)
    g = bytearray(seq(rng, 700))
    g[500:560] = g[100:160]
    g = bytes(g)
    seqs = []
    for _ in range(160):
        n = int(rng.integers(41, 121))
        at = int(rng.integers(0, len(g) - n + 1))
        s = g[at:at + n]
        seqs.append(rc(s) if rng.random() < 0.5 else s)
    reads = reads_of(seqs)
    sup = contained.supers(reads)
    assert (sup > 0).sum() > 20
    assert np.array_equal(sup, brute_force(reads))


@pytest.mark.parametrize("name,files", [
    ("se_mixlen", ["se_mixlen.fasta"]),
    ("mix_ps", ["pe_small.fasta", "se_mixlen.fasta"]),
    ("se_heap", ["se_heap.fasta"])])
def test_matches_the_assemblers_sorted_reads(name, files):
    """The golden sets' _sortedReads.fasta, written by the assembler
    itself (-l 40): every line, its order, sequence and super read, equals
    the references' ingest and containment."""
    golden = os.path.join(ROOT, "golden")
    reads = ingest.load([os.path.join(golden, "data", f) for f in files],
                        40)
    sup = contained.supers(reads)
    with open(os.path.join(golden, "out", name, "g__sortedReads.fasta"),
              "rb") as f:
        lines = f.read().splitlines()
    want = [b"%10d %s %10d %s" % (
        i + 1, b"Contained in" if sup[i + 1] else b"Noncontained",
        sup[i + 1], reads.fwd[i, :reads.lengths[i]].tobytes())
        for i in range(reads.count)]
    assert (sup > 0).sum() > 1000
    assert lines == want


@pytest.mark.parametrize("wrong", [1, 37, 200])
def test_supers_check_counts_every_read(wrong):
    """supers_differing compares every read's super read, not a sample's:
    one wrong super read anywhere moves it, and a missing array counts
    every read."""
    from omegabench import check
    rng = np.random.default_rng(wrong)
    sup = np.concatenate([[0], rng.integers(0, 5, 200) * (rng.random(200)
                                                          < 0.4)])
    assert check.supers_check(sup, sup.copy(), lambda m: None).value == 0
    got = sup.copy()
    got[wrong] = sup[wrong] + 1
    c = check.supers_check(sup, got, lambda m: None)
    assert (c.value, c.of) == (1, 200)
    assert check.supers_check(sup, None, lambda m: None).value == 200
