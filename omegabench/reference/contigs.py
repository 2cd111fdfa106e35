"""What the late phases' contig files may hold, from the community itself.

A contig spells reads laid one after another along a path of the graph;
two reads next to each other overlap exactly, by min_overlap bases or
more along the graph's edges, or by 10 bases or more where scaffolding
joins two edges, or the contig marks the break with 'N'.  So every string
of K bases of a contig that holds no 'N' (K <= min_overlap + 1) lies
inside one read, and with error-free reads inside the community, on one
strand or the other, or spans a join of two reads that the community
holds where the join is right.  The stage-1 contigs are the graph's edges
as construction left them, each spelled from its reads.
"""

import re

import numpy as np

K = 32                      # bases a k-mer: 2 bits each in one uint64
CODE = np.full(256, 255, np.uint8)
CODE[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
COMPLEMENT = np.zeros(256, np.uint8)
COMPLEMENT[np.frombuffer(b"ACGTN", np.uint8)] = np.frombuffer(b"TGCAN",
                                                              np.uint8)
HEADER = re.compile(rb"^>\S+ .*Edge +\( *(\d+), *(\d+)\)")


def canonical_kmers(seq):
    """Canonical (the smaller of the two strands') 2-bit codes of every
    K-mer of an ACGT uint8 array, as uint64."""
    n = len(seq) - K + 1
    if n <= 0:
        return np.zeros(0, np.uint64)
    c = CODE[seq].astype(np.uint64)
    rc = (np.uint64(3) - c)[::-1]
    fwd = np.zeros(n, np.uint64)
    rev = np.zeros(n, np.uint64)
    for j in range(K):
        fwd = (fwd << np.uint64(2)) | c[j:j + n]
        rev = (rev << np.uint64(2)) | rc[j:j + n]
    return np.minimum(fwd, rev[::-1])


def community_kmers(bases, starts, lengths, circular):
    """Sorted unique canonical K-mers of every entity; a circular
    element's run on past its end (the generator lays its first bases
    again after it)."""
    out = []
    for s, ln, circ in zip(starts.tolist(), lengths.tolist(),
                           circular.tolist()):
        out.append(canonical_kmers(bases[s:s + ln + (K - 1 if circ
                                                       else 0)]))
    return np.unique(np.concatenate(out))


def read_records(path):
    """(source, destination, sequence) of each record of a contig file."""
    with open(path, "rb") as f:
        data = f.read()
    records = []
    for block in data.split(b">")[1:]:
        head, _, body = block.partition(b"\n")
        m = HEADER.match(b">" + head)
        if m is None:
            raise ValueError("%s: a record without its edge: %r"
                             % (path, head[:80]))
        records.append((int(m.group(1)), int(m.group(2)),
                        body.replace(b"\n", b"")))
    return records


def kmers_absent(records, table):
    """(K-mers of the records' sequences, split at 'N', not in the
    community's table; K-mers counted)."""
    absent = total = 0
    for _, _, seq in records:
        for piece in seq.split(b"N"):
            km = canonical_kmers(np.frombuffer(piece, np.uint8))
            if not len(km):
                continue
            at = np.minimum(np.searchsorted(table, km), len(table) - 1)
            absent += int((table[at] != km).sum())
            total += len(km)
    return absent, total


def spell(reads, edge):
    """The sequence an edge spells, from the reference's reads: the source
    read, then each next read's bases past the one before it."""
    src, dst, o, off, ids, offs, oris = edge
    rows = [src] + list(ids) + [dst]
    fwd = [(o >> 1) & 1] + list(oris) + [o & 1]
    rel = list(offs) + [off - sum(offs)]
    parts = [strand(reads, src, fwd[0])]
    prev = len(parts[0])
    for r, f, d in zip(rows[1:], fwd[1:], rel):
        s = strand(reads, r, f)
        sub = len(s) + d - prev
        parts.append(s[len(s) - sub:] if sub > 0 else b"")
        prev = len(s)
    return b"".join(parts)


def strand(reads, r, fwd):
    m = reads.fwd if fwd else reads.rev
    return m[r - 1, :reads.lengths[r - 1]].tobytes()


def reverse_complement(seq):
    return COMPLEMENT[np.frombuffer(seq, np.uint8)[::-1]].tobytes()


def stage1_differing(reads, edges, records):
    """Records of the stage-1 contig file unlike the graph's edges spelled
    by the reference (one record an edge and its twin: the twin whose
    source is the lower read; of a loop, either), counted both ways."""
    want = {}
    for e in edges:
        src, dst = e[0], e[1]
        if src > dst:
            continue
        s = spell(reads, e)
        if src == dst:
            s = min(s, reverse_complement(s))
        want[(src, dst, s)] = want.get((src, dst, s), 0) + 1
    for k in [k for k in want if k[0] == k[1]]:
        want[k] //= 2                      # a loop and its twin: one record
    got = {}
    for src, dst, s in records:
        if src == dst:
            s = min(s, reverse_complement(s))
        got[(src, dst, s)] = got.get((src, dst, s), 0) + 1
    return sum(abs(got.get(k, 0) - want.get(k, 0))
               for k in set(got) | set(want))
