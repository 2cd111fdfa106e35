"""The comparison that decides `correct`: what the timed path produced,
against the plain reference (reference/), each number beside its limit.

Where the sample's reads have several lengths, a read found inside a
longer one is contained: the reference's rows and graph leave out every
overlap with a contained read at either end, and a contained read's row
is empty.

Every number compared is exact, so every limit is 0:

- rows_differing: of a sample of reads drawn from the seed (and the four
  with the most overlaps), those whose row of the canonical overlap stream
  that the last timed construction handed to the replay differs from the
  reference's row in any record (read, orientation, offset, flags);
- links_unsound: of every link of the overlap graph that the last timed
  construction left (two reads placed one after the other along an edge),
  those that are not an exact overlap of at least the minimum length;
- links_differing: of the same sample, the reads in the graph whose links
  are not exactly the overlaps the reference keeps (transitive ones
  dropped) with reads in the graph, and the reads missing from it that a
  chain of more than dead_end_length reads keeps there;
- supers_differing (samples of several lengths only): of every read,
  those whose super read (0 for none) differs from the reference's
  (reference/contained.py);
- sorted_reads_differing (assemble): lines of the _sortedReads.fasta
  artifact that differ from the reference's own sorted unique reads;
- contigs1_differing (assemble): records of contigs1.fasta unlike the
  graph's edges spelled from the reference's reads;
- contig_kmers_absent (assemble): 32-base strings of contigs1-4.fasta,
  between 'N' gaps, found on neither strand of the community.
"""

import numpy as np

from omegabench.reference import (contained, contigs, ingest, links,
                                  overlaps, reduced)


class Check:
    def __init__(self, name, value, limit, of):
        self.name, self.value, self.limit, self.of = name, value, limit, of

    @property
    def ok(self):
        return self.value <= self.limit

    def record(self):
        return {"value": self.value, "limit": self.limit, "of": self.of}


# ---------------------------------------------------------- program side

def stream_rows(stream, ids):
    """The program's rows of a canonical stream (counts per read, packed
    words [r2 | flags:4 | offset:off_bits]) as the reference keys them:
    {id: sorted (r2 * 4 + orientation) * 2^16 + offset}, and the ids whose
    records carry any flag but the edge flag."""
    counts, words, ob = stream
    counts = np.asarray(counts, np.int64)
    ends = np.cumsum(counts)
    w = np.asarray(words).astype(np.int64)
    rows, odd = {}, []
    for r in ids:
        seg = w[ends[r] - counts[r]:ends[r]]
        fe = (seg >> ob) & 15
        key = (((seg >> (4 + ob)) * 4 + (fe & 3)) << 16) + (seg & ((1 << ob)
                                                                   - 1))
        rows[int(r)] = np.sort(key)
        if (fe & 12 != 4).any():
            odd.append(int(r))
    return rows, odd


def graph_links(edges):
    """Links of a graph's edges (one of each edge and its twin), given as (source, destination, orient,
    offset, interior reads, their offsets, their orients): the source at
    0 as itself where orient's high bit is set, each interior read at the
    running sum of the offsets as itself where its orient is 1, the
    destination at the edge's offset as itself where orient's low bit is
    set.  Returns the six arrays reference.links.unsound takes."""
    ids, fwd, pos, first = [], [], [], []
    for src, dst, o, off, reads, offs, oris in edges:
        first.append(len(ids))
        ids.append(src)
        fwd.append((o >> 1) & 1)
        pos.append(0)
        ids.extend(reads)
        fwd.extend(oris)
        pos.extend(np.cumsum(offs, dtype=np.int64).tolist())
        ids.append(dst)
        fwd.append(o & 1)
        pos.append(off)
    ids = np.asarray(ids, np.int64)
    fwd = np.asarray(fwd, np.int64)
    pos = np.asarray(pos, np.int64)
    last = np.ones(len(ids), bool)
    last[np.asarray(first[1:], np.int64) - 1] = False
    last[-1:] = False
    a = np.flatnonzero(last)
    return ids[a], fwd[a], pos[a], ids[a + 1], fwd[a + 1], pos[a + 1]


def unitig_edges(path):
    """Edges of a .unitig checkpoint: per edge source, destination,
    orient, offset, n, then n (read, offset, orient) triples."""
    with open(path) as f:
        nums = np.array(f.read().split(), dtype=np.int64)
    edges = []
    i = 0
    while i + 5 <= len(nums):
        src, dst, o, off, n = (int(x) for x in nums[i:i + 5])
        body = nums[i + 5:i + 5 + 3 * n]
        edges.append((src, dst, o, off, body[0::3].tolist(),
                      body[1::3].tolist(), body[2::3].tolist()))
        i += 5 + 3 * n
    return edges


# ---------------------------------------------------------- comparisons

def sample_rows(u, n, seed, stream):
    """n read ids drawn from the seed, plus the four rows of the stream
    with the most records."""
    rng = np.random.default_rng([seed, 7])
    ids = set(rng.choice(np.arange(1, u + 1), size=min(n, u),
                         replace=False).tolist())
    if stream is not None:
        counts = np.asarray(stream[0])
        ids.update(int(r) for r in np.argsort(-counts[1:u + 1])[:4] + 1)
    return np.array(sorted(ids), np.int64)


def rows_check(reads, stream, ids, found, log):
    """rows_differing: the sampled rows against the reference's; found is
    the index's overlaps of the sampled ids."""
    r1, key = found
    keep = (key >> 18) >= r1
    ref = overlaps.split_rows(ids, r1[keep], key[keep])
    if stream is None:
        log("rows: no overlap stream reached the replay in the last step")
        return Check("rows_differing", len(ids), 0, len(ids))
    if len(stream[0]) != reads.count + 1:
        log("rows: the stream has %d rows, the reference %d reads"
            % (len(stream[0]) - 1, reads.count))
        return Check("rows_differing", len(ids), 0, len(ids))
    got, odd = stream_rows(stream, ids)
    bad = [r for r in ids if r in odd or not np.array_equal(got[r], ref[r])]
    n_rec = sum(len(v) for v in ref.values())
    log("rows: %d sampled rows, %d reference records, %d rows differ%s"
        % (len(ids), n_rec, len(bad), (" (first %s)" % bad[:5]) if bad
           else ""))
    return Check("rows_differing", len(bad), 0, len(ids))


def links_check(reads, arrays, min_overlap, log):
    """links_unsound: every link of the graph's edges."""
    n = len(arrays[0])
    bad = links.unsound(reads, *arrays, min_overlap)
    log("links: %d links, %d unsound" % (n, bad))
    return Check("links_unsound", bad, 0, n)


def completeness_check(index, arrays, ids, found, config, log, sup=None):
    """links_differing: each sampled read's links in the graph against the
    overlaps the reference keeps (sup: the reference's super reads, where
    the sample has contained reads)."""
    a_id, a_fwd, a_pos, b_id, b_fwd, b_pos = arrays
    present = np.unique(np.concatenate([a_id, b_id]))
    # each link seen from both of its reads: a then b, and b's other
    # strand then a's, which the edge's twin spells
    d = b_pos - a_pos
    lens = index.reads.lengths
    first = np.concatenate([a_id, b_id])
    key = np.concatenate([
        ((b_id * 4 + 2 * a_fwd + b_fwd) << 16) + d,
        ((a_id * 4 + 2 * (1 - b_fwd) + 1 - a_fwd) << 16)
        + d + lens[b_id - 1] - lens[a_id - 1]])
    order = np.lexsort((key, first))
    got = overlaps.split_rows(ids, first[order], key[order])
    ref = reduced.Reduced(index, config["min_overlap"], sup)
    ref.compute(ids, found)
    is_in = np.isin(ids, present)
    need = ref.must_be_present(ids[~is_in], config["dead_end_length"])
    bad = []
    for r, inside in zip(ids.tolist(), is_in.tolist()):
        if inside:
            want = ref.links[r]
            want = want[np.isin(want >> 18, present)]
            if not np.array_equal(got[r], want):
                bad.append(r)
        elif r in need:
            bad.append(r)
    log("graph: %d of %d sampled reads in it (%d kept links), %d missing "
        "that must be there, %d differ%s"
        % (int(is_in.sum()), len(ids), sum(len(v) for v in got.values()),
           len(need), len(bad), (" (first %s)" % bad[:5]) if bad else ""))
    return Check("links_differing", len(bad), 0, len(ids))


def read_lines(path, log):
    try:
        with open(path, "rb") as f:
            return f.read().splitlines()
    except OSError as exc:
        log("sorted reads: none (%s)" % exc)
        return []


def sorted_reads_check(reads, lines, log, sup=None):
    """sorted_reads_differing: the lines of the _sortedReads.fasta
    artifact, one a read '<id:10> Noncontained|Contained in <super:10>
    <sequence>', against the reference's reads and super reads (sup;
    None: every read is non-contained, as in a sample of one length)."""
    n = max(len(lines), reads.count)
    bad = abs(len(lines) - reads.count)
    for i, line in enumerate(lines[:reads.count]):
        s = 0 if sup is None else int(sup[i + 1])
        want = b"%10d %s %10d %s" % (
            i + 1, b"Contained in" if s else b"Noncontained", s,
            reads.fwd[i, :reads.lengths[i]].tobytes())
        bad += line != want
    log("sorted reads: %d lines, %d reference reads, %d differ"
        % (len(lines), reads.count, bad))
    return Check("sorted_reads_differing", bad, 0, n)


def sorted_reads_supers(lines):
    """Super reads [len(lines) + 1] as _sortedReads.fasta lines state
    them, in the super read's column; -1 where a line has none."""
    out = np.full(len(lines) + 1, -1, np.int64)
    out[0] = 0
    for i, line in enumerate(lines):
        try:
            out[i + 1] = int(line[24:34])
        except ValueError:
            pass
    return out


def supers_check(sup, got, log):
    """supers_differing: the reads whose super read in the program (got,
    by read id; 0 for none) differs from the reference's (sup), over every
    read of the sample."""
    n = len(sup) - 1
    if got is None or len(got) != len(sup):
        log("supers: the program's %s super reads, the reference's %d"
            % ("no" if got is None else len(got) - 1, n))
        return Check("supers_differing", n, 0, n)
    bad = np.flatnonzero(np.asarray(got, np.int64)[1:] != sup[1:]) + 1
    log("supers: %d of %d reads contained, %d differ%s"
        % (int((sup > 0).sum()), n, len(bad),
           (" (first %s)" % bad[:5].tolist()) if len(bad) else ""))
    return Check("supers_differing", len(bad), 0, n)


def contig_checks(reads, edges, prefix, config, seed, log):
    """contigs1_differing and contig_kmers_absent over the contig files an
    assembly wrote at `prefix`."""
    from omegabench import generator
    records = {}
    for stage in (1, 2, 3, 4):
        path = "%scontigs%d.fasta" % (prefix, stage)
        try:
            records[stage] = contigs.read_records(path)
        except (OSError, ValueError) as exc:
            log("contigs%d: none readable (%s)" % (stage, exc))
            records[stage] = None
    bases, starts, comm = generator.genomes(config, seed)
    table = contigs.community_kmers(bases, starts, comm["lengths"],
                                    comm["circular"])
    del bases
    absent = total = 0
    for stage, recs in records.items():
        if recs is None:
            absent += 1         # a stage with no readable file is not sound
            continue
        a, t = contigs.kmers_absent(recs, table)
        log("contigs%d: %d records, %d of %d %d-mers absent from the "
            "community" % (stage, len(recs), a, t, contigs.K))
        absent += a
        total += t
    if records[1] is None:
        differ = len(edges) or 1
    else:
        differ = contigs.stage1_differing(reads, edges, records[1])
    log("contigs1: %d records unlike the graph's edges" % differ)
    return [Check("contigs1_differing", differ, 0,
                  len(records[1] or ())),
            Check("contig_kmers_absent", absent, 0, total)]


def several_lengths(reads):
    return reads.count > 0 and reads.lengths.min() != reads.lengths.max()


def check_outputs(outputs, fasta, config, traffic, seed, log):
    """Every check of a run's outputs."""
    mo = config["min_overlap"]
    reads = ingest.load(fasta, mo)
    # only a sample of several lengths has contained reads
    sup = contained.supers(reads) if several_lengths(reads) else None
    index = overlaps.StrandIndex(reads)
    stream = outputs.get("stream")
    ids = sample_rows(reads.count, traffic["check_rows"], seed, stream)
    found = contained.without_contained(index.overlaps(ids, mo), sup)
    edges = outputs.get("edges", [])
    arrays = graph_links(edges) if edges else (np.zeros(0, np.int64),) * 6
    checks = [rows_check(reads, stream, ids, found, log),
              links_check(reads, arrays, mo, log),
              completeness_check(index, arrays, ids, found, config, log,
                                 sup)]
    lines = (read_lines(outputs["sorted_reads"], log)
             if "sorted_reads" in outputs else None)
    if sup is not None:
        got = (outputs.get("supers") if lines is None
               else sorted_reads_supers(lines))
        checks.append(supers_check(sup, got, log))
    if lines is not None:
        checks.append(sorted_reads_check(reads, lines, log, sup))
    if "contigs" in outputs:
        checks += contig_checks(reads, edges, outputs["contigs"], config,
                                seed, log)
    return checks
