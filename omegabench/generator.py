"""CAMI-shaped paired-end metagenome samples, made from a seed.

One general generator reads a configuration (the community: genome and
circular-element counts and lengths, the abundance law, read length, insert
libraries, planted repeats) and a traffic mix (read pairs per library), and
writes one interleaved two-line FASTA file per library.

The sample's layout comes from the configuration's `community_seed`: every
length and abundance, each entity's read count, where the repeats lie,
and every fragment's start, insert and strand.  The run seed draws the
bases (genomes and repeat units).  So every seed makes the same overlap
structure, and the same work, over other sequences.  Reads are
error-free: the assembler finds exact overlaps, and its users correct or
trim errors before it.

A configuration may trim its reads.  `"trim": {"source": ..., "length_bins":
[[lo, hi, weight], ...]}` is a histogram of read lengths after trimming,
with the public distribution it was taken from in `source`.  Each read,
each mate on its own, draws a bin by weight and a length uniformly from
lo to hi, and is cut at its 3' end (the end of its record: read 2 is
written reverse-complemented) to that length; a bin at read_length keeps
reads whole.  The lengths come from the `community_seed` too, so every run
seed trims alike.  Without the key no read is cut and no number more is
drawn.
"""

import os

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
COMPLEMENT = np.zeros(256, dtype=np.uint8)
COMPLEMENT[np.frombuffer(b"ACGT", np.uint8)] = np.frombuffer(b"TGCA",
                                                             np.uint8)
NAME_DIGITS = 9
PAIRS_PER_BLOCK = 1 << 17


def community(config):
    """The community the configuration states, with its lengths cut:
    dict of `lengths` (bp, int64), `circular` (bool), `abundance` (relative,
    summing to 1) per entity, genomes first."""
    rng = np.random.default_rng(config["community_seed"])
    ng = config["genomes"]
    nc = config["circular_elements"]
    glo, ghi = config["genome_length_bp"]
    clo, chi = config["circular_length_bp"]
    lengths = np.concatenate([rng.uniform(glo, ghi, ng),
                              rng.uniform(clo, chi, nc)])
    lengths = np.maximum(np.rint(lengths * config["length_scale"]),
                         config["min_length_bp"]).astype(np.int64)
    weights = rng.lognormal(config["abundance_mu"],
                            config["abundance_sigma"], ng + nc)
    return {"lengths": lengths,
            "circular": np.arange(ng + nc) >= ng,
            "abundance": weights / weights.sum()}


def pairs_per_entity(comm, n_pairs):
    """Read pairs of each entity for a library of n_pairs: proportional to
    abundance x length (cells times genome size), rounded by largest
    remainder so that they sum to n_pairs exactly."""
    share = comm["abundance"] * comm["lengths"]
    exact = n_pairs * share / share.sum()
    count = np.floor(exact).astype(np.int64)
    short = n_pairs - int(count.sum())
    count[np.argsort(-(exact - count), kind="stable")[:short]] += 1
    return count


def _plant_repeats(bases_rng, layout_rng, seq, repeats):
    """Copy each repeat family into `seq` (one entity, modified in place):
    a family goes in only where its copies fill at most half of the
    sequence; copy k lies at a random place inside the k-th of `copies`
    equal slots, so copies never overlap."""
    n = len(seq)
    for fam in repeats:
        ln, copies = fam["length_bp"], fam["copies"]
        if ln * copies * 2 > n:
            continue
        unit = BASES[bases_rng.integers(0, 4, ln)]
        slot = n // copies
        for k in range(copies):
            at = k * slot + int(layout_rng.integers(0, slot - ln + 1))
            seq[at:at + ln] = unit


def genomes(config, seed):
    """(bases, starts, comm): every entity's bases in one uint8 array,
    entity i at [starts[i], starts[i] + lengths[i]) and, for a circular
    element, followed by its first bases again (as many as the longest
    fragment needs) so that fragments that wrap read straight on."""
    comm = community(config)
    rng = np.random.default_rng([seed, 1])
    layout_rng = np.random.default_rng([config["community_seed"], 1])
    wrap = max(lib["insert_mean_bp"] for lib in config["libraries"]) * 2
    pieces = []
    starts = []
    at = 0
    for i, (ln, circ) in enumerate(zip(comm["lengths"], comm["circular"])):
        seq = BASES[rng.integers(0, 4, int(ln))]
        if not circ:
            _plant_repeats(rng, layout_rng, seq, config["repeats"])
        else:
            seq = np.concatenate([seq, np.resize(seq, wrap)])
        starts.append(at)
        pieces.append(seq)
        at += len(seq)
    return np.concatenate(pieces), np.asarray(starts, np.int64), comm


def read_lengths(config, li, n_reads):
    """Each read's length in library li, in file order, where the
    configuration trims its reads; None where it does not."""
    trim = config.get("trim")
    if trim is None:
        return None
    if not str(trim.get("source", "")).strip():
        raise ValueError("trim needs the source of its length histogram")
    rl = config["read_length"]
    bins = np.asarray(trim["length_bins"], np.float64).reshape(-1, 3)
    lo, hi, weight = bins.T
    if (lo != np.rint(lo)).any() or (hi != np.rint(hi)).any() \
            or not ((1 <= lo) & (lo <= hi) & (hi <= rl)).all() \
            or not (weight > 0).all():
        raise ValueError("trim bins %s do not fit reads of %d bp"
                         % (trim["length_bins"], rl))
    rng = np.random.default_rng([config["community_seed"], 3, li])
    cum = np.cumsum(weight) / weight.sum()
    b = np.minimum(np.searchsorted(cum, rng.random(n_reads), side="right"),
                   len(cum) - 1)
    span = (hi - lo + 1)[b]
    off = np.minimum((rng.random(n_reads) * span).astype(np.int64),
                     span.astype(np.int64) - 1)
    return lo[b].astype(np.int64) + off


def _fasta_block(reads, first_id, lengths=None):
    """Two-line FASTA records `>r<id>` for a [n, read_len] uint8 block;
    with `lengths`, each read cut to its own."""
    n, rl = reads.shape
    rec = np.empty((n, 1 + NAME_DIGITS + 1 + rl + 1), dtype=np.uint8)
    rec[:, 0] = ord(">")
    ids = np.arange(first_id, first_id + n, dtype=np.int64)
    for d in range(NAME_DIGITS):
        rec[:, NAME_DIGITS - d] = ord("0") + (ids // 10 ** d) % 10
    rec[:, NAME_DIGITS + 1] = ord("\n")
    rec[:, NAME_DIGITS + 2:-1] = reads
    rec[:, -1] = ord("\n")
    if lengths is None:
        return rec.tobytes()
    end = NAME_DIGITS + 2 + lengths          # each record's last newline
    rec[np.arange(n), end] = ord("\n")
    return rec[np.arange(rec.shape[1]) <= end[:, None]].tobytes()


def write_sample(config, traffic, seed, out_dir):
    """Write one interleaved paired-end FASTA file per library into
    out_dir (read 1 of a pair, then read 2, FR orientation).  Returns the
    paths and the sample's counts."""
    libs = config["libraries"]
    pairs = traffic["read_pairs"]
    if len(pairs) != len(libs):
        raise ValueError("traffic gives %d libraries' pairs, the "
                         "configuration has %d" % (len(pairs), len(libs)))
    bases, starts, comm = genomes(config, seed)
    rl = config["read_length"]
    k = np.arange(rl, dtype=np.int64)
    paths = []
    bases_read = 0
    for li, (lib, n_pairs) in enumerate(zip(libs, pairs)):
        rng = np.random.default_rng([config["community_seed"], 2, li])
        per = pairs_per_entity(comm, n_pairs)
        ent = np.repeat(np.arange(len(per)), per)
        rng.shuffle(ent)
        mean = lib["insert_mean_bp"]
        ins = np.rint(rng.normal(mean, lib["insert_sd_frac"] * mean,
                                 len(ent))).astype(np.int64)
        ln = comm["lengths"][ent]
        circ = comm["circular"][ent]
        ins = np.clip(ins, rl, 2 * mean)
        ins = np.where(circ, ins, np.minimum(ins, ln))
        span = np.where(circ, ln, ln - ins + 1)
        pos = starts[ent] + (rng.random(len(ent)) * span).astype(np.int64)
        flip = rng.random(len(ent)) < 0.5
        lens = read_lengths(config, li, 2 * len(ent))
        bases_read += 2 * len(ent) * rl if lens is None else int(lens.sum())
        path = os.path.join(out_dir, "%s_lib%d.fasta" % (config["name"], li))
        with open(path, "wb") as f:
            for s in range(0, len(ent), PAIRS_PER_BLOCK):
                e = min(s + PAIRS_PER_BLOCK, len(ent))
                a = bases[pos[s:e, None] + k]
                b = COMPLEMENT[bases[(pos[s:e] + ins[s:e] - rl)[:, None]
                                     + k[::-1]]]
                fl = flip[s:e, None]
                pair = np.stack([np.where(fl, b, a), np.where(fl, a, b)], 1)
                f.write(_fasta_block(pair.reshape(-1, rl), 2 * s,
                                     None if lens is None
                                     else lens[2 * s:2 * e]))
        paths.append(path)
    stats = {"entities": len(comm["lengths"]),
             "community_bp": int(comm["lengths"].sum()),
             "reads": 2 * int(sum(pairs))}
    stats["mean_coverage"] = bases_read / stats["community_bp"]
    return paths, stats
