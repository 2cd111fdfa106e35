"""The sample generator: one seed, one sample; the sample as the
configuration states it."""

import hashlib
import json
import os

import numpy as np
import pytest

from omegabench import generator
from omegabench.reference.ingest import read_fasta, reverse_complement
from omegabench_helpers import BENCH_DIR, TINY_CONFIG, TINY_PAIRS


def config(name, **tiny):
    with open(os.path.join(BENCH_DIR, "configs", name + ".json")) as f:
        c = json.load(f)
    c.update(tiny)
    return c


def digest(paths):
    h = hashlib.sha256()
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def test_same_seed_same_sample(tmp_path):
    c = config("cami-low", **TINY_CONFIG)
    t = {"read_pairs": TINY_PAIRS["construct"]}
    paths = []
    for d, seed in (("a", 7), ("b", 7), ("c", 8)):
        os.makedirs(tmp_path / d)
        p, _ = generator.write_sample(c, t, seed, str(tmp_path / d))
        paths.append(p)
    assert digest(paths[0]) == digest(paths[1])
    assert digest(paths[0]) != digest(paths[2])


def test_large_seed(tmp_path):
    c = config("cami-low", **TINY_CONFIG)
    p, stats = generator.write_sample(c, {"read_pairs": [100]},
                                      2 ** 31 + 12345, str(tmp_path))
    assert stats["reads"] == 200


@pytest.mark.parametrize("name", ["cami-low", "cami-medium"])
def test_community_matches_config(name):
    """Full-size community: entity counts, lengths cut by the stated
    factor inside the stated ranges (raised to the floor), log-normal
    weights, and the cut mean coverage the file records."""
    c = config(name)
    comm = generator.community(c)
    ng, nc = c["genomes"], c["circular_elements"]
    assert len(comm["lengths"]) == ng + nc
    assert (~comm["circular"][:ng]).all() and comm["circular"][ng:].all()
    f = c["length_scale"]
    lo, hi = c["genome_length_bp"]
    g = comm["lengths"][:ng]
    assert (g >= max(lo * f, c["min_length_bp"]) - 1).all()
    assert (g <= max(hi * f, c["min_length_bp"]) + 1).all()
    lo, hi = c["circular_length_bp"]
    e = comm["lengths"][ng:]
    assert (e >= max(lo * f, c["min_length_bp"]) - 1).all()
    assert (e <= max(hi * f, c["min_length_bp"]) + 1).all()
    assert comm["abundance"].sum() == pytest.approx(1.0)
    # the weights are exp of a normal(mu, sigma) draw: their logs' spread
    # is sigma's, whatever the normalisation shifts
    assert np.std(np.log(comm["abundance"])) == pytest.approx(
        c["abundance_sigma"], rel=0.35)
    reads = 2 * sum(c["cut"]["read_pairs"])
    cov = reads * c["read_length"] / comm["lengths"].sum()
    assert cov == pytest.approx(c["cut"]["mean_coverage_x"], rel=0.01)


def test_pairs_follow_abundance_times_length():
    c = config("cami-medium")
    comm = generator.community(c)
    per = generator.pairs_per_entity(comm, 100000)
    assert per.sum() == 100000
    share = comm["abundance"] * comm["lengths"]
    assert np.abs(per - 100000 * share / share.sum()).max() <= 1


@pytest.mark.parametrize("name,traffic", [("cami-low", "construct"),
                                          ("cami-medium", "assemble")])
def test_reads_and_inserts_match_config(tmp_path, name, traffic):
    """Every read has the stated length and lies in the community (either
    strand); each pair is FR, and its insert, measured by finding both
    reads on the genomes, has the library's mean."""
    c = config(name, **TINY_CONFIG)
    pairs = TINY_PAIRS[traffic]
    paths, stats = generator.write_sample(c, {"read_pairs": pairs}, 99,
                                          str(tmp_path))
    bases, starts, comm = generator.genomes(c, 99)
    rl = c["read_length"]
    where = {}
    repeated = set()
    for i in range(len(bases) - rl + 1):
        key = bases[i:i + rl].tobytes()
        if key in where:
            repeated.add(key)
        where.setdefault(key, i)
    for lib, path, n in zip(c["libraries"], paths, pairs):
        mat, lengths = read_fasta(path)
        assert len(lengths) == 2 * n and (lengths == rl).all()
        rc = reverse_complement(mat, lengths)
        inserts = []
        for k in range(0, len(mat), 2):
            a, b = mat[k].tobytes(), mat[k + 1].tobytes()
            ra, rb = rc[k].tobytes(), rc[k + 1].tobytes()
            if a in where and rb in where:       # forward fragment
                lo, hi = where[a], where[rb] + rl
            else:                                # reverse fragment
                assert b in where and ra in where
                lo, hi = where[b], where[ra] + rl
            ent = np.searchsorted(starts, lo, side="right") - 1
            # pairs placed once (no read in a planted repeat), of linear
            # genomes that hold two inserts: no wrap, no clipping
            if repeated & {a, b, ra, rb}:
                continue
            if (not comm["circular"][ent] and comm["lengths"][ent]
                    >= 2 * lib["insert_mean_bp"]):
                inserts.append(hi - lo)
        assert len(inserts) > 100
        assert np.mean(inserts) == pytest.approx(lib["insert_mean_bp"],
                                                 rel=0.03)
    assert stats["reads"] == 2 * sum(pairs)


# ------------------------------------------------------------ trimming

# sha256 of every file of a tiny sample, written by the generator before
# it could trim: without `trim` a sample stays byte for byte the same
UNTRIMMED = {
    ("cami-low", "construct", 5):
        "a73a3c7faf2e6a158bcbfffadca222a64cfeb838a732a7b7110d3a930666b625",
    ("cami-low", "construct", 2 ** 31 + 77):
        "6113d0d9d41d3d25cce037dfe4ec443288fb4611047a6ec13e232784f89497a6",
    ("cami-medium", "assemble", 5):
        "cdf4f36272823737606e0b178afd7f11a7842dc808f7dfd0d1b0ec0b5b20db38",
    ("cami-medium", "assemble", 2 ** 31 + 77):
        "370f28221df290d4fd07f405285885fb56e6fb27d302c79bb1db984c1626008b",
}


@pytest.mark.parametrize("name,traffic,seed", sorted(UNTRIMMED))
def test_untrimmed_sample_unchanged(tmp_path, name, traffic, seed):
    c = config(name, **TINY_CONFIG)
    paths, stats = generator.write_sample(
        c, {"read_pairs": TINY_PAIRS[traffic]}, seed, str(tmp_path))
    assert digest(paths) == UNTRIMMED[(name, traffic, seed)]
    assert stats["mean_coverage"] == (stats["reads"] * c["read_length"]
                                      / stats["community_bp"])


def trimmed_and_whole(tmp_path, name, traffic, seed, trim):
    """Per library: the reads of a trimmed sample and of the same sample
    untrimmed, (matrix, lengths) each."""
    out = []
    for sub, t in (("trim", trim), ("whole", None)):
        c = config(name, **TINY_CONFIG)
        if t is not None:
            c["trim"] = t
        os.makedirs(tmp_path / sub)
        paths, _ = generator.write_sample(
            c, {"read_pairs": TINY_PAIRS[traffic]}, seed,
            str(tmp_path / sub))
        out.append([read_fasta(p) for p in paths])
    return list(zip(*out))


@pytest.mark.parametrize("name,traffic", [("cami-low", "construct"),
                                          ("cami-medium", "assemble")])
def test_trim_follows_config(tmp_path, name, traffic):
    """Each bin's share of the reads, lengths uniform within a bin, and
    cuts at the 3' end only: each trimmed read is a prefix of the read the
    same draw makes untrimmed."""
    trim = {"source": "none: a made-up histogram for tests",
            "length_bins": [[150, 150, 6], [100, 149, 1], [60, 99, 3]]}
    for (mat, lens), (whole, wl) in trimmed_and_whole(tmp_path, name,
                                                      traffic, 11, trim):
        assert (wl == 150).all() and len(lens) == len(wl)
        assert lens.min() == 60 and lens.max() == 150
        share = [np.mean(lens == 150), np.mean((lens >= 100) & (lens < 150)),
                 np.mean(lens < 100)]
        assert share == pytest.approx([0.6, 0.1, 0.3], abs=0.03)
        # uniform over the 40 lengths of 60-99: each tenth of the range
        # about a tenth of that bin
        low = lens[lens < 100]
        tenth = np.bincount((low - 60) // 4, minlength=10)
        assert np.abs(tenth / len(low) - 0.1).max() < 0.03
        k = np.arange(mat.shape[1])[None, :]
        assert (np.where(k < lens[:, None], whole[:, :mat.shape[1]] == mat,
                         mat == 0)).all()


def test_trim_lengths_same_for_every_run_seed(tmp_path):
    trim = {"source": "none: a made-up histogram for tests",
            "length_bins": [[150, 150, 1], [41, 120, 1]]}
    a = trimmed_and_whole(tmp_path / "a", "cami-low", "construct", 3, trim)
    b = trimmed_and_whole(tmp_path / "b", "cami-low", "construct",
                          2 ** 31 + 9, trim)
    for ((ma, la), _), ((mb, lb), _) in zip(a, b):
        assert np.array_equal(la, lb)
        assert not np.array_equal(ma, mb)


@pytest.mark.parametrize("trim", [
    {"source": "none: test", "length_bins": [[60, 151, 1]]},
    {"source": "none: test", "length_bins": [[0, 149, 1]]},
    {"source": "none: test", "length_bins": [[90, 80, 1]]},
    {"source": "none: test", "length_bins": [[150, 150, 1], [60, 149, 0]]},
    {"source": "", "length_bins": [[60, 149, 1]]},
    {"length_bins": [[60, 149, 1]]}])
def test_trim_refuses_a_histogram_it_cannot_draw(tmp_path, trim):
    """Bins outside 1..read_length, empty ones, a weight of 0 and a
    histogram with no source are refused."""
    c = config("cami-low", **TINY_CONFIG)
    c["trim"] = trim
    with pytest.raises(ValueError):
        generator.write_sample(c, {"read_pairs": [10]}, 1, str(tmp_path))
