"""Least bytes of the device pipeline's stages, copied from the port's
bench (metagenomics_tpu_torch/bench.py stage_bytes) so that the yardstick
stays here: each stage's real inputs read once and outputs written once,
4 bytes a value (2-bit codes packed 16 to a word, uint32 hashes and keys,
int32 ids, lengths and counts), whatever the port's own passes and
widths.  Generalised to a probe of rows [row0, n1) (the hybrid engine's
device shard), where the index still covers all n reads."""

from omegabench import peaks


def stage_bytes(dims):
    """dims: n1 (rows with the dummy row 0), row0, w (packed words a row),
    npos (window starts a row), h_total (hit queries), survivors (the
    shard's canonical records)."""
    n1, row0, w, npos = dims["n1"], dims["row0"], dims["w"], dims["npos"]
    h, surv = dims["h_total"], dims["survivors"]
    n = n1 - 1
    probed = n1 - row0
    return {
        # in: forward packed words and lengths; out: the reverse strand's
        # packed words, forward hashes, 4n keys and 4n entry words
        "setup_kernel": 4 * (2 * n1 * w + n1 + n1 * npos + 8 * n),
        # in: the probed rows' hashes and lengths, the 4n keys; out: each
        # hit query's id, bucket start and count, the candidate total
        "probe_join": 4 * (probed * npos + probed + 4 * n) + 12 * h + 8,
        # in: the hits, the 4n entry words, both strands' packed words,
        # lengths; out: the survivors' words and the per-read counts
        "emit_verify": (12 * h + 4 * (4 * n + 2 * n1 * w + n1) + 4 * surv
                        + 4 * n1),
    }


def stage_lines(dims, ms):
    """One line per stage: least bytes, mean device ms a construction and
    the share of the data sheet's HBM rate those bytes would need."""
    out = []
    for name, nbytes in stage_bytes(dims).items():
        if name in ms:
            t = ms[name] / 1e3
            out.append("stage %s: least bytes %d, %.6f ms, %.4f%% of %.2f "
                       "TB/s" % (name, nbytes, ms[name],
                                 100 * peaks.least_seconds(nbytes) / t,
                                 peaks.HBM_BYTES_PER_S / 1e12))
    return out
