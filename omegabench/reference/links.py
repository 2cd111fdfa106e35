"""Soundness of the links of an overlap graph: two reads placed one after
the other along an edge overlap exactly where they are placed."""

import numpy as np

BLOCK = 1 << 16


def unsound(reads, a_id, a_fwd, a_pos, b_id, b_fwd, b_pos, min_overlap):
    """Count of links that are not an exact overlap.  Link i places read
    a_id[i] (as itself where a_fwd, else its reverse complement) at
    a_pos[i] and read b_id[i] at b_pos[i] along one spelled string; it is
    sound where b starts after a (d = b_pos - a_pos >= 1), reaches past
    a's end, the two share m = len(a) - d >= min_overlap bases, and those
    bases are equal."""
    lmax = reads.fwd.shape[1]
    k = np.arange(lmax)[None, :]
    bad = 0
    for s in range(0, len(a_id), BLOCK):
        e = min(s + BLOCK, len(a_id))
        ai, bi = a_id[s:e] - 1, b_id[s:e] - 1
        if len(ai) and (min(ai.min(), bi.min()) < 0
                        or max(ai.max(), bi.max()) >= reads.count):
            raise ValueError("a link names a read that does not exist")
        la = reads.lengths[ai]
        lb = reads.lengths[bi]
        d = b_pos[s:e] - a_pos[s:e]
        m = la - d
        shape_ok = (d >= 1) & (m >= min_overlap) & (m < lb)
        A = np.where(a_fwd[s:e, None] != 0, reads.fwd[ai], reads.rev[ai])
        B = np.where(b_fwd[s:e, None] != 0, reads.fwd[bi], reads.rev[bi])
        idx = np.clip(d[:, None] + k, 0, lmax - 1)
        same = (np.take_along_axis(A, idx, axis=1) == B) | (k >= m[:, None])
        bad += int((~(shape_ok & same.all(axis=1))).sum())
    return bad
