"""A numpy model of the emit_verify kernel (csrc/emit_verify.cu), step for
step where its steps decide a result: owners from one search a tile, the
later buckets' first-slot marks and a max-scan (a per-slot search where
the marks overflow the tile), the length tests and the deduplicating
skip before any row is compared, windows compared on the low 32 bits of
the int64-held words by funnel shifts, survivors kept in slot order, and
per-read counts.  The CPU tests hold it equal to the plain _emit2; the
card check uses it to count the slots whose rows the kernel compares."""

import numpy as np

TILE = 1024          # csrc/emit_verify.cu kTile
QMASK = 0x3FFFFFFF
M32 = 0xFFFFFFFF


def owners(cum, total, tile=TILE):
    """Each slot's bucket, the kernel's way (cum: int64 inclusive sums)."""
    nh = len(cum)
    out = np.empty(total, np.int64)
    x = np.arange(1, tile)
    for k0 in range(0, total, tile):
        end = min(k0 + tile, total)
        o0 = int(np.searchsorted(cum, k0, side="right"))
        if o0 + tile < nh and cum[o0 + tile - 1] < end:
            out[k0:end] = np.searchsorted(cum, np.arange(k0, end),
                                          side="right")
            continue
        b = o0 + x
        live = b < nh
        b, xb = b[live], x[live]
        st = cum[b - 1]
        mark = (st < end) & (cum[b] > st)
        own = np.zeros(tile, np.int64)
        own[st[mark] - k0] = xb[mark]
        out[k0:end] = o0 + np.maximum.accumulate(own)[:end - k0]
    return out


def _word_offset(s, qw_max):
    q = s >> 4
    return np.where((q >= 1) & (q <= qw_max), q, 0)


def windows_equal(p32, ra, s1, rb, s2, m, w, qw_max):
    """The m bases from base s1 of rows ra equal those from base s2 of rows
    rb (p32: [rows, wp] uint32 words)."""
    q1, q2 = _word_offset(s1, qw_max), _word_offset(s2, qw_max)
    sh1 = ((s1 & 15) * 2).astype(np.uint64)
    sh2 = ((s2 & 15) * 2).astype(np.uint64)
    nw = np.minimum((m + 15) >> 4, w)
    eq = np.ones(len(ra), bool)

    def word(r, q, sh, i):
        lo = p32[r, q + i].astype(np.uint64)
        hi = p32[r, q + i + 1].astype(np.uint64)
        return ((hi << np.uint64(32) | lo) >> sh) & np.uint64(M32)

    for i in range(w):
        x = word(ra, q1, sh1, i) ^ word(rb, q2, sh2, i)
        nb = np.clip(m - 16 * i, 0, 16).astype(np.uint64)
        mask = np.where(nb >= 16, np.uint64(M32),
                        (np.uint64(1) << (np.uint64(2) * nb)) - np.uint64(1))
        eq &= (i >= nw) | ((x & mask) == 0)
    return eq


def emit2(packed2, lengths, rk_pad, rleft_pad, rcnt_pad, sid, h0, nh, row0,
          hash_len, cap, npos, w, qw_max, check_cont, off_bits, uniform_len,
          dedup, tile=TILE):
    """The kernel's results from numpy arrays (packed2 int64 [2 n1, wp]):
    (survivors, keep_counts int32, n_keep, compared).  survivors is the
    first n_keep words (int64) or (r2, meta) int32 arrays; compared counts
    the slots whose rows the kernel reads (a slot that runs both tests
    counts once)."""
    p32 = np.asarray(packed2).astype(np.uint32)
    lengths = np.asarray(lengths).astype(np.int64)
    n1 = len(lengths)
    nrows = p32.shape[0] // 2
    l = hash_len
    lmax = npos + l - 1
    cum = np.cumsum(np.asarray(rcnt_pad[h0:h0 + nh]).astype(np.int64))
    total = int(min(cum[-1] if nh else 0, cap))
    k = np.arange(total)
    b = owners(cum, total, tile)
    start = np.where(b > 0, cum[np.maximum(b - 1, 0)], 0)
    src = np.clip(k - start + np.asarray(rleft_pad)[h0 + b], 0,
                  len(sid) - 1)
    e = np.asarray(sid)[src]
    r2, orient = e >> 2, e & 3
    qid = np.asarray(rk_pad)[h0 + b] & QMASK
    j = qid % npos
    r1 = np.clip(row0 + qid // npos, 0, n1 - 1)
    if uniform_len >= 0:
        len1 = np.full(total, uniform_len, np.int64)
        len2 = len1
    else:
        len1, len2 = lengths[r1], lengths[r2]
    is_pre = (orient & 1) == 0
    is_rev = orient > 1
    rev_shift = np.where(is_rev, lmax - len2, 0)
    row2 = r2 + np.where(is_rev, nrows, 0)

    cont = np.zeros(total, bool)
    if check_cont:
        m2 = len2 - l
        ok_c = (np.where(is_pre, len1 - j - l >= m2, j >= m2)
                & (len1 > len2) & (len2 > l))
        s1 = np.maximum(np.where(is_pre, j, j - m2), 0)
        i = np.flatnonzero(ok_c)
        cont[i] = windows_equal(p32, r1[i], s1[i], row2[i], rev_shift[i],
                                len2[i], w, qw_max)
    else:
        ok_c = cont
    ok_e = np.where(is_pre, len1 - j < len2, len2 - l >= j)
    run_e = ok_e & ((not dedup) | (r1 <= r2) | cont)
    edge = np.zeros(total, bool)
    i = np.flatnonzero(run_e)
    s2 = np.maximum(np.where(is_pre, 0, len2 - l - j), 0)
    edge[i] = windows_equal(p32, r1[i], np.where(is_pre, j, 0)[i], row2[i],
                            (s2 + rev_shift)[i],
                            np.where(is_pre, len1 - j, j + l)[i], w, qw_max)
    keep = ((edge & (r1 <= r2)) | cont) if dedup else (edge | cont)

    eo = np.array([3, 0, 2, 1])[orient]
    fe = eo | (edge.astype(np.int64) << 2) | (cont.astype(np.int64) << 3)
    eoff = np.where(is_pre, j, len1 - l - j)
    kept = np.flatnonzero(keep)
    counts = np.bincount(r1[kept], minlength=n1).astype(np.int32)
    if off_bits >= 0:
        word = (((r2 << (4 + off_bits)) | (fe << off_bits)
                 | np.clip(eoff, 0, (1 << off_bits) - 1)) & M32)
        out = word[kept]
    else:
        out = (r2[kept].astype(np.int32),
               ((fe | (eoff << 4)) & 0xFFFF)[kept].astype(np.int32))
    return out, counts, len(kept), int((ok_c | run_e).sum())
