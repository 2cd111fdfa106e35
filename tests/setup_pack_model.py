"""A numpy model of the setup_pack kernel (csrc/setup_pack.cu), step for
step: rows taken a block at a time, each block's words staged with their
reverse complements (a bit reverse and a swap of adjacent bits), 16-byte
chunks of the block's flat [rows, lmax] byte range gathered by funnel
shifts (one a row a chunk touches) and spread to bytes, then both
strands' words.  The CPU tests hold it equal to the plain
_setup_pack_torch; the test data and shapes here serve them and
chip_smoke.py's check on the card."""

import numpy as np

from metagenomics_tpu_torch.ops.device_overlap import pack_codes_host

STAGE_WORDS = 4096   # csrc/setup_pack.cu kStageWords
MAX_ROWS = 64        # csrc/setup_pack.cu kMaxRows
M32 = np.uint64(0xFFFFFFFF)

# (rows, lmax, w): the 150 bp cells (w 10) and the trimmed 300 bp cell
# (w 19) at and off a multiple of 16, the 4096 length cap, short rows
# whose 16-byte chunks span several rows, and w past ceil(lmax / 16)
SHAPES = [(1000, 150, 10), (500, 160, 10), (300, 300, 19), (300, 304, 19),
          (70, 4095, 256), (37, 33, 3), (50, 5, 1), (20, 12, 3), (1, 16, 1),
          (129, 17, 2)]


def words(rng, rows, lmax, w, full=False):
    """uint32 [rows, w] forward words: random codes of mixed lengths (0
    past a read, row 0 the zero dummy) packed by pack_codes_host; or,
    with full, random 32-bit words (lanes past lmax set too)."""
    if full:
        return rng.integers(0, 1 << 32, (rows, w), dtype=np.uint64).astype(
            np.uint32)
    lengths = rng.integers(1, lmax + 1, rows)
    lengths[0] = 0
    codes = rng.integers(0, 4, (rows, lmax)).astype(np.uint8)
    codes[np.arange(lmax)[None, :] >= lengths[:, None]] = 0
    out = pack_codes_host(codes)
    return np.pad(out, ((0, 0), (0, w - out.shape[1])))


def spill_width(lmax, w):
    """The pipeline's spill-padded row width wp at hash_len 39 (less for
    rows of 40 bases or fewer)."""
    l = min(39, lmax - 1) if lmax > 1 else 1
    return ((lmax - l) >> 4) + w + 1


def rows_a_block(w):
    """The kernel's rows_a_block."""
    return max(16, min(MAX_ROWS, 16 * (STAGE_WORDS // (16 * w))))


def _bit_reverse(x):
    x = x.astype(np.uint32)
    for shift, mask in ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F),
                        (8, 0x00FF00FF), (16, 0x0000FFFF)):
        m = np.uint32(mask)
        x = ((x >> np.uint32(shift)) & m) | ((x & m) << np.uint32(shift))
    return x


def reverse_complement(x):
    y = _bit_reverse(~x.astype(np.uint32))
    m = np.uint32(0x55555555)
    return ((y >> np.uint32(1)) & m) | ((y & m) << np.uint32(1))


def lanes_at(s, rows, w, c):
    """lanes_at on staged rows s [R, w] uint32 at rows `rows`, lane c."""
    q = c >> 4
    pad = np.concatenate([s, np.zeros((s.shape[0], 2), np.uint32)], 1)
    lo = pad[rows, np.minimum(q, w)].astype(np.uint64)
    hi = pad[rows, np.minimum(q + 1, w)].astype(np.uint64)
    return (((hi << np.uint64(32)) | lo)
            >> (2 * (c & 15)).astype(np.uint64)) & M32


def chunk_lanes(s, w, lmax, off, rr, c, nrows):
    x = np.zeros(rr.shape, np.uint64)
    filled = np.zeros(rr.shape, np.int64)
    rr, c = rr.copy(), c.copy()
    while True:
        live = (filled < 16) & (rr < nrows)
        if not live.any():
            return x.astype(np.uint32)
        n = np.minimum(16 - filled, lmax - c)
        v = lanes_at(s, np.minimum(rr, nrows - 1), w, c + off)
        v = np.where(n < 16, v & ((np.uint64(1) << (2 * n).astype(
            np.uint64)) - np.uint64(1)), v)
        x = np.where(live, x | ((v << (2 * filled).astype(np.uint64)) & M32),
                     x)
        filled = np.where(live, filled + n, filled)
        c = np.where(live, c + n, c)
        wrap = live & (c == lmax)
        c = np.where(wrap, 0, c)
        rr = np.where(wrap, rr + 1, rr)


def spread16(x):
    """spread16 of each word: four uint32 whose bytes are its lanes."""
    out = []
    for q in range(4):
        b = (x >> np.uint32(8 * q)) & np.uint32(0xFF)
        out.append((b & np.uint32(0x3)) | ((b & np.uint32(0xC)) << np.uint32(6))
                   | ((b & np.uint32(0x30)) << np.uint32(12))
                   | ((b & np.uint32(0xC0)) << np.uint32(18)))
    return np.stack(out, axis=-1).astype("<u4").view(np.uint8)


def setup_pack(fwd, w, wp, lmax):
    """The kernel's three outputs from uint32 forward words fwd [n1, w]:
    (codes [n1, lmax] uint8, flipped [n1, lmax] uint8, packed2 [2 n1, wp]
    int64)."""
    n1 = fwd.shape[0]
    rows = rows_a_block(w)
    d = 16 * w - lmax
    codes = np.zeros(n1 * lmax, np.uint8)
    flipped = np.zeros(n1 * lmax, np.uint8)
    packed2 = np.zeros((2 * n1, wp), np.int64)
    for r0 in range(0, n1, rows):
        nrows = min(rows, n1 - r0)
        sf = fwd[r0:r0 + nrows].astype(np.uint32)
        sr = reverse_complement(sf)[:, ::-1]
        nbytes = nrows * lmax
        p = 16 * np.arange((nbytes + 15) >> 4)
        rr = p // lmax
        c = p - rr * lmax
        for s, off, out in ((sf, 0, codes), (sr, d, flipped)):
            x = chunk_lanes(s, w, lmax, off, rr, c, nrows)
            out[r0 * lmax:r0 * lmax + nbytes] = spread16(x).reshape(-1)[
                :nbytes]
        k = np.arange(wp)[None, :]
        live = k < w
        r_idx = np.broadcast_to(np.arange(nrows)[:, None], (nrows, wp))
        f = np.where(live, np.pad(sf, ((0, 0), (0, wp - w)))[:, :wp], 0)
        r = np.where(live, lanes_at(sr, r_idx, w,
                                    np.broadcast_to(16 * k + d, (nrows, wp))
                                    ).astype(np.uint32), 0)
        packed2[r0:r0 + nrows] = f
        packed2[n1 + r0:n1 + r0 + nrows] = r
    return (codes.reshape(n1, lmax), flipped.reshape(n1, lmax), packed2)
