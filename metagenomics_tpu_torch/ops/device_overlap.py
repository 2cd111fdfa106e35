"""Device overlap pipeline in PyTorch: hash -> sort-join -> verify.

Port of metagenomics_tpu/ops/device_overlap.py (the design notes there hold
here too).  Every stage is a plain function on tensors that live on one
explicit torch.device; the pipeline class carries that device.  On a CUDA
device the window hashes come from the hand-written kernels
(ops/window_hash.py, csrc/window_hash.cu), _setup_kernel's row packing
from another (ops/setup_pack.py, csrc/setup_pack.cu) and _emit2 from a
third (ops/emit_verify.py, csrc/emit_verify.cu); every other stage is
torch ops.

Where torch differs from JAX, the port holds the reference's semantics:

* uint32 values (hashes, index keys, packed index entries, survivor words)
  are zero-extended into int64 tensors: products are reduced mod 2^32
  explicitly and sorts see the unsigned order;
* every jax.lax.sort(..., num_keys=1, is_stable=True) is a stable
  torch.sort of the key plus gathers of the payloads by its indices;
* .at[idx].max/min/add(mode="drop") drops out-of-range indices (the
  sentinels cap / n1); torch's scatters raise on them, so _scatter_drop
  filters them first;
* JAX gathers clamp; where the reference relies on that, the index is
  clamped explicitly;
* int32 cumsums and partial sums keep an explicit int32 dtype, and the
  (r2 int32, meta uint16) layout keeps meta in an int32 tensor that is
  cast to uint16 on download.
"""

import os

import numpy as np
import torch

from ..utils.timing import count, span, traced
from . import emit_verify, setup_pack
from .window_hash import MASK32, window_hashes, window_hashes_at

PAD_HASH = 0xFFFFFFFF

_I32 = torch.int32
_I64 = torch.int64


def torch_device():
    """The pipeline's device: MGTPU_TORCH_DEVICE, cuda by default.  A CUDA
    device without a visible card raises."""
    dev = torch.device(os.environ.get("MGTPU_TORCH_DEVICE", "cuda"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("MGTPU_TORCH_DEVICE=%s but no CUDA device is "
                           "available" % dev)
    return dev


def from_jax_arrays(arrays, device):
    """Numpy views of the JAX pipeline's arrays -> the port's tensors on
    `device`: uint32 -> int64 (masked to 32 bits), uint16 -> int32, other
    dtypes as they are.  `arrays` maps names to arrays; returns a dict."""
    out = {}
    for name, a in arrays.items():
        a = np.asarray(a)
        if a.dtype == np.uint32:
            t = torch.from_numpy(a.astype(np.int64)) & MASK32
        elif a.dtype == np.uint16:
            t = torch.from_numpy(a.astype(np.int32))
        else:
            t = torch.from_numpy(np.array(a))
        out[name] = t.to(device)
    return out


def _scatter_drop(target, idx, src, reduce):
    """target.at[idx].<reduce>(src, mode="drop"): indices outside
    [0, len(target)) are dropped.  reduce is "sum", "amax" or "amin"."""
    keep = (idx >= 0) & (idx < target.shape[0])
    idx = idx[keep].to(_I64)
    src = src.expand_as(keep)[keep].to(target.dtype)
    if reduce == "sum":
        return target.index_add_(0, idx, src)
    return target.scatter_reduce_(0, idx, src, reduce=reduce)


def _slot_owner(cum, k):
    """The bucket that owns each slot k of a segmented expansion: cum is
    the inclusive int32 sum of the buckets' counts (counts >= 0), k the
    int32 slot indices.  For a slot k < total = cum[-1] this is the first
    bucket with cum > k, which is the largest bucket with a nonzero count
    that starts at or before k; a slot k >= total maps to the last bucket
    with a nonzero count, and every slot maps to 0 when total is 0.  That
    equals, bit for bit, the JAX package's scatter-max of bucket ids at
    their starts followed by a cummax, as one parallel binary search with
    no host read of the total.  Returns int64 bucket ids."""
    return torch.searchsorted(cum, torch.minimum(k, cum[-1] - 1),
                              right=True)


# --------------------------------------------------------------- bit packing

def pack_codes_host(codes):
    """2-bit pack [n, lmax] uint8 codes into [n, ceil(lmax/16)] uint32 words
    (LSB-first lanes).  Pad columns (PAD_CODE) pack as base 0 ('A'): the
    window hash maps both to the same symbol and verification masks to the
    compared length, so the padding value is immaterial.

    Byte-wise packing (4 codes per uint8, little-endian uint32 view) keeps
    every temporary uint8-sized — ~4x faster than the uint32 lane-shift
    formulation on large read sets."""
    n, lmax = codes.shape
    w = (lmax + 15) // 16
    c = np.zeros((n, 16 * w), np.uint8)
    np.bitwise_and(codes, 3, out=c[:, :lmax])
    b = c[:, 0::4] | (c[:, 1::4] << 2) | (c[:, 2::4] << 4) | (c[:, 3::4] << 6)
    return np.ascontiguousarray(b).view(np.uint32)


def _upload_words(words_u32, device):
    """uint32 numpy words -> int64 tensor on device (uploads 4 bytes a
    word, widens on the device)."""
    t = torch.from_numpy(np.ascontiguousarray(words_u32).view(np.int32))
    count("device.h2d_bytes", t.numel() * t.element_size())
    return t.to(device).to(_I64) & MASK32


def _unpack_codes(words, lmax):
    """Inverse of pack_codes_host: [n, w] words -> [n, lmax] uint8 in 0..3
    (padding positions read as 0)."""
    n, w = words.shape
    sh = 2 * torch.arange(16, dtype=_I64, device=words.device)
    lanes = (words[:, :, None] >> sh[None, None, :]) & 3
    return lanes.reshape(n, 16 * w)[:, :lmax].to(torch.uint8)


def _rc_codes(codes, lengths):
    """Reverse complement of uint8 code rows in the TRUE layout (data at
    columns [0, len); positions >= length -> 0).  The reference's gather
    clamps its index; here the clamp is explicit."""
    lmax = codes.shape[1]
    k = torch.arange(lmax, dtype=_I64, device=codes.device)[None, :]
    src = torch.clamp(lengths.to(_I64)[:, None] - 1 - k, 0, lmax - 1)
    g = torch.gather(codes, 1, src)
    return torch.where(k < lengths[:, None], 3 - g, 0).to(torch.uint8)


def _pack_codes_device(codes, w):
    n, lmax = codes.shape
    c = torch.nn.functional.pad(codes.to(_I64) & 3, (0, 16 * w - lmax))
    lanes = c.reshape(n, w, 16)
    sh = 2 * torch.arange(16, dtype=_I64, device=codes.device)
    return (lanes << sh[None, None, :]).sum(dim=2)


# ------------------------------------------------------------------- verify

def _extract_words(rows, s, w, qw_max):
    """16-base words of each row starting at base offset s (w words).

    rows is [C, >= qw_max+w+1] int64 words; s the per-row base offset.
    The reference selects the word offset with a select chain that falls
    back to offset 0 outside 1..qw_max; a gather with the same fallback
    gives the same words."""
    qw = s >> 4
    qw = torch.where((qw >= 1) & (qw <= qw_max), qw, 0).to(_I64)
    cols = qw[:, None] + torch.arange(w + 1, dtype=_I64, device=rows.device)
    x = torch.gather(rows, 1, cols)
    sh = ((s & 15) << 1).to(_I64)[:, None]
    lo = x[:, :w]
    hi = x[:, 1:]
    spill = torch.where(sh == 0, 0, (hi << ((32 - sh) & 31)) & MASK32)
    return (lo >> sh) | spill


def _verify_pairs(packed2, len1, len2, r1, j, r2, orient, hash_len, w,
                  qw_max, check_cont, rev_lmax):
    """Exact packed-word verification of candidate pairs: gathers the two
    packed rows from the combined fwd+rev matrix, then _verify_windows.

    The reverse half is in the FLIPPED-PADDED layout (3 - fwd[:, ::-1]:
    data at columns [lmax - len, lmax), rev_lmax = lmax), whose window
    starts shift by lmax - len2.  (The true-RC layout, rev_shift None,
    serves the sharded pipeline, which calls _verify_windows directly.)"""
    nrows = packed2.shape[0] // 2
    rows1 = packed2[r1]
    is_rev = orient > 1
    rows2 = packed2[torch.where(is_rev, r2 + nrows, r2)]
    rev_shift = torch.where(is_rev, rev_lmax - len2, 0)
    return _verify_windows(rows1, rows2, len1, len2, j, orient, hash_len,
                           w, qw_max, check_cont, rev_shift)


def _verify_windows(rows1, rows2, len1, len2, j, orient, hash_len, w,
                    qw_max, check_cont, rev_shift=None):
    """Exact packed-word verification of candidate pairs (edge mode:
    checkOverlap, OverlapGraph.cpp:354-383, seed included; containment
    mode: checkOverlapForContainedRead, :302-340; orientation and offset:
    :550-557).  rev_shift, when given, is added to every rows2 window
    start (the flipped-padded reverse layout); None means rows2 is in the
    true layout.  Returns (edge_ok, cont_ok, eo, eoff)."""
    l = hash_len
    if rev_shift is None:
        rev_shift = 0
    is_pre = (orient == 0) | (orient == 2)
    wk16 = 16 * torch.arange(w, dtype=_I64, device=rows1.device)[None, :]

    def windows_equal(s1, s2, m):
        x = (_extract_words(rows1, s1, w, qw_max)
             ^ _extract_words(rows2, s2 + rev_shift, w, qw_max))
        nb = torch.clamp(m[:, None] - wk16, 0, 16)
        mask = torch.where(nb >= 16, MASK32,
                           (torch.ones_like(nb) << (2 * nb)) - 1)
        return ((x & mask) == 0).all(dim=1)

    # edge mode (checkOverlap; seed included)
    ok_e = torch.where(is_pre, len1 - j < len2, len2 - l >= j)
    s1_e = torch.where(is_pre, j, 0)
    s2_e = torch.clamp(torch.where(is_pre, 0, len2 - l - j), min=0)
    m_e = torch.where(ok_e, torch.where(is_pre, len1 - j, j + l), 0)
    edge_ok = ok_e & windows_equal(s1_e, s2_e, m_e)

    if check_cont:
        # containment mode (checkOverlapForContainedRead); the len2 > l
        # guard rejects zero-length dummy/padding rows exactly
        m2 = len2 - l
        ok_c = (torch.where(is_pre, len1 - j - l >= m2, j >= m2)
                & (len1 > len2) & (len2 > l))
        s1_c = torch.clamp(torch.where(is_pre, j, j - m2), min=0)
        m_c = torch.where(ok_c, len2, 0)
        cont_ok = ok_c & windows_equal(s1_c, torch.zeros_like(s1_c), m_c)
    else:
        cont_ok = torch.zeros_like(edge_ok)

    eo = torch.where(orient == 0, 3,
         torch.where(orient == 1, 0,
         torch.where(orient == 2, 2, 1)))
    eoff = torch.where(is_pre, j, len1 - l - j)
    return edge_ok, cont_ok, eo, eoff


# ----------------------------------------------------------------- pipeline

def _setup_kernel(pf, lengths, hash_len, w, wp, lmax):
    """Derive everything from the host-packed forward words: 2-bit packed
    rows (fwd then rev, spill-padded to wp), forward window hashes, and the
    stable-sorted 4-key index with (rid<<2|orient) packed entry words
    (HashTable.cpp:88-104 key set, bucket (rid, orient) order).  Returns
    (packed2, hf, sk, sid, bad): bad is the reverse-strand hash's range
    flag, one int32 on the device, nonzero where a start was out of range
    (read back, and raised on, by DeviceOverlapPipeline._probe)."""
    dev = pf.device
    codes_fwd, flipped, packed2 = _setup_pack(pf, w, wp, lmax)
    hf = window_hashes(codes_fwd, hash_len)

    n = hf.shape[0] - 1                      # row 0 is the unused dummy
    suf = (lengths[1:] - hash_len).to(_I64)
    k0 = hf[1:, 0]
    k1 = torch.gather(hf[1:], 1, suf[:, None])[:, 0]
    # flipped layout: the RC prefix window sits at column lmax - len, the
    # RC suffix window at the (static) last column lmax - hash_len; only
    # those two reverse-strand windows are hashed (QC keeps reads longer
    # than hash_len + 1, so both starts lie in [0, lmax - hash_len]; the
    # kernel checks that into `bad` without a read-back here)
    rstarts = torch.stack([lmax - lengths[1:].to(_I64),
                           torch.full((n,), lmax - hash_len, dtype=_I64,
                                      device=dev)], dim=1)
    bad = torch.zeros(1, dtype=_I32, device=dev)
    k23 = window_hashes_at(flipped[1:], hash_len, rstarts, bad)
    keys = torch.cat([k0[:, None], k1[:, None], k23], dim=1).reshape(-1)
    rid = torch.arange(1, n + 1, dtype=_I64, device=dev).repeat_interleave(4)
    orient = torch.arange(4, dtype=_I64, device=dev).repeat(n)
    sk, perm = torch.sort(keys, stable=True)
    sid = ((rid << 2) | orient)[perm]
    return packed2, hf, sk, sid, bad


def _setup_pack(pf, w, wp, lmax):
    """The rows _setup_kernel derives from the forward words pf: the
    hand-written kernel for CUDA tensors (ops/setup_pack.py), the plain
    version, _setup_pack_torch, for CPU tensors.  Arguments and return as
    _setup_pack_torch's."""
    fn = (setup_pack.setup_pack_cuda if pf.device.type == "cuda"
          else _setup_pack_torch)
    return fn(pf, w, wp, lmax)


def _setup_pack_torch(pf, w, wp, lmax):
    """Unpack the [n1, w] forward words pf into codes [n1, lmax] uint8,
    the reverse strand's codes in the FLIPPED-PADDED layout (3 -
    fwd[:, ::-1] IS the reverse complement, shifted right so row data
    occupies columns [lmax - len, lmax)), and pack both strands' words,
    spill-padded to wp: returns (codes_fwd, flipped, packed2 [2 n1, wp])."""
    codes_fwd = _unpack_codes(pf, lmax).contiguous()
    flipped = (3 - codes_fwd.flip(1)).contiguous()
    pr = _pack_codes_device(flipped, w)
    pad = (0, wp - w)
    packed2 = torch.cat([torch.nn.functional.pad(pf, pad),
                         torch.nn.functional.pad(pr, pad)], dim=0)
    return codes_fwd, flipped, packed2


def _probe_join(hf, lengths, sk, hash_len, sum_block):
    """Sort-merge join of every (read, position) query hash against the
    sorted index keys.  Returns (rk, rleft, rcnt, h_total, parts): hit
    query ids with bucket geometry, sentinel-padded, the hit total and
    blocked int32 partial candidate sums (summed on the host in int64)."""
    dev = hf.device
    n1, npos = hf.shape
    q_total = n1 * npos
    m = sk.shape[0]
    l = hash_len
    q = hf.reshape(-1)
    jj = torch.arange(npos, dtype=_I32, device=dev)[None, :]
    valid = ((jj >= 1) & (jj < (lengths[:, None] - l))).reshape(-1)

    # payload: bit31 = index entry, bit30 = invalid query, low bits = id
    qid = torch.arange(q_total, dtype=_I64, device=dev)
    pq = qid | torch.where(valid, 0, 0x40000000)
    pi = torch.arange(m, dtype=_I64, device=dev) | 0x80000000
    kv, perm = torch.sort(torch.cat([q, sk]), stable=True)
    pv = torch.cat([pq, pi])[perm]
    del perm

    tag = (pv >> 31).to(_I32)
    u = torch.cumsum(tag, dim=0, dtype=_I32)
    # at a query position u counts index entries with key < q (equal-key
    # entries sort after queries by stability) => u = lower_bound; the
    # upper bound is u at the last position of the key's run, which is the
    # count of index keys <= q: a binary search in the sorted keys
    left = u
    ub = torch.searchsorted(sk, kv, right=True, out_int32=True)
    del kv
    cnt = ub - left                          # bucket size at query positions

    is_query = tag == 0
    hit = is_query & (cnt > 0) & ((pv & 0x40000000) == 0)
    rkey = torch.where(hit, pv & 0x3FFFFFFF, PAD_HASH)
    rk, perm = torch.sort(rkey, stable=True)
    rleft = left[perm]
    rcnt = cnt[perm]
    h_total = hit.sum(dtype=_I32)

    # exact grand total without int32 overflow: blocked partial sums,
    # finished on the host in int64
    cq = torch.where(hit, cnt, 0)
    v = cq.shape[0]
    vp = -v % sum_block
    parts = torch.nn.functional.pad(cq, (0, vp)).reshape(-1, sum_block).sum(
        dim=1, dtype=_I32)
    return rk, rleft, rcnt, h_total, parts


def _row_stats(rk, rcnt, h_total, n1, npos):
    """Per-read candidate totals and hit-query counts (multi-chunk planning
    only)."""
    dev = rk.device
    v = rk.shape[0]
    isq = torch.arange(v, dtype=_I32, device=dev) < h_total
    row = torch.where(isq, rk // npos, n1)
    row_tot = _scatter_drop(torch.zeros(n1, dtype=_I32, device=dev), row,
                            torch.where(isq, rcnt, 0), "sum")
    row_hits = _scatter_drop(torch.zeros(n1, dtype=_I32, device=dev), row,
                             isq.to(_I32), "sum")
    return row_tot, row_hits


def _emit2(packed2, lengths, rk_pad, rleft_pad, rcnt_pad, sid, h0, nh_real,
           row0, hash_len, nqt, cap, npos, w, qw_max, check_cont, off_bits,
           uniform_len, dedup=False):
    """Expand + verify + order one chunk of hit queries [h0, h0+nh_real):
    the hand-written kernel for CUDA tensors (ops/emit_verify.py), which
    leaves the buffer past n_keep unspecified, and the plain version,
    _emit2_torch, for CPU tensors.  Arguments and return as
    _emit2_torch's."""
    fn = (emit_verify.emit2_cuda if packed2.device.type == "cuda"
          else _emit2_torch)
    return fn(packed2, lengths, rk_pad, rleft_pad, rcnt_pad, sid, h0,
              nh_real, row0, hash_len, nqt, cap, npos, w, qw_max,
              check_cont, off_bits, uniform_len, dedup=dedup)


def _emit2_torch(packed2, lengths, rk_pad, rleft_pad, rcnt_pad, sid, h0,
                 nh_real, row0, hash_len, nqt, cap, npos, w, qw_max,
                 check_cont, off_bits, uniform_len, dedup=False):
    """Expand + verify + order one chunk of hit queries [h0, h0+nh_real).

    nqt is the tier size of the slice; counts beyond nh_real are zeroed so
    the tier-rounded window never double-emits the next chunk's rows.  The
    survivor buffer comes back compacted to the front and in the
    reference's discovery order (query id asc, bucket order) from one
    stable sort.  Returns (out, keep_counts, n_keep): out is the int64
    packed-word buffer when off_bits >= 0, else (r2 int32, meta int32)."""
    dev = packed2.device
    n1 = lengths.shape[0]
    # the arrays are sentinel-padded by nqt (DeviceOverlapPipeline._padded),
    # so this slice never runs past the end
    assert h0 + nqt <= rk_pad.shape[0]
    qid_s = rk_pad[h0:h0 + nqt]
    left_s = rleft_pad[h0:h0 + nqt]
    cnt_s = rcnt_pad[h0:h0 + nqt]
    live = torch.arange(nqt, dtype=_I32, device=dev) < nh_real
    cnt_s = torch.where(live, cnt_s, 0)

    cum = torch.cumsum(cnt_s, dim=0, dtype=_I32)
    total = cum[-1]
    starts = cum - cnt_s
    k = torch.arange(cap, dtype=_I32, device=dev)
    hidx = _slot_owner(cum, k)
    in_range = k < total

    dsh = left_s - starts                    # src = slot + (left - start)
    src = k.to(_I64) + dsh[hidx]
    qid = qid_s[hidx] & 0x3FFFFFFF
    e = sid[torch.clamp(src, 0, sid.shape[0] - 1)]
    r2 = e >> 2
    orient = e & 3
    qloc = qid // npos
    j = qid - qloc * npos
    r1 = row0 + qloc           # probe rows may be a shard [row0, n)
    r1c = torch.clamp(r1, 0, n1 - 1)

    if uniform_len >= 0:
        len1 = torch.full((cap,), uniform_len, dtype=_I64, device=dev)
        len2 = len1
    else:
        len1 = lengths[r1c].to(_I64)
        len2 = lengths[r2].to(_I64)

    edge_ok, cont_ok, eo, eoff = _verify_pairs(
        packed2, len1, len2, r1c, j, r2, orient, hash_len, w, qw_max,
        check_cont, rev_lmax=npos + hash_len - 1)
    if dedup and check_cont:
        # hybrid mixed mode: canonical edges (smaller endpoint) PLUS every
        # containment hit
        keep = in_range & ((edge_ok & (r1c <= r2)) | cont_ok)
    elif dedup:
        # canonical-dedup mode: keep each overlap's smaller-endpoint
        # occurrence only; the native replay reconstructs the mirrors
        keep = in_range & edge_ok & (r1c <= r2)
    else:
        keep = in_range & (edge_ok | cont_ok)
    fe = eo | (edge_ok.to(_I64) << 2) | (cont_ok.to(_I64) << 3)
    n_keep = keep.sum(dtype=_I32)
    keep_counts = _scatter_drop(torch.zeros(n1, dtype=_I32, device=dev),
                                r1c, keep.to(_I32), "sum")

    # compaction + final order in one stable sort: survivors first, and the
    # slot order (qid asc, bucket position asc) is preserved for equal keys
    skey = 1 - keep.to(_I32)
    _, perm = torch.sort(skey, stable=True)
    if off_bits >= 0:
        # single 32-bit word per survivor: [r2 | fe:4 | eoff:off_bits]
        word = (((r2 << (4 + off_bits)) | (fe << off_bits)
                 | torch.clamp(eoff, 0, (1 << off_bits) - 1)) & MASK32)
        return word[perm], keep_counts, n_keep
    meta = (fe | (eoff << 4)) & 0xFFFF       # uint16 on download
    return ((r2.to(_I32)[perm], meta.to(_I32)[perm]), keep_counts, n_keep)


def _cont_canon(out, kc, n_keep, lengths, n1, off_bits):
    """On-device containment resolution + canonical edge filter over one
    survivor buffer (single-chunk mixed-length datasets): the winner for a
    contained read is the FIRST hit whose container length equals the
    segment maximum (OverlapGraph.cpp:225-290).  Returns (words2, counts2,
    n_keep2, supers, firsthit_r1)."""
    dev = out.device
    cap = out.shape[0]
    k = torch.arange(cap, dtype=_I32, device=dev)
    live = k < n_keep
    # recover each slot's source read from the reads' keep counts
    r1 = _slot_owner(torch.cumsum(kc, dim=0, dtype=_I32), k)

    ob = off_bits
    r2 = out >> (4 + ob)
    fe = (out >> ob) & 15
    cont = live & ((fe & 8) != 0)
    edge = live & ((fe & 4) != 0)
    len1 = lengths[r1]
    r2c = torch.clamp(r2, 0, n1 - 1)

    big = cap
    seg = torch.where(cont, r2c, n1)         # n1 is out of range -> dropped
    maxlen = _scatter_drop(torch.zeros(n1, dtype=_I32, device=dev), seg,
                           len1, "amax")
    is_max = cont & (len1 == maxlen[r2c])
    winner = _scatter_drop(torch.full((n1,), big, dtype=_I32, device=dev),
                           torch.where(is_max, r2c, n1), k, "amin")
    first = _scatter_drop(torch.full((n1,), big, dtype=_I32, device=dev),
                          seg, k, "amin")
    winner_r1 = r1[torch.clamp(winner, 0, cap - 1).to(_I64)]
    supers = torch.where(winner < big, winner_r1, 0)
    firsthit = torch.where(first < big,
                           r1[torch.clamp(first, 0, cap - 1).to(_I64)],
                           0).to(_I32)

    keep2 = edge & (supers[r1] == 0) & (supers[r2c] == 0) & (r1 <= r2)
    counts2 = _scatter_drop(torch.zeros(n1, dtype=_I32, device=dev),
                            torch.where(keep2, r1, n1),
                            torch.ones((), dtype=_I32, device=dev), "sum")
    n_keep2 = keep2.sum(dtype=_I32)
    skey = 1 - keep2.to(_I32)
    _, perm = torch.sort(skey, stable=True)
    return out[perm], counts2, n_keep2, supers, firsthit


def canon_off_bits(n_unique, lmax, min_overlap):
    """Packed-word offset width shared by the device pipeline and the
    native canonical scan, or -1 when the single-u32 layout doesn't fit."""
    bits_r2 = max(1, n_unique.bit_length())
    bits_off = max(1, (lmax - min_overlap + 1).bit_length())
    return bits_off if bits_r2 + 4 + bits_off <= 32 else -1


def _tier(x, lo=1 << 16):
    """Smallest of {2^k, 3*2^(k-1)} >= x: bounds compile tiers to ~2/octave."""
    t = lo
    while t < x:
        t2 = t + (t >> 1)
        if t2 >= x:
            return t2
        t *= 2
    return t


def _fetch_words(outs):
    """Concatenate the first n_keep int64-held 32-bit words of each
    (device buffer, n_keep) pair into one uint32 array (one download per
    buffer)."""
    with span("overlap.fetch"):
        parts = [buf[:nk].cpu().numpy().astype(np.uint32)
                 for buf, nk in outs]
    count("device.syncs", len(parts))
    words = np.concatenate(parts) if parts else np.zeros(0, np.uint32)
    count("overlap.survivors", len(words))
    return words


def _fetch(t):
    """One read-back of a per-read device array (counts, supers, first
    hits) as numpy."""
    with span("overlap.fetch"):
        a = t.cpu().numpy()
    count("device.syncs")
    return a


class DeviceOverlapPipeline:
    """Host orchestration of the device overlap pipeline on one
    torch.device.

    Produces the packed survivor stream consumed by the native threaded
    replay (graph/build.py build_from_pipeline): per-read counts, r2 ids and
    uint16 meta words in reference discovery order.
    """

    MAX_CAP = 1 << 23      # upper bound on a chunk's candidate buffer

    @traced("overlap.pipeline")
    def __init__(self, dataset, min_overlap, row_lo=0, device=None):
        with span("overlap.upload"):
            self._configure(dataset, min_overlap, row_lo, device)
            pf = _upload_words(pack_codes_host(dataset.codes_fwd),
                               self.device)
        self._build_index(pf)
        self._probe()

    def _configure(self, dataset, min_overlap, row_lo, device):
        """Shapes, limits, read lengths on the device and the survivor
        packing; no device work but the lengths' upload."""
        self.device = torch_device() if device is None else torch.device(
            device)
        self.ds = dataset
        self.hash_len = min_overlap - 1
        # probe only reads >= row_lo (the hybrid engine's device shard);
        # the index still covers ALL reads
        self.row0 = int(row_lo)
        ds = dataset
        lmax = ds.codes_fwd.shape[1]
        if lmax >= 4096:
            raise ValueError("read length >= 4096 unsupported by meta packing")
        self.lmax = lmax
        self.w = (lmax + 15) // 16
        # spill-padded row width: word extraction reads words
        # [s>>4, s>>4 + w] with s <= lmax - hash_len
        self.qw_max = (lmax - self.hash_len) >> 4
        self.wp = self.qw_max + self.w + 1
        n1 = ds.codes_fwd.shape[0]
        self.npos = lmax - self.hash_len + 1
        if n1 * self.npos >= 1 << 30:
            raise ValueError(
                "query id space exceeds 2^30 (%d reads x %d positions); "
                "use the sharded pipeline" % (n1, self.npos))
        lengths = torch.from_numpy(ds.lengths.astype(np.int32))
        count("device.h2d_bytes", lengths.numel() * lengths.element_size())
        self.lengths = lengths.to(self.device)

        # survivor packing: one 32-bit word per survivor when
        # (r2 bits + 4 flag/orient bits + offset bits) fit, else the
        # (r2 int32, meta uint16) pair
        self.off_bits = canon_off_bits(n1 - 1, lmax, min_overlap)
        lens = ds.lengths[1:]
        self.uniform_len = (int(lens[0])
                            if len(lens) and (lens == lens[0]).all() else -1)
        self._pad_cache = None

    def _build_index(self, pf):
        """_setup_kernel on the uploaded forward words pf; its range flag
        waits on the device for _probe's read-back."""
        (self.packed2, self.hf, self.sk, self.sid,
         self.bad_start) = _setup_kernel(pf, self.lengths, self.hash_len,
                                         self.w, self.wp, self.lmax)

    def _probe(self):
        """The probe join of reads >= row0 and its hit and candidate
        totals (read back); the blocked partial sums keep every
        device-side accumulator < 2^31 even for pathologically repetitive
        inputs.  The hit total comes back in one copy with the setup's
        range flag, and a set flag raises here."""
        m = int(self.sk.shape[0])
        sum_block = 1 << max(3, min(12, (1 << 31).bit_length()
                                    - max(m, 1).bit_length() - 2))
        hf_probe = self.hf[self.row0:] if self.row0 else self.hf
        len_probe = (self.lengths[self.row0:] if self.row0
                     else self.lengths)
        self.rk, self.rleft, self.rcnt, h_total, parts = _probe_join(
            hf_probe, len_probe, self.sk, self.hash_len, sum_block)
        self.h_total, bad = torch.cat([h_total.reshape(1),
                                       self.bad_start]).tolist()
        count("device.syncs")
        if bad:
            raise ValueError("window start out of range [0, %d] in "
                             "_setup_kernel's reverse-strand keys"
                             % (self.lmax - self.hash_len))
        self.grand = int(parts.cpu().numpy().sum(dtype=np.int64))
        count("device.syncs")
        count("overlap.candidates", self.grand)
        self._pad_cache = None

    def _plan_chunks(self):
        """Chunk plan (cap, nqt, chunks) with chunks = [(hit offset, hit
        count)]; every chunk's candidate total fits cap."""
        npos = self.npos
        n1 = self.hf.shape[0]
        grand, h_total = self.grand, self.h_total
        limit = self.MAX_CAP
        if grand <= limit:
            return (_tier(max(grand, 1)), _tier(max(h_total, 1)),
                    [(0, h_total)])
        row_tot, row_hits = _row_stats(self.rk, self.rcnt, h_total, n1, npos)
        row_tot = row_tot.cpu().numpy().astype(np.int64)
        row_hits = row_hits.cpu().numpy().astype(np.int64)
        count("device.syncs", 2)
        cap = min(_tier(max(grand, 1)), limit)
        cap = max(cap, int(row_tot.max()))
        cum = np.concatenate([[0], np.cumsum(row_tot)])
        bounds = [0]
        while bounds[-1] < n1:
            b = int(np.searchsorted(cum, cum[bounds[-1]] + cap,
                                    side="right")) - 1
            b = max(b, bounds[-1] + 1)
            bounds.append(min(b, n1))
        hoff = np.concatenate([[0], np.cumsum(row_hits)])
        chunks = []
        for i in range(len(bounds) - 1):
            assert int(row_tot[bounds[i]:bounds[i + 1]].sum()) <= cap
            chunks.append((int(hoff[bounds[i]]),
                           int(hoff[bounds[i + 1]] - hoff[bounds[i]])))
        nqt = _tier(max(max(c[1] for c in chunks), 1))
        return cap, nqt, chunks

    def _padded(self, nqt):
        """Sentinel-pad the probe arrays once so every chunk's fixed-size
        slice stays in bounds."""
        if self._pad_cache is None or self._pad_cache[0] < nqt:
            dev = self.device
            self._pad_cache = (nqt, (
                torch.cat([self.rk, torch.full((nqt,), PAD_HASH, dtype=_I64,
                                               device=dev)]),
                torch.cat([self.rleft, torch.zeros(nqt, dtype=_I32,
                                                   device=dev)]),
                torch.cat([self.rcnt, torch.zeros(nqt, dtype=_I32,
                                                  device=dev)])))
        return self._pad_cache[1]

    def _emit_chunks(self, check_cont, dedup, step=None):
        """Run _emit2 over every chunk of the plan, each inside its
        overlap.emit span, and then step(out, kc, n_keep) there where one
        is given (it returns the same triple); returns ([(out, n_keep
        int)], per-read survivor counts as int64 numpy)."""
        cap, nqt, chunks = self._plan_chunks()
        rk_pad, rleft_pad, rcnt_pad = self._padded(nqt)
        outs = []
        kc_total = None
        for i, (h0, nh) in enumerate(chunks):
            with span("overlap.emit", chunk=i, cap=cap):
                out, kc, n_keep = _emit2(
                    self.packed2, self.lengths, rk_pad, rleft_pad, rcnt_pad,
                    self.sid, h0, nh, self.row0, self.hash_len, nqt, cap,
                    self.npos, self.w, self.qw_max, check_cont,
                    self.off_bits, self.uniform_len, dedup=dedup)
                if step is not None:
                    out, kc, n_keep = step(out, kc, n_keep)
            outs.append((out, n_keep))
            kc_total = kc if kc_total is None else kc_total + kc
        outs = [(out, int(nk)) for out, nk in outs]
        count("device.syncs", len(outs))
        return outs, _fetch(kc_total).astype(np.int64)

    @traced("overlap.stream")
    def stream(self, check_cont=True):
        """Survivor stream in reference discovery order (read asc, j asc,
        bucket order): (counts [n+1] int64, r2 int32, meta uint16)."""
        outs, keep_counts = self._emit_chunks(check_cont, dedup=False)
        if self.off_bits >= 0:
            r2, meta = self._unpack_words(_fetch_words(outs))
        else:
            parts = [(_fetch(out[0][:nk]), _fetch(out[1][:nk]).astype(
                np.uint16)) for out, nk in outs if nk]
            count("overlap.survivors", sum(len(p[0]) for p in parts))
            if parts:
                r2 = np.concatenate([p[0] for p in parts])
                meta = np.concatenate([p[1] for p in parts])
            else:
                r2 = np.zeros(0, np.int32)
                meta = np.zeros(0, np.uint16)
        return keep_counts, r2, meta

    def _unpack_words(self, packed):
        ob = self.off_bits
        r2 = (packed >> np.uint32(4 + ob)).astype(np.int32)
        meta = ((((packed >> np.uint32(ob)) & np.uint32(15))
                 | ((packed & np.uint32((1 << ob) - 1)) << np.uint32(4)))
                .astype(np.uint16))
        return r2, meta

    @traced("overlap.stream")
    def stream_canon(self, check_cont=True):
        """Canonical (deduplicated) survivor stream for the native replay:
        one record per physical overlap, from its smaller endpoint;
        containment resolved ON DEVICE.

        Returns (counts int64, packed uint32 words, supers, firsthit) —
        supers/firsthit are None without check_cont.  Returns None when the
        canonical path is unsupported (no packed-word layout, or a
        mixed-length dataset whose candidate total needs multiple chunks).
        """
        if self.off_bits < 0:
            return None
        if not check_cont:
            outs, counts = self._emit_chunks(False, dedup=True)
            return counts, _fetch_words(outs), None, None
        if len(self._plan_chunks()[2]) > 1:
            return None                       # containment is global; the
                                              # full-stream path handles it
        n1 = self.hf.shape[0]
        held = []

        def resolve(out, kc, n_keep):
            words2, counts2, n_keep2, sup, fh = _cont_canon(
                out, kc, n_keep, self.lengths, n1, self.off_bits)
            held.extend((sup, fh))
            return words2, counts2, n_keep2
        outs, counts = self._emit_chunks(True, dedup=False, step=resolve)
        supers, firsthit = held
        return (counts, _fetch_words(outs), _fetch(supers).astype(np.int64),
                _fetch(firsthit))

    @traced("overlap.stream")
    def stream_canon_raw_mixed(self):
        """Hybrid mixed-mode stream: canonical edge records (smaller
        endpoint, UNFILTERED by containment) plus every containment hit,
        as packed words carrying their fe flags (bit 2 edge, bit 3 cont).
        Returns (counts int64, words uint32) or None.  The containment
        hits among the fetched words are counted on the host
        (overlap.cont_hits)."""
        if self.off_bits < 0:
            return None
        outs, counts = self._emit_chunks(True, dedup=True)
        words = _fetch_words(outs)
        count("overlap.cont_hits", int(np.count_nonzero(
            words & np.uint32(8 << self.off_bits))))
        return counts, words
