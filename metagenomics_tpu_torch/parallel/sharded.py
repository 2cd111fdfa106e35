"""Sharded overlap detection over a (dp, ix) mesh (port of
metagenomics_tpu/parallel/sharded.py; its design notes hold here too).

The reference runs each stage as one shard_map kernel.  The port splits
every kernel body at its collectives into bulk-synchronous steps: a step
runs the per-shard torch ops for every shard this process holds, and the
collective between two steps is a call of the mesh's backend
(parallel/collectives.py).  So the same code serves every shard of the
mesh in one process (on one device repeated, or several) and one shard
per rank under torch.distributed.

* reads are row-sharded over both mesh axes: each shard packs, reverse-
  complements and hashes its own rows (the forward strand with the
  hand-written window_hash kernel, the two reverse keys a read with
  window_hash_at on a card) and builds its slice of the 4-key index with
  global read ids;
* the index is sharded by hash range over "ix" (all_to_all), merged over
  "dp" (all_gather) in (dp, source row) order; queries are routed to
  their range's owner (all_to_all over "ix");
* each shard runs the stable sort-merge join, emission is chunked into
  row windows that fit a fixed buffer, verification rides a D-round ring
  over "dp" (ppermute) and survivors merge over "ix" (all_gather) in
  global query order.

Where torch differs from JAX (ops/device_overlap.py lists the rules): a
uint32 value is held in int64; dynamic_slice clamps its start, and the
slices here either pad first (_expand_window, _range_blocks) or clamp
the start themselves and mask by global position (_emit_chunk);
mode="drop" scatters go through _scatter_drop; multi-key sorts are
stable torch.sorts with the payloads gathered.
"""

import numpy as np
import torch

from ..ops import device_overlap as dov
from ..ops.window_hash import window_hashes, window_hashes_at
from .collectives import LEDGER

PAD_KEY = 0xFFFFFFFF
SENT = 0xFFFFFFFF
QPAD = 0x7FFFFFFF     # routed-query padding id (never a real qid)

_I32 = torch.int32
_I64 = torch.int64


def _take(a, start, n):
    """a[start:start + n] (rows, for a 2-D a) at a 0-d tensor start,
    without reading it back to the host; the caller keeps it in bounds."""
    idx = start.to(_I64) + torch.arange(n, dtype=_I64, device=a.device)
    return a[idx]


def _clamped_start(start, cap, m_blk):
    """The start jax.lax.dynamic_slice uses for an m_blk slice of a cap
    buffer: clamped to [0, cap - m_blk]."""
    return torch.clamp(start, 0, cap - m_blk)


def _expand_window(rk, rleft, rcnt, h0, nh, cap):
    """Slice one hit window [h0, h0+nh) (sentinel-padded, so the start
    never needs clamping) and expand it: per-slot global query id, index
    position, slot index and live total."""
    dev = rk.device
    pad_i = torch.zeros(cap, dtype=_I32, device=dev)
    qid_s = _take(torch.cat([rk, torch.full((cap,), SENT, dtype=_I64,
                                            device=dev)]), h0, cap)
    left_s = _take(torch.cat([rleft, pad_i]), h0, cap)
    cnt_s = _take(torch.cat([rcnt, pad_i]), h0, cap)
    k = torch.arange(cap, dtype=_I32, device=dev)
    cnt_s = torch.where(k < nh, cnt_s, 0)
    cum = torch.cumsum(cnt_s, dim=0, dtype=_I32)
    total = cum[-1]
    starts = cum - cnt_s
    hidx = dov._slot_owner(cum, k)
    src = k.to(_I64) + (left_s - starts)[hidx]
    qid = qid_s[hidx]
    return qid, src, k, total


def _range_blocks(rank_sorted, keys_sorted, payload, cap, pad_payload, I):
    """[I, cap] per-range blocks of rank-sorted arrays (block r = entries
    with rank r; entries ranked >= I are never emitted)."""
    dev = keys_sorted.device
    off = torch.searchsorted(
        rank_sorted, torch.arange(I + 1, dtype=rank_sorted.dtype,
                                  device=dev))
    key_ext = torch.cat([keys_sorted, torch.full((cap,), PAD_KEY,
                                                 dtype=_I64, device=dev)])
    pay_ext = torch.cat([payload, torch.full((cap,), pad_payload,
                                             dtype=_I64, device=dev)])
    j = torch.arange(cap, dtype=_I64, device=dev)[None, :]
    idx = off[:I, None] + j
    live = j < (off[1:] - off[:I])[:, None]
    return (torch.where(live, key_ext[idx], PAD_KEY),
            torch.where(live, pay_ext[idx], pad_payload))


def _stable_sort(key, *payloads):
    """jax.lax.sort((key, *payloads), num_keys=1, is_stable=True)."""
    sk, perm = torch.sort(key, stable=True)
    return (sk,) + tuple(p[perm] for p in payloads)


def _rows_slice(arr, lo, n, fill):
    """Rows [lo, lo + n) of a host array, padded with `fill` past its end."""
    part = arr[lo:lo + n]
    if part.shape[0] < n:
        pad = np.full((n - part.shape[0],) + arr.shape[1:], fill, arr.dtype)
        part = np.concatenate([part, pad])
    return part


class ShardedOverlapPipeline:
    """Multi-shard twin of ops.device_overlap.DeviceOverlapPipeline.

    stream() returns the identical survivor stream -- (per-read counts,
    r2, meta) in the reference's discovery order -- so
    OverlapGraph.build_from_pipeline and the native replay run unchanged
    and the artifacts stay byte-equal (tests/test_torch_sharded.py).

    Each stage returns per-shard dicts {(d, i): tensor} over mesh.local;
    global_() assembles one in the reference's global layout.
    """

    MAX_CAP = 1 << 22      # per-shard upper bound on a chunk's buffer

    def __init__(self, dataset, min_overlap, mesh=None, device=None):
        from .mesh import default_devices, make_mesh
        self.ds = dataset
        self.hash_len = min_overlap - 1
        ds = dataset
        if mesh is None:
            devices = default_devices(device)
            nd = len(devices)
            ix = 2 if nd % 2 == 0 and nd >= 4 else 1
            mesh = make_mesh(dp=nd // ix, ix=ix, devices=devices)
        self.mesh = mesh
        self.comm = mesh.comm
        self.dp = D = mesh.shape["dp"]
        self.ix = I = mesh.shape["ix"]
        if I & (I - 1):
            raise ValueError("ix axis must be a power of two (hash-range "
                             "sharding uses top-bit ranges), got %d" % I)

        lmax = ds.codes_fwd.shape[1]
        if lmax >= 4096:
            raise ValueError("read length >= 4096 unsupported by meta packing")
        self.lmax = lmax
        self.npos = lmax - self.hash_len + 1
        self.w = (lmax + 15) // 16
        self.qw_max = (lmax - self.hash_len) >> 4
        self.wp = self.qw_max + self.w + 1

        n1 = ds.codes_fwd.shape[0]
        self.n1 = n1
        self.nloc2 = nloc2 = -(-n1 // (D * I))   # rows per shard
        self.nloc = nloc = nloc2 * I             # rows per dp shard
        self.n1_pad = nloc * D
        # global query ids must stay strictly below the routing pad id
        # 0x7FFFFFFF and the join's index-tag bit 2^31
        if self.n1_pad * self.npos >= 0x7FFFFFFF:
            raise ValueError(
                "query id space too large (%d rows x %d positions)"
                % (self.n1_pad, self.npos))

        # sharded upload: each shard receives only its row slice (padding
        # rows: codes 4, length 0)
        lengths_host = ds.lengths.astype(np.int32)
        self.codes, self.lengths_sl = {}, {}
        for key in mesh.local:
            lo = (key[0] * I + key[1]) * nloc2
            dev = mesh.device(key)
            self.codes[key] = torch.from_numpy(_rows_slice(
                ds.codes_fwd, lo, nloc2, 4)).to(dev)
            self.lengths_sl[key] = torch.from_numpy(_rows_slice(
                lengths_host, lo, nloc2, 0)).to(dev)

        # stage 1: per-slice setup (each read processed exactly once).  The
        # query histograms come back in one copy with every shard's range
        # flag of the reverse-strand hash (window_hash_at), so every rank
        # raises on a bad start at this read-back
        (self.pslice_f, self.pslice_r, self.hf_sl, self.keys_l, self.id_l,
         qcnt, icnt, bad) = self._with_phase("setup", self._setup)
        qcnt_bad = self.global_({k: torch.cat([qcnt[k], bad[k][None]], dim=1)
                                 for k in mesh.local})
        if qcnt_bad[:, -1].any():
            raise ValueError("window start out of range [0, %d] in the "
                             "reverse-strand keys of the setup stage"
                             % (lmax - self.hash_len))
        self.cap_q = int(dov._tier(
            max(int(qcnt_bad[:, :-1].max()), 1), lo=1 << 8))
        self.cap_blk = int(dov._tier(
            max(int(self.global_(icnt).max()), 1), lo=1 << 8))

        # stages 2+3: query + index routing, probe join, block assembly
        (self.pfwd, self.prev, self.lengths, self.sid2, self.rk,
         self.rleft, self.rcnt, self.row_hits_cum, row_tot,
         grand_parts) = self._with_phase(
            "probe", self._probe,
            self.cap_q, self.cap_blk, self.pslice_f, self.pslice_r,
            self.hf_sl, self.lengths_sl, self.keys_l, self.id_l)
        self.row_tot = self.global_(row_tot, ix_replicated=True).astype(
            np.int64)
        parts = self.global_(grand_parts).astype(np.int64)
        self.dev_tot = parts.sum(axis=1)           # per-shard candidates
        self.grand = int(self.dev_tot.sum())

    def _with_phase(self, name, fn, *args):
        """Run one stage under the collective ledger's phase: its
        collectives are charged to `name`, and the phase's invocation
        count rises by one (collectives.py)."""
        with LEDGER.phase(name):
            return fn(*args)

    def _local(self, fn, *shard_args):
        """fn(key, *args of that shard) for every local shard; a tuple
        result becomes a tuple of shard dicts."""
        out = {k: fn(k, *(a[k] for a in shard_args))
               for k in self.mesh.local}
        first = next(iter(out.values()))
        if isinstance(first, tuple):
            return tuple({k: v[n] for k, v in out.items()}
                         for n in range(len(first)))
        return out

    def global_(self, shards, ix_replicated=False):
        """Host numpy copy of a stage output in the reference's global
        layout: the shards concatenated along dim 0 in (d, i) order, or,
        for an output replicated over "ix" (out_specs P("dp", ...)), one
        shard per dp row.  0-d shards count as length 1."""
        D, I = self.dp, self.ix
        keys = ([(d, 0) for d in range(D)] if ix_replicated
                else [(d, i) for d in range(D) for i in range(I)])
        host = self.comm.host(shards, keys)
        return np.concatenate([np.reshape(host[k], (-1,) + host[k].shape[1:])
                               for k in keys])

    def _rows(self, shards, nrows):
        """Row blocks of an ix-replicated output as numpy, one per dp
        row."""
        host = self.comm.host(shards, [(d, 0) for d in range(nrows)])
        return [host[(d, 0)] for d in range(nrows)]

    # ------------------------------------------------------------- stage 1

    def _setup(self):
        return self._local(self._setup_shard, self.codes, self.lengths_sl)

    def _setup_shard(self, key, codes_u8, lengths):
        I = self.ix
        hash_len, w, wp, nloc2, npos = (self.hash_len, self.w, self.wp,
                                        self.nloc2, self.npos)
        dev = codes_u8.device
        rbits = (I - 1).bit_length()           # range id = key >> (32-rbits)

        codes_fwd = (codes_u8 & 3).contiguous()
        codes_rev = dov._rc_codes(codes_fwd, lengths).contiguous()
        pad = (0, wp - w)
        pf = torch.nn.functional.pad(dov._pack_codes_device(codes_fwd, w),
                                     pad)
        pr = torch.nn.functional.pad(dov._pack_codes_device(codes_rev, w),
                                     pad)
        hf = window_hashes(codes_fwd, hash_len)

        # 4-key local index with GLOBAL read ids; zero-length rows (the
        # global dummy row 0 and padding) become inert PAD entries with
        # identry 0 (rejected at verification: length 0)
        row0 = key[0] * self.nloc + key[1] * nloc2
        rows_g = row0 + torch.arange(nloc2, dtype=_I64, device=dev)
        real = lengths > hash_len
        suf = torch.clamp(lengths - hash_len, 0, npos - 1).to(_I64)
        k0 = hf[:, 0]
        k1 = torch.gather(hf, 1, suf[:, None])[:, 0]
        # the reverse keys hr[:, 0] and hr[:, suf], hashed at those two
        # starts only (suf is clipped to [0, npos - 1], so padding rows
        # pass the kernel's range check too; its flag is read in __init__)
        bad = torch.zeros(1, dtype=_I32, device=dev)
        k23 = window_hashes_at(codes_rev, hash_len, torch.stack(
            [torch.zeros_like(suf), suf], dim=1), bad)
        keys = torch.cat([k0[:, None], k1[:, None], k23], dim=1)
        keys = torch.where(real[:, None], keys, PAD_KEY).reshape(-1)
        rid = rows_g.repeat_interleave(4)
        orient = torch.arange(4, dtype=_I64, device=dev).repeat(nloc2)
        identry = torch.where(real.repeat_interleave(4),
                              (rid << 2) | orient, 0)
        sk, sid = _stable_sort(keys, identry)

        # per-range histograms for the routing buffer tiers
        jj = torch.arange(npos, dtype=_I32, device=dev)[None, :]
        valid = ((jj >= 1) & (jj < (lengths[:, None] - hash_len))).reshape(-1)
        if rbits:
            irng = sk >> (32 - rbits)
            icnt = dov._scatter_drop(torch.zeros(I, dtype=_I32, device=dev),
                                     irng, torch.ones((), dtype=_I32,
                                                      device=dev), "sum")
            qrng = torch.where(valid, hf.reshape(-1) >> (32 - rbits), I)
            qcnt = dov._scatter_drop(torch.zeros(I, dtype=_I32, device=dev),
                                     qrng, torch.ones((), dtype=_I32,
                                                      device=dev), "sum")
        else:
            icnt = torch.full((1,), sk.shape[0], dtype=_I32, device=dev)
            qcnt = valid.sum(dtype=_I32).reshape(1)
        return pf, pr, hf, sk, sid, qcnt[None], icnt[None], bad

    # --------------------------------------------------------- stages 2+3

    def _probe(self, cap_q, cap_blk, pslice_f, pslice_r, hf_sl, lengths_sl,
               keys_l, id_l):
        comm, I = self.comm, self.ix
        rbits = (I - 1).bit_length()

        # ---- assemble each dp row's packed block + lengths -------------
        pfwd = comm.all_gather(pslice_f, "ix")
        prev = comm.all_gather(pslice_r, "ix")
        len_blk = comm.all_gather(lengths_sl, "ix")

        # ---- route queries to their hash range's owner -----------------
        qblk_k, qblk_id = self._local(
            lambda key, hf, lengths: self._query_blocks(key, hf, lengths,
                                                        cap_q),
            hf_sl, lengths_sl)
        qr_k = comm.all_to_all(qblk_k, "ix")
        qr_id = comm.all_to_all(qblk_id, "ix")
        del qblk_k, qblk_id

        # ---- route + merge the index range slices ----------------------
        def index_blocks(key, keys, ids):
            irank = (keys >> (32 - rbits) if rbits
                     else torch.zeros_like(keys))
            return _range_blocks(irank, keys, ids, cap_blk, 0, I)
        iblk_k, iblk_id = self._local(index_blocks, keys_l, id_l)
        ir_k = comm.all_to_all(iblk_k, "ix")
        ir_id = comm.all_to_all(iblk_id, "ix")
        del iblk_k, iblk_id
        flat = lambda xs: {k: v.reshape(-1) for k, v in xs.items()}
        gk = comm.all_gather(flat(ir_k), "dp")
        gi = comm.all_gather(flat(ir_id), "dp")
        del ir_k, ir_id

        sid, rk, rleft, rcnt, row_hits_cum, row_tot, parts = self._local(
            self._join, flat(qr_k), flat(qr_id), gk, gi)
        row_tot_all = comm.psum(row_tot, "ix")
        return (pfwd, prev, len_blk, sid, rk, rleft, rcnt, row_hits_cum,
                row_tot_all, parts)

    def _query_blocks(self, key, hf, lengths, cap_q):
        """[I, cap_q] blocks of this shard's (hash, global qid) probes by
        hash range (invalid positions are never routed)."""
        I, npos, hash_len = self.ix, self.npos, self.hash_len
        rbits = (I - 1).bit_length()
        dev = hf.device
        row0 = key[0] * self.nloc + key[1] * self.nloc2
        q = hf.reshape(-1)
        jj = torch.arange(npos, dtype=_I32, device=dev)[None, :]
        valid = ((jj >= 1) & (jj < (lengths[:, None] - hash_len))).reshape(-1)
        qid = row0 * npos + torch.arange(q.shape[0], dtype=_I64, device=dev)
        qrank = torch.where(valid, q >> (32 - rbits) if rbits else 0, I)
        qsr, qskey, qsid = _stable_sort(qrank, q,
                                        torch.where(valid, qid, QPAD))
        return _range_blocks(qsr, qskey, qsid, cap_q, QPAD, I)

    def _join(self, key, qr_k, qr_id, gk, gi):
        """The stable sort-merge join of one shard (queries sort before
        their equal-key index entries), its hit queries in global qid
        order, per-row hit offsets and the blocked int32 partial sums."""
        dev = qr_k.device
        d = key[0]
        nloc, npos = self.nloc, self.npos
        # blocked partial sums keep int32 accumulators exact (finished in
        # int64 on the host)
        sum_block = 1 << max(3, min(
            12, 29 - max(4 * self.n1_pad, 1).bit_length()))

        sk, sid = _stable_sort(gk, gi)
        pi = 0x80000000 | torch.arange(sk.shape[0], dtype=_I64, device=dev)
        kv, pv = _stable_sort(torch.cat([qr_k, sk]), torch.cat([qr_id, pi]))
        tag = (pv >> 31).to(_I32)
        u = torch.cumsum(tag, dim=0, dtype=_I32)
        left = u
        # the key run's upper bound: the count of index keys <= the key
        ub = torch.searchsorted(sk, kv, right=True, out_int32=True)
        del kv
        cnt = ub - left
        hit = (tag == 0) & (cnt > 0) & (pv != QPAD)
        rkey = torch.where(hit, pv, SENT)
        rk, rleft, rcnt = _stable_sort(rkey, left, cnt)

        # per-row hit offsets (dp-block-local rows) + candidate sums
        vsz = rk.shape[0]
        h_total = hit.sum(dtype=_I32)
        isq = torch.arange(vsz, dtype=_I32, device=dev) < h_total
        row = torch.where(isq, rk // npos - d * nloc, nloc)
        cq = torch.where(isq, rcnt, 0)
        row = torch.clamp(row, 0, nloc)
        row_hits = dov._scatter_drop(torch.zeros(nloc, dtype=_I32,
                                                 device=dev), row,
                                     isq.to(_I32), "sum")
        row_tot = dov._scatter_drop(torch.zeros(nloc, dtype=_I32,
                                                device=dev), row, cq, "sum")
        row_hits_cum = torch.cat([torch.zeros(1, dtype=_I32, device=dev),
                                  torch.cumsum(row_hits, 0, dtype=_I32)])
        vp = -vsz % sum_block
        parts = torch.nn.functional.pad(cq, (0, vp)).reshape(
            -1, sum_block).sum(dim=1, dtype=_I32)
        return (sid, rk, rleft, rcnt, row_hits_cum, row_tot, parts[None])

    # ------------------------------------------------------------ prepass

    def _window(self, key, rk, rleft, rcnt, hcum, sid, r0s, r1s, cap):
        """A chunk's hit window of one shard, expanded: (qid, r2, orient,
        slot, in-range mask)."""
        d = key[0]
        h0 = hcum[int(r0s[d])]
        nh = hcum[int(r1s[d])] - h0
        qid, src, k, total = _expand_window(rk, rleft, rcnt, h0, nh, cap)
        e = sid[torch.clamp(src, 0, sid.shape[0] - 1)]
        return qid, e >> 2, e & 3, k, k < total

    def _owner_hist(self, r0s, r1s, cap, rk_a, rleft_a, rcnt_a, hcum_a,
                    sid_a):
        """Largest per-owner candidate block of one chunk, per shard --
        sizes the static ring-round slice m_blk (the host takes the max)."""
        D, nloc = self.dp, self.nloc

        def hist(key, rk, rleft, rcnt, hcum, sid):
            _, r2, _, _, in_range = self._window(key, rk, rleft, rcnt, hcum,
                                                 sid, r0s, r1s, cap)
            owner = torch.clamp(r2 // nloc, 0, D - 1)
            h = dov._scatter_drop(
                torch.zeros(D, dtype=_I32, device=rk.device),
                torch.where(in_range, owner, D),
                torch.ones((), dtype=_I32, device=rk.device), "sum")
            return h.max().reshape(1, 1)
        return self._local(hist, rk_a, rleft_a, rcnt_a, hcum_a, sid_a)

    # --------------------------------------------------------------- emit

    def _emit_chunk(self, r0s, r1s, cap, m_blk, cc, rk_a, rleft_a, rcnt_a,
                    hcum_a, sid_a, pfwd_a, prev_a, lengths_a, dedup=False):
        comm, D = self.comm, self.dp
        nloc, npos, w = self.nloc, self.npos, self.w
        hash_len, qw_max = self.hash_len, self.qw_max

        # ---- candidates sorted by r2's owner shard ---------------------
        def by_owner(key, rk, rleft, rcnt, hcum, sid, lengths):
            qid, r2, orient, k, in_range = self._window(
                key, rk, rleft, rcnt, hcum, sid, r0s, r1s, cap)
            qid_i = qid & 0x7FFFFFFF
            r1loc = torch.clamp(qid_i // npos - key[0] * nloc, 0, nloc - 1)
            j = qid_i - (qid_i // npos) * npos
            len1 = lengths[r1loc].to(_I64)
            owner = torch.where(in_range, torch.clamp(r2 // nloc, 0, D - 1),
                                D)
            meta1 = (torch.clamp(j, 0, 4095)
                     | (torch.clamp(len1, 0, 4095) << 12) | (orient << 24))
            # the reference sorts on (owner, slot), unstably; slots are
            # k = 0..cap-1 in order, so a stable sort on owner alone gives
            # the same (unique) order
            so, sslot, sr2, sm1, sr1loc, sqid = _stable_sort(
                owner, k.to(_I64), r2, meta1, r1loc, qid)
            off = torch.searchsorted(so, torch.arange(
                D + 1, dtype=_I64, device=so.device))
            return sslot, sr2, sm1, sr1loc, sqid, off

        sslot, sr2, sm1, sr1loc, sqid, off = self._local(
            by_owner, rk_a, rleft_a, rcnt_a, hcum_a, sid_a, lengths_a)

        # ---- D-round ring verify ---------------------------------------
        tile = {k: torch.cat([pfwd_a[k], prev_a[k]], dim=0)
                for k in self.mesh.local}
        tlen = lengths_a
        blks = {k: [] for k in self.mesh.local}
        for t in range(D):
            for key in self.mesh.local:
                o = (key[0] + t) % D
                start = off[key][o]
                bsz = off[key][o + 1] - start
                # the reference's dynamic_slice clamps its start to
                # cap - m_blk when the window would run past the buffer;
                # slice at that clamped start and mask by GLOBAL position
                # so the block stays exact (bsz <= m_blk, so the window
                # still covers [start, start + bsz))
                start_eff = _clamped_start(start, cap, m_blk)

                def blk(a):
                    return _take(a, start_eff, m_blk)
                br2 = blk(sr2[key])
                bm1 = blk(sm1[key])
                bj = bm1 & 4095
                blen1 = (bm1 >> 12) & 4095
                bori = (bm1 >> 24) & 3
                lrow = torch.clamp(br2 - o * nloc, 0, nloc - 1)
                rows2 = tile[key][lrow + nloc * (bori > 1).to(_I64)]
                rows1 = pfwd_a[key][blk(sr1loc[key])]
                edge_ok, cont_ok, eo, eoff = dov._verify_windows(
                    rows1, rows2, blen1, tlen[key][lrow].to(_I64), bj, bori,
                    hash_len, w, qw_max, cc)
                pos = torch.arange(m_blk, dtype=_I64,
                                   device=br2.device) + start_eff
                livem = (pos >= start) & (pos < start + bsz)
                bqid = blk(sqid[key])
                if dedup:
                    # canonical-dedup mode: keep only the smaller-endpoint
                    # occurrence of each edge; dedup == "cont" also keeps
                    # every containment hit (either id order)
                    br1g = (bqid & 0x7FFFFFFF) // npos
                    bkeep = livem & edge_ok & (br1g <= br2)
                    if dedup == "cont":
                        bkeep = bkeep | (livem & cont_ok)
                else:
                    bkeep = livem & (edge_ok | cont_ok)
                fe = (eo | (edge_ok.to(_I64) << 2)
                      | (cont_ok.to(_I64) << 3))
                bmeta = (fe | (eoff << 4)) & 0xFFFF     # uint16
                blks[key].append((bkeep, blk(sslot[key]), bqid, br2, bmeta))
            if t != D - 1:
                tile = comm.ppermute(tile)
                tlen = comm.ppermute(tlen)
        del tile, tlen

        # ---- compaction + slot order (= qid asc, bucket order) ---------
        def compact(key):
            b = blks.pop(key)
            keep_f, slot_f, qid_f, r2_f, meta_f = (
                torch.cat([x[n] for x in b]) for n in range(5))
            n_keep = keep_f.sum(dtype=_I32)
            qkey_f = torch.where(keep_f, qid_f, SENT)
            skey = torch.where(keep_f, slot_f, SENT)
            _, qo, r2o, mo = _stable_sort(skey, qkey_f, r2_f, meta_f)
            if qo.shape[0] < cap:
                padn = cap - qo.shape[0]
                dev = qo.device
                qo = torch.cat([qo, torch.full((padn,), SENT, dtype=_I64,
                                               device=dev)])
                r2o = torch.cat([r2o, torch.zeros(padn, dtype=_I64,
                                                  device=dev)])
                mo = torch.cat([mo, torch.zeros(padn, dtype=_I64,
                                                device=dev)])
            # per-read survivor counts (dp-block-local rows)
            krow = qid_f // npos - key[0] * nloc
            kc = dov._scatter_drop(
                torch.zeros(nloc, dtype=_I32, device=qo.device),
                torch.where(keep_f, torch.clamp(krow, 0, nloc), nloc),
                torch.ones((), dtype=_I32, device=qo.device), "sum")
            return (qo[:cap], r2o[:cap], mo[:cap].to(_I32), n_keep, kc)
        qo, r2o, mo, n_keep, kc = self._local(compact)

        # cross-ix merge in global qid order (a bucket lives wholly in one
        # hash range, so streams never interleave within a query)
        qg = comm.all_gather(qo, "ix")
        r2g = comm.all_gather(r2o, "ix")
        mg = comm.all_gather(mo, "ix")
        del qo, r2o, mo
        nk_all = comm.psum(n_keep, "ix")
        kc = comm.psum(kc, "ix")
        qs, r2s, ms = self._local(lambda key, q, r, m: _stable_sort(q, r, m),
                                  qg, r2g, mg)
        return qs, r2s, ms, {k: v.reshape(1) for k, v in nk_all.items()}, kc

    # -------------------------------------------------------------- stream

    def stream_canon(self, check_cont=True):
        """Canonical (deduplicated) survivor stream in the packed-word
        contract of DeviceOverlapPipeline.stream_canon -- halves the
        cross-ix all_gather payload AND the device->host download.

        Mixed-length datasets (check_cont=True): the stages keep every
        containment hit alongside the canonical (sup-UNFILTERED) edges;
        the host resolves supers globally with the same vectorized
        first-wins/longest-replaces rule as the hybrid engine and masks
        the edge stream before the replay."""
        ob = dov.canon_off_bits(self.n1 - 1, self.lmax, self.hash_len + 1)
        if ob < 0:
            return None
        self.off_bits = ob

        def pack(r2, meta):
            return ((r2.astype(np.uint32) << np.uint32(4 + ob))
                    | ((meta.astype(np.uint32) & np.uint32(15))
                       << np.uint32(ob))
                    | (meta.astype(np.uint32) >> np.uint32(4)))

        if not check_cont:
            counts, r2, meta = self.stream(check_cont=False, dedup=True)
            return counts, pack(r2, meta), None, None

        counts, r2, meta = self.stream(check_cont=True, dedup="cont")
        from ..graph.build import _resolve_supers
        n = self.n1 - 1
        r1 = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
        r2_64 = r2.astype(np.int64)
        cont = (meta & 8) != 0
        supers, firsthit = _resolve_supers(
            r1[cont], r2_64[cont], self.ds.lengths, n)
        keep = (((meta & 4) != 0) & (r1 <= r2_64)
                & (supers[r1] == 0) & (supers[r2_64] == 0))
        ccounts = np.zeros(len(counts), np.int64)
        np.add.at(ccounts, r1[keep], 1)
        return ccounts, pack(r2[keep], meta[keep]), supers, firsthit

    def stream(self, check_cont=True, dedup=False):
        """Survivor stream in reference discovery order: (counts [n1] int64,
        r2 int32, meta uint16) -- the DeviceOverlapPipeline.stream
        contract."""
        D = self.dp
        n1, nloc = self.n1, self.nloc

        # chunk planning.  Single-chunk fast path: buffers sized to the
        # LARGEST PER-SHARD candidate total.  Multi-chunk path: per-dp-row
        # windows whose ix-TOTAL sums fit one buffer (a conservative bound
        # on any shard's share).
        dev_max = int(self.dev_tot.max()) if self.dev_tot.size else 1
        per_shard = self.row_tot.reshape(D, nloc)
        if dev_max <= self.MAX_CAP:
            cap = int(dov._tier(max(dev_max, 1), lo=1 << 12))
            bounds = [[0, nloc] for _ in range(D)]
            nchunks = 1
        else:
            cap = min(int(dov._tier(max(self.grand, 1), lo=1 << 12)),
                      self.MAX_CAP)
            cap = max(cap, int(per_shard.max()) if per_shard.size else 1)
            bounds = []
            nchunks = 1
            for d in range(D):
                b = [0]
                acc = 0
                for r in range(nloc):
                    if acc + per_shard[d, r] > cap and b[-1] != r:
                        b.append(r)
                        acc = 0
                    acc += per_shard[d, r]
                b.append(nloc)
                bounds.append(b)
                nchunks = max(nchunks, len(b) - 1)
            for b in bounds:             # lockstep: pad with empty chunks
                while len(b) - 1 < nchunks:
                    b.append(nloc)

        outs = []
        kc_total = None
        for c in range(nchunks):
            r0s = np.asarray([bounds[d][c] for d in range(D)], np.int32)
            r1s = np.asarray([bounds[d][c + 1] for d in range(D)],
                             np.int32)
            hist = self.global_(self._with_phase(
                "owner_hist", self._owner_hist,
                r0s, r1s, cap, self.rk, self.rleft, self.rcnt,
                self.row_hits_cum, self.sid2))
            m_blk = min(int(dov._tier(max(int(hist.max()), 1), lo=1 << 8)),
                        cap)
            qk, r2o, mo, nk, kc = self._with_phase(
                "emit", self._emit_chunk,
                r0s, r1s, cap, m_blk, check_cont, self.rk, self.rleft,
                self.rcnt, self.row_hits_cum, self.sid2, self.pfwd,
                self.prev, self.lengths, dedup)
            outs.append((qk, r2o, mo, nk))
            kc_total = kc if kc_total is None else {
                k: kc_total[k] + kc[k] for k in kc}

        n_keeps = []
        for *_, nk in outs:
            n_keeps.append([int(r[0]) for r in self._rows(nk, D)])

        r2_parts, m_parts = [], []
        fetched = []
        for c in range(nchunks):
            _, r2o, mo, _ = outs[c]
            fetched.append((self._rows(r2o, D), self._rows(mo, D)))
        for d in range(D):
            for c in range(nchunks):
                kept = n_keeps[c][d]
                if kept == 0:
                    continue
                r2_parts.append(fetched[c][0][d].reshape(-1)[:kept])
                m_parts.append(fetched[c][1][d].reshape(-1)[:kept])
        counts = np.concatenate(self._rows(kc_total, D)).astype(
            np.int64)[:n1]
        if r2_parts:
            r2 = np.concatenate(r2_parts).astype(np.int32)
            meta = np.concatenate(m_parts).astype(np.uint16)
        else:
            r2 = np.zeros(0, np.int32)
            meta = np.zeros(0, np.uint16)
        return counts, r2, meta
