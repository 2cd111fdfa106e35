"""Dataset: ingest, QC, canonicalize, sort, dedup, mate-pair store.

Replaces the reference's per-read object pipeline (MetaGenomics/Dataset.cpp)
with a padded-array pipeline: QC and canonicalization run as batched JAX
kernels over all records of a file at once (ops/packing.py); sorting and
dedup run over packed uint64 limbs so comparisons are vectorized memcmp-style
instead of std::string compares.

Semantics preserved from the reference:
* QC: only {A,C,G,T}, < trunc(0.8*len) of any one base, len > minOverlap
  (Dataset.cpp:160, 398-413).
* Canonical form: lexicographic min(read, reverse complement)
  (Dataset.cpp:164-167); ties store the reverse.
* Lexicographic sort + dedup assigning IDs 1..numberOfUniqueReads with
  duplicate frequency accumulation (Dataset.cpp:197-202, 316-345).
* Mate pairs: second pass over PE files; reads located by binary search of
  the canonical form; contained reads remapped one level to their super
  read; 2-bit orientation from substring containment of the original line
  in the (super) read's forward string; per-read dedup of
  (id, orientation, dataset) triples (Dataset.cpp:208-310, Read.cpp:132-166).
"""

import numpy as np

from .io.fastx import fastx_records, fastx_pairs
from .ops import packing


def reverse_complement_str(s: str) -> str:
    return s.translate(_RC_TABLE)[::-1]


_RC_TABLE = str.maketrans("ACGT", "TGCA")


class MatePair:
    __slots__ = ("mate_id", "orientation", "dataset")

    def __init__(self, mate_id, orientation, dataset):
        self.mate_id = mate_id
        self.orientation = orientation
        self.dataset = dataset


class _LazyLists:
    """List-of-lists that creates rows on first touch.  The eager version
    (u+1 preallocated empty lists, five structures) held ~300MB of empty
    lists for a 1M-read dataset before any was used."""

    __slots__ = ("n", "d")

    def __init__(self, n):
        self.n = n
        self.d = {}

    def __getitem__(self, i):
        if i < 0 or i >= self.n:
            raise IndexError(i)
        lst = self.d.get(i)
        if lst is None:
            lst = self.d[i] = []
        return lst

    def __setitem__(self, i, v):
        if i < 0 or i >= self.n:
            raise IndexError(i)
        self.d[i] = v

    def __len__(self):
        return self.n


class _MatePairRows:
    """Array-backed read -> [MatePair] view over the flat mp_* arrays
    (sorted by read id); rows materialize as small lists on access."""

    __slots__ = ("n", "rid", "mate", "orient", "dsn", "ptr")

    def __init__(self, n_reads, rid, mate, orient, dsn):
        self.n = n_reads + 1
        self.rid = rid
        self.mate = mate
        self.orient = orient
        self.dsn = dsn
        self.ptr = np.searchsorted(rid, np.arange(n_reads + 2))

    def __getitem__(self, i):
        if i < 0 or i >= self.n:
            raise IndexError(i)
        s, e = int(self.ptr[i]), int(self.ptr[i + 1])
        return [MatePair(int(self.mate[j]), int(self.orient[j]),
                         int(self.dsn[j])) for j in range(s, e)]

    def __len__(self):
        return self.n


class _LazyReadStrings:
    """read id -> ASCII byte string, decoded on demand from the rank-code
    matrix (one LUT gather per access).  Replaces the eager per-read bytes
    lists: for metagenome-scale inputs those held ~2x the sequence bytes
    plus per-object overhead resident for the whole run."""

    __slots__ = ("codes", "lengths")

    def __init__(self, codes, lengths):
        self.codes = codes
        self.lengths = lengths

    def __getitem__(self, i):
        return packing.codes_to_ascii(self.codes[i], int(self.lengths[i]))


class Dataset:
    """Sorted, deduplicated canonical reads plus mate-pair metadata.

    Reads are 1-indexed (index 0 unused) to match reference IDs.
    """

    def __init__(self, pe_files, se_files, min_overlap, log=print):
        self.pe_files = list(pe_files)
        self.se_files = list(se_files)
        self.min_overlap = int(min_overlap)
        self.log = log

        self.number_of_reads = 0
        self.mp_rid = np.zeros(0, np.int64)
        self.mp_mate = np.zeros(0, np.int64)
        self.mp_orient = np.zeros(0, np.int64)
        self.mp_dataset = np.zeros(0, np.int64)
        self.shortest_read_length = None
        self.longest_read_length = None

        from .utils.timing import phase_clock
        all_codes = []
        all_lengths = []
        counter = 0
        for path in self.pe_files + self.se_files:
            with phase_clock("readDataset", log=self.log, src=__file__):
                chunks_codes, chunks_lens = self._read_file(path, counter)
            counter += 1
            all_codes.extend(chunks_codes)
            all_lengths.extend(chunks_lens)

        lmax = max((c.shape[1] for c in all_codes if c.size), default=0)
        codes = np.full((sum(len(l) for l in all_lengths), lmax),
                        packing.PAD_CODE, dtype=np.uint8)
        row = 0
        while all_codes:                     # consume chunks as they merge
            c = all_codes.pop(0)
            if len(c):
                codes[row:row + len(c), :c.shape[1]] = c
                row += len(c)
        lengths = (np.concatenate(all_lengths) if all_lengths
                   else np.zeros(0, np.int64))
        del all_lengths

        # with zero good reads the reference prints the untouched init
        # values: shortest = u64 max, longest = 0 (Dataset.cpp:30-31, :61-62)
        self.log("")
        self.log("Shortest read length in all datasets: %5d"
                 % (self.shortest_read_length
                    if self.shortest_read_length is not None
                    else (1 << 64) - 1))
        self.log(" Longest read length in all datasets: %5d"
                 % (self.longest_read_length
                    if self.longest_read_length is not None else 0))

        self._sort_and_dedup(codes, lengths)

        # Per-read mutable state used by the graph layer (rows materialize
        # on first touch).
        u = self.number_of_unique_reads
        self.super_read_id = np.zeros(u + 1, dtype=np.int64)
        self._mp_pending = []      # per-chunk mate-pair batches
        self.mate_pair_lists = _MatePairRows(
            u, self.mp_rid, self.mp_mate, self.mp_orient, self.mp_dataset)
        # read -> (edge, location) inverted index, maintained by the graph.
        self._edges_forward = _LazyLists(u + 1)
        self._loc_forward = _LazyLists(u + 1)
        self._edges_reverse = _LazyLists(u + 1)
        self._loc_reverse = _LazyLists(u + 1)
        # raw (array-form) location data from the native engine, converted
        # to per-read Python lists on first access (graph/build.py)
        self._pending_locations = None

    # ------------------------------------------------------------------ ingest

    # reads per QC/canonicalization batch: bounds ingest's transient arrays
    # (the [chunk, Lmax] gather/ASCII/code matrices) regardless of file size
    CHUNK_READS = 1 << 16

    def _read_file(self, path, dataset_number):
        """Ingest one file through fixed-size QC/canonicalize batches.
        Returns lists of per-chunk canonical code arrays and lengths (the
        only data kept; raw text and ASCII transients are chunk-bounded).

        Strict 2-line FASTA files take a byte-level numpy fast path; any
        deviation (FASTQ, multi-line or blank-line FASTA) falls back to the
        reference-semantics stream parser (io/fastx.py)."""
        self.log("Reading dataset: %d from file: %s" % (dataset_number, path))
        chunks_codes = []
        chunks_lens = []
        good = 0
        processed = 0
        heartbeats = []   # (records, good_at_that_point) per 1e6 boundary

        def qc_canon_batch(ascii_arr, lengths):
            nonlocal good, processed
            codes = packing.ascii_to_codes(ascii_arr, lengths)
            # host twins of the device kernels: ingest is IO-bound host
            # work, so paying an XLA compile here buys nothing (equality
            # tested in tests/test_ops.py)
            good_mask = packing.qc_mask_np(codes, lengths, self.min_overlap)
            gcodes = codes[good_mask]
            glens = lengths[good_mask]
            canon, _ = packing.canonicalize_codes_np(gcodes, glens)
            g = int(good_mask.sum())
            m = len(lengths)
            b = (processed // 1000000 + 1) * 1000000
            if b <= processed + m:
                cum = np.cumsum(good_mask)
                while b <= processed + m:
                    heartbeats.append((b, good + int(cum[b - processed - 1])))
                    b += 1000000
            processed += m
            good += g
            if g:
                self.shortest_read_length = (
                    int(glens.min()) if self.shortest_read_length is None
                    else min(self.shortest_read_length, int(glens.min())))
                self.longest_read_length = (
                    int(glens.max()) if self.longest_read_length is None
                    else max(self.longest_read_length, int(glens.max())))
                chunks_codes.append(canon)
                chunks_lens.append(glens)

        fast = self._scan_two_line_fasta(path)
        if fast is None:
            fast = self._scan_four_line_fastq(path)
        if fast is not None:
            arr, seq_starts, seq_lens = fast
            n = len(seq_starts)
            B = self.CHUNK_READS
            for s in range(0, n, B):
                e = min(s + B, n)
                ls = seq_lens[s:e]
                os_ = seq_starts[s:e]
                lmax = max(int(ls.max()), 1) if e > s else 1
                k = np.arange(lmax)[None, :]
                if int(ls.min()) == lmax:
                    ascii_arr = arr[os_[:, None] + k]
                else:
                    pos = np.minimum(os_[:, None] + k, len(arr) - 1)
                    ascii_arr = np.where(k < ls[:, None], arr[pos], 0)
                qc_canon_batch(ascii_arr, ls)
        else:
            buf = bytearray()
            lens = []
            n = 0

            def flush():
                nonlocal buf, lens
                if not lens:
                    return
                lengths = np.asarray(lens, dtype=np.int64)
                m = len(lens)
                lmax = max(int(lengths.max()), 1)
                flat = np.frombuffer(bytes(buf) + b"\0", dtype=np.uint8)
                if int(lengths.min()) == lmax:
                    # uniform lengths: the flat buffer IS the matrix
                    ascii_arr = flat[:m * lmax].reshape(m, lmax)
                else:
                    offsets = np.zeros(m, dtype=np.int64)
                    np.cumsum(lengths[:-1], out=offsets[1:])
                    pos = np.minimum(
                        offsets[:, None] + np.arange(lmax)[None, :],
                        len(flat) - 1)
                    ascii_arr = np.where(
                        np.arange(lmax)[None, :] < lengths[:, None],
                        flat[pos], 0)
                qc_canon_batch(ascii_arr, lengths)
                buf = bytearray()
                lens = []

            for s in fastx_records(path):
                b = s.encode()
                buf += b
                lens.append(len(b))
                n += 1
                if len(lens) >= self.CHUNK_READS:
                    flush()
            flush()

        bad = n - good
        self.number_of_reads += good
        # per-1e6 progress heartbeats (Dataset.cpp:125-126): the reference
        # checks at the top of each record iteration, so a boundary only
        # prints when at least one further record follows it
        for b, g in heartbeats:
            if b < n:
                self.log("%10d reads processed in dataset %2d. %10d good "
                         "reads.%10d bad reads." % (b, dataset_number, g,
                                                    b - g))
        # end-of-file block (Dataset.cpp:185-190)
        self.log("")
        self.log("Dataset: %2d" % dataset_number)
        self.log("File name: %s" % path)
        self.log("%10d good reads in current dataset." % good)
        self.log("%10d bad reads in current dataset." % bad)
        self.log("%10d total reads in current dataset." % n)
        self.log("%10d good reads in all datasets." % self.number_of_reads)
        self.log("")
        return chunks_codes, chunks_lens

    @staticmethod
    def _scan_four_line_fastq(path):
        """Byte-level scan of a 4-line-per-record FASTQ.  The reference's
        FASTQ parse (Dataset.cpp:149-157) is purely line-count based: four
        getlines per record, sequence = line 2, no content validation — so
        any file whose line count is a multiple of 4 parses identically.
        Returns (uppercased byte array, sequence line starts, sequence
        lengths) INCLUDING the phantom empty record the reference's
        while(!eof) loop produces after the last real record (the trailing
        newline leaves eofbit unset; the extra iteration yields an empty
        sequence counted as a bad read).  None -> stream-parser fallback."""
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            from .errors import MyExit
            raise MyExit("Unable to open file: " + path) from None
        if not data.startswith(b"@") or not data.endswith(b"\n"):
            return None
        data = data.upper()             # reference uppercases per line
        arr = np.frombuffer(data, np.uint8)
        nl = np.flatnonzero(arr == 10)
        nlines = len(nl)
        if nlines == 0 or nlines % 4:
            return None
        starts = np.empty(nlines, np.int64)
        starts[0] = 0
        starts[1:] = nl[:-1] + 1
        seq_starts = np.append(starts[1::4], 0)
        seq_lens = np.append(nl[1::4] - starts[1::4], 0)  # phantom record
        return arr, seq_starts, seq_lens

    @staticmethod
    def _scan_two_line_fasta(path):
        """Byte-level scan of a strict 2-line FASTA: every record exactly
        one '>' header line + one sequence line.  Returns (uppercased byte
        array, sequence line starts, sequence lengths) or None when the
        layout deviates in any way — exact line alternation is validated,
        so the fallback stream parser handles every other shape."""
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            from .errors import MyExit
            # reference: MYEXIT("Unable to open file: ...") (Dataset.cpp:117)
            raise MyExit("Unable to open file: " + path) from None
        if not data.startswith(b">"):
            return None
        data = data.upper()             # reference uppercases per line
        if not data.endswith(b"\n"):
            data += b"\n"
        arr = np.frombuffer(data, np.uint8)
        nl = np.flatnonzero(arr == 10)
        nlines = len(nl)
        if nlines == 0 or nlines % 2:
            return None
        starts = np.empty(nlines, np.int64)
        starts[0] = 0
        starts[1:] = nl[:-1] + 1
        gt = np.uint8(ord(">"))
        if not (arr[starts[0::2]] == gt).all():
            return None
        seq_starts = starts[1::2]
        # any '>' beyond the one per header line (embedded mid-line) would
        # split the record under the reference's getline(file, '>') parse
        # (Dataset.cpp:142-146) — fall back to the stream parser there
        if int((arr == gt).sum()) != len(starts[0::2]):
            return None
        seq_lens = nl[1::2] - seq_starts
        return arr, seq_starts, seq_lens

    # ------------------------------------------------------- sort/dedup/index

    @staticmethod
    def _lex_order(limbs):
        """Row order of a full lexicographic sort over the limb columns.

        A straight np.lexsort is one stable sort PASS PER LIMB (13 passes
        for 100bp reads — the dominant ingest cost at metagenome scale).
        The first two limbs cover 16 bases = 4^16 key values, so almost
        every row is already uniquely ordered by them: sort on those two,
        then refine only the tied groups over the remaining limbs.  Ties
        beyond all limbs are identical reads, whose relative order is
        unobservable after dedup, so the result equals the full lexsort
        exactly where it matters and byte-identically downstream."""
        n, nlimb = limbs.shape
        if nlimb <= 3 or n < (1 << 16):
            return np.lexsort(tuple(limbs[:, k]
                                    for k in range(nlimb - 1, -1, -1)))
        order = np.lexsort((limbs[:, 1], limbs[:, 0]))
        l0 = limbs[order, 0]
        l1 = limbs[order, 1]
        tie = np.zeros(n, dtype=bool)
        same = (l0[1:] == l0[:-1]) & (l1[1:] == l1[:-1])
        tie[1:] = same
        tie[:-1] |= same
        idx = np.flatnonzero(tie)
        if len(idx):
            rows = order[idx]
            # group id = run index of the tied block; a new group starts on
            # a positional gap OR a (limb0, limb1) key change (two distinct
            # tie runs can be adjacent)
            l0i = l0[idx]
            l1i = l1[idx]
            starts = np.zeros(len(idx), dtype=np.int64)
            starts[1:] = np.cumsum((idx[1:] - idx[:-1] > 1)
                                   | (l0i[1:] != l0i[:-1])
                                   | (l1i[1:] != l1i[:-1]))
            sub = limbs[rows]
            keys = tuple(sub[:, k] for k in range(sub.shape[1] - 1, 1, -1))
            refine = np.lexsort(keys + (starts,))
            order[idx] = rows[refine]
        return order

    def _sort_and_dedup(self, codes, lengths):
        from .utils.timing import phase_clock
        n, lmax = codes.shape
        with phase_clock("sortReads", log=self.log, src=__file__):
            limbs = packing.pack_sort_limbs(codes, lengths)
            if limbs.shape[1] == 0:
                # zero good reads: no sort keys exist (lexsort requires >= 1)
                limbs = np.zeros((n, 1), dtype=np.uint64)
            order = self._lex_order(limbs)
            limbs = limbs[order]
            codes = codes[order]
            lengths = lengths[order]
        with phase_clock("removeDupicateReads", log=self.log, src=__file__):
            if n:
                new_run = np.empty(n, dtype=bool)
                new_run[0] = True
                new_run[1:] = (limbs[1:] != limbs[:-1]).any(axis=1)
                uniq_idx = np.flatnonzero(new_run)
                freq = np.diff(np.append(uniq_idx, n))
            else:
                uniq_idx = np.zeros(0, np.int64)
                freq = np.zeros(0, np.int64)
            u = len(uniq_idx)
            self.number_of_unique_reads = u
            self.log("Number of unique reads: %d" % u)

        # 1-indexed padded arrays for the device kernels.
        self.codes_fwd = np.full((u + 1, lmax), packing.PAD_CODE, dtype=np.uint8)
        self.codes_fwd[1:] = codes[uniq_idx]
        self.lengths = np.zeros(u + 1, dtype=np.int64)
        self.lengths[1:] = lengths[uniq_idx]
        self.frequencies = np.zeros(u + 1, dtype=np.int64)
        self.frequencies[1:] = freq
        self.sort_limbs = limbs[uniq_idx]      # for binary-search lookup

        # row 0 is the unused PAD row; excluding it lets the uniform-length
        # fast path in reverse_complement_codes_np apply, and the out=
        # view fill avoids a full-size transient
        self.codes_rev = np.empty_like(self.codes_fwd)
        self.codes_rev[0] = packing.PAD_CODE
        if u:
            packing.reverse_complement_codes_np(
                self.codes_fwd[1:], self.lengths[1:],
                out=self.codes_rev[1:])

        # byte-string views for the graph-surgery layer, decoded on demand
        # from the code matrices (no resident string copies)
        self.read_strs = _LazyReadStrings(self.codes_fwd, self.lengths)
        self.read_strs_rev = _LazyReadStrings(self.codes_rev, self.lengths)

    # ------------------------------------------- read -> edge location index

    @property
    def edges_forward(self):
        if self._pending_locations is not None:
            self._materialize_locations()
        return self._edges_forward

    @edges_forward.setter
    def edges_forward(self, v):
        self._pending_locations = None
        self._edges_forward = v

    @property
    def loc_forward(self):
        if self._pending_locations is not None:
            self._materialize_locations()
        return self._loc_forward

    @loc_forward.setter
    def loc_forward(self, v):
        self._pending_locations = None
        self._loc_forward = v

    @property
    def edges_reverse(self):
        if self._pending_locations is not None:
            self._materialize_locations()
        return self._edges_reverse

    @edges_reverse.setter
    def edges_reverse(self, v):
        self._pending_locations = None
        self._edges_reverse = v

    @property
    def loc_reverse(self):
        if self._pending_locations is not None:
            self._materialize_locations()
        return self._loc_reverse

    @loc_reverse.setter
    def loc_reverse(self, v):
        self._pending_locations = None
        self._loc_reverse = v

    def _materialize_locations(self):
        """Convert the native engine's flat location arrays into per-read
        Python lists for the graph-surgery layer.  Every row is populated,
        so the containers become PLAIN lists of lists — the laziness only
        pays before this point, and the late phases index these rows
        millions of times (a Python-level __getitem__ would dominate)."""
        edges, counts_f, counts_r, loc_edge_pos, ld = self._pending_locations
        self._pending_locations = None
        import numpy as _np
        edge_objs = _np.empty(max(len(edges), 1), dtype=object)
        for p, e in enumerate(edges):
            edge_objs[p] = e
        ael = (edge_objs[loc_edge_pos].tolist() if len(edges) else [])
        # all four containers are built with C-level map/slice loops: this
        # runs inside the timed construction phase for every read row.
        # slice objects are built per 64k-row block (2 full-length slice
        # lists would hold ~100MB at metagenome scale)
        cf = _np.asarray(counts_f, _np.int64)
        cr = _np.asarray(counts_r, _np.int64)
        tot = cf + cr
        ends = _np.cumsum(tot)
        f_start = (ends - tot).tolist()
        f_end = (ends - cr).tolist()
        r_end = ends.tolist()
        n_rows = len(f_start)
        ef, lf, er, lr = [], [], [], []
        B = 1 << 16
        for s in range(0, n_rows, B):
            e = min(s + B, n_rows)
            slf = list(map(slice, f_start[s:e], f_end[s:e]))
            slr = list(map(slice, f_end[s:e], r_end[s:e]))
            ef.extend(map(ael.__getitem__, slf))
            lf.extend(map(ld.__getitem__, slf))
            er.extend(map(ael.__getitem__, slr))
            lr.extend(map(ld.__getitem__, slr))
        self._edges_forward = ef
        self._loc_forward = lf
        self._edges_reverse = er
        self._loc_reverse = lr

    # ------------------------------------------------------------- accessors

    def get_string_forward(self, read_id: int) -> bytes:
        return self.read_strs[read_id]

    def get_string_reverse(self, read_id: int) -> bytes:
        return self.read_strs_rev[read_id]

    def read_length(self, read_id: int) -> int:
        return int(self.lengths[read_id])

    def find_read_id(self, seq: str) -> int:
        """Binary search for a read by string, canonicalizing first
        (reference: Dataset.cpp:421-455)."""
        rc = reverse_complement_str(seq)
        key = seq if seq < rc else rc
        b = key.encode()
        n = len(b)
        arr = np.frombuffer(b, dtype=np.uint8)
        codes = packing.ascii_to_codes(arr[None, :], np.array([n]))
        limbs = packing.pack_sort_limbs(codes, np.array([n]))
        nlimb = self.sort_limbs.shape[1]
        q = np.zeros(nlimb, dtype=np.uint64)
        q[: limbs.shape[1]] = limbs[0]
        lo, hi = 0, len(self.sort_limbs)
        sl = self.sort_limbs
        while lo < hi:
            mid = (lo + hi) // 2
            row = sl[mid]
            cmp = 0
            for k in range(nlimb):
                if row[k] != q[k]:
                    cmp = -1 if row[k] < q[k] else 1
                    break
            if cmp == 0:
                return mid + 1
            if cmp < 0:
                lo = mid + 1
            else:
                hi = mid
        raise KeyError("String not found in Dataset: " + seq)

    # ----------------------------------------------------------- mate pairs

    def read_mate_pairs_from_file(self):
        """Second pass over the PE files storing mate-pair info
        (reference: Dataset.cpp:97-104, 208-310).  Must run after
        contained-read marking.  Ends with the printDataset debug dump,
        exactly like the reference's readMatePairsFromFile."""
        from .utils.timing import phase_clock
        for d, path in enumerate(self.pe_files):
            with phase_clock("storeMatePairInformation", log=self.log,
                             src=__file__):
                self._store_mate_pairs(path, d)
        self._build_mp_arrays()
        with phase_clock("printDataset", log=self.log, src=__file__):
            self.print_dataset()

    def print_dataset(self):
        """First-20-reads debug dump (Dataset.cpp:370-393): id, forward
        string and frequency, then the mate-pair lists of those reads."""
        self.log("Printing reads in the dataset")
        self.log("Number of reads: %d" % self.number_of_reads)
        self.log("Number of unique reads: %d" % self.number_of_unique_reads)
        top = min(20, self.number_of_unique_reads)
        for i in range(1, top + 1):
            self.log("%10d %s%10d" % (i, self.read_strs[i].decode(),
                                      self.frequencies[i]))
        self.log("")
        self.log("Printing matepairs")
        for i in range(1, top + 1):
            self.log("Mate-Pair 1%10d %s" % (i, self.read_strs[i].decode()))
            for mp in self.mate_pair_lists[i]:
                self.log("Mate-Pair 2%10d %s Orientation: %d Dataset: %d"
                         % (mp.mate_id,
                            self.read_strs[mp.mate_id].decode(),
                            mp.orientation, mp.dataset))

    def _build_mp_arrays(self):
        """Build the flat mate-pair arrays from the pending per-chunk
        batches, fully vectorized, in the reference's iteration order
        (read id ascending, then per-read insertion order) with the
        reference's per-read dedup of (mate, orientation, dataset) triples
        keeping the FIRST occurrence (Read::addMatePair, Read.cpp:132-166).
        Immutable after this point; mate_pair_lists becomes an array-backed
        row view."""
        parts = self._mp_pending
        self._mp_pending = []
        if parts:
            rid = np.concatenate([p[0] for p in parts])
            mate = np.concatenate([p[1] for p in parts])
            ori = np.concatenate([p[2] for p in parts])
            dsn = np.concatenate([np.full(len(p[0]), p[3], np.int64)
                                  for p in parts])
            k = np.arange(len(rid), dtype=np.int64)
            order = np.lexsort((k, dsn, ori, mate, rid))
            rs, ms, os_, ds_ = rid[order], mate[order], ori[order], dsn[order]
            first = np.ones(len(rs), dtype=bool)
            if len(rs) > 1:
                first[1:] = ((rs[1:] != rs[:-1]) | (ms[1:] != ms[:-1])
                             | (os_[1:] != os_[:-1]) | (ds_[1:] != ds_[:-1]))
            keep = order[first]            # min-k (first occurrence) of group
            fo = np.lexsort((keep, rid[keep]))
            sel = keep[fo]
            self.mp_rid = rid[sel]
            self.mp_mate = mate[sel]
            self.mp_orient = ori[sel]
            self.mp_dataset = dsn[sel]
        else:
            self.mp_rid = np.zeros(0, np.int64)
            self.mp_mate = np.zeros(0, np.int64)
            self.mp_orient = np.zeros(0, np.int64)
            self.mp_dataset = np.zeros(0, np.int64)
        self.mate_pair_lists = _MatePairRows(
            self.number_of_unique_reads, self.mp_rid, self.mp_mate,
            self.mp_orient, self.mp_dataset)

    def _store_mate_pairs(self, path, dataset_number):
        """Vectorized second pass (Dataset.cpp:208-310): chunked batches of
        pairs go through numpy QC, canonicalization (whose flip flag IS the
        orientation for non-contained reads — strstr against an equal-length
        canonical string is equality, Dataset.cpp:294-298) and a vectorized
        lexicographic binary search over the sorted limb index; only the
        contained-read remaps fall back to the per-string substring check."""
        self.log("Store paired-end information of dataset: %d from file: %s"
                 % (dataset_number, path))
        good = bad = 0
        pairs_done = 0
        heartbeats = []
        pend = []
        # half the ingest chunk so each 2-reads-per-pair batch reuses the
        # QC kernel shapes already compiled during _read_file
        CH = self.CHUNK_READS // 2

        def flush(pend):
            nonlocal good, bad, pairs_done
            g, b, okpair = self._store_mate_pair_chunk(pend, dataset_number)
            # per-1e6-read heartbeats (Dataset.cpp:228-231): reads move in
            # steps of 2, so boundaries are the pair indices divisible by
            # 500000 inside this chunk; the good/bad split at the EXACT
            # boundary pair comes from the chunk's per-pair mask
            lo, hi = pairs_done + 1, pairs_done + len(pend)
            bs = range((lo + 499999) // 500000 * 500000, hi + 1, 500000)
            if len(bs):
                cum = np.cumsum(okpair)
                for p in bs:
                    heartbeats.append(
                        (2 * p, good + 2 * int(cum[p - pairs_done - 1])))
            pairs_done += len(pend)
            good += g
            bad += b

        # byte-level fast path: strict 2-line FASTA or 4-line FASTQ scans
        # feed padded ASCII rows straight to the vectorized chunk core,
        # skipping per-record Python string assembly entirely
        scan = self._scan_two_line_fasta(path)
        fastq_phantom = False
        if scan is None:
            scan = self._scan_four_line_fastq(path)
            if scan is not None:
                arr0, st0, ln0 = scan
                # the phantom empty record pairs with nothing real; it is
                # accounted below as the reference's ("", "") bad pair
                scan = (arr0, st0[:-1], ln0[:-1])
                fastq_phantom = True
        if scan is not None and len(scan[1]) % 2 == 0:
            arr0, starts0, lens0 = scan
            nrec = len(starts0)
            for s in range(0, nrec, 2 * CH):
                e = min(s + 2 * CH, nrec)
                ls = np.asarray(lens0[s:e], np.int64)
                os_ = starts0[s:e]
                lmax = max(int(ls.max()), 1) if e > s else 1
                k = np.arange(lmax)[None, :]
                if e > s and int(ls.min()) == lmax \
                        and int(os_[-1]) + lmax <= len(arr0):
                    # uniform lengths: one plain gather, no clamp/where
                    # (same shortcut as the ingest fast path)
                    ascii_arr = arr0[os_[:, None] + k]
                else:
                    pos = np.minimum(os_[:, None] + k, len(arr0) - 1)
                    ascii_arr = np.where(k < ls[:, None], arr0[pos], 0)

                def orig(j, os_=os_, ls=ls):
                    return arr0[os_[j]:os_[j] + ls[j]].tobytes()

                g, b, okpair = self._store_mate_pair_chunk_arrays(
                    ascii_arr, ls, orig, dataset_number)
                lo = pairs_done + 1
                hi = pairs_done + (e - s) // 2
                bs = range((lo + 499999) // 500000 * 500000, hi + 1, 500000)
                if len(bs):
                    cum = np.cumsum(okpair)
                    for p in bs:
                        heartbeats.append(
                            (2 * p, good + 2 * int(cum[p - pairs_done - 1])))
                pairs_done += (e - s) // 2
                good += g
                bad += b
            if fastq_phantom:
                # the reference's trailing while(!eof) iteration reads 8
                # empty lines and discards the empty pair (Dataset.cpp:
                # 232-239 QC failure path)
                bad += 2
                pairs_done += 1
        else:
            for pair in fastx_pairs(path):
                pend.append(pair)
                if len(pend) >= CH:
                    flush(pend)
                    pend = []
            if pend:
                flush(pend)
        for hb, g_at in heartbeats:
            if hb < 2 * pairs_done:
                # exact boundary-time split (Dataset.cpp:228-231: the check
                # runs at the top of each pair iteration, so the printed
                # good/bad are the counts over the first hb/2 pairs)
                self.log("%10d reads processed in store mate-pair "
                         "information.%10d reads in good mate-pairs.%10d "
                         "reads in bad mate-pairs." % (hb, g_at, hb - g_at))
        self.log("")
        self.log("Dataset: %2d" % dataset_number)
        self.log("File name: %s" % path)
        self.log("%10d reads in %10d mate-pairs are good." % (good, good // 2))
        self.log("%10d reads in %10d mate-pairs are discarded." % (bad, bad // 2))
        self.log("")

    def _store_mate_pair_chunk(self, pairs, dataset_number):
        m2 = 2 * len(pairs)
        lens = np.fromiter((len(s) for pr in pairs for s in pr),
                           np.int64, m2)
        lmax = max(int(lens.max()), 1)
        flat = np.frombuffer(
            "".join(s for pr in pairs for s in pr).encode() + b"\0",
            dtype=np.uint8)
        if int(lens.min()) == lmax:
            ascii_arr = flat[:m2 * lmax].reshape(m2, lmax)
        else:
            offsets = np.zeros(m2, dtype=np.int64)
            np.cumsum(lens[:-1], out=offsets[1:])
            pos = np.minimum(offsets[:, None] + np.arange(lmax)[None, :],
                             len(flat) - 1)
            ascii_arr = np.where(
                np.arange(lmax)[None, :] < lens[:, None], flat[pos], 0)
        orig = lambda gj: pairs[gj // 2][gj % 2].encode()
        return self._store_mate_pair_chunk_arrays(
            ascii_arr, lens, orig, dataset_number)

    def _store_mate_pair_chunk_arrays(self, ascii_arr, lens, orig,
                                      dataset_number):
        """Core of the vectorized mate-pair second pass over a chunk given
        as padded ASCII rows (reads interleaved: row 2k / 2k+1 = pair k).
        `orig(j)` returns the original byte string of row j (only consulted
        for contained-read remaps)."""
        m2 = len(lens)
        codes = packing.ascii_to_codes(ascii_arr, lens)
        ok = packing.qc_mask_np(codes, lens, self.min_overlap)
        okpair = ok[0::2] & ok[1::2]
        good = 2 * int(okpair.sum())
        bad = m2 - good
        if not good:
            return good, bad, okpair
        sel = np.repeat(okpair, 2)
        canon, flipped = packing.canonicalize_codes_np(codes[sel], lens[sel])
        limbs = packing.pack_sort_limbs(canon, lens[sel])
        nlimb = self.sort_limbs.shape[1]
        if limbs.shape[1] > nlimb:
            if limbs[:, nlimb:].any():
                raise KeyError("String not found in Dataset (too long)")
            limbs = limbs[:, :nlimb]
        q = np.zeros((limbs.shape[0], nlimb), dtype=np.uint64)
        q[:, :limbs.shape[1]] = limbs
        rid = self._batch_find_ids(q)
        sup = self.super_read_id[rid]
        remap = sup != 0
        rid = np.where(remap, sup, rid)
        # Orientation is the reference's substring probe (Dataset.cpp:294-298):
        # for a non-contained read the stored string is the equal-length
        # canonical form, so `s in stored` == rowwise equality.  Comparing
        # canon against the forward codes (not ~flipped) keeps palindromic
        # (self-RC) reads forward: their tie path reports flipped=True even
        # though the forward string matches the stored string.
        orient = (canon == codes[sel]).all(axis=1).astype(np.int64)
        del flipped
        if remap.any():
            # contained reads: the super read is longer, use the reference's
            # substring probe on the original (non-canonical) string
            gsel = np.flatnonzero(sel)
            for j in np.flatnonzero(remap):
                gj = int(gsel[j])
                orient[j] = 1 if orig(gj) in self.read_strs[int(rid[j])] \
                    else 0
        # both directions of every pair, interleaved in the reference's
        # insertion order (r1-entry then r2-entry per pair); dedup happens
        # vectorized in _build_mp_arrays
        r1a, r2a = rid[0::2], rid[1::2]
        o1a, o2a = orient[0::2], orient[1::2]
        m = len(r1a)
        rids = np.empty(2 * m, np.int64)
        rids[0::2] = r1a
        rids[1::2] = r2a
        mates = np.empty(2 * m, np.int64)
        mates[0::2] = r2a
        mates[1::2] = r1a
        ors = np.empty(2 * m, np.int64)
        ors[0::2] = o1a * 2 + o2a
        ors[1::2] = o1a + o2a * 2
        self._mp_pending.append((rids, mates, ors, dataset_number))
        return good, bad, okpair

    def _batch_find_ids(self, q):
        """Vectorized lexicographic lookup of query limb rows in the sorted
        dataset limb index (one np.searchsorted over a big-endian byte view
        — memcmp order == per-limb numeric order); returns 1-based read ids,
        raising like getReadFromString (Dataset.cpp:454) on a miss."""
        sl = self.sort_limbs
        n, nlimb = sl.shape
        if n == 0:
            raise KeyError("String not found in Dataset")
        vt = "V%d" % (8 * nlimb)
        view = getattr(self, "_sort_limbs_view", None)
        if view is None or len(view) != n:
            view = (np.ascontiguousarray(sl).astype(">u8")
                    .reshape(n, -1).view(vt).ravel())
            self._sort_limbs_view = view
        qv = (np.ascontiguousarray(q).astype(">u8")
              .reshape(len(q), -1).view(vt).ravel())
        lo = np.searchsorted(view, qv)
        safe = np.minimum(lo, n - 1)
        ok = (lo < n) & (sl[safe] == q).all(axis=1)
        if not ok.all():
            raise KeyError("String not found in Dataset")
        return lo + 1

    # -------------------------------------------------------------- artifacts

    def save_reads(self, path):
        """Write the sorted-reads debug dump (reference: Dataset.cpp:71-90);
        reads are decoded in blocked batches (one LUT gather per block)."""
        n = self.number_of_unique_reads
        B = 1 << 15
        with open(path, "wb") as f:
            for s in range(1, n + 1, B):
                e = min(s + B, n + 1)
                amat = packing.codes_to_ascii_all(self.codes_fwd[s:e])
                lens = self.lengths[s:e].tolist()
                sups = self.super_read_id[s:e].tolist()
                flat = amat.reshape(-1).data
                w = amat.shape[1]
                rows = []
                for t in range(e - s):
                    sup = sups[t]
                    rows.append(b"%10d %b %10d %b\n" % (
                        s + t,
                        b"Contained in" if sup else b"Noncontained",
                        sup, flat[t * w:t * w + lens[t]]))
                f.write(b"".join(rows))


def _test_read(s: str) -> bool:
    """Host-side QC identical to Dataset::testRead (Dataset.cpp:398-413)."""
    cnt = [0, 0, 0, 0]
    for ch in s:
        if ch == "A":
            cnt[0] += 1
        elif ch == "C":
            cnt[1] += 1
        elif ch == "G":
            cnt[2] += 1
        elif ch == "T":
            cnt[3] += 1
        else:
            return False
    threshold = int(len(s) * 0.8)
    return not any(c >= threshold for c in cnt)
