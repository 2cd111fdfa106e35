"""Loader for the native (C++) graph-construction engine.

Compiles mg_native.cpp on first use (g++ -O2 -shared) and exposes it via
ctypes.  If no compiler is available the package transparently falls back to
the pure-Python construction path (same semantics, slower).
"""

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "mg_native.cpp")
_SO = os.path.join(_DIR, "libmg_native.so")

_lock = threading.Lock()
_lib = None
_tried = False

_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I8P = ctypes.POINTER(ctypes.c_int8)


def _build_lib():
    """Compile _SRC into _SO.  Processes that start at once (test workers,
    the CLI beside a test) take turns on a lock file beside the library;
    each writes its own temp file, and one that finds the library built
    while it waited does not build it again.  The compile is a span
    kernel.build of the port's recorder."""
    import contextlib
    import fcntl
    try:
        from ..utils.timing import span
    except ImportError:
        # this file loaded on its own, outside the package
        def span(name, **attrs):
            return contextlib.nullcontext()
    with open(_SO + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if (os.path.exists(_SO)
                and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)):
            return
        tmp = "%s.%d.tmp" % (_SO, os.getpid())
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
               "-o", tmp, _SRC]
        with span("kernel.build", library=_SO):
            try:
                subprocess.run(cmd, check=True, capture_output=True)
            except subprocess.CalledProcessError:
                cmd = ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, _SRC]
                subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _SO)


def get_lib():
    """Return the loaded library or None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if (not os.path.exists(_SO)
                    or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
                _build_lib()
            lib = ctypes.CDLL(_SO)
        except Exception:
            return None
        lib.mg_build.restype = ctypes.c_void_p
        lib.mg_build.argtypes = [
            ctypes.c_int64, _I64P, _U8P, ctypes.c_int64, _I64P, _I64P,
            _I8P, _I64P, ctypes.c_int64]
        lib.mg_assemble.restype = ctypes.c_void_p
        lib.mg_assemble.argtypes = [
            ctypes.c_int64, _I64P, _U8P, _U8P, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
        lib.mg_build_stream.restype = ctypes.c_void_p
        lib.mg_build_stream.argtypes = [
            ctypes.c_int64, _I64P, _I64P,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
        lib.mg_build_stream_canon.restype = ctypes.c_void_p
        lib.mg_build_stream_canon.argtypes = [
            ctypes.c_int64, _I64P, _I64P,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
        lib.mg_build_stream_canon_words.restype = ctypes.c_void_p
        lib.mg_build_stream_canon_words.argtypes = [
            ctypes.c_int64, _I64P, _I64P,
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
        lib.mg_scan_canon.restype = ctypes.c_void_p
        lib.mg_scan_canon.argtypes = [
            ctypes.c_int64, _I64P, _U8P, _U8P, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64]
        lib.mg_scan_canon_len.restype = ctypes.c_int64
        lib.mg_scan_canon_len.argtypes = [ctypes.c_void_p]
        lib.mg_scan_canon_cont_len.restype = ctypes.c_int64
        lib.mg_scan_canon_cont_len.argtypes = [ctypes.c_void_p]
        lib.mg_scan_canon_fetch.restype = None
        lib.mg_scan_canon_fetch.argtypes = [
            ctypes.c_void_p, _I64P, ctypes.POINTER(ctypes.c_uint32)]
        lib.mg_scan_canon_cont.restype = None
        lib.mg_scan_canon_cont.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32)]
        lib.mg_scan_canon_free.restype = None
        lib.mg_scan_canon_free.argtypes = [ctypes.c_void_p]
        lib.mg_supers.restype = None
        lib.mg_supers.argtypes = [ctypes.c_void_p, _I64P]
        for name in ("mg_num_edges", "mg_num_nodes", "mg_graph_num_edges",
                     "mg_manifest_len", "mg_serial_counter", "mg_loc_total",
                     "mg_bfs_nodes", "mg_bfs_edges", "mg_iter_log_len",
                     "mg_bfs_heartbeats_len", "mg_cont_heartbeats_len"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_void_p]
        lib.mg_edges.restype = None
        lib.mg_edges.argtypes = [ctypes.c_void_p] + [_I64P] * 8
        lib.mg_manifest.restype = None
        lib.mg_manifest.argtypes = [ctypes.c_void_p, _I64P, _I64P, _U8P]
        lib.mg_locations.restype = None
        lib.mg_locations.argtypes = [ctypes.c_void_p, _I64P, _I64P, _I64P,
                                     _I64P]
        lib.mg_iter_log.restype = None
        lib.mg_iter_log.argtypes = [ctypes.c_void_p, _I64P, _I64P, _I64P]
        lib.mg_bfs_heartbeats.restype = None
        lib.mg_bfs_heartbeats.argtypes = [ctypes.c_void_p, _I64P, _I64P,
                                          _I64P]
        lib.mg_cont_heartbeats.restype = None
        lib.mg_cont_heartbeats.argtypes = [ctypes.c_void_p, _I64P, _I64P]
        lib.mg_hashstats.restype = None
        lib.mg_hashstats.argtypes = [
            ctypes.c_int64, _I64P, _U8P, _U8P, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, _I64P, _I64P, ctypes.c_int64]
        lib.mg_free.restype = None
        lib.mg_free.argtypes = [ctypes.c_void_p]
        lib.mg_mincostflow.restype = ctypes.c_int64
        lib.mg_mincostflow.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                       _I64P, _I64P, _I64P, _I64P, _I64P,
                                       _I64P]
        _lib = lib
        return _lib


def _p64(a):
    return a.ctypes.data_as(_I64P)


def build_graph_native(lengths, contained, cand_start, cand_dest,
                       cand_orient, cand_offset, dead_end_length):
    """Run the native construction engine.  Returns a dict of numpy arrays
    describing the final graph (emission order = node-ascending adjacency
    order) or None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n_reads = len(lengths) - 1
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    contained = np.ascontiguousarray(contained, dtype=np.uint8)
    cand_start = np.ascontiguousarray(cand_start, dtype=np.int64)
    cand_dest = np.ascontiguousarray(cand_dest, dtype=np.int64)
    cand_orient = np.ascontiguousarray(cand_orient, dtype=np.int8)
    cand_offset = np.ascontiguousarray(cand_offset, dtype=np.int64)
    h = lib.mg_build(
        n_reads, _p64(lengths), contained.ctypes.data_as(_U8P),
        len(cand_dest), _p64(cand_start), _p64(cand_dest),
        cand_orient.ctypes.data_as(_I8P), _p64(cand_offset),
        dead_end_length)
    return _extract_result(lib, h, n_reads, want_supers=False)


def build_graph_stream(lengths, counts, r2, meta, mixed, dead_end_length,
                       n_threads=None):
    """Threaded native replay of the device pipeline's survivor stream
    (per-read counts + (r2, meta) in reference discovery order; meta bits:
    0-1 edge orientation, 2 edge_ok, 3 cont_ok, 4-15 overlap offset).
    Performs containment replay + super filter + BFS construction; returns
    the graph dict with a 'supers' array, or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if n_threads is None:
        n_threads = os.cpu_count() or 1
    n_reads = len(lengths) - 1
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    r2 = np.ascontiguousarray(r2, dtype=np.int32)
    meta = np.ascontiguousarray(meta, dtype=np.uint16)
    h = lib.mg_build_stream(
        n_reads, _p64(lengths), _p64(counts),
        r2.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        meta.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        len(r2), 1 if mixed else 0, dead_end_length, n_threads)
    return _extract_result(lib, h, n_reads, want_supers=True)


def build_graph_stream_canon(lengths, counts, r2, meta, hash_len,
                             dead_end_length, n_threads=None):
    """Threaded native replay of the CANONICAL (deduplicated) device
    survivor stream: one record per physical overlap, discovered from its
    smaller endpoint (self overlaps keep both occurrences); containment is
    already resolved on device, so every record is a kept edge.  The C++
    side reconstructs the mirror occurrences and each read's discovery
    order arithmetically (see mg_build_stream_canon).  Returns the graph
    dict (no 'supers' — the caller owns the device-computed supers), or
    None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if n_threads is None:
        n_threads = os.cpu_count() or 1
    n_reads = len(lengths) - 1
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    r2 = np.ascontiguousarray(r2, dtype=np.int32)
    meta = np.ascontiguousarray(meta, dtype=np.uint16)
    h = lib.mg_build_stream_canon(
        n_reads, _p64(lengths), _p64(counts),
        r2.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        meta.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        len(r2), hash_len, dead_end_length, n_threads)
    return _extract_result(lib, h, n_reads, want_supers=False)


def build_graph_stream_canon_words(lengths, counts, words, off_bits,
                                   hash_len, dead_end_length,
                                   n_threads=None):
    """build_graph_stream_canon over the device pipeline's packed uint32
    words [r2 | flags:4 | offset:off_bits] — no host-side unpack."""
    lib = get_lib()
    if lib is None:
        return None
    if n_threads is None:
        n_threads = os.cpu_count() or 1
    n_reads = len(lengths) - 1
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    words = np.ascontiguousarray(words, dtype=np.uint32)
    h = lib.mg_build_stream_canon_words(
        n_reads, _p64(lengths), _p64(counts),
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        len(words), off_bits, hash_len, dead_end_length, n_threads)
    return _extract_result(lib, h, n_reads, want_supers=False)


def scan_canon(lengths, codes_fwd, codes_rev, hash_len, r_lo, r_hi,
               off_bits, n_threads=1, mixed=False):
    """CPU-side canonical overlap scan of reads [r_lo, r_hi) against the
    full index, for the hybrid engine: returns (counts int64 [n+1],
    words uint32) in the device pipeline's packed layout — plus, in mixed
    mode, (cont_r1, cont_r2) containment hits in discovery order (edge
    records are then UNFILTERED by containment; the caller resolves
    supers globally).  None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n_reads = len(lengths) - 1
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    codes_fwd = np.ascontiguousarray(codes_fwd, dtype=np.uint8)
    codes_rev = np.ascontiguousarray(codes_rev, dtype=np.uint8)
    h = lib.mg_scan_canon(
        n_reads, _p64(lengths), codes_fwd.ctypes.data_as(_U8P),
        codes_rev.ctypes.data_as(_U8P), codes_fwd.shape[1], hash_len,
        r_lo, r_hi, off_bits, 1 if mixed else 0, n_threads)
    try:
        m = lib.mg_scan_canon_len(h)
        counts = np.empty(n_reads + 1, dtype=np.int64)
        words = np.empty(m, dtype=np.uint32)
        lib.mg_scan_canon_fetch(
            h, _p64(counts),
            words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
        if not mixed:
            return counts, words
        nc = lib.mg_scan_canon_cont_len(h)
        cr1 = np.empty(nc, dtype=np.int32)
        cr2 = np.empty(nc, dtype=np.int32)
        lib.mg_scan_canon_cont(
            h, cr1.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            cr2.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return counts, words, cr1, cr2
    finally:
        lib.mg_scan_canon_free(h)


def solve_min_cost_flow_native(n, arcs):
    """Native exact min-cost-flow (mg_mincostflow): identical tie-breaking
    to mincostflow.solve_min_cost_flow, so both return the same flow vector.
    Returns the per-arc flow list, None if the library is unavailable;
    raises ValueError on an infeasible instance (matching the Python
    solver)."""
    lib = get_lib()
    if lib is None:
        return None
    m = len(arcs)
    a = np.asarray(arcs, dtype=np.int64).reshape(m, 5)
    cols = [np.ascontiguousarray(a[:, k]) for k in range(5)]
    flow = np.empty(m, dtype=np.int64)
    rc = lib.mg_mincostflow(n, m, *(_p64(c) for c in cols), _p64(flow))
    if rc != 0:
        raise ValueError("infeasible min-cost flow instance")
    return flow.tolist()


def assemble_native(lengths, codes_fwd, codes_rev, hash_len, mixed,
                    dead_end_length, n_threads=None):
    """Full native overlap-detection + construction (index, probe scan,
    containment, BFS, contraction).  Returns the graph dict plus a
    'supers' array, or None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if n_threads is None:
        n_threads = os.cpu_count() or 1
    n_reads = len(lengths) - 1
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    codes_fwd = np.ascontiguousarray(codes_fwd, dtype=np.uint8)
    codes_rev = np.ascontiguousarray(codes_rev, dtype=np.uint8)
    h = lib.mg_assemble(
        n_reads, _p64(lengths), codes_fwd.ctypes.data_as(_U8P),
        codes_rev.ctypes.data_as(_U8P), codes_fwd.shape[1], hash_len,
        1 if mixed else 0, dead_end_length, n_threads)
    return _extract_result(lib, h, n_reads, want_supers=True)


def _extract_result(lib, h, n_reads, want_supers):
    try:
        ne = lib.mg_num_edges(h)
        ml = lib.mg_manifest_len(h)
        out = {name: np.empty(ne, dtype=np.int64)
               for name in ("src", "dst", "orient", "offset", "serial",
                            "twin_pos", "man_start", "man_len")}
        lib.mg_edges(h, *[_p64(out[k]) for k in
                          ("src", "dst", "orient", "offset", "serial",
                           "twin_pos", "man_start", "man_len")])
        man_reads = np.empty(ml, dtype=np.int64)
        man_offsets = np.empty(ml, dtype=np.int64)
        man_orients = np.empty(ml, dtype=np.uint8)
        lib.mg_manifest(h, _p64(man_reads), _p64(man_offsets),
                        man_orients.ctypes.data_as(_U8P))
        lt = lib.mg_loc_total(h)
        counts_f = np.empty(n_reads + 1, dtype=np.int64)
        counts_r = np.empty(n_reads + 1, dtype=np.int64)
        loc_edge_pos = np.empty(lt, dtype=np.int64)
        loc_dist = np.empty(lt, dtype=np.int64)
        lib.mg_locations(h, _p64(counts_f), _p64(counts_r),
                         _p64(loc_edge_pos), _p64(loc_dist))
        nch = lib.mg_cont_heartbeats_len(h)
        ch_b = np.zeros(max(nch, 1), dtype=np.int64)
        ch_c = np.zeros(max(nch, 1), dtype=np.int64)
        lib.mg_cont_heartbeats(h, _p64(ch_b), _p64(ch_c))
        nhb = lib.mg_bfs_heartbeats_len(h)
        hb_c = np.zeros(max(nhb, 1), dtype=np.int64)
        hb_n = np.zeros(max(nhb, 1), dtype=np.int64)
        hb_e = np.zeros(max(nhb, 1), dtype=np.int64)
        lib.mg_bfs_heartbeats(h, _p64(hb_c), _p64(hb_n), _p64(hb_e))
        nit = lib.mg_iter_log_len(h)
        it_merged = np.zeros(max(nit, 1), dtype=np.int64)
        it_dead_nodes = np.zeros(max(nit, 1), dtype=np.int64)
        it_dead_edges = np.zeros(max(nit, 1), dtype=np.int64)
        lib.mg_iter_log(h, _p64(it_merged), _p64(it_dead_nodes),
                        _p64(it_dead_edges))
        out.update(
            man_reads=man_reads, man_offsets=man_offsets,
            man_orients=man_orients, counts_f=counts_f, counts_r=counts_r,
            loc_edge_pos=loc_edge_pos, loc_dist=loc_dist,
            n_nodes=lib.mg_num_nodes(h),
            n_edges=lib.mg_graph_num_edges(h),
            bfs_nodes=lib.mg_bfs_nodes(h),
            bfs_edges=lib.mg_bfs_edges(h),
            iter_log=list(zip(it_merged[:nit].tolist(),
                              it_dead_nodes[:nit].tolist(),
                              it_dead_edges[:nit].tolist())),
            bfs_heartbeats=list(zip(hb_c[:nhb].tolist(), hb_n[:nhb].tolist(),
                                    hb_e[:nhb].tolist())),
            cont_heartbeats=list(zip(ch_b[:nch].tolist(),
                                     ch_c[:nch].tolist())),
            serial_counter=lib.mg_serial_counter(h))
        if want_supers:
            supers = np.zeros(n_reads + 1, dtype=np.int64)
            lib.mg_supers(h, _p64(supers))
            out["supers"] = supers
        return out
    finally:
        lib.mg_free(h)
