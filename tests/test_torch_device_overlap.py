"""Each stage of the port's device overlap pipeline against its JAX
counterpart, fed the same upstream state through from_jax_arrays, so a
mismatch points at one stage.  Every value is an integer: the tolerance is
exact equality of every array (uint32 values compare as their int64
zero-extension, uint16 meta as int32)."""

import os

import numpy as np
import pytest
import torch

# one torch thread: the suite runs several workers side by side, and
# torch's spinning OpenMP threads would fight them (and JAX) for the cores
torch.set_num_threads(1)

from metagenomics_tpu.dataset import Dataset
from metagenomics_tpu.ops import device_overlap as jdo
from metagenomics_tpu.ops import packing as jpacking
from metagenomics_tpu.ops.overlap import (CandidateBatch,
                                          verify_candidates as jverify)
from metagenomics_tpu_torch.ops import device_overlap as tdo
from metagenomics_tpu_torch.ops.overlap import verify_candidates as tverify

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "golden", "data")
CPU = torch.device("cpu")
MIN_OVERLAP = 40
L = MIN_OVERLAP - 1


def _quiet(*a, **k):
    pass


def _np(x):
    """Array (JAX or torch) -> numpy, widened so uint32 compares with its
    int64 zero-extension and uint16 with int32."""
    if isinstance(x, torch.Tensor):
        return x.numpy()
    a = np.asarray(x)
    if a.dtype == np.uint32:
        return a.astype(np.int64)
    if a.dtype == np.uint16:
        return a.astype(np.int32)
    return a


def _equal(got, want, what):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, "%s: shape %s != %s" % (what, g.shape,
                                                       w.shape)
    np.testing.assert_array_equal(g, w, err_msg=what)


@pytest.fixture(scope="module")
def pipes():
    """JAX pipelines on a uniform-length and a mixed-length golden set."""
    out = {}
    for name in ("se_small", "se_mixlen"):
        ds = Dataset([], [os.path.join(GOLDEN, name + ".fasta")],
                     MIN_OVERLAP, log=_quiet)
        out[name] = jdo.DeviceOverlapPipeline(ds, MIN_OVERLAP)
    return out


def _t(**arrays):
    return tdo.from_jax_arrays(arrays, CPU)


def test_from_jax_arrays_dtypes():
    t = _t(a=np.array([0, 0xFFFFFFFF], np.uint32),
           b=np.array([7, 0xFFFF], np.uint16),
           c=np.array([-3, 4], np.int32))
    assert t["a"].dtype == torch.int64 and t["a"].tolist() == [0, 0xFFFFFFFF]
    assert t["b"].dtype == torch.int32 and t["b"].tolist() == [7, 0xFFFF]
    assert t["c"].dtype == torch.int32 and t["c"].tolist() == [-3, 4]


@pytest.mark.parametrize("name", ["se_small", "se_mixlen"])
def test_setup_kernel(pipes, name):
    jp = pipes[name]
    pf = jdo.pack_codes_host(jp.ds.codes_fwd)
    want = jdo._setup_kernel(pf, jp.lengths, L, jp.w, jp.wp, jp.lmax, False)
    t = _t(pf=pf, lengths=np.asarray(jp.lengths))
    got = tdo._setup_kernel(t["pf"], t["lengths"], L, jp.w, jp.wp, jp.lmax)
    for g, w, what in zip(got, want, ("packed2", "hf", "sk", "sid")):
        _equal(g, w, what)


@pytest.mark.parametrize("name,row0", [("se_small", 0), ("se_mixlen", 0),
                                       ("se_mixlen", 700)])
def test_probe_join(pipes, name, row0):
    jp = pipes[name]
    hf = np.asarray(jp.hf)[row0:]
    lengths = np.asarray(jp.lengths)[row0:]
    sk = np.asarray(jp.sk)
    sum_block = 64
    want = jdo._probe_join(hf, lengths, sk, L, sum_block)
    t = _t(hf=hf, lengths=lengths, sk=sk)
    got = tdo._probe_join(t["hf"], t["lengths"], t["sk"], L, sum_block)
    for g, w, what in zip(got, want,
                          ("rk", "rleft", "rcnt", "h_total", "parts")):
        _equal(g, w, what)


def test_row_stats(pipes):
    jp = pipes["se_mixlen"]
    n1, npos = jp.hf.shape
    want = jdo._row_stats(jp.rk, jp.rcnt, np.int32(jp.h_total), n1, npos)
    t = _t(rk=np.asarray(jp.rk), rcnt=np.asarray(jp.rcnt))
    got = tdo._row_stats(t["rk"], t["rcnt"], jp.h_total, n1, npos)
    for g, w, what in zip(got, want, ("row_tot", "row_hits")):
        _equal(g, w, what)


def _emit_both(jp, check_cont, dedup, off_bits, uniform_len, chunk=0):
    """Run the JAX and the port's _emit2 on one chunk of jp's plan."""
    cap, nqt, chunks = jp._plan_chunks()
    h0, nh = chunks[chunk]
    rk_pad, rleft_pad, rcnt_pad = jp._padded(nqt)
    want = jdo._emit2(
        jp.packed2, jp.lengths, rk_pad, rleft_pad, rcnt_pad, jp.sid,
        np.int32(h0), np.int32(nh), np.int32(jp.row0), L, nqt, cap,
        jp.npos, jp.w, jp.qw_max, check_cont, off_bits, uniform_len,
        dedup=dedup)
    t = _t(packed2=np.asarray(jp.packed2), lengths=np.asarray(jp.lengths),
           rk_pad=np.asarray(rk_pad), rleft_pad=np.asarray(rleft_pad),
           rcnt_pad=np.asarray(rcnt_pad), sid=np.asarray(jp.sid))
    got = tdo._emit2(
        t["packed2"], t["lengths"], t["rk_pad"], t["rleft_pad"],
        t["rcnt_pad"], t["sid"], h0, nh, jp.row0, L, nqt, cap, jp.npos,
        jp.w, jp.qw_max, check_cont, off_bits, uniform_len, dedup=dedup)
    return got, want


# (check_cont, dedup): keep all / keep canonical / canonical + containment
KEEP_MODES = [(True, False), (False, True), (True, True)]


@pytest.mark.parametrize("check_cont,dedup", KEEP_MODES)
@pytest.mark.parametrize("layout", ["words", "r2_meta"])
def test_emit2_mixed(pipes, check_cont, dedup, layout):
    jp = pipes["se_mixlen"]
    off_bits = jp.off_bits if layout == "words" else -1
    (gout, gkc, gnk), (wout, wkc, wnk) = _emit_both(
        jp, check_cont, dedup, off_bits, -1)
    if layout == "words":
        _equal(gout, wout, "words")
    else:
        _equal(gout[0], wout[0], "r2")
        _equal(gout[1], wout[1], "meta")
    _equal(gkc, wkc, "keep_counts")
    _equal(gnk, wnk, "n_keep")
    assert int(gnk) > 0


@pytest.mark.parametrize("check_cont,dedup", KEEP_MODES)
def test_emit2_uniform_len(pipes, check_cont, dedup):
    jp = pipes["se_small"]
    assert jp.uniform_len == 100
    (gout, gkc, gnk), (wout, wkc, wnk) = _emit_both(
        jp, check_cont, dedup, jp.off_bits, jp.uniform_len)
    _equal(gout, wout, "words")
    _equal(gkc, wkc, "keep_counts")
    _equal(gnk, wnk, "n_keep")


def test_emit2_later_chunk(pipes):
    """A chunk that starts past hit 0 (multi-chunk plan, h0 > 0)."""
    jp = pipes["se_small"]
    old = jdo.DeviceOverlapPipeline.MAX_CAP
    try:
        jdo.DeviceOverlapPipeline.MAX_CAP = 1 << 14
        jp._pad_cache = None
        assert len(jp._plan_chunks()[2]) > 1
        (gout, gkc, gnk), (wout, wkc, wnk) = _emit_both(
            jp, False, True, jp.off_bits, jp.uniform_len, chunk=1)
    finally:
        jdo.DeviceOverlapPipeline.MAX_CAP = old
        jp._pad_cache = None
    _equal(gout, wout, "words")
    _equal(gkc, wkc, "keep_counts")
    _equal(gnk, wnk, "n_keep")


def test_cont_canon(pipes):
    jp = pipes["se_mixlen"]
    n1 = jp.hf.shape[0]
    (out, kc, nk), (jout, jkc, jnk) = _emit_both(jp, True, False,
                                                 jp.off_bits, -1)
    want = jdo._cont_canon(jout, jkc, jnk, jp.lengths, n1, jp.off_bits)
    got = tdo._cont_canon(out, kc, nk, _t(lengths=jp.lengths)["lengths"],
                          n1, jp.off_bits)
    for g, w, what in zip(got, want, ("words2", "counts2", "n_keep2",
                                      "supers", "firsthit")):
        _equal(g, w, what)
    assert int((got[3] != 0).sum()) > 0, "no contained reads exercised"


def _random_reads(rng, n, lmin, lmax):
    return ["".join(rng.choice(list("ACGT"), rng.integers(lmin, lmax + 1)))
            for _ in range(n)]


@pytest.mark.parametrize("mode", ["edge", "containment"])
def test_verify_candidates(mode):
    """Both verify modes on every (r1, j, r2, orient) of random reads."""
    rng = np.random.default_rng(3)
    reads = [""] + _random_reads(rng, 25, 12, 40)
    lens = np.array([len(r) for r in reads])
    ascii_arr = np.zeros((len(reads), lens.max()), np.uint8)
    for i, r in enumerate(reads):
        ascii_arr[i, :len(r)] = np.frombuffer(r.encode(), np.uint8)
    codes = jpacking.ascii_to_codes(ascii_arr, lens)
    # plant an exact overlap so both outcomes occur
    codes[2, :10] = codes[1, lens[1] - 10:lens[1]]
    rev = jpacking.reverse_complement_codes_np(codes, lens)
    l = 5
    r1, j, r2, orient = np.meshgrid(np.arange(1, len(reads)),
                                    np.arange(0, 36, 3),
                                    np.arange(1, len(reads)),
                                    np.arange(4), indexing="ij")
    batch = CandidateBatch(r1.ravel(), j.ravel(), r2.ravel(),
                           orient.ravel().astype(np.uint8))
    want = jverify(codes, rev, lens, batch, l, mode=mode, chunk=4096)
    got = tverify(codes, rev, lens, batch, l, mode=mode, chunk=4096,
                  device=CPU)
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()
