"""The emit_verify kernel's wrapper, mode and build rule on the CPU, and a
numpy model of the kernel (tests/emit_model.py) against the plain _emit2
on the golden sets: every mode, both survivor layouts, one length and
mixed lengths, a later chunk, spare slots past the total, a probe shard
and buckets of zero slots.  The kernel itself runs only on a card
(chip_smoke.py holds it bit-equal to the plain version there).  Every
value is an integer: the tolerance is exact equality."""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import emit_model
from metagenomics_tpu_torch.dataset import Dataset
from metagenomics_tpu_torch.ops import device_overlap as tdo
from metagenomics_tpu_torch.ops import emit_verify, window_hash
from metagenomics_tpu_torch.utils import timing

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "golden", "data")
MIN_OVERLAP = 40
L = MIN_OVERLAP - 1

# (check_cont, dedup): keep all edges / canonical / canonical + containment
# / edges and containment (stream_canon(True)); the hybrid's modes and the
# device engine's
MODES = [(False, False), (False, True), (True, True), (True, False)]


def _quiet(*a, **k):
    pass


@pytest.fixture(scope="module")
def pipes():
    """The port's pipelines on the CPU: a uniform- and a mixed-length
    golden set, and the mixed set's hybrid-style shard of the top reads."""
    out = {}
    for name in ("se_small", "se_mixlen"):
        ds = Dataset([], [os.path.join(GOLDEN, name + ".fasta")],
                     MIN_OVERLAP, log=_quiet)
        out[name] = tdo.DeviceOverlapPipeline(ds, MIN_OVERLAP, device="cpu")
    ds = out["se_mixlen"].ds
    out["shard"] = tdo.DeviceOverlapPipeline(
        ds, MIN_OVERLAP, row_lo=1 + int(0.9 * ds.number_of_unique_reads),
        device="cpu")
    return out


def _call(p, check_cont, dedup, off_bits, uniform_len, chunk=0, cap=None):
    """The arguments of one _emit2 call on chunk `chunk` of p's plan."""
    pcap, nqt, chunks = p._plan_chunks()
    h0, nh = chunks[chunk]
    rk_pad, rleft_pad, rcnt_pad = p._padded(nqt)
    return (p.packed2, p.lengths, rk_pad, rleft_pad, rcnt_pad, p.sid, h0, nh,
            p.row0, p.hash_len, nqt, cap or pcap, p.npos, p.w, p.qw_max,
            check_cont, off_bits, uniform_len), dict(dedup=dedup)


def _model_vs_plain(args, kw, tile=emit_model.TILE):
    """The model's survivors, counts and n_keep against the plain
    version's first n_keep slots; returns (n_keep, compared, total)."""
    out, kc, nk = tdo._emit2_torch(*args, **kw)
    (packed2, lengths, rk_pad, rleft_pad, rcnt_pad, sid, h0, nh, row0, l,
     nqt, cap, npos, w, qw_max, check_cont, off_bits, uniform_len) = args
    mout, mkc, mnk, compared = emit_model.emit2(
        packed2.numpy(), lengths.numpy(), rk_pad.numpy(), rleft_pad.numpy(),
        rcnt_pad.numpy(), sid.numpy(), h0, nh, row0, l, cap, npos, w, qw_max,
        check_cont, off_bits, uniform_len, kw["dedup"], tile)
    nk = int(nk)
    assert mnk == nk
    np.testing.assert_array_equal(mkc, kc.numpy())
    if off_bits >= 0:
        np.testing.assert_array_equal(mout, out[:nk].numpy())
    else:
        np.testing.assert_array_equal(mout[0], out[0][:nk].numpy())
        np.testing.assert_array_equal(mout[1], out[1][:nk].numpy())
    total = int(rcnt_pad[h0:h0 + nh].sum())
    return nk, compared, total


# ----------------------------------------------------- mode and wrapper

@pytest.mark.parametrize("check_cont", [False, True])
@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("off_bits", [7, -1])
@pytest.mark.parametrize("uniform_len", [150, -1])
def test_kernel_mode(check_cont, dedup, off_bits, uniform_len):
    """The mode bits come from the call's own arguments, one bit each."""
    mode = emit_verify.kernel_mode(check_cont, dedup, off_bits, uniform_len)
    assert bool(mode & emit_verify.MODE_CONT) == check_cont
    assert bool(mode & emit_verify.MODE_DEDUP) == dedup
    assert bool(mode & emit_verify.MODE_WORDS) == (off_bits >= 0)
    assert bool(mode & emit_verify.MODE_UNIFORM) == (uniform_len >= 0)
    assert 0 <= mode < 16


def test_wrapper_refuses_cpu_tensors(pipes):
    args, kw = _call(pipes["se_small"], False, True, 7, 100)
    before = emit_verify.launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        emit_verify.emit2_cuda(*args, **kw)
    assert emit_verify.launches == before


def _bad(name):
    """Mutate one argument of a good call the way `name` says."""
    def go(a):
        if name == "packed2_int32":
            a[0] = a[0].to(torch.int32)
        elif name == "packed2_rows":
            a[0] = a[0][:-2]
        elif name == "packed2_narrow":
            a[0] = a[0][:, :a[13] + a[14]].contiguous()
        elif name == "packed2_strided":
            a[0] = a[0].t().contiguous().t()
        elif name == "lengths_int64":
            a[1] = a[1].to(torch.int64)
        elif name == "rk_int32":
            a[2] = a[2].to(torch.int32)
        elif name == "rleft_int64":
            a[3] = a[3].to(torch.int64)
        elif name == "rcnt_short":
            a[4] = a[4][:-1]
        elif name == "sid_2d":
            a[5] = a[5][:, None]
        elif name == "lengths_meta":
            a[1] = torch.empty(a[1].shape, dtype=torch.int32, device="meta")
        elif name == "chunk_past_end":
            a[6] = a[2].shape[0] - a[10] + 1
        elif name == "nh_over_tier":
            a[7] = a[10] + 1
        elif name == "cap_zero":
            a[11] = 0
        elif name == "off_bits_wide":
            a[16] = 28
        return a
    return go


BAD = ["packed2_int32", "packed2_rows", "packed2_narrow", "packed2_strided",
       "lengths_int64", "rk_int32", "rleft_int64", "rcnt_short", "sid_2d",
       "lengths_meta", "chunk_past_end", "nh_over_tier", "cap_zero",
       "off_bits_wide"]


def _checked(args):
    (packed2, lengths, rk_pad, rleft_pad, rcnt_pad, sid, h0, nh, _, _, nqt,
     cap, npos, w, qw_max, _, off_bits, _) = args
    emit_verify._check(packed2, lengths, rk_pad, rleft_pad, rcnt_pad, sid,
                       h0, nh, nqt, cap, npos, w, qw_max, off_bits)


@pytest.mark.parametrize("name", BAD)
def test_wrapper_refuses_bad_arguments(pipes, name):
    """Wrong dtypes, shapes, strides, devices and ranges raise before any
    launch; the good call passes the same check."""
    args, _ = _call(pipes["se_small"], False, True, 7, 100)
    _checked(args)
    with pytest.raises(ValueError):
        _checked(_bad(name)(list(args)))


def test_cpu_tensors_take_the_plain_path(pipes, monkeypatch):
    """_emit2 on CPU tensors runs _emit2_torch: no launch, no counter."""
    def refuse(*a, **k):
        raise AssertionError("the kernel was called for CPU tensors")
    monkeypatch.setattr(emit_verify, "emit2_cuda", refuse)
    monkeypatch.setattr(emit_verify, "launches", 0)
    rec = timing.Recorder()
    monkeypatch.setattr(timing, "recorder", rec)
    args, kw = _call(pipes["se_mixlen"], True, True, 9, -1)
    got = tdo._emit2(*args, **kw)
    want = tdo._emit2_torch(*args, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert emit_verify.launches == 0
    assert not [x for x in rec.snapshot() if x.name == "kernel.emit_verify"]


def test_kernel_source_and_build_rule(monkeypatch, tmp_path):
    """The CUDA source ships in the package, is built for sm_90a by the
    window-hash kernels' rule into a cache directory of its own, and its
    mode bits are the wrapper's."""
    src = open(emit_verify.SOURCE).read()
    assert os.path.dirname(emit_verify.SOURCE) == os.path.dirname(
        window_hash.SOURCE)
    assert 'extern "C" int emit_verify_launch' in src
    assert 'extern "C" int emit_verify_tile' in src
    assert "constexpr int kTile = kThreads * kItems" in src
    for name in ("CONT", "DEDUP", "WORDS", "UNIFORM"):
        bit = getattr(emit_verify, "MODE_" + name)
        assert "constexpr int kMode%s = %d;" % (
            name.capitalize(), bit) in src
    # four template parameters, all 16 instantiations reachable
    assert "template <bool kCont, bool kDedup, bool kWords, bool kUniform>" \
        in src
    assert "metagenomics_tpu/ops/device_overlap.py:445" in src
    assert "arch=compute_90a,code=sm_90a" in window_hash.NVCC_FLAGS
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do [ "$1" = -o ] && '
                    'touch "$2"; shift; done\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(window_hash, "_find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(window_hash, "BUILD_ROOT", str(tmp_path / "build"))
    so = emit_verify.build_library()
    assert os.path.exists(so)
    assert os.path.basename(so) == "libemit_verify.so"
    assert os.path.basename(os.path.dirname(so)).startswith("emit_verify-")
    assert window_hash.build_library() != so


def test_cuda_path_has_no_sort_nonzero_or_row_gather():
    """The CUDA path is one cumsum, the zeroed counts and the launch: no
    sort, no nonzero (a host sync), no [cap, w] gather."""
    import inspect
    body = inspect.getsource(emit_verify.emit2_cuda)
    for op in ("sort", "nonzero", "gather", "packed2[", ".item(", ".cpu("):
        assert op not in body, op
    assert body.count("torch.cumsum(") == 1
    code = "\n".join(line.split("//")[0]
                     for line in open(emit_verify.SOURCE).read().splitlines())
    assert "sort" not in code.lower()


def test_model_tile_is_the_kernels():
    src = open(emit_verify.SOURCE).read()
    threads = int(src.split("constexpr int kThreads = ")[1].split(";")[0])
    items = int(src.split("constexpr int kItems = ")[1].split(";")[0])
    assert threads * items == emit_model.TILE


# ------------------------------------------- the model vs the plain _emit2

@pytest.mark.parametrize("check_cont,dedup", MODES)
@pytest.mark.parametrize("layout", ["words", "r2_meta"])
@pytest.mark.parametrize("name", ["se_small", "se_mixlen"])
def test_model_equals_plain(pipes, name, layout, check_cont, dedup):
    p = pipes[name]
    uniform = p.uniform_len
    assert (uniform >= 0) == (name == "se_small")
    off_bits = p.off_bits if layout == "words" else -1
    args, kw = _call(p, check_cont, dedup, off_bits, uniform)
    nk, compared, total = _model_vs_plain(args, kw)
    assert 0 < nk <= compared <= total


@pytest.mark.parametrize("check_cont,dedup", MODES)
def test_model_equals_plain_on_a_shard(pipes, check_cont, dedup):
    """Rows [row0, n) probed, as the hybrid's device shard: in the
    deduplicating modes most slots have r1 > r2 and skip the compare."""
    p = pipes["shard"]
    assert p.row0 > 1
    args, kw = _call(p, check_cont, dedup, p.off_bits, -1)
    nk, compared, total = _model_vs_plain(args, kw)
    assert nk > 0
    if dedup and not check_cont:
        assert compared < total / 2


def test_model_later_chunk_and_small_tiles(pipes):
    """A chunk past hit 0 of a multi-chunk plan, in tiles of 64 slots."""
    p = pipes["se_small"]
    old = tdo.DeviceOverlapPipeline.MAX_CAP
    try:
        tdo.DeviceOverlapPipeline.MAX_CAP = 1 << 14
        p._pad_cache = None
        assert len(p._plan_chunks()[2]) > 1
        args, kw = _call(p, False, True, p.off_bits, p.uniform_len, chunk=1)
        assert args[6] > 0
        _model_vs_plain(args, kw, tile=64)
    finally:
        tdo.DeviceOverlapPipeline.MAX_CAP = old
        p._pad_cache = None


def test_model_spare_slots(pipes):
    """cap well past the total: the spare slots keep nothing."""
    p = pipes["se_mixlen"]
    cap = 4 * p._plan_chunks()[0]
    args, kw = _call(p, True, True, p.off_bits, -1, cap=cap)
    nk, _, total = _model_vs_plain(args, kw)
    assert total < cap // 4 and nk > 0


def test_model_buckets_of_zero_slots(pipes):
    """Hits with zero candidates inserted between the chunk's hits (runs of
    up to 150, past a 64-slot tile's marks): the owners still match."""
    p = pipes["se_mixlen"]
    cap, nqt, chunks = p._plan_chunks()
    h0, nh = chunks[0]
    rng = np.random.default_rng(3)
    rk = p.rk[:nh].numpy()
    rleft = p.rleft[:nh].numpy()
    rcnt = p.rcnt[:nh].numpy()
    reps = np.where(rng.random(nh) < 0.05, rng.integers(2, 150, nh), 1)
    idx = np.repeat(np.arange(nh), reps)
    first = np.r_[True, idx[1:] != idx[:-1]]
    nh2 = len(idx)
    nqt2 = tdo._tier(nh2)
    pad = nqt2
    rk2 = torch.from_numpy(np.r_[rk[idx], np.full(pad, tdo.PAD_HASH)])
    rleft2 = torch.from_numpy(np.r_[rleft[idx], np.zeros(pad, np.int32)])
    rcnt2 = torch.from_numpy(np.r_[np.where(first, rcnt[idx], 0),
                                   np.zeros(pad, np.int32)]
                             .astype(np.int32))
    args = (p.packed2, p.lengths, rk2, rleft2, rcnt2, p.sid, 0, nh2, p.row0,
            p.hash_len, nqt2, cap, p.npos, p.w, p.qw_max, True, p.off_bits,
            -1)
    nk, _, _ = _model_vs_plain(args, dict(dedup=True), tile=64)
    assert nk > 0
    # the same survivors as without the empty buckets
    base, _ = _call(p, True, True, p.off_bits, -1)
    want = tdo._emit2_torch(*base, dedup=True)
    got = tdo._emit2_torch(*args, dedup=True)
    assert int(got[2]) == int(want[2])
    assert torch.equal(got[0][:nk], want[0][:nk])
