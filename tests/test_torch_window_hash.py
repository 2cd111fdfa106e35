"""The port's plain window hash (window_hashes_torch) against the JAX
package's rolling hash and its Pallas kernel (interpret mode), and against
a numpy uint32 model of the CUDA kernel's prefix-difference arithmetic;
window_hashes_at against a gather of the full matrix, and its range check
deferred to a flag that the pipelines read back in their probe.  Inputs
are made with numpy from fixed seeds.  Every value is an integer, so the
tolerance is exact equality."""

import numpy as np
import pytest
import torch

from metagenomics_tpu.ops.device_overlap import window_hashes_u32
from metagenomics_tpu.ops.pallas_hash import window_hashes_pallas
from metagenomics_tpu_torch.ops import window_hash


def _codes(seed, n, lmax):
    return np.random.default_rng(seed).integers(0, 5, (n, lmax)).astype(
        np.uint8)


def _port(codes, l):
    out = window_hash.window_hashes(torch.from_numpy(codes), l)
    assert out.dtype == torch.int64
    return out.numpy()


@pytest.mark.parametrize("n,lmax,l", [
    (3, 50, 11), (300, 100, 39), (64, 130, 64),   # tests/test_ops.py
    (9, 40, 1),                                    # l = 1
    (9, 40, 40),                                   # l = lmax (npos = 1)
])
def test_window_hashes_match_jax(n, lmax, l):
    codes = _codes(5, n, lmax)
    want = np.asarray(window_hashes_u32(codes, l))
    got = _port(codes, l)
    assert got.shape == want.shape == (n, lmax - l + 1)
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_window_hashes_match_pallas_interpret():
    codes = _codes(6, 300, 100)
    want = np.asarray(window_hashes_pallas(codes, 39, interpret=True))
    np.testing.assert_array_equal(_port(codes, 39), want.astype(np.int64))


# chip_smoke.py's kernel shapes (its long-read shape at 4 rows)
KERNEL_SHAPES = [(3, 50, 11), (300, 100, 39), (64, 130, 64), (5, 40, 40),
                 (7, 33, 1), (4, 4095, 63)]


def _mixed_codes(seed, n, lmax, l):
    """Rows of random lengths in [l, lmax], padded with code 4 as the
    data set pads them; returns (codes, lengths)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(l, lmax + 1, n)
    codes = rng.integers(0, 4, (n, lmax)).astype(np.uint8)
    codes[np.arange(lmax)[None, :] >= lengths[:, None]] = 4
    return codes, lengths


def _prefix_difference_model(codes, l):
    """The CUDA kernel's arithmetic in numpy uint32: prefix hashes
    P[i] = P[i-1] * B + c[i-1] per row, then w[j] = P[j+l] - P[j] * B^l,
    mixed as (w1 * M1) xor (w2 * M2)."""
    c = (codes.astype(np.uint32) & 3) + 1
    n, lmax = codes.shape
    out = []
    for base in (window_hash._B1, window_hash._B2):
        b = np.uint32(base)
        p = np.zeros((n, lmax + 1), dtype=np.uint32)
        for i in range(lmax):
            p[:, i + 1] = p[:, i] * b + c[:, i]
        bl = np.uint32(pow(base, l, 1 << 32))
        out.append(p[:, l:] - p[:, :lmax - l + 1] * bl)
    return ((out[0] * np.uint32(window_hash._M1))
            ^ (out[1] * np.uint32(window_hash._M2))).astype(np.int64)


@pytest.mark.parametrize("n,lmax,l", KERNEL_SHAPES)
def test_prefix_difference_model_matches_plain(n, lmax, l):
    with np.errstate(over="ignore"):
        codes = _codes(11, n, lmax)
        np.testing.assert_array_equal(_prefix_difference_model(codes, l),
                                      _port(codes, l))
        codes, _ = _mixed_codes(12, n, lmax, l)
        np.testing.assert_array_equal(_prefix_difference_model(codes, l),
                                      _port(codes, l))


@pytest.mark.parametrize("n,lmax,l", KERNEL_SHAPES)
def test_window_hashes_at_is_a_gather(n, lmax, l):
    """At the pipeline's reverse-strand starts (lmax - len, lmax - l) and
    at random starts, on rows of mixed lengths."""
    codes, lengths = _mixed_codes(13, n, lmax, l)
    rng = np.random.default_rng(14)
    starts = np.stack([lmax - lengths, np.full(n, lmax - l),
                       rng.integers(0, lmax - l + 1, n)], axis=1)
    codes_t = torch.from_numpy(codes)
    starts_t = torch.from_numpy(starts.astype(np.int64))
    got = window_hash.window_hashes_at(codes_t, l, starts_t)
    want = torch.gather(window_hash.window_hashes_torch(codes_t, l), 1,
                        starts_t)
    assert got.dtype == torch.int64 and got.shape == (n, 3)
    assert torch.equal(got, want)
    assert torch.equal(window_hash.window_hashes_at_torch(codes_t, l,
                                                          starts_t), want)


def _horner(v4, nb, w1, w2):
    """The kernel's horner(): the low min(nb, 4) bytes of v4, low first,
    into both window sums mod 2^32."""
    for b in range(min(nb, 4)):
        v = (v4 >> (8 * b)) & 0xFF
        w1 = (w1 * window_hash._B1 + v) & 0xFFFFFFFF
        w2 = (w2 * window_hash._B2 + v) & 0xFFFFFFFF
    return w1, w2


def _chunked_at_model(codes, l, starts, mis):
    """window_hash_at_kernel's loads in Python, its rows in one buffer
    whose address is mis mod 16: each window read as the aligned 16-byte
    chunks that hold it, each chunk's 4-byte words taken apart by shifts
    with the bytes before the window masked off, or byte by byte where a
    chunk would leave the buffer.  Returns (hashes, outputs by path)."""
    n, lmax = codes.shape
    buf = codes.tobytes()
    out = np.zeros(starts.shape, np.int64)
    paths = {"bytes": 0, "chunks": 0, "head": 0}
    for (r, i), s in np.ndenumerate(starts):
        w1 = w2 = 0
        p = mis + r * lmax + int(s)          # the window's address
        head = p & 15
        cp = p - head
        nbytes = head + l
        nchunks = (nbytes + 15) >> 4
        if cp < mis or cp + 16 * nchunks > mis + n * lmax:
            paths["bytes"] += 1
            for b in buf[p - mis:p - mis + l]:
                w1, w2 = _horner((b & 3) + 1, 1, w1, w2)
        else:
            paths["chunks"] += 1
            paths["head"] += head > 0
            for c in range(nchunks):
                chunk = buf[cp - mis + 16 * c:cp - mis + 16 * c + 16]
                for j in range(4):
                    pos = 16 * c + 4 * j
                    lead = head - pos
                    if pos >= nbytes:
                        break
                    if lead >= 4:
                        continue
                    word = int.from_bytes(chunk[4 * j:4 * j + 4], "little")
                    v4 = (word & 0x03030303) + 0x01010101
                    if lead > 0:
                        v4 &= (0xFFFFFFFF << (8 * lead)) & 0xFFFFFFFF
                    w1, w2 = _horner(v4, nbytes - pos, w1, w2)
        out[r, i] = ((w1 * window_hash._M1) ^ (w2 * window_hash._M2)) \
            & 0xFFFFFFFF
    return out, paths


@pytest.mark.parametrize("mis", [0, 4, 15])
@pytest.mark.parametrize("n,lmax,l", [(300, 100, 39), (7, 33, 1),
                                      (5, 40, 40), (4, 4095, 63)])
def test_chunked_at_model_matches_plain(n, lmax, l, mis):
    """The kernel's chunk, head-mask and edge-fallback arithmetic (a
    numpy model) equals window_hashes_at_torch at unaligned addresses
    (mis 4: rows [1:] of an aligned [N, 100] tensor, as _setup_kernel
    passes them), at the reverse-strand starts, at 0 and lmax - l, and on
    the first and last rows."""
    codes, lengths = _mixed_codes(19, n, lmax, l)
    rng = np.random.default_rng(20)
    starts = np.stack([lmax - lengths, np.full(n, lmax - l),
                       rng.integers(0, lmax - l + 1, n), np.zeros(n)],
                      axis=1).astype(np.int64)
    got, paths = _chunked_at_model(codes, l, starts, mis)
    want = window_hash.window_hashes_at_torch(torch.from_numpy(codes), l,
                                              torch.from_numpy(starts))
    np.testing.assert_array_equal(got, want.numpy())
    assert paths["chunks"] and paths["head"]
    assert paths["bytes"] or mis == 0


@pytest.mark.parametrize("bad", [-1, 62])
def test_window_hashes_at_raises_out_of_range(bad):
    """A start outside [0, lmax - l] raises; nothing is clamped."""
    codes = torch.from_numpy(_codes(15, 4, 100))
    starts = torch.zeros((4, 2), dtype=torch.int64)
    window_hash.window_hashes_at(codes, 39, starts + 61)
    starts[2, 1] = bad
    with pytest.raises(ValueError, match="out of range"):
        window_hash.window_hashes_at(codes, 39, starts)
    with pytest.raises(ValueError, match="out of range"):
        window_hash.window_hashes_at_torch(codes, 39, starts)


@pytest.mark.parametrize("start", [-1, 62, 30])
def test_window_hashes_at_flagged_mode(start):
    """Given a flag, the plain version (and the CPU dispatcher) defers the
    range check as the kernel does: a start outside [0, lmax - l] (-1,
    lmax - l + 1 = 62) sets the flag and gives 0 at that output, and every
    other output equals the gather of the full matrix; a good start
    leaves the flag at 0."""
    codes = torch.from_numpy(_codes(16, 6, 100))
    l = 39
    starts = torch.from_numpy(np.random.default_rng(17).integers(
        0, 62, (6, 2)))
    starts[3, 1] = start
    want = torch.gather(window_hash.window_hashes_torch(codes, l), 1,
                        starts.clamp(0, 61))
    is_bad = not 0 <= start <= 61
    if is_bad:
        want[3, 1] = 0
    for fn in (window_hash.window_hashes_at_torch,
               window_hash.window_hashes_at):
        bad = torch.zeros(1, dtype=torch.int32)
        got = fn(codes, l, starts, bad)
        assert bad.tolist() == [int(is_bad)]
        assert torch.equal(got, want)


def test_window_hashes_at_flag_is_checked():
    """The flag must be one int32 on the codes' device."""
    codes = torch.from_numpy(_codes(18, 4, 50))
    starts = torch.zeros((4, 2), dtype=torch.int64)
    for flag in (torch.zeros(2, dtype=torch.int32),
                 torch.zeros(1, dtype=torch.int64)):
        with pytest.raises(ValueError, match="bad must be"):
            window_hash.window_hashes_at(codes, 11, starts, flag)


def _bad_reverse_starts(monkeypatch, module):
    """Shift every start `module` passes to window_hashes_at out of range
    (by lmax); returns the list the spy appends to once each call has
    returned, which shows the hash itself did not raise."""
    real = module.window_hashes_at
    returned = []

    def spy(codes, hash_len, starts, bad=None):
        out = real(codes, hash_len, starts + codes.shape[1], bad)
        returned.append(bad)
        return out
    monkeypatch.setattr(module, "window_hashes_at", spy)
    return returned


def _golden_dataset(name):
    import os
    from metagenomics_tpu_torch.dataset import Dataset
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "golden", "data", name + ".fasta")
    return Dataset([], [path], 40, log=lambda *a, **k: None)


def test_device_pipeline_raises_bad_starts_at_probe(monkeypatch):
    """Out-of-range reverse-strand starts in _setup_kernel set its flag
    without raising; _probe raises at its read-back of the hit total."""
    from metagenomics_tpu_torch.ops import device_overlap as tdo
    ds = _golden_dataset("se_small")
    returned = _bad_reverse_starts(monkeypatch, tdo)
    p = tdo.DeviceOverlapPipeline.__new__(tdo.DeviceOverlapPipeline)
    p._configure(ds, 40, 0, "cpu")
    p._build_index(tdo._upload_words(tdo.pack_codes_host(ds.codes_fwd),
                                     p.device))
    assert len(returned) == 1 and returned[0] is p.bad_start
    assert p.bad_start.tolist() == [1]
    with pytest.raises(ValueError, match="out of range"):
        p._probe()
    with pytest.raises(ValueError, match="out of range"):
        tdo.DeviceOverlapPipeline(ds, 40, device="cpu")


def test_sharded_setup_raises_bad_starts_at_read_back(monkeypatch):
    """The same on a 1-shard mesh: the setup stage returns with its flag
    set, and the constructor raises at the histograms' read-back, before
    the probe stage."""
    from metagenomics_tpu_torch.parallel import sharded
    from metagenomics_tpu_torch.parallel.mesh import make_mesh
    ds = _golden_dataset("se_small")
    returned = _bad_reverse_starts(monkeypatch, sharded)
    probed = []
    monkeypatch.setattr(sharded.ShardedOverlapPipeline, "_probe",
                        lambda self, *a: probed.append(a))
    with pytest.raises(ValueError, match="out of range"):
        sharded.ShardedOverlapPipeline(
            ds, 40, mesh=make_mesh(dp=1, ix=1, devices=[torch.device("cpu")]))
    assert len(returned) == 1 and returned[0].tolist() == [1]
    assert probed == []


def test_mul32_is_multiplication_mod_2_32():
    rng = np.random.default_rng(7)
    a = rng.integers(0, 1 << 32, 1000, dtype=np.uint64)
    b = rng.integers(0, 1 << 32, 1000, dtype=np.uint64)
    want = (a * b) & np.uint64(0xFFFFFFFF)      # uint64 wraps mod 2^64
    got = window_hash.mul32(torch.from_numpy(a.astype(np.int64)),
                            torch.from_numpy(b.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrappers never take a CPU tensor, and the dispatchers
    send CPU tensors to the plain versions without touching a kernel."""
    codes = torch.from_numpy(_codes(8, 4, 20))
    starts = torch.zeros((4, 2), dtype=torch.int64)
    with pytest.raises(ValueError):
        window_hash.window_hashes_cuda(codes, 5)
    with pytest.raises(ValueError):
        window_hash.window_hashes_at_cuda(codes, 5, starts)
    before = window_hash.launches, window_hash.at_launches
    window_hash.window_hashes(codes, 5)
    window_hash.window_hashes_at(codes, 5, starts)
    assert (window_hash.launches, window_hash.at_launches) == before


@pytest.mark.parametrize("private", [True, False])
def test_launch_stream_handle(monkeypatch, private):
    """The wrappers launch on the current stream's raw handle: through
    torch's private call where the torch has it, else through the public
    torch.cuda.current_stream."""
    from types import SimpleNamespace
    calls = []
    monkeypatch.setattr(torch.cuda, "current_stream", lambda index: (
        calls.append(("public", index)) or SimpleNamespace(cuda_stream=77)))
    if private:
        monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                            lambda index: calls.append(("raw", index)) or 77,
                            raising=False)
    else:
        monkeypatch.delattr(torch._C, "_cuda_getCurrentRawStream",
                            raising=False)
    t = SimpleNamespace(device=torch.device("cuda", 3))
    assert window_hash._device_and_stream(t) == (3, 77)
    assert calls == [("raw" if private else "public", 3)]


def test_kernel_source_and_build_rule():
    """The CUDA source ships in the package and is built for sm_90a."""
    import os
    assert os.path.exists(window_hash.SOURCE)
    assert "arch=compute_90a,code=sm_90a" in window_hash.NVCC_FLAGS
    src = open(window_hash.SOURCE).read()
    assert 'extern "C" int window_hash_launch' in src
    assert 'extern "C" int window_hash_at_launch' in src
    # window_hash_at takes the range flag and reads device memory directly
    # (no shared-memory tiles)
    body = src[src.index("window_hash_at_kernel("):]
    body = body[:body.index("\n}\n")]
    assert "int32_t* __restrict__ bad" in body
    assert "for_each_tile" not in body and "smem" not in body
    launch = src[src.index('extern "C" int window_hash_at_launch'):]
    assert "void* bad" in launch[:launch.index("{")]
