"""The setup_pack kernel's plain version, wrapper and build rule on the
CPU, and a numpy model of the kernel (its word-level reverse complement,
funnel shifts, 16-byte chunks across rows and row blocks) against the
plain version; on a card (marker `card`), the kernel itself against the
plain version and _setup_kernel's whole output on the card against the
CPU's.  Every value is an integer: the tolerance is exact equality.

The card tests need no JAX: on a machine with a card and without jax,
run them as `python -m pytest --noconftest -m card
tests/test_torch_setup_pack.py` from the repo root."""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import setup_pack_model as model
from metagenomics_tpu_torch.dataset import Dataset
from metagenomics_tpu_torch.ops import device_overlap as tdo
from metagenomics_tpu_torch.ops import setup_pack, window_hash
from metagenomics_tpu_torch.utils import timing

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "golden", "data")
CPU = torch.device("cpu")

SHAPES = model.SHAPES


def _words(rows, lmax, w, seed, full=False):
    return model.words(np.random.default_rng(seed), rows, lmax, w, full)


def _pf(words):
    return torch.from_numpy(words.astype(np.int64))


_wp = model.spill_width


# ------------------------------------------------------- the plain version

def _expected(words, w, wp, lmax):
    """Independent numpy statement of the three outputs: each base from
    its lane, the flipped row, both strands packed 16 bases a word."""
    rows = words.shape[0]
    lanes = (words[:, :, None] >> (2 * np.arange(16, dtype=np.uint32))) & 3
    codes = lanes.reshape(rows, 16 * w)[:, :lmax].astype(np.uint8)
    flipped = (3 - codes[:, ::-1]).astype(np.uint8)
    rev = np.zeros((rows, 16 * w), np.uint64)
    rev[:, :lmax] = flipped
    rev = (rev.reshape(rows, w, 16)
           << (2 * np.arange(16, dtype=np.uint64))).sum(axis=2)
    packed2 = np.zeros((2 * rows, wp), np.int64)
    packed2[:rows, :w] = words
    packed2[rows:, :w] = rev
    return codes, flipped, packed2


@pytest.mark.parametrize("rows,lmax,w", [s for s in SHAPES
                                         if s[1] in (150, 160, 300, 304)])
def test_plain_version_is_the_packing(rows, lmax, w):
    """_setup_pack_torch at w 10 and 19, lmax off and at a multiple of 16,
    mixed lengths: its three outputs equal the packing stated directly."""
    words = _words(rows, lmax, w, seed=lmax)
    wp = _wp(lmax, w)
    got = tdo._setup_pack_torch(_pf(words), w, wp, lmax)
    for g, e, what in zip(got, _expected(words, w, wp, lmax),
                          ("codes_fwd", "flipped", "packed2")):
        assert g.dtype == torch.from_numpy(e).dtype, what
        np.testing.assert_array_equal(g.numpy(), e, err_msg=what)


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    """_setup_pack on CPU tensors runs _setup_pack_torch: no launch, no
    counter."""
    def refuse(*a, **k):
        raise AssertionError("the kernel was called for CPU tensors")
    monkeypatch.setattr(setup_pack, "setup_pack_cuda", refuse)
    monkeypatch.setattr(setup_pack, "launches", 0)
    rec = timing.Recorder()
    monkeypatch.setattr(timing, "recorder", rec)
    words = _words(300, 150, 10, seed=1)
    got = tdo._setup_pack(_pf(words), 10, 17, 150)
    for g, e in zip(got, tdo._setup_pack_torch(_pf(words), 10, 17, 150)):
        assert torch.equal(g, e)
    assert setup_pack.launches == 0
    assert not [x for x in rec.snapshot() if x.name == "kernel.setup_pack"]


def test_setup_kernel_rows_are_the_packing():
    """_setup_kernel's packed2 on a golden set is the plain packing of
    the uploaded words."""
    ds = Dataset([], [os.path.join(GOLDEN, "se_mixlen.fasta")], 40,
                 log=lambda *a, **k: None)
    p = tdo.DeviceOverlapPipeline(ds, 40, device=CPU)
    words = tdo.pack_codes_host(ds.codes_fwd)
    _, _, packed2 = _expected(words, p.w, p.wp, p.lmax)
    np.testing.assert_array_equal(p.packed2.numpy(), packed2)


# ----------------------------------------------------- the wrapper's checks

def test_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        setup_pack.setup_pack_cuda(_pf(_words(4, 150, 10, 0)), 10, 17, 150)


BAD = {
    "int32 words": lambda pf: (pf.to(torch.int32), 10, 17, 150),
    "1-D words": lambda pf: (pf.reshape(-1), 10, 17, 150),
    "w not pf's": lambda pf: (pf, 11, 17, 150),
    "strided words": lambda pf: (torch.cat([pf, pf], 1)[:, ::2], 10, 17,
                                 150),
    "wp below w": lambda pf: (pf, 10, 9, 150),
    "lmax past 16 w": lambda pf: (pf, 10, 17, 161),
    "lmax 0": lambda pf: (pf, 10, 17, 0),
    "lmax 4096": lambda pf: (torch.zeros((4, 256), dtype=torch.int64), 256,
                             257, 4096),
    "w past 256": lambda pf: (torch.zeros((4, 257), dtype=torch.int64), 257,
                              258, 4095),
}


@pytest.mark.parametrize("name", BAD)
def test_wrapper_refuses_bad_arguments(name):
    """Wrong dtypes, shapes, strides and ranges raise before any launch;
    the good call passes the same check."""
    pf = _pf(_words(4, 150, 10, 0))
    setup_pack._check(pf, 10, 17, 150)
    setup_pack._check(torch.zeros((4, 256), dtype=torch.int64), 256, 257,
                      4095)
    with pytest.raises(ValueError):
        setup_pack._check(*BAD[name](pf))


def _source_int(name):
    src = open(setup_pack.SOURCE).read()
    return int(src.split("constexpr int %s = " % name)[1].split(";")[0])


def test_kernel_source_and_build_rule(monkeypatch, tmp_path):
    """The CUDA source ships in the package, is built for sm_90a by the
    window-hash kernels' rule into a cache directory of its own, and
    builds the reverse strand from whole words (bit reverse, funnel
    shift)."""
    src = open(setup_pack.SOURCE).read()
    assert os.path.dirname(setup_pack.SOURCE) == os.path.dirname(
        window_hash.SOURCE)
    assert 'extern "C" int setup_pack_launch' in src
    assert "metagenomics_tpu/ops/device_overlap.py:329-341" in src
    assert _source_int("kStageWords") == 16 * setup_pack.MAX_WORDS
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    assert "__brev" in code and "__funnelshift_r" in code
    assert "arch=compute_90a,code=sm_90a" in window_hash.NVCC_FLAGS
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do [ "$1" = -o ] && '
                    'touch "$2"; shift; done\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(window_hash, "_find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(window_hash, "BUILD_ROOT", str(tmp_path / "build"))
    so = setup_pack.build_library()
    assert os.path.exists(so)
    assert os.path.basename(so) == "libsetup_pack.so"
    assert os.path.basename(os.path.dirname(so)).startswith("setup_pack-")
    assert window_hash.build_library() != so


def test_setup_kernel_launches_through_the_dispatcher():
    """_setup_kernel takes its rows from _setup_pack (one place decides
    kernel or plain), and the CUDA path has no int64 lane op left."""
    import inspect
    body = inspect.getsource(tdo._setup_kernel)
    assert "_setup_pack(pf, w, wp, lmax)" in body
    for op in ("_unpack_codes", "_pack_codes_device", ".flip("):
        assert op not in body, op
    wrapper = inspect.getsource(setup_pack.setup_pack_cuda)
    for op in ("<<", ">>", "&", ".sum(", ".flip(", ".cpu(", ".item("):
        assert op not in wrapper, op


# ------------------------------------------- a numpy model of the kernel

@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("rows,lmax,w", SHAPES)
def test_model_equals_plain(rows, lmax, w, full):
    """The kernel's algorithm gives the plain version's three outputs at
    every shape, on packed reads of mixed lengths and on arbitrary words
    (lanes past lmax set)."""
    words = _words(rows, lmax, w, seed=rows + lmax, full=full)
    wp = _wp(lmax, w)
    got = model.setup_pack(words, w, wp, lmax)
    want = tdo._setup_pack_torch(_pf(words), w, wp, lmax)
    for g, e, what in zip(got, want, ("codes_fwd", "flipped", "packed2")):
        np.testing.assert_array_equal(g, e.numpy(), err_msg=what)


def test_model_blocks_are_the_kernels():
    """The model's block constants are the kernel's; rows a block are a
    multiple of 16 (each block's bytes start 16-byte aligned), both staged
    strands within the shared memory budget."""
    assert _source_int("kStageWords") == model.STAGE_WORDS
    assert _source_int("kMaxRows") == model.MAX_ROWS
    src = open(setup_pack.SOURCE).read()
    assert "int rows = 16 * (kStageWords / (16 * w));" in src
    for w in range(1, setup_pack.MAX_WORDS + 1):
        rows = model.rows_a_block(w)
        assert rows % 16 == 0 and 16 <= rows <= model.MAX_ROWS
        assert rows * w <= model.STAGE_WORDS
    assert model.rows_a_block(10) == 64 and model.rows_a_block(256) == 16


# ----------------------------------------------------------------- on a card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("rows,lmax,w", SHAPES)
def test_kernel_equals_plain(card, rows, lmax, w, full):
    words = _words(rows, lmax, w, seed=rows + lmax, full=full)
    wp = _wp(lmax, w)
    before = setup_pack.launches
    got = setup_pack.setup_pack_cuda(_pf(words).to(card), w, wp, lmax)
    torch.cuda.synchronize()
    assert setup_pack.launches == before + 1
    want = tdo._setup_pack_torch(_pf(words), w, wp, lmax)
    for g, e, what in zip(got, want, ("codes_fwd", "flipped", "packed2")):
        assert g.dtype == e.dtype and g.is_contiguous(), what
        assert torch.equal(g.cpu(), e), what


@pytest.mark.card
@pytest.mark.parametrize("name", ["se_small.fasta", "se_mixlen.fasta"])
def test_setup_kernel_on_the_card_equals_the_cpu(card, name):
    """_setup_kernel's whole output (packed2, hf, sk, sid, bad) on the
    card, through the kernel, equals the CPU's plain run bit for bit."""
    ds = Dataset([], [os.path.join(GOLDEN, name)], 40,
                 log=lambda *a, **k: None)
    n1, lmax = ds.codes_fwd.shape
    w = (lmax + 15) // 16
    wp = ((lmax - 39) >> 4) + w + 1
    words = tdo.pack_codes_host(ds.codes_fwd)
    lengths = torch.from_numpy(ds.lengths.astype(np.int32))
    want = tdo._setup_kernel(_pf(words), lengths, 39, w, wp, lmax)
    got = tdo._setup_kernel(_pf(words).to(card), lengths.to(card), 39, w, wp,
                            lmax)
    for g, e, what in zip(got, want, ("packed2", "hf", "sk", "sid", "bad")):
        assert torch.equal(g.cpu(), e), what
