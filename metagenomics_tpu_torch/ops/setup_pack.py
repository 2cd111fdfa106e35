"""The device pipeline's row packing as one CUDA kernel.

ops/device_overlap.py _setup_kernel takes its rows from _setup_pack, which
dispatches here for CUDA tensors: the hand-written kernel in
csrc/setup_pack.cu reads the forward packed words once and writes, in one
launch, the forward codes, the flipped-padded reverse strand's codes and
both strands' zero-padded packed words, with no int64 lane per base.  CPU
tensors take the plain version (device_overlap._setup_pack_torch), which
the kernel equals bit for bit; chip_smoke.py checks that on the card.

The kernel is compiled with nvcc by window_hash.build_library (same
flags, same cache under build/torch_kernels/) at first use and loaded
with ctypes.  There is no fallback: a CUDA tensor gets the kernel or an
error.
"""

import ctypes
import os
import threading

import torch

from ..utils.timing import count
from . import window_hash

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "setup_pack.cu")

MAX_WORDS = 256      # words a row: the kernel stages 16 rows at w = 256

# kernel launches since the last reset (the main path must show > 0)
launches = 0

_lib = None
_lock = threading.Lock()


def build_library():
    """Compile csrc/setup_pack.cu (once per source and flag set) and
    return the shared library's path."""
    return window_hash.build_library(SOURCE)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            p, i32 = ctypes.c_void_p, ctypes.c_int
            lib.setup_pack_launch.argtypes = [p] * 4 + [i32] * 5 + [p]
            lib.setup_pack_launch.restype = i32
            _lib = lib
        return _lib


def _check(pf, w, wp, lmax):
    """pf's dtype, shape and contiguity and the plain arguments' ranges
    (no values: nothing is read back from the card)."""
    if pf.dtype != torch.int64 or pf.dim() != 2 or pf.shape[1] != w:
        raise ValueError("pf must be a 2-D int64 tensor of %d words a row, "
                         "got %s %s" % (w, pf.dtype, tuple(pf.shape)))
    if not pf.is_contiguous():
        raise ValueError("pf must be contiguous")
    if not (1 <= w <= MAX_WORDS and wp >= w and 1 <= lmax <= 16 * w
            and lmax < window_hash.MAX_LMAX):
        raise ValueError("w %d, wp %d or lmax %d out of the kernel's range"
                         % (w, wp, lmax))


def setup_pack_cuda(pf, w, wp, lmax):
    """_setup_pack on a CUDA tensor, as one launch of the kernel: pf the
    [n1, w] int64 forward words; returns (codes_fwd [n1, lmax] uint8,
    flipped [n1, lmax] uint8, packed2 [2 n1, wp] int64), equal to the
    plain version's bit for bit."""
    global launches
    w, wp, lmax = int(w), int(wp), int(lmax)
    if pf.device.type != "cuda":
        raise ValueError("setup_pack_cuda needs a CUDA tensor, got %s"
                         % pf.device)
    _check(pf, w, wp, lmax)
    n1 = pf.shape[0]
    dev = pf.device
    codes = torch.empty((n1, lmax), dtype=torch.uint8, device=dev)
    flipped = torch.empty((n1, lmax), dtype=torch.uint8, device=dev)
    packed2 = torch.empty((2 * n1, wp), dtype=torch.int64, device=dev)
    if n1 == 0:
        return codes, flipped, packed2
    lib = _load()
    err = lib.setup_pack_launch(
        pf.data_ptr(), codes.data_ptr(), flipped.data_ptr(),
        packed2.data_ptr(), n1, w, wp, lmax,
        *window_hash._device_and_stream(pf))
    if err != 0:
        raise RuntimeError("setup_pack kernel launch failed: %s"
                           % ("arguments out of range" if err < 0
                              else "CUDA error %d" % err))
    launches += 1
    count("kernel.setup_pack")
    return codes, flipped, packed2
