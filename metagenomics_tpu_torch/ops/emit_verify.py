"""The device pipeline's expand-verify-compact stage as one CUDA kernel.

ops/device_overlap.py _emit2 dispatches here for CUDA tensors: the
hand-written kernel in csrc/emit_verify.cu expands a chunk's candidate
slots, verifies each pair on its packed words, keeps what the mode keeps
and compacts the survivors to the front in slot order, in one launch with
no [cap, w] intermediate, no sort and no read-back.  CPU tensors take the
plain version (device_overlap._emit2_torch), whose results in the slots a
caller reads (the first n_keep survivors, the per-read counts, n_keep)
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
    os.path.abspath(__file__))), "csrc", "emit_verify.cu")

# the kernel's template parameters, as emit_verify_launch reads its mode
MODE_CONT = 1        # containment test
MODE_DEDUP = 2       # keep an edge from its smaller endpoint only
MODE_WORDS = 4       # one 32-bit word a survivor, else (r2, meta)
MODE_UNIFORM = 8     # one read length, else the lengths array

# kernel launches since the last reset (the main path must show > 0)
launches = 0

_lib = None
_tile = None
_lock = threading.Lock()

_I32 = torch.int32
_I64 = torch.int64


def kernel_mode(check_cont, dedup, off_bits, uniform_len):
    """The kernel's mode bits for an _emit2 call's own arguments."""
    return ((MODE_CONT if check_cont else 0)
            | (MODE_DEDUP if dedup else 0)
            | (MODE_WORDS if off_bits >= 0 else 0)
            | (MODE_UNIFORM if uniform_len >= 0 else 0))


def build_library():
    """Compile csrc/emit_verify.cu (once per source and flag set) and
    return the shared library's path."""
    return window_hash.build_library(SOURCE)


def _load():
    global _lib, _tile
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            lib.emit_verify_launch.argtypes = (
                [p] * 11 + [i64] + [i32] * 15 + [p])
            lib.emit_verify_launch.restype = i32
            lib.emit_verify_tile.restype = i32
            _tile = lib.emit_verify_tile()
            _lib = lib
        return _lib


def _check(packed2, lengths, rk_pad, rleft_pad, rcnt_pad, sid, h0, nh_real,
           nqt, cap, npos, w, qw_max, off_bits):
    """Dtypes, shapes, contiguity and one device (packed2's) for every
    tensor argument, and the plain arguments' ranges (no values: nothing
    is read back from the card)."""
    dev = packed2.device
    want = (("packed2", packed2, _I64, 2), ("lengths", lengths, _I32, 1),
            ("rk_pad", rk_pad, _I64, 1), ("rleft_pad", rleft_pad, _I32, 1),
            ("rcnt_pad", rcnt_pad, _I32, 1), ("sid", sid, _I64, 1))
    for name, t, dtype, dim in want:
        if t.device != dev or t.dtype != dtype or t.dim() != dim:
            raise ValueError("%s must be a %d-D %s tensor on %s, got %s %s "
                             "on %s" % (name, dim, dtype, dev, t.dtype,
                                        tuple(t.shape), t.device))
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
    n1 = lengths.shape[0]
    if packed2.shape[0] != 2 * n1 or packed2.shape[1] < qw_max + w + 1:
        raise ValueError("packed2 must be [2 * %d, >= %d], got %s"
                         % (n1, qw_max + w + 1, tuple(packed2.shape)))
    if not rk_pad.shape == rleft_pad.shape == rcnt_pad.shape:
        raise ValueError("rk_pad, rleft_pad and rcnt_pad differ in shape: "
                         "%s, %s, %s" % (tuple(rk_pad.shape),
                                         tuple(rleft_pad.shape),
                                         tuple(rcnt_pad.shape)))
    if not (0 <= h0 and 0 <= nh_real <= nqt
            and h0 + nqt <= rk_pad.shape[0]):
        raise ValueError("chunk [%d, %d + %d) of tier %d outside the %d "
                         "padded hits" % (h0, h0, nh_real, nqt,
                                          rk_pad.shape[0]))
    if not (1 <= cap < 1 << 31 and npos >= 1 and w >= 1 and qw_max >= 0
            and off_bits <= 27 and sid.shape[0] >= 1):
        raise ValueError("cap %d, npos %d, w %d, qw_max %d, off_bits %d or "
                         "%d index entries out of the kernel's range"
                         % (cap, npos, w, qw_max, off_bits, sid.shape[0]))


def emit2_cuda(packed2, lengths, rk_pad, rleft_pad, rcnt_pad, sid, h0,
               nh_real, row0, hash_len, nqt, cap, npos, w, qw_max,
               check_cont, off_bits, uniform_len, dedup=False):
    """_emit2 on CUDA tensors, as one launch of the kernel: the same
    arguments and the same return, (out, keep_counts, n_keep).  out is
    the int64 word buffer [cap] when off_bits >= 0, else (r2 int32 [cap],
    meta int32 [cap]); its first n_keep entries, keep_counts and n_keep
    equal the plain version's bit for bit, and the entries past n_keep
    are unspecified.  The chunk's counts are summed by one torch cumsum;
    the total stays on the card."""
    global launches
    h0, nh_real, nqt, cap = int(h0), int(nh_real), int(nqt), int(cap)
    if packed2.device.type != "cuda":
        raise ValueError("emit2_cuda needs CUDA tensors, got %s"
                         % packed2.device)
    _check(packed2, lengths, rk_pad, rleft_pad, rcnt_pad, sid, h0, nh_real,
           nqt, cap, npos, w, qw_max, off_bits)
    lib = _load()
    dev = packed2.device
    n1 = lengths.shape[0]
    cum = torch.cumsum(rcnt_pad[h0:h0 + nh_real], 0, dtype=_I32)
    # one zeroed buffer: the per-read counts, then (8-byte aligned) n_keep,
    # a pad word, the tile ticket and its pad, then one int64 state a tile
    n1p = n1 + (n1 & 1)
    ntiles = -(-cap // _tile)
    zeroed = torch.zeros(n1p + 4 + 2 * ntiles, dtype=_I32, device=dev)
    keep_counts = zeroed[:n1]
    n_keep = zeroed[n1p]
    if off_bits >= 0:
        out = torch.empty(cap, dtype=_I64, device=dev)
        ptrs = (out.data_ptr(), None, None)
    else:
        out = (torch.empty(cap, dtype=_I32, device=dev),
               torch.empty(cap, dtype=_I32, device=dev))
        ptrs = (None, out[0].data_ptr(), out[1].data_ptr())
    err = lib.emit_verify_launch(
        packed2.data_ptr(), lengths.data_ptr(), rk_pad[h0:].data_ptr(),
        rleft_pad[h0:].data_ptr(), cum.data_ptr(), sid.data_ptr(), *ptrs,
        keep_counts.data_ptr(), zeroed[n1p:].data_ptr(), sid.shape[0], cap,
        nh_real, n1, n1, packed2.shape[1], w, qw_max, row0, hash_len, npos,
        npos + hash_len - 1, off_bits, uniform_len,
        kernel_mode(check_cont, dedup, off_bits, uniform_len),
        *window_hash._device_and_stream(packed2))
    if err != 0:
        raise RuntimeError("emit_verify kernel launch failed: %s"
                           % ("arguments out of range" if err < 0
                              else "CUDA error %d" % err))
    launches += 1
    count("kernel.emit_verify")
    return out, keep_counts, n_keep
