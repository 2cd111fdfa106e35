"""Window hashes of the overlap index: the CUDA kernel and its plain version.

Every read window of length l is keyed with two polynomial hashes mixed
into one 32-bit value (metagenomics_tpu/ops/device_overlap.py
window_hashes_u32, and the Pallas TPU kernel ops/pallas_hash.py).  The
port holds 32-bit unsigned values zero-extended in int64 tensors: torch's
uint32 supports few ops, and int64 keeps multiplication mod 2^32 and the
unsigned sort order exact.

window_hashes() hashes every window of every row; window_hashes_at()
hashes k given windows of each row (the pipeline's reverse-strand keys).
The starts' range is checked where they are read: given a flag tensor, a
start outside [0, lmax - l] sets it, and the caller reads it back with a
copy it makes anyway (the pipelines' probe), so no launch waits for the
host.

Each dispatches on the tensor's device: a CPU tensor goes to the plain
version (window_hashes_torch, window_hashes_at_torch), a CUDA tensor to the
hand-written kernels in csrc/window_hash.cu, which is compiled with nvcc
into build/torch_kernels/ at first use and loaded with ctypes.  There is
no fallback from one to the other: a CUDA tensor gets a kernel or an
error.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from ..utils.timing import count, span

_B1 = 0x01000193     # FNV prime
_B2 = 0x9E3779B1     # golden-ratio odd constant
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
MASK32 = 0xFFFFFFFF

MAX_LMAX = 4096      # exclusive; the pipeline's meta packing enforces it

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "window_hash.cu")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

# kernel launches since the last reset (the main path must show > 0):
# window_hash_launch and window_hash_at_launch
launches = 0
at_launches = 0

_lib = None
_lock = threading.Lock()


def mul32(a, b):
    """(a * b) mod 2^32 for int64 tensors (or ints) holding values in
    [0, 2^32): split a into 16-bit halves so no product leaves int64."""
    lo = (a & 0xFFFF) * b
    hi = (((a >> 16) * b) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def window_hashes_torch(codes, hash_len):
    """Plain PyTorch version: [N, npos] int64 hashes (values < 2^32) of
    uint8 codes [N, lmax].  Sums the l terms c[j+k] * B^(l-1-k) exactly in
    int64 (each term < 2^34, l < 4096 terms) and reduces mod 2^32 once."""
    n, lmax = codes.shape
    l = hash_len
    npos = lmax - l + 1
    c = (codes.to(torch.int64) & 3) + 1
    w1 = torch.zeros((n, npos), dtype=torch.int64, device=codes.device)
    w2 = torch.zeros_like(w1)
    for k in range(l):
        t = c[:, k:k + npos]
        w1 += t * pow(_B1, l - 1 - k, 1 << 32)
        w2 += t * pow(_B2, l - 1 - k, 1 << 32)
    return mul32(w1 & MASK32, _M1) ^ mul32(w2 & MASK32, _M2)


def _check_at(codes, hash_len, starts, bad):
    """Shapes, types and devices of window_hashes_at's arguments (no
    values: nothing is read back from a card)."""
    if codes.dim() != 2 or starts.dim() != 2 or \
            starts.shape[0] != codes.shape[0]:
        raise ValueError("need codes [N, lmax] and starts [N, k], got %s and "
                         "%s" % (tuple(codes.shape), tuple(starts.shape)))
    if starts.dtype != torch.int64 or starts.device != codes.device:
        raise ValueError("starts must be int64 on %s, got %s on %s"
                         % (codes.device, starts.dtype, starts.device))
    lmax = codes.shape[1]
    if not 1 <= hash_len <= lmax:
        raise ValueError("need 1 <= hash_len (%d) <= lmax (%d)"
                         % (hash_len, lmax))
    if bad is not None and (bad.shape != (1,) or bad.dtype != torch.int32
                            or bad.device != codes.device):
        raise ValueError("bad must be one int32 on %s, got %s %s on %s"
                         % (codes.device, bad.dtype, tuple(bad.shape),
                            bad.device))


def _out_of_range(lmax, hash_len):
    return ValueError("window start out of range [0, %d]"
                      % (lmax - hash_len))


def window_hashes_at_torch(codes, hash_len, starts, bad=None):
    """Plain PyTorch version of window_hashes_at: out[r, i] equals
    window_hashes_torch(codes, hash_len)[r, starts[r, i]], summed exactly
    in int64 one window base at a time.  A start outside [0, lmax - l]
    raises here, or, given a one-element int32 flag `bad`, sets it to 1
    and gives 0 at that output, as the kernel does."""
    _check_at(codes, hash_len, starts, bad)
    l = hash_len
    hi = codes.shape[1] - l
    oob = (starts < 0) | (starts > hi)
    if bad is None:
        if bool(oob.any()):
            raise _out_of_range(codes.shape[1], l)
    else:
        bad.masked_fill_(oob.any(), 1)
    starts = starts.clamp(0, hi)
    w1 = torch.zeros(starts.shape, dtype=torch.int64, device=codes.device)
    w2 = torch.zeros_like(w1)
    for k in range(l):
        t = (torch.gather(codes, 1, starts + k).to(torch.int64) & 3) + 1
        w1 += t * pow(_B1, l - 1 - k, 1 << 32)
        w2 += t * pow(_B2, l - 1 - k, 1 << 32)
    out = mul32(w1 & MASK32, _M1) ^ mul32(w2 & MASK32, _M2)
    return out.masked_fill_(oob, 0)


def _find_nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the window-hash kernel cannot be "
                       "built (set CUDA_HOME or put nvcc on PATH)")


def build_library(source=SOURCE):
    """Compile a kernel source of csrc/ (window_hash.cu unless given;
    once per source and flag set) and return the path of the shared
    library.  Raises on a missing nvcc or a failed build."""
    with open(source, "rb") as f:
        src = f.read()
    name = os.path.splitext(os.path.basename(source))[0]
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out_dir = os.path.join(BUILD_ROOT, "%s-%s" % (name, key[:16]))
    so = os.path.join(out_dir, "lib%s.so" % name)
    if os.path.exists(so):
        return so
    nvcc = _find_nvcc()
    os.makedirs(out_dir, exist_ok=True)
    tmp = "%s.%d.tmp" % (so, os.getpid())
    with span("kernel.build", library=so):
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, source],
                              capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed on %s:\n%s%s"
                           % (source, proc.stdout, proc.stderr))
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            lib.window_hash_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int, ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32,
                ctypes.c_int, ctypes.c_void_p]
            lib.window_hash_launch.restype = ctypes.c_int
            lib.window_hash_at_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            lib.window_hash_at_launch.restype = ctypes.c_int
            _lib = lib
        return _lib


def _device_and_stream(t):
    """(device index, raw handle of its current stream) for a launch: the
    kernel library makes the device current itself, so no device context
    is entered here.  torch._C._cuda_getCurrentRawStream gives the handle
    without building the Stream object torch.cuda.current_stream returns
    (host time on every launch); it is private (checked on torch 2.11), so
    where a torch lacks it the public call stands in.  chip_smoke.py
    checks that the two agree."""
    index = t.device.index
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        return index, torch.cuda.current_stream(index).cuda_stream
    return index, raw(index)


def _check_codes(codes, name):
    if codes.device.type != "cuda":
        raise ValueError("%s needs a CUDA tensor, got %s"
                         % (name, codes.device))
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise ValueError("codes must be a 2-D uint8 tensor, got %s %s"
                         % (codes.dtype, tuple(codes.shape)))
    if not codes.is_contiguous():
        raise ValueError("codes must be contiguous")
    if codes.shape[1] >= MAX_LMAX:
        raise ValueError("lmax (%d) must be < %d"
                         % (codes.shape[1], MAX_LMAX))


def window_hashes_cuda(codes, hash_len):
    """Launch the CUDA kernel on a uint8 [N, lmax] CUDA tensor; returns the
    int64 [N, npos] hashes (equal to window_hashes_torch bit for bit)."""
    global launches
    _check_codes(codes, "window_hashes_cuda")
    n, lmax = codes.shape
    if not 1 <= hash_len <= lmax:
        raise ValueError("need 1 <= hash_len (%d) <= lmax (%d)"
                         % (hash_len, lmax))
    out = torch.empty((n, lmax - hash_len + 1), dtype=torch.int64,
                      device=codes.device)
    if n == 0:
        return out
    lib = _load()
    err = lib.window_hash_launch(
        codes.data_ptr(), out.data_ptr(), n, lmax, hash_len,
        pow(_B1, hash_len, 1 << 32), pow(_B2, hash_len, 1 << 32),
        *_device_and_stream(codes))
    if err != 0:
        raise RuntimeError("window_hash kernel launch failed: CUDA error %d"
                           % err)
    launches += 1
    return out


def window_hashes_at_cuda(codes, hash_len, starts, bad=None):
    """Launch window_hash_at on a uint8 [N, lmax] CUDA tensor and int64
    starts [N, k]; returns the int64 [N, k] hashes at those starts (equal
    to window_hashes_at_torch bit for bit).  The kernel checks the starts'
    range: given a one-element int32 flag `bad` (zeroed by the caller), a
    start outside [0, lmax - l] sets it and gives 0 at that output, and
    nothing is read back; without one, the wrapper reads its own flag
    after the launch and raises."""
    global at_launches
    _check_codes(codes, "window_hashes_at_cuda")
    _check_at(codes, hash_len, starts, bad)
    starts = starts.contiguous()
    n, lmax = codes.shape
    out = torch.empty(starts.shape, dtype=torch.int64, device=codes.device)
    if out.numel() == 0:
        return out
    flag = (torch.zeros(1, dtype=torch.int32, device=codes.device)
            if bad is None else bad)
    lib = _load()
    err = lib.window_hash_at_launch(
        codes.data_ptr(), starts.data_ptr(), out.data_ptr(), flag.data_ptr(),
        n, lmax, hash_len, starts.shape[1], *_device_and_stream(codes))
    if err != 0:
        raise RuntimeError("window_hash_at kernel launch failed: CUDA error "
                           "%d" % err)
    at_launches += 1
    if bad is None:
        count("device.syncs")
        if flag.item():
            raise _out_of_range(lmax, hash_len)
    return out


def window_hashes(codes, hash_len):
    """[N, npos] window hashes of uint8 codes [N, lmax] on codes' device:
    the plain version for a CPU tensor, the CUDA kernel for a CUDA one."""
    if codes.device.type == "cpu":
        return window_hashes_torch(codes, hash_len)
    if codes.device.type == "cuda":
        return window_hashes_cuda(codes, hash_len)
    raise ValueError("no window-hash implementation for device %s"
                     % codes.device)


def window_hashes_at(codes, hash_len, starts, bad=None):
    """[N, k] window hashes of uint8 codes [N, lmax] at int64 starts
    [N, k] on codes' device: the plain version for a CPU tensor, the CUDA
    kernel for a CUDA one.  A start outside [0, lmax - l] raises, or sets
    the one-element int32 flag `bad` when one is given (see
    window_hashes_at_cuda)."""
    if codes.device.type == "cpu":
        return window_hashes_at_torch(codes, hash_len, starts, bad)
    if codes.device.type == "cuda":
        return window_hashes_at_cuda(codes, hash_len, starts, bad)
    raise ValueError("no window-hash implementation for device %s"
                     % codes.device)
