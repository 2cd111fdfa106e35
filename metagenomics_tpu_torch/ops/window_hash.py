"""Window hashes of the overlap index: the CUDA kernel and its plain version.

Every read window of length l is keyed with two polynomial hashes mixed
into one 32-bit value (metagenomics_tpu/ops/device_overlap.py
window_hashes_u32, and the Pallas TPU kernel ops/pallas_hash.py).  The
port holds 32-bit unsigned values zero-extended in int64 tensors: torch's
uint32 supports few ops, and int64 keeps multiplication mod 2^32 and the
unsigned sort order exact.

window_hashes() dispatches on the tensor's device: a CPU tensor goes to
window_hashes_torch (the plain version), a CUDA tensor to the hand-written
kernel in csrc/window_hash.cu, which is compiled with nvcc into
build/torch_kernels/ at first use and loaded with ctypes.  There is no
fallback from one to the other: a CUDA tensor gets the kernel or an error.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

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

# kernel launches since the last reset (the main path must show > 0)
launches = 0

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


def _find_nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the window-hash kernel cannot be "
                       "built (set CUDA_HOME or put nvcc on PATH)")


def build_library():
    """Compile csrc/window_hash.cu (once per source and flag set) and
    return the path of the shared library.  Raises on a missing nvcc or
    a failed build."""
    with open(SOURCE, "rb") as f:
        src = f.read()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out_dir = os.path.join(BUILD_ROOT, "window_hash-" + key[:16])
    so = os.path.join(out_dir, "libwindow_hash.so")
    if os.path.exists(so):
        return so
    nvcc = _find_nvcc()
    os.makedirs(out_dir, exist_ok=True)
    tmp = "%s.%d.tmp" % (so, os.getpid())
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed on %s:\n%s%s"
                           % (SOURCE, proc.stdout, proc.stderr))
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
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            lib.window_hash_launch.restype = ctypes.c_int
            _lib = lib
        return _lib


def window_hashes_cuda(codes, hash_len):
    """Launch the CUDA kernel on a uint8 [N, lmax] CUDA tensor; returns the
    int64 [N, npos] hashes (equal to window_hashes_torch bit for bit)."""
    global launches
    if codes.device.type != "cuda":
        raise ValueError("window_hashes_cuda needs a CUDA tensor, got %s"
                         % codes.device)
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise ValueError("codes must be a 2-D uint8 tensor, got %s %s"
                         % (codes.dtype, tuple(codes.shape)))
    if not codes.is_contiguous():
        raise ValueError("codes must be contiguous")
    n, lmax = codes.shape
    if not 1 <= hash_len <= lmax < MAX_LMAX:
        raise ValueError("need 1 <= hash_len (%d) <= lmax (%d) < %d"
                         % (hash_len, lmax, MAX_LMAX))
    out = torch.empty((n, lmax - hash_len + 1), dtype=torch.int64,
                      device=codes.device)
    if n == 0:
        return out
    lib = _load()
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.window_hash_launch(codes.data_ptr(), out.data_ptr(), n,
                                     lmax, hash_len, stream)
    if err != 0:
        raise RuntimeError("window_hash kernel launch failed: CUDA error %d"
                           % err)
    launches += 1
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
