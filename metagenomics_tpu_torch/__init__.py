"""metagenomics_tpu_torch — the assembler's device path in PyTorch and CUDA.

A port of metagenomics_tpu (the JAX package beside it, which stays the
reference): the same CLI, the same 12 staged artifacts and the same log,
byte for byte, with the overlap pipeline running as torch ops on one
torch.device and the window hashes as a hand-written CUDA kernel
(csrc/window_hash.cu) on an NVIDIA Hopper card.

The host modules (dataset, hashstats, index, graph/*, config, errors, io,
native, cs2replay, mincostflow, utils.stdsort) are verbatim copies of the
reference's whose imports point at this package, and the native library
builds from this package's own native/mg_native.cpp.  This package imports
neither jax nor metagenomics_tpu, and runs with both absent.
"""

__version__ = "0.1.0"

from .config import AssemblerConfig

__all__ = ["AssemblerConfig"]
