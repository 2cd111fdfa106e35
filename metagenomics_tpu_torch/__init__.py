"""metagenomics_tpu_torch — the assembler's device path in PyTorch and CUDA.

A port of metagenomics_tpu (the JAX package beside it, which stays the
reference): the same CLI, the same 12 staged artifacts and the same log,
byte for byte, with the overlap pipeline running as torch ops on one
torch.device and the window hashes as a hand-written CUDA kernel
(csrc/window_hash.cu) on an NVIDIA Hopper card.

Host modules that import jax in the reference (dataset, hashstats, graph/*)
are verbatim copies whose imports point at this package; jax-free modules
(config, errors, io, native, cs2replay, mincostflow, utils.stdsort) are
imported from metagenomics_tpu directly.  This package never imports jax.
"""

__version__ = "0.1.0"

from metagenomics_tpu.config import AssemblerConfig

__all__ = ["AssemblerConfig"]
