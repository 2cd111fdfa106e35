"""Device-side (PyTorch) bulk kernels and their host helpers.

The port of metagenomics_tpu/ops: packing (the numpy ingest half and the
torch device half), the candidate verification ops, the window packing of
the host engine (ops.kmer), the window-hash kernel and the device overlap
pipeline (imported by module: ops.device_overlap, ops.window_hash).
"""

from .packing import (
    PAD_CODE,
    ascii_to_codes,
    codes_to_ascii,
    reverse_complement_codes,
    canonicalize_codes,
    qc_mask,
    pack_sort_limbs,
)
from .overlap import verify_candidates, CandidateBatch

__all__ = [
    "PAD_CODE",
    "ascii_to_codes",
    "codes_to_ascii",
    "reverse_complement_codes",
    "canonicalize_codes",
    "qc_mask",
    "pack_sort_limbs",
    "verify_candidates",
    "CandidateBatch",
]
