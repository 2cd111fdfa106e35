"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at the
700 W power limit), and the least time a kernel's bytes allow."""

HBM_BYTES_PER_S = 3.35e12


def least_seconds(nbytes):
    """Time to move nbytes at the data sheet's HBM bandwidth."""
    return nbytes / HBM_BYTES_PER_S
