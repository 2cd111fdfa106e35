"""Share of its roofline that the window_hash kernel reaches: codes read
once and hashes written once, at the data sheet's 3.35 TB/s, over its
kernel time in the device trace."""

from omegabench.readers import roofline_pct


def read(run):
    return roofline_pct(run, "window_hash")
