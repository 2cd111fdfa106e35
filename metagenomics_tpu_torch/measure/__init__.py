"""Measurement tools of the port on CUDA cards (the counterparts of the
repo's tools/profile_device.py, measure_engines_1m.py,
measure_sharded_scale.py and measure_scaling.py).  Each runs as
`python -m metagenomics_tpu_torch.measure.<name>` from the repo root,
prints its results with the card's name and power limit, writes no result
file, and refuses to run without a card."""
