"""Tools of the port beside its benchmark (omegabench/): scale.py, the
real-size run of the full CLI per engine against native (the counterpart
of the repo's tools/measure_scale.py), and pipefuzz.py, the full-pipeline
fuzzer (tools/pipefuzz.py's).  Each runs as
`python -m metagenomics_tpu_torch.measure.<name>` from the repo root, on
the card or with MGTPU_TORCH_DEVICE=cpu on the CPU, prints its results
and writes no result file."""
