"""The benchmark of metagenomics_tpu_torch on CUDA cards.

    python3 omegabench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Cells, configurations, traffic mixes and metrics are named in the
repository's BENCHMARK.json and found here by name: configs/<config>.json,
traffic/<mix>.json, entries/<entry>.py (the program entry a mix drives),
metrics/<metric>.py (one reader each).  reference/ is the plain NumPy
reference that decides `correct`.
"""
