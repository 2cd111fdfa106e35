"""Tiny copies of the benchmark's cells for the CPU tests."""

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)

TINY_CONFIG = {"genomes": 4, "circular_elements": 2, "length_scale": 0.003}
TINY_PAIRS = {"construct": [3000], "assemble": [2500, 1000]}


TRIM = {"source": "none: a made-up histogram for tests",
        "length_bins": [[150, 150, 0.7], [60, 149, 0.3]]}


def tiny_copy(dest, trim=None):
    """A copy of omegabench/ under dest whose configurations and traffic
    mixes are cut to a few thousand reads (with `trim`, their reads
    trimmed so); returns its path."""
    root = os.path.join(str(dest), "omegabench")
    shutil.copytree(BENCH_DIR, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name in os.listdir(os.path.join(root, "configs")):
        path = os.path.join(root, "configs", name)
        with open(path) as f:
            config = json.load(f)
        config.update(TINY_CONFIG)
        if trim is not None:
            config["trim"] = trim
        with open(path, "w") as f:
            json.dump(config, f)
    for name in os.listdir(os.path.join(root, "traffic")):
        path = os.path.join(root, "traffic", name)
        with open(path) as f:
            traffic = json.load(f)
        traffic["read_pairs"] = TINY_PAIRS[traffic["entry"]]
        traffic["check_rows"] = 200
        with open(path, "w") as f:
            json.dump(traffic, f)
    return root


def benchmark():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)
