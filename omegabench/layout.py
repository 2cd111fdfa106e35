"""Finds a cell's parts by the names BENCHMARK.json gives them."""

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Cell:
    """One workload of BENCHMARK.json with its configuration, traffic mix,
    entry module and metric entries resolved."""

    def __init__(self, name, bench, root=HERE):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError("no workload %r in BENCHMARK.json (has %s)"
                           % (name, ", ".join(sorted(cells))))
        w = cells[name]
        self.name = name
        self.chips = w["chips"]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = load_json(os.path.join(
            root, os.path.relpath(configs[w["config"]]["file"],
                                  os.path.basename(HERE))))
        self.traffic = load_json(os.path.join(root, "traffic",
                                              w["traffic"] + ".json"))
        self.entry = load_module(os.path.join(
            root, "entries", self.traffic["entry"] + ".py"))
        self.end_to_end = [m for m in bench["end_to_end"] if covers(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if covers(m, name)]
        self.root = root

    def reader(self, metric):
        """The read(run) function of metrics/<metric>.py."""
        return load_module(os.path.join(self.root, "metrics",
                                        metric + ".py")).read


def covers(metric, cell):
    return cell in metric.get("workloads", [cell])


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path):
    """A module from a file path; the name may hold dots."""
    name = "omegabench_" + os.path.basename(path)[:-3].replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root=ROOT):
    return load_json(os.path.join(root, "BENCHMARK.json"))
