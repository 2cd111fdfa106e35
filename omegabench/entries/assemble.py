"""A whole assembly: every step runs the command line's main in process
(-pe with one interleaved file per library, -f over the same prefix every
step, -l the configuration's minimum overlap), which writes all 12
artifacts.  Its log goes to one file a step, from which the phases'
CLOCKSTOP times are read.  A step's work is one assembly."""

import contextlib
import gc
import os
import re


class Assemble:
    units = 1

    def __init__(self, run):
        self.dir = run.workdir
        self.prefix = os.path.join(run.workdir, "asm_")
        self.argv = (["metagenomics_tpu_torch", "-pe", str(len(run.fasta))]
                     + list(run.fasta)
                     + ["-f", self.prefix, "-l",
                        str(run.config["min_overlap"])])
        self.logs = []
        self.asm = None

    def step(self):
        from metagenomics_tpu_torch import cli
        path = os.path.join(self.dir, "log%d.txt" % len(self.logs))
        # the last assembly's graph holds cycles (an edge and its twin):
        # free it here, not whenever the collector next runs
        self.asm = None
        gc.collect()
        try:
            with open(path, "w") as f, contextlib.redirect_stdout(f):
                self.asm = cli.main(self.argv)
        except SystemExit as exc:
            # the command line's way to end on an error
            raise RuntimeError("the assembler exited with code %s (log %s)"
                               % (exc.code, path)) from None
        self.logs.append(path)

    def engine(self):
        return self.asm.engine if self.asm is not None else None

    def forget_logs(self):
        self.logs = []

    def phases(self):
        """Per step: the seconds of its parts, from its log."""
        out = []
        for path in self.logs:
            with open(path) as f:
                out.append(log_phases(f.read()))
        return out

    def outputs(self):
        from omegabench.check import unitig_edges
        return {"edges": unitig_edges(self.prefix + ".unitig"),
                "sorted_reads": self.prefix + "_sortedReads.fasta",
                "contigs": self.prefix}

    def release(self):
        self.asm = None


def log_phases(stdout):
    """Seconds of an assembly's parts from its log's CLOCKSTOP lines:
    construction (insertDataset + buildOverlapGraphFromHashTable), ingest
    (readDataset + sortReads + removeDupicateReads), the I/O between
    (printDataset + saveGraphToFile), main, and the late phases (the rest
    of main).  A function that runs more than once counts with the sum of
    its runs."""
    t = {}
    for name, secs in re.findall(
            r"Function (\w+)\(\) finished in ([\d.e+-]+) Seconds", stdout):
        t[name] = t.get(name, 0.0) + float(secs)
    p = {"construction": t["insertDataset"]
         + t["buildOverlapGraphFromHashTable"],
         "ingest": t["readDataset"] + t["sortReads"]
         + t["removeDupicateReads"],
         "mid_io": t.get("printDataset", 0.0) + t.get("saveGraphToFile", 0.0),
         "main": t["main"]}
    p["late"] = p["main"] - p["ingest"] - p["construction"] - p["mid_io"]
    return p


def make(run):
    return Assemble(run)
