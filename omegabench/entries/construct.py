"""Overlap-graph construction: the sample is loaded once; every step
builds the overlap graph again with Assembler._build under the engine the
program picks (MGTPU_OVERLAP_ENGINE unset: `auto`), from a fresh graph
and the dataset's per-read graph state reset as a new Dataset has it.
A step's work is the sample's unique reads."""

import gc


def quiet(*args, **kwargs):
    pass


class Construct:
    def __init__(self, run):
        from metagenomics_tpu_torch.assembler import Assembler
        from metagenomics_tpu_torch.config import AssemblerConfig
        from metagenomics_tpu_torch.dataset import Dataset
        cfg = AssemblerConfig(paired_end_files=list(run.fasta),
                              min_overlap=run.config["min_overlap"])
        self.ds = Dataset(cfg.paired_end_files, [], cfg.min_overlap,
                          log=quiet)
        self.asm = Assembler(cfg, log=quiet)
        self.asm.dataset = self.ds
        # the per-read edge and location rows of a Dataset that no graph
        # has touched yet (rows made on first use)
        self.fresh_rows = type(self.ds.edges_forward)
        self.units = self.ds.number_of_unique_reads
        self.graph = None

    def step(self):
        from metagenomics_tpu_torch.graph import OverlapGraph
        ds = self.ds
        # the last graph's edges hold each other (an edge and its twin):
        # free them here, not whenever the collector next runs
        self.graph = None
        gc.collect()
        n = ds.number_of_unique_reads + 1
        ds.edges_forward = self.fresh_rows(n)
        ds.loc_forward = self.fresh_rows(n)
        ds.edges_reverse = self.fresh_rows(n)
        ds.loc_reverse = self.fresh_rows(n)
        ds.super_read_id[:] = 0
        graph = OverlapGraph(ds, self.asm.cfg, log=quiet)
        self.asm._build(graph)
        self.graph = graph

    def engine(self):
        return self.asm.engine

    def outputs(self):
        """The last step's graph: of each edge and its twin, the one from
        the lower read (of a loop, either), as the .unitig file has it;
        and each read's super read (0: not contained)."""
        if self.graph is None:
            return {}
        edges = [(e.source, e.destination, e.orient, e.offset,
                  list(e.list_reads), list(e.list_offsets),
                  list(e.list_orients))
                 for row in self.graph.adj for e in row
                 if e.source < e.destination
                 or (e.source == e.destination and id(e) < id(e.reverse))]
        return {"edges": edges, "supers": self.ds.super_read_id.copy()}

    def release(self):
        self.graph = None
        self.ds = None
        self.asm = None


def make(run):
    return Construct(run)
