"""End-to-end assembly driver (reference: MetaGenomics/main.cpp:23-109).

Phase order and artifact set match the reference exactly:
  build (or resume via -s from the .unitig checkpoint) -> flow ->
  contigs1 -> mate-pair merge loop -> contigs2 -> scaffold loop ->
  contigs3 -> resolve loop -> contigs4,
with the same loopLimit=15 caps on each of the three driver loops.

Port of metagenomics_tpu/assembler.py; only the engine dispatch differs.
"""

import time

from metagenomics_tpu.config import AssemblerConfig
from .dataset import Dataset
from .graph import OverlapGraph
from .utils import PhaseTimer

# engines of the reference that the port does not run yet, with the
# ROADMAP item that ports each
_NOT_PORTED = {
    "hybrid": "ROADMAP.md section 1 item 3 (build_hybrid)",
    "host": "ROADMAP.md section 1 item 5 (host engine)",
    "sharded": "ROADMAP.md section 1 item 7 (parallel/* over "
               "torch.distributed)",
}


class Assembler:
    def __init__(self, config: AssemblerConfig, log=print):
        self.cfg = config
        self.log = log
        self._timer = PhaseTimer(log=log)

    @property
    def timings(self):
        return self._timer.timings

    def _timed(self, name, fn, *args):
        """Silently-timed phase for bench consumers; the reference-format
        CLOCKSTART/CLOCKSTOP log blocks are emitted by the phase functions
        themselves (utils/timing.py phase_clock)."""
        with self._timer.phase(name):
            result = fn(*args)
        return result

    def _build(self, graph):
        """Run the construction phase with the selected overlap engine.

        Engines (env MGTPU_OVERLAP_ENGINE or config):
          device  — the torch overlap pipeline (ops/device_overlap.py) on
                    the device named by MGTPU_TORCH_DEVICE (cuda by
                    default), canonical stream + native replay; `auto`
                    means device
          native  — full C++ engine (index/scan/verify/BFS) on the host
        Both produce byte-identical graphs (tests/test_torch_golden.py).
        """
        from .utils.timing import phase_clock
        with phase_clock("buildOverlapGraphFromHashTable", log=self.log,
                         src=__file__):
            self._build_engine(graph)

    def _build_engine(self, graph):
        import os
        from metagenomics_tpu import native
        engine = os.environ.get("MGTPU_OVERLAP_ENGINE",
                                getattr(self.cfg, "overlap_engine", "auto"))
        if engine == "auto":
            engine = "device"
        if engine in _NOT_PORTED:
            raise NotImplementedError(
                "overlap engine %r is not ported to torch yet: %s"
                % (engine, _NOT_PORTED[engine]))
        if engine == "native":
            if os.environ.get("MGTPU_NO_NATIVE") or \
                    not graph.build_full_native():
                raise RuntimeError("native overlap engine unavailable")
            return
        if engine != "device":
            raise ValueError("unknown overlap engine %r" % engine)
        from .ops.device_overlap import DeviceOverlapPipeline, torch_device
        device = torch_device()
        if device.type == "cuda" and native.get_lib() is None:
            # the replay would silently run in pure Python otherwise
            raise RuntimeError("the device engine on cuda needs the native "
                               "replay library, which failed to build")
        pipeline = DeviceOverlapPipeline(self.dataset, self.cfg.min_overlap,
                                         device=device)
        graph.build_from_pipeline(pipeline)

    def run(self):
        cfg = self.cfg
        prefix = cfg.output_prefix
        t_start = time.time()
        with self._timer.phase("Dataset"):
            ds = Dataset(cfg.paired_end_files, cfg.single_end_files,
                         cfg.min_overlap, log=self.log)
        if ds.number_of_unique_reads == 0:
            # the reference segfaults in HashTable::insertDataset here; stop
            # with a labeled diagnostic instead
            from metagenomics_tpu.errors import MyExit
            raise MyExit("No good reads in input; nothing to assemble.")
        graph = OverlapGraph(ds, cfg, log=self.log)
        self.dataset = ds
        self.graph = graph

        if cfg.resume_from_unitig:
            # reference resume path (main.cpp:36-42): mate pairs reloaded
            # WITHOUT contained-read marking, then graph from checkpoint.
            ds.read_mate_pairs_from_file()
            graph.read_graph_from_file(prefix + ".unitig")
            graph.sort_edges()
        else:
            # insertDataset runs before graph construction in the
            # reference (main.cpp:45-46); the TPU pipeline replaces the
            # string hash table with a sorted-key join, so this emits the
            # reference's table statistics from a simulation (hashstats.py)
            from .hashstats import emit_insert_dataset_log
            with self._timer.phase("insertDataset"):
                emit_insert_dataset_log(ds, cfg.min_overlap, self.log)
            self._timed("buildOverlapGraphFromHashTable", self._build, graph)
            self._timed("printDataset", ds.save_reads,
                        prefix + "_sortedReads.fasta")
            graph.sort_edges()
            self._timed("saveGraphToFile", graph.save_graph_to_file,
                        prefix + ".unitig")

        self._timed("calculateFlow", graph.calculate_flow,
                    prefix + "_flow.input", prefix + "_flow.output")
        self.log("nodes: %d edges: %d"
                 % (graph.number_of_nodes, graph.number_of_edges))
        graph.print_graph(prefix + "graph1.gdl", prefix + "contigs1.fasta")

        graph.remove_all_simple_edges_without_flow()
        graph.calculate_mean_and_sd_of_insert_size()

        BANNER = "=" * 143

        iteration = 0
        while True:
            iteration += 1
            self.log("")
            self.log(BANNER)
            self.log("FIRST LOOP ITERATION %d" % iteration)
            self.log(BANNER)
            graph.simplify_graph()
            counter = graph.find_support_by_matepairs_and_merge()
            if not (counter > 0 and iteration < cfg.loop_limit):
                break
        graph.print_graph(prefix + "graph2.gdl", prefix + "contigs2.fasta")

        iteration = 0
        while True:
            iteration += 1
            self.log("")
            self.log(BANNER)
            self.log("SECOND LOOP ITERATION %d" % iteration)
            self.log(BANNER)
            graph.simplify_graph()
            counter = graph.scaffolder()
            if not (counter > 0 and iteration < cfg.loop_limit):
                break
        graph.print_graph(prefix + "graph3.gdl", prefix + "contigs3.fasta")

        iteration = 0
        while True:
            iteration += 1
            self.log("")
            self.log(BANNER)
            self.log("THIRD LOOP ITERATION %d" % iteration)
            self.log(BANNER)
            graph.simplify_graph()
            counter = graph.resolve_nodes()
            if not (counter > 0 and iteration < cfg.loop_limit):
                break
        graph.print_graph(prefix + "graph4.gdl", prefix + "contigs4.fasta")

        self.timings["total"] = time.time() - t_start
        return graph
