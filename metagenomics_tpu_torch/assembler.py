"""End-to-end assembly driver (reference: MetaGenomics/main.cpp:23-109).

Phase order and artifact set match the reference exactly:
  build (or resume via -s from the .unitig checkpoint) -> flow ->
  contigs1 -> mate-pair merge loop -> contigs2 -> scaffold loop ->
  contigs3 -> resolve loop -> contigs4,
with the same loopLimit=15 caps on each of the three driver loops.

Port of metagenomics_tpu/assembler.py; only the engine dispatch differs.
"""

from .config import AssemblerConfig
from .dataset import Dataset
from .graph import OverlapGraph
from .index import OverlapIndex
from .utils import timing

# Assembler.timings: its key -> the span of run() that times it
PHASE_SPANS = {"Dataset": "assembler.dataset",
               "insertDataset": "insertDataset",
               "buildOverlapGraphFromHashTable":
                   "buildOverlapGraphFromHashTable",
               "printDataset": "assembler.save_reads",
               "saveGraphToFile": "saveGraphToFile",
               "calculateFlow": "calculateFlow",
               "total": "assembler.run"}

def auto_engine(device_type, n_cards, world_size=1):
    """The engine `auto` picks for the pipeline's device type, the number
    of visible cards and the torch.distributed world size: the JAX
    package's rule (metagenomics_tpu/assembler.py:63-71) with the card in
    the TPU's place.

    Cards put the device to work: the sharded engine when the run has more
    than one card (several visible in this process, or a world of more
    than one rank), else the hybrid engine (a native CPU scan of reads
    [1, a) concurrent with the device shard [a, n]), which falls back to
    the device pipeline itself where it does not apply.  Any other device
    takes the native engine; under `auto` the device pipeline runs if the
    native engine is unavailable.
    """
    if device_type == "cuda" and (n_cards > 1 or world_size > 1):
        return "sharded"
    if device_type == "cuda" and n_cards >= 1:
        return "hybrid"
    return "native"


class Assembler:
    def __init__(self, config: AssemblerConfig, log=print):
        self.cfg = config
        self.log = log
        self.engine = None
        self._timings = {}

    @property
    def timings(self):
        """Seconds of the last run()'s phases (PHASE_SPANS' keys), from
        the spans the recorder took of it."""
        return self._timings

    def _phase_seconds(self, run_span):
        """PHASE_SPANS' keys -> seconds, from run_span and the spans it
        holds directly."""
        key = {v: k for k, v in PHASE_SPANS.items()}
        out = {}
        for r in timing.recorder.snapshot(since=run_span.start):
            if isinstance(r, timing.Span) and r.parent == run_span.id \
                    and r.name in key:
                out[key[r.name]] = (r.end - r.start) / 1e9
        out[key[run_span.name]] = run_span.seconds
        return out

    def _build(self, graph):
        """Run the construction phase with the selected overlap engine.

        Engines (env MGTPU_OVERLAP_ENGINE or config), each on the device
        named by MGTPU_TORCH_DEVICE (cuda by default):
          device  — the torch overlap pipeline (ops/device_overlap.py),
                    canonical stream + native replay
          hybrid  — device shard + concurrent native CPU shard with exact
                    canonical merge (graph/build.py build_hybrid)
          sharded — the (dp, ix) mesh pipeline (parallel/sharded.py):
                    cfg.mesh, else one shard per visible card or per
                    torch.distributed rank
          host    — host join (index.py) + device verify
          native  — full C++ engine (index/scan/verify/BFS) on the host
          auto    — the JAX package's choice (auto_engine)
        All produce byte-identical graphs (tests/test_torch_golden.py,
        tests/test_torch_golden_host.py, tests/test_torch_engines.py,
        tests/test_torch_sharded.py).
        The engine that built the graph is left in self.engine ("device"
        when hybrid fell back to the device pipeline).  After any engine
        the recorder counts the data set's unique reads and, of them, the
        contained ones (assembler.unique_reads, assembler.contained_reads).
        """
        with timing.phase_clock("buildOverlapGraphFromHashTable",
                                log=self.log, src=__file__):
            self._build_engine(graph)
        ds = graph.ds
        timing.count("assembler.unique_reads", ds.number_of_unique_reads)
        timing.count("assembler.contained_reads",
                     int((ds.super_read_id[1:] != 0).sum()))

    def _build_engine(self, graph):
        import os
        import torch
        from . import native
        from .ops.device_overlap import DeviceOverlapPipeline, torch_device
        engine = os.environ.get("MGTPU_OVERLAP_ENGINE",
                                getattr(self.cfg, "overlap_engine", "auto"))
        if engine not in ("auto", "native", "device", "hybrid", "host",
                          "sharded"):
            raise ValueError("unknown overlap engine %r" % engine)
        auto = engine == "auto"
        if auto:
            device = torch_device()
            from .parallel.launcher import world_size
            engine = auto_engine(device.type, torch.cuda.device_count()
                                 if device.type == "cuda" else 0,
                                 world_size())
        if engine == "native":
            if not os.environ.get("MGTPU_NO_NATIVE") and \
                    graph.build_full_native():
                self.engine = "native"
                return
            if not auto:
                raise RuntimeError("native overlap engine unavailable")
            engine = "device"
        # build_hybrid constructs its pipeline without a device argument
        # (graph/build.py is a verbatim copy), so there the pipeline reads
        # MGTPU_TORCH_DEVICE itself, as torch_device() does here
        device = torch_device()
        if device.type == "cuda" and native.get_lib() is None:
            # the replay would silently run in pure Python otherwise
            raise RuntimeError("the %s engine on cuda needs the native "
                               "replay library, which failed to build"
                               % engine)
        if engine == "hybrid":
            # CPU scan of reads [1, a) concurrent with the device shard
            # [a, n]; False where it does not apply (fewer than 1024
            # reads, reads too long for one packed word), and the device
            # pipeline runs instead
            if graph.build_hybrid():
                self.engine = "hybrid"
                return
            engine = "device"
        if engine == "host":
            graph.build_from_index(OverlapIndex(self.dataset,
                                                self.cfg.min_overlap))
        elif engine == "sharded":
            from .parallel.sharded import ShardedOverlapPipeline
            graph.build_from_pipeline(ShardedOverlapPipeline(
                self.dataset, self.cfg.min_overlap, mesh=self.cfg.mesh,
                device=device))
        else:
            graph.build_from_pipeline(DeviceOverlapPipeline(
                self.dataset, self.cfg.min_overlap, device=device))
        self.engine = engine

    def run(self):
        run_span = timing.span("assembler.run")
        try:
            with run_span:
                return self._run()
        finally:
            self._timings = self._phase_seconds(run_span)

    def _run(self):
        cfg = self.cfg
        prefix = cfg.output_prefix
        with timing.span("assembler.dataset"):
            ds = Dataset(cfg.paired_end_files, cfg.single_end_files,
                         cfg.min_overlap, log=self.log)
        if ds.number_of_unique_reads == 0:
            # the reference segfaults in HashTable::insertDataset here; stop
            # with a labeled diagnostic instead
            from .errors import MyExit
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
            emit_insert_dataset_log(ds, cfg.min_overlap, self.log)
            self._build(graph)
            with timing.span("assembler.save_reads"):
                ds.save_reads(prefix + "_sortedReads.fasta")
            graph.sort_edges()
            graph.save_graph_to_file(prefix + ".unitig")

        graph.calculate_flow(prefix + "_flow.input", prefix + "_flow.output")
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
        return graph
