"""Assembler configuration.

All algorithm tuning values of the reference assembler are compile-time
constants scattered through the code (reference: MetaGenomics/Common.h:40-44
plus literals in OverlapGraph.cpp).  Here they are lifted into a single
dataclass with the exact reference defaults — these values determine output
equality with the reference, so do not change them casually.
"""

from dataclasses import dataclass, field
from typing import List


@dataclass
class AssemblerConfig:
    # --- CLI-level options (reference: main.cpp:117-184) ---
    paired_end_files: List[str] = field(default_factory=list)
    single_end_files: List[str] = field(default_factory=list)
    output_prefix: str = ""
    min_overlap: int = 0
    resume_from_unitig: bool = False  # -s flag

    # --- Core constants (reference: Common.h:40-44) ---
    a_statistics_threshold: int = 3
    min_delta: int = 1000
    dead_end_length: int = 10          # composite edges with more reads guard dead-end removal
    minimum_support: int = 3           # mate-pair support needed to merge edges
    loop_limit: int = 15               # cap on each of the three driver loops

    # --- QC (reference: Dataset.cpp:398-413) ---
    max_same_base_frac: float = 0.8

    # --- Hash/index (reference: HashTable.cpp:54,56) ---
    # hash string length = min_overlap - 1; table sizing is an artifact of the
    # open-addressing design and has no equivalent in the sorted-key index.

    # --- Insert size estimation (reference: OverlapGraph.cpp:1170) ---
    insert_size_cap: int = 1000
    insert_size_window_sd: int = 3     # mean +/- 3*SD windows (:1697,:1812,:2157)

    # --- Mate-pair path search (reference: OverlapGraph.cpp:1800) ---
    dfs_depth_cap: int = 100

    # --- Flow bounds/costs (reference: OverlapGraph.cpp:1614-1638,1405-1446) ---
    composite_edge_min_reads_for_flow: int = 20   # lb 1 if more than this many reads
    flow_simple_cost: int = 500000
    flow_simple_ub: int = 10
    flow_costs: tuple = (1, 50000, 100000)
    flow_ubs: tuple = (1, 1, 8)
    flow_return_arc_cost: int = 1000000
    flow_return_arc_ub: int = 1000000

    # --- Graph cleanup (reference: OverlapGraph.cpp:2567,2572,2371,948) ---
    similar_edge_frac: int = 20        # lengths/edit distance within 1/20 (5%)
    min_scaffold_overlap: int = 10     # bp needed to join scaffold junction reads

    # --- Mate-pair linkage graph (reference design intent) ---
    # coverageDepthLB/UB are referenced but never declared in the snapshot
    # (MatePairGraph.cpp:241); the mate-pair-graph refinement is therefore
    # off by default and these bounds are explicit config here.
    coverage_depth_lb: int = 2
    coverage_depth_ub: int = 100

    # --- New-framework options (no reference equivalent) ---
    # clean_flow: solve the flow phase with the clean-room SSP solver
    # (mincostflow.py / mg_mincostflow) instead of the CS2-trajectory
    # replay.  Flows are exact optima of the same instance, but the
    # _flow.output line order and the selection among equal-cost optima are
    # this solver's own, so downstream artifacts need not byte-match a
    # reference run.  See LICENSES.md for why this mode exists.
    clean_flow: bool = False
    use_native_build: bool = True      # C++ construction engine when available
    overlap_engine: str = "auto"       # auto | native | device | sharded | host
    mesh: object = None                # jax.sharding.Mesh for the sharded
                                       # engine (default: auto from devices)

    @property
    def hash_string_length(self) -> int:
        """l-mer length used for overlap seeding (reference: HashTable.cpp:54)."""
        return self.min_overlap - 1
