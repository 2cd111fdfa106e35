"""Overlap-graph core: construction, reduction, flow, mate pairs, scaffolding.

The bulk candidate generation/verification runs on device (ops/, index.py);
this package performs the order-sensitive graph surgery on host over a
compact edge structure, reproducing the reference's operation order exactly
(required for artifact byte-equality — see SURVEY.md §"Hard parts").
"""

from .core import Edge, GraphCore
from .build import BuildMixin
from .simplify import SimplifyMixin
from .flow import FlowMixin
from .matepair import MatePairMixin
from .scaffold import ScaffoldMixin
from .genome_size import GenomeSizeMixin
from .matepair_graph import MatePairGraph, MatePairLink


class OverlapGraph(BuildMixin, SimplifyMixin, FlowMixin, MatePairMixin,
                   ScaffoldMixin, GenomeSizeMixin, GraphCore):
    """Bidirected overlap graph with the full reference feature set."""


__all__ = ["Edge", "OverlapGraph", "MatePairGraph", "MatePairLink"]
