"""Multi-shard scaling: device meshes and sharded overlap detection (port of
metagenomics_tpu/parallel/ over torch.distributed).

The reference is strictly single-threaded; this package adds the scaling
axes:

* ``dp``  -- read/candidate batches sharded across shards (data parallel)
* ``ix``  -- the l-mer index sharded by key range across shards

Candidate matching is a join between the two: every dp shard's queries
visit every ix shard's index slice; per-shard partial results combine
with psum/all_gather (parallel/collectives.py: in one process, or one
shard per rank over torch.distributed).
"""

from .mesh import make_mesh
from .launcher import initialize_distributed
from .sharded import ShardedOverlapPipeline

__all__ = ["make_mesh", "initialize_distributed", "ShardedOverlapPipeline"]
