"""Multi-device layer: meshes, the distributed six-step NTT, its all-to-alls
and its memory budget.

The counterpart of ``sventt_tpu/parallel/``: the length-n coefficient
vector is row-sharded over the devices of a mesh, one process drives every
shard, and the six-step transposes are all-to-alls between the shards (a
torch copy, or the ring kernel K10 on CUDA shards).
"""

from .budget import MemoryBudget, distributed_memory_budget, validate_2p30
from .mesh import make_ntt_mesh
from .sixstep import DistributedNTT

__all__ = [
    "make_ntt_mesh",
    "DistributedNTT",
    "MemoryBudget",
    "distributed_memory_budget",
    "validate_2p30",
]
