"""Multi-chip sharding: collections larger than one chip shard across a
``jax.sharding.Mesh`` with query broadcast and a sharded top-k merge over the interconnect
(the distributed backend the single-node reference lacks; SURVEY §5.8)."""

from .collection_mesh import MeshFlatIndex, MeshHnswIndex
from .hnsw_mesh import ShardedHnsw
from .mesh import ShardedFlat, make_mesh, sharded_search

__all__ = [
    "MeshFlatIndex",
    "MeshHnswIndex",
    "ShardedFlat",
    "ShardedHnsw",
    "make_mesh",
    "sharded_search",
]
