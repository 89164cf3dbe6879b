"""Multi-device search over a mesh of ``torch.device`` slots.

Port of ``fast_plaid_tpu/parallel/``. One process drives every device of
the mesh, a worker thread a distinct device:

* document sharding (``parallel/sharded.py``): codes, residuals and
  per-shard IVFs split by document across the mesh, each shard searched
  whole, the per-shard [B, top_k] results merged on the first device;
* query sharding (``sharded.query_sharded_search``): the index copied to
  each device, the query batch split;
* 2-D (replica x shard) meshes (``parallel/mesh2d.py``): doc-sharded
  groups replicated along a second axis that splits the query batch;
* per-shard low_memory (``parallel/lm_sharded.py``): each shard a
  low_memory index searched by ``search_on_device``, merged on the
  host;
* ``ShardedFastPlaid`` (``parallel/api.py``) over an on-disk index.

A mesh may name one device several times: ``[cuda:0] * 4`` runs four
shards on one card, ``[cpu] * 4`` runs them in the tests.
"""

from fast_plaid_tpu_torch.parallel.api import ShardedFastPlaid
from fast_plaid_tpu_torch.parallel.lm_sharded import ShardedLowMemory, load_sharded_lm
from fast_plaid_tpu_torch.parallel.mesh import make_mesh
from fast_plaid_tpu_torch.parallel.mesh2d import (
    make_mesh_2d,
    replicate_sharded_index,
    sharded_search_2d,
)
from fast_plaid_tpu_torch.parallel.sharded import (
    ShardedIndex,
    build_sharded_index,
    query_sharded_search,
    sharded_search,
)

__all__ = [
    "ShardedFastPlaid",
    "make_mesh",
    "ShardedIndex",
    "build_sharded_index",
    "sharded_search",
    "query_sharded_search",
    "ShardedLowMemory",
    "load_sharded_lm",
    "make_mesh_2d",
    "replicate_sharded_index",
    "sharded_search_2d",
]
