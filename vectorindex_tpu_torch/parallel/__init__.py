"""Sharding over a mesh of devices held by one process (counterpart of
vectorindex_tpu.parallel): row- and list-sharded corpora, per-shard search,
and the strict top-k merge on the mesh's first device."""

from vectorindex_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    REPLICA_AXIS,
    Mesh,
    ShardedRows,
    corpus_sharding,
    make_mesh,
    make_mesh_2d,
    pad_rows,
    replicated,
    shard_rows,
)
from vectorindex_tpu_torch.parallel.sharded_search import (  # noqa: F401
    make_sharded_search_fn,
    sharded_flat_search,
    sharded_flat_search_2d,
)
from vectorindex_tpu_torch.parallel.sharded_ivf import (  # noqa: F401
    ShardedIVFArrays,
    partition_store,
    sharded_ivf_pq_search,
    sharded_ivf_search,
)
from vectorindex_tpu_torch.parallel.sharded_hnsw import (  # noqa: F401
    ShardedHNSWState,
    build_sharded_hnsw,
    sharded_hnsw_search,
)
