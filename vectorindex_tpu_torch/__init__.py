"""vectorindex_tpu_torch — the PyTorch/CUDA port of vectorindex_tpu.

The JAX package `vectorindex_tpu` is the reference; this package mirrors its
layout and public names so each module has an obvious counterpart:

  ops/         scoring, topk, scan, filtering, idmap, rng, kmeans, ivf,
               dtypes, dedup, pq, ivf_pq, range_query, reservoir, rerank,
               graph, mips, layout (plain torch; rerank's host path is
               native C++)
  kernels/     hand-written CUDA kernels for Hopper (sm_90a), each with a
               plain PyTorch version used for CPU tensors
  models/      FlatIndex, IVFIndex, IVFPQIndex, HNSWIndex, ShardedFlatIndex,
               ShardedHNSWIndex, JournalFilter, the index protocol,
               HostRerankSession (models/serve), the acceleration seam
               (models/accel), typed inputs (models/typed)
  parallel/    device meshes held by one process, row- and list-sharded
               search with the strict top-k merge (no torch.distributed)
  persistence/ JSON snapshots, the binary container (native/container.cpp)
               with the Flat/HNSW layouts and the durable IVF journal, all
               in the JAX package's formats; the native host-ops source
               (native/hostops.cpp)
  utils/       config, structured errors, telemetry, debug checks
  bench/       the benchmark harness and its CLI (`python -m
               vectorindex_tpu_torch.bench`): seeded corpora, the artifact
               cache, bulk index builders, exact truth and timing

Nothing here imports jax or vectorindex_tpu. The port covers the JAX
package's API: exact flat search (fused kernels, the verified two-phase
scan) and range queries, IVF-Flat, IVF-PQ with the device-resident rerank
and with the host-memory rerank tier, the full-corpus ADC scans, HNSW,
persistence, MIPS, the acceleration seam, sharding and the benchmark
harness.
"""

__version__ = "0.1.0"

from vectorindex_tpu_torch.utils.errors import IndexError, IndexErrorKind  # noqa: F401
from vectorindex_tpu_torch.models.hnsw import HNSWConfig, HNSWIndex  # noqa: F401,E402
from vectorindex_tpu_torch.models.ivf import (  # noqa: F401,E402
    IVFConfig,
    IVFIndex,
    IVFPQConfig,
    IVFPQIndex,
)
from vectorindex_tpu_torch.models.sharded import (  # noqa: F401,E402
    ShardedFlatIndex,
    ShardedHNSWIndex,
)
