"""vectorindex_tpu_torch — the PyTorch/CUDA port of vectorindex_tpu.

The JAX package `vectorindex_tpu` is the reference; this package mirrors its
layout and public names so each module has an obvious counterpart:

  ops/         scoring, topk, scan, filtering, idmap, rng, kmeans, ivf,
               dtypes, dedup, pq, ivf_pq, range_query, reservoir, rerank,
               graph (plain torch; rerank's host path is native C++)
  kernels/     hand-written CUDA kernels for Hopper (sm_90a), each with a
               plain PyTorch version used for CPU tensors
  models/      FlatIndex, IVFIndex, IVFPQIndex, HNSWIndex, JournalFilter,
               the index protocol, HostRerankSession (models/serve)
  persistence/ JSON snapshots (byte-compatible with the JAX package) and the
               native host-ops source (native/hostops.cpp)
  utils/       config, structured errors, telemetry

Nothing here imports jax or vectorindex_tpu. The port so far covers exact flat
search and range queries, IVF-Flat, IVF-PQ with the device-resident rerank
and with the host-memory rerank tier, the full-corpus ADC scans, and HNSW
(chunked build, fused search, filters, the serving stream); ROADMAP.md lists
what is still to port.
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
