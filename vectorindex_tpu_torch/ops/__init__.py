"""Kernel-level operations as plain torch functions on tensors (the
counterparts of vectorindex_tpu.ops)."""

from vectorindex_tpu_torch.ops import (  # noqa: F401
    dedup,
    dtypes,
    filtering,
    graph,
    idmap,
    ivf,
    ivf_pq,
    kmeans,
    pq,
    range_query,
    rerank,
    reservoir,
    rng,
    scan,
    scoring,
    topk,
)
