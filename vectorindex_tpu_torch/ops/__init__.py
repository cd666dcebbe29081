"""Kernel-level operations as plain torch functions on tensors (the
counterparts of vectorindex_tpu.ops)."""

from vectorindex_tpu_torch.ops import (  # noqa: F401
    filtering,
    idmap,
    ivf,
    kmeans,
    rng,
    scan,
    scoring,
    topk,
)
