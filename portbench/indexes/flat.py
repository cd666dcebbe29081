"""flat: the port's exact flat index (`models.FlatIndex`).

The configuration's `index` block gives its capacity and storage dtype.
Rows go in through `insert_batch` with the ids 0..N-1 in chunks, queries
through `batch_search` (an allow list as `allow_ids`). Its answers are an
exact top-k, so the comparison takes the "exact" form (compare.py).

Queries that K2's count cannot prove exact (ties at the k-th distance)
take the strict fallback; its counter is RARE_COUNTER, so set-up warms it.

An index module gives ANSWER and build / search / pairs, and may give
prime (set-up before the timed index is built) and RARE_COUNTER (a TELEM
counter of a path few queries take). Nothing of the program is imported
until a function runs.
"""

from __future__ import annotations

import numpy as np
import torch

ANSWER = "exact"
RARE_COUNTER = "flat.verify_fallback"
#: rows a call to insert_batch
INSERT_CHUNK = 1 << 20
#: rows and capacity of the index that builds the kernels in set-up (the
#: capacity from which the index takes the fused scan)
PRIME_ROWS, PRIME_CAPACITY = 2048, 1 << 17

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _new(cfg: dict, capacity: int, device: torch.device):
    from vectorindex_tpu_torch.models import FlatIndex
    from vectorindex_tpu_torch.utils.config import Metric

    metric = {"l2": Metric.L2, "ip": Metric.INNER_PRODUCT, "cosine": Metric.COSINE}[cfg["metric"]]
    return FlatIndex(int(cfg["dimension"]), metric, capacity=capacity,
                     storage_dtype=_DTYPES[cfg["index"]["storage_dtype"]], device=device)


def prime(cfg: dict, batch: int, k: int, device: torch.device, rows: np.ndarray) -> None:
    """Build and load the kernels, and start the device's libraries, on a
    small index of the configuration's kind."""
    x = np.ascontiguousarray(rows[:PRIME_ROWS])
    index = _new(cfg, PRIME_CAPACITY, device)
    index.insert_batch(range(x.shape[0]), x)
    index.batch_search(x[: min(batch, x.shape[0])], k)


def build(cfg: dict, rows: np.ndarray, device: torch.device):
    """The timed index, holding every row under its row number."""
    index = _new(cfg, int(cfg["index"]["capacity"]), device)
    for s in range(0, rows.shape[0], INSERT_CHUNK):
        index.insert_batch(range(s, min(s + INSERT_CHUNK, rows.shape[0])), rows[s : s + INSERT_CHUNK])
    return index


def search(index, queries: np.ndarray, k: int, allow=None):
    if allow is None:
        return index.batch_search(queries, k)
    return index.batch_search(queries, k, allow_ids=allow)


def pairs(result) -> list:
    """[(id, score), ...] of each query of a call's result."""
    return [[(r.id, r.score) for r in row] for row in result]
