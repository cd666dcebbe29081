"""Serving sessions: the query-stream entry points of the host-memory rerank
tier.

Counterpart of vectorindex_tpu/models/serve.py. The reference serves every
flow through the index protocol (IVFIndex.swift:413 search / batchSearch)
and pipelines gather tiles against scoring (ExactRerank.swift:21-64). Here a
serving session is a long-lived object holding the device-resident index
state (centroids, CSR metadata, PQ codes and corrections) and the host-side
VectorReader; its `stream()` overlaps the candidate stage on the card, the
copy of the candidate ids to the host and the host rerank across a lookahead
window of batches.

`IVFPQIndex.serve_session` builds a session from live index state;
capacity deployments that load packed state themselves build
`HostRerankSession` directly.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from vectorindex_tpu_torch.kernels.adc_probe import (
    _host_queries,
    _upload,
    candidate_count,
    ivf_search_pq_hostrerank,
    ivf_search_pq_hostrerank_stream,
    pq_probe_candidates,
    rerank_by_ids,
)
from vectorindex_tpu_torch.utils.config import Metric

Tensor = torch.Tensor


def _on(t: Tensor, device: torch.device) -> bool:
    """t lies on `device` ("cuda" without an index means any card)."""
    return t.device.type == device.type and device.index in (None, t.device.index)


def _numpy(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@dataclass
class HostRerankSession:
    """Host-memory rerank tier serving session (reference VectorReader seam,
    ExactRerank.swift:81-96): the PQ codes and CSR metadata stay on
    `device` (~24 B a row at pq16), the f32 corpus serves the exact rerank
    from host RAM, and only candidate ids cross the link per batch.

    `stream(q_batches, k)` is the pipelined serving loop; `search(q, k)` the
    per-call latency path. Results are numpy arrays (dist [B, k], internal
    ids [B, k])."""

    centroids: Tensor
    arrays: object  # ops.ivf.IVFListArrays (vecs/sqnorms may be None)
    codes: Tensor
    tcorr: Tensor
    books: object  # ops.pq.PQCodebooks
    reader: object  # ops.rerank.VectorReader
    nprobe: int
    probe_cap: int
    rerank_c: int = 1024
    metric: Metric = Metric.L2
    packed_u4: bool = False
    dedup: bool = False
    row_allow: Optional[Tensor] = None
    disabled_lists: Optional[Tensor] = None
    lookahead: int = 3
    device: torch.device = torch.device("cuda")
    _kw: dict = field(init=False, repr=False)

    def __post_init__(self):
        self.device = torch.device(self.device)
        state = [self.centroids, self.codes, self.tcorr, self.books.centroids,
                 *self.arrays, self.row_allow, self.disabled_lists]
        if any(t is not None and not _on(t, self.device) for t in state):
            raise ValueError(f"the session's state must lie on its device ({self.device})")
        self._kw = dict(
            nprobe=self.nprobe, probe_cap=self.probe_cap, metric=self.metric,
            packed_u4=self.packed_u4, dedup=self.dedup, row_allow=self.row_allow,
            disabled_lists=self.disabled_lists,
        )

    def _c(self, k: int) -> int:
        return candidate_count(self.rerank_c, k, self.nprobe, self.centroids.shape[0],
                               self.probe_cap)

    def search(self, q, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Per call → (dist [B, k], internal ids [B, k]) on the host."""
        sd, si = ivf_search_pq_hostrerank(
            q, self.centroids, self.arrays, self.codes, self.tcorr, self.books, self.reader,
            k=k, rerank_c=self.rerank_c, **self._kw)
        return _numpy(sd), _numpy(si)

    def probe_candidates(self, q, k: int) -> Tuple[Tensor, Tensor, Tensor]:
        """The candidate stage alone → device tensors (adc_dist [B, C],
        CSR rows [B, C], ids [B, C]): the hook that times which stage
        binds."""
        if not isinstance(q, torch.Tensor) or not _on(q, self.device):
            q = _upload(_host_queries(q), self.device)
        return pq_probe_candidates(q, self.centroids, self.arrays, self.codes, self.tcorr,
                                   self.books, c=self._c(k), **self._kw)

    def candidates_closure(self, k: int):
        """(fn, args) with fn(q_dev, *args) → pq_probe_candidates' tensors:
        the large device state (centroids, CSR metadata, codes, tcorr, and
        the allow mask and disabled lists where set) rides in `args`, so
        timing code passes it as arguments instead of capturing it."""
        books = self.books
        kw = dict(nprobe=self.nprobe, probe_cap=self.probe_cap, c=self._c(k), metric=self.metric,
                  packed_u4=self.packed_u4, dedup=self.dedup)
        has_allow = self.row_allow is not None
        has_disabled = self.disabled_lists is not None

        def fn(q, centroids, arrays, codes, tcorr, *extra):
            extra = list(extra)
            row_allow = extra.pop(0) if has_allow else None
            disabled = extra.pop(0) if has_disabled else None
            return pq_probe_candidates(q, centroids, arrays, codes, tcorr, books,
                                       row_allow=row_allow, disabled_lists=disabled, **kw)

        extra = tuple(a for a in (self.row_allow, self.disabled_lists) if a is not None)
        return fn, (self.centroids, self.arrays, self.codes, self.tcorr) + extra

    def rerank_host(self, iids, q, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """The host rerank alone over candidate ids [B, C]: native where the
        reader's layout admits it, else the reader's gather_ids + numpy. A
        rows-keyed reader cannot serve ids: ValueError (search() and
        stream() serve it)."""
        if not hasattr(self.reader, "gather_ids"):
            raise ValueError(
                "rerank_host requires an id-keyed reader (gather_ids); this session's reader "
                "is rows-keyed: use search() or stream()"
            )
        return rerank_by_ids(self.reader, _numpy(iids), _host_queries(q), k=k,
                             metric=self.metric)

    def stream(self, q_batches: Iterable, k: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Pipelined serving: yields (dist [B, k], ids [B, k]) per batch, in
        order, with up to `lookahead` batches in flight."""
        for sd, si in ivf_search_pq_hostrerank_stream(
            q_batches, self.centroids, self.arrays, self.codes, self.tcorr, self.books,
            self.reader, k=k, rerank_c=self.rerank_c, lookahead=self.lookahead, **self._kw,
        ):
            yield _numpy(sd), _numpy(si)
