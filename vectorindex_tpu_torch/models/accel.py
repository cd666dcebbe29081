"""Acceleration seam: structure/candidate export + result finalization.

Counterpart of vectorindex_tpu.models.accel. Parity target: reference
AccelerableIndex.swift:130-194 (getCandidates / getBatchCandidates /
getIndexStructure / finalizeResults / shouldAccelerate),
AccelerationCandidates contiguous snapshot (:15-69), HNSWStructure /
IVFStructure exports (:95-127), default shouldAccelerate ≥50k ops && ≥500
candidates (:198-202), AccelerableIndexEnhanced.swift, and
VectorReferenceCollection.swift (contiguous vector snapshots).

In the reference this seam hands work *to* an accelerator; here the card
is the primary engine, so the seam faces the other way: it exports
contiguous snapshots and index structure for external consumers (CPU
rerankers, other processes, debuggers), and `finalize_results` turns
externally computed candidate lists back into public results through the
id mapping, filter and score conversion the native search uses. Arrays
returned are numpy copies, safe across later index mutation. The IVF
candidates come from the port's ops/ivf.ivf_select on the index's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

import torch

from vectorindex_tpu_torch.models.base import FilterFn, SearchResult, VectorIndex
from vectorindex_tpu_torch.models.flat import FlatIndex
from vectorindex_tpu_torch.models.hnsw import HNSWIndex
from vectorindex_tpu_torch.models.ivf import IVFIndex
from vectorindex_tpu_torch.ops.ivf import ivf_select
from vectorindex_tpu_torch.utils.config import Metric

#: default acceleration thresholds (reference :198-202)
MIN_OPS = 50_000
MIN_CANDIDATES = 500


@dataclass
class VectorReferenceCollection:
    """Contiguous snapshot of live vectors (reference
    VectorReferenceCollection.swift). Arrays are copies — safe across
    subsequent index mutation."""

    vectors: np.ndarray  # [n, d] f32
    internal_ids: np.ndarray  # [n] i32
    external_ids: list


@dataclass
class AccelerationCandidates:
    """Contiguous candidate snapshot (reference AccelerationCandidates,
    AccelerableIndex.swift:15-69)."""

    vectors: np.ndarray  # [c, d]
    internal_ids: np.ndarray  # [c]
    count: int


@dataclass
class FlatStructure:
    count: int
    dimension: int
    metric: str


@dataclass
class IVFStructure:
    """Reference IVFStructure (:95-127)."""

    centroids: Optional[np.ndarray]
    list_starts: Optional[np.ndarray]
    list_lengths: Optional[np.ndarray]
    row_ids: Optional[np.ndarray]
    nlist: int
    nprobe: int
    trained: bool


@dataclass
class HNSWStructure:
    """Reference HNSWStructure (:95-127): per-level fixed-degree tables +
    global-id rows (the CSR analog)."""

    levels: list  # per level: {"node_ids": [n_l], "neighbors": [n_l, M_l]}
    entry_point: int
    max_level: int
    m: int


def snapshot(index: VectorIndex) -> VectorReferenceCollection:
    """Contiguous live-vector snapshot for any index family."""
    if isinstance(index, FlatIndex):
        slots = np.nonzero(index._valid)[0]
        vecs = index._vectors[slots].copy()
    elif isinstance(index, IVFIndex):
        slots = np.asarray(sorted(index._vectors.keys()), dtype=np.int64)
        vecs = (
            np.stack([index._vectors[int(s)] for s in slots])
            if len(slots)
            else np.zeros((0, index.dimension), np.float32)
        )
    elif isinstance(index, HNSWIndex):
        slots = np.nonzero(index._valid)[0]
        vecs = index._vectors[slots].copy()
    else:
        raise TypeError(f"unsupported index type {type(index)!r}")
    ext = [index._idmap.external_for(int(s)) for s in slots]
    return VectorReferenceCollection(vecs, slots.astype(np.int32), ext)


def get_index_structure(index: VectorIndex):
    """Export the navigable structure (reference getIndexStructure)."""
    if isinstance(index, HNSWIndex):
        index._ensure_built()
        levels = []
        for layer in index._layers:
            n = layer.count
            levels.append(
                {
                    "node_ids": np.asarray(layer.node_ids, dtype=np.int32),
                    "neighbors": layer.nbrs[:n].copy(),
                }
            )
        return HNSWStructure(
            levels=levels,
            entry_point=index._entry,
            max_level=len(index._layers) - 1,
            m=index.config.m,
        )
    if isinstance(index, IVFIndex):
        if index.trained:
            p = index._store.packed()
            return IVFStructure(
                centroids=np.asarray(index._centroids).copy(),
                list_starts=p["starts"].copy(),
                list_lengths=p["lengths"].copy(),
                row_ids=p["row_ids"].copy(),
                nlist=index.config.nlist,
                nprobe=index.config.nprobe,
                trained=True,
            )
        return IVFStructure(None, None, None, None, index.config.nlist, index.config.nprobe, False)
    if isinstance(index, FlatIndex):
        return FlatStructure(index.count, index.dimension, index.metric.value)
    raise TypeError(f"unsupported index type {type(index)!r}")


def get_batch_candidates(
    index: VectorIndex, queries, limit: int = 0
) -> list[AccelerationCandidates]:
    """Candidate snapshots per query (reference getBatchCandidates): flat →
    the whole store; IVF → the probed lists' rows; HNSW → beam frontier."""
    q = np.asarray(queries, dtype=np.float32)
    if q.ndim == 1:
        q = q[None, :]
    if isinstance(index, FlatIndex):
        snap = snapshot(index)
        cand = AccelerationCandidates(
            snap.vectors, snap.internal_ids, len(snap.internal_ids)
        )
        return [cand for _ in range(q.shape[0])]
    if isinstance(index, IVFIndex) and index.trained:
        _, lists = ivf_select(
            torch.from_numpy(q).to(index.device),
            index._centroids_dev,
            nprobe=min(index.config.nprobe, index.config.nlist),
            metric=index.metric,
        )
        lists = lists.cpu().numpy()
        out = []
        for b in range(q.shape[0]):
            ids, vecs = [], []
            for l in lists[b]:
                li, lv = index._store.read_list(int(l))
                ids.append(li)
                vecs.append(lv)
            ids = np.concatenate(ids) if ids else np.zeros(0, np.int32)
            vecs = (
                np.concatenate(vecs)
                if vecs
                else np.zeros((0, index.dimension), np.float32)
            )
            if limit and len(ids) > limit:
                ids, vecs = ids[:limit], vecs[:limit]
            out.append(AccelerationCandidates(vecs, ids, len(ids)))
        return out
    if isinstance(index, HNSWIndex):
        k = limit or index.config.ef_search
        res = index.batch_search(q, k)
        out = []
        for row in res:
            slots = np.asarray(
                [index._idmap.lookup(r.id) for r in row], dtype=np.int32
            )
            out.append(
                AccelerationCandidates(
                    index._vectors[slots].copy(), slots, len(slots)
                )
            )
        return out
    raise TypeError(f"unsupported index for candidates: {type(index)!r}")


def get_candidates(index: VectorIndex, query, limit: int = 0) -> AccelerationCandidates:
    return get_batch_candidates(index, np.asarray(query)[None, :], limit)[0]


def finalize_results(
    index: VectorIndex,
    internal_ids: np.ndarray,
    dists: np.ndarray,
    k: int,
    filter: Optional[FilterFn] = None,
) -> list[SearchResult]:
    """Turn externally-computed (internal id, ascending distance) candidates
    into public results (reference finalizeResults): id mapping, metadata
    filter, metric score conversion (sqrt at the L2 boundary)."""
    order = np.argsort(dists, kind="stable")
    out: list[SearchResult] = []
    metric = index.metric
    for j in order:
        slot = int(internal_ids[j])
        try:
            ext = index._idmap.external_for(slot)
        except Exception:
            continue
        meta = (
            index._metadata[slot]
            if isinstance(index._metadata, list)
            else index._metadata.get(slot)
        )
        if filter is not None and not filter(meta):
            continue
        d = float(dists[j])
        if metric == Metric.L2:
            score = float(np.sqrt(max(d, 0.0)))
        elif metric == Metric.INNER_PRODUCT:
            score = -d
        elif metric == Metric.COSINE:
            score = 1.0 - d
        else:
            score = d
        out.append(SearchResult(id=ext, score=score, metadata=meta))
        if len(out) == k:
            break
    return out


def should_accelerate(index: VectorIndex, n_queries: int, k: int) -> bool:
    """Heuristic: offload only when the work amortizes the transfer
    (reference default ≥50k distance ops && ≥500 candidates, :198-202)."""
    ops = n_queries * index.count * getattr(index, "dimension", 1)
    return ops >= MIN_OPS and index.count >= MIN_CANDIDATES
