"""ShardedFlatIndex and ShardedHNSWIndex: a corpus sharded across the
devices of a mesh held by one process.

Counterpart of vectorindex_tpu.models.sharded (SURVEY.md §2.4/§5.8: the
component the reference does not have). The JAX package shards over a
`Mesh` with `shard_map`; here a mesh is a list of torch devices
(parallel/mesh), each shard's tensors live on their device, each shard's
scan is enqueued there, and the per-shard k-lists merge on the mesh's first
device (parallel/sharded_search). No torch.distributed. A mesh may repeat a
device, so one card can hold several shards.

Constructors take the JAX package's arguments plus the port's `device`
(where the mesh's devices come from: "cuda" means the visible cards, "cpu"
means n_devices copies of the CPU) or an explicit `devices` list.

  - ShardedFlatIndex: FlatIndex's host control plane (tombstones, free
    list, growth, compact, statistics, JSON save/load in the JAX snapshot
    format, type "sharded_flat"), placed row-sharded on sync; exact search
    on any shard count.
  - ShardedHNSWIndex: per-shard graphs built in bulk (parallel/
    sharded_hnsw) with a host TAIL BUFFER: inserts after the build are
    scanned exactly and merged, and the graphs are rebuilt only when the
    tail outgrows max(1024, built/8) rows, or on compact(); removals are
    tombstones filtered at result assembly (the searches over-fetch).
"""

from __future__ import annotations

from dataclasses import asdict, fields
from typing import Optional

import numpy as np
import torch

from vectorindex_tpu_torch.models.base import (
    FilterFn,
    IndexStats,
    Metadata,
    SearchResult,
    VectorID,
    VectorIndex,
)
from vectorindex_tpu_torch.models.flat import MIN_CAPACITY, FlatIndex
from vectorindex_tpu_torch.models.hnsw import HNSWConfig
from vectorindex_tpu_torch.ops.range_query import range_scan
from vectorindex_tpu_torch.ops.topk import INVALID_ID
from vectorindex_tpu_torch.parallel import sharded_hnsw
from vectorindex_tpu_torch.parallel.mesh import corpus_sharding, make_mesh
from vectorindex_tpu_torch.parallel.sharded_search import sharded_flat_search
from vectorindex_tpu_torch.persistence.json_snapshot import (
    PersistedIndex,
    PersistedRecord,
    load_snapshot,
    save_snapshot,
)
from vectorindex_tpu_torch.utils import debug
from vectorindex_tpu_torch.utils.config import Metric
from vectorindex_tpu_torch.utils.errors import (
    ErrorBuilder,
    IndexErrorKind,
    dimension_mismatch,
    duplicate_id,
    not_found,
)
from vectorindex_tpu_torch.utils.telemetry import TELEM


def _mesh(n_devices: Optional[int], device, devices):
    """The index's mesh: `devices` as given, else the visible cards for a
    CUDA `device`, else n_devices copies of `device`."""
    if devices is None and torch.device(device).type != "cuda":
        devices = [torch.device(device)] * (n_devices or 1)
    return make_mesh(n_devices, devices=devices)


class ShardedFlatIndex(FlatIndex):
    """FlatIndex whose storage and scan are sharded over a device mesh."""

    TYPE = "sharded_flat"

    def __init__(
        self,
        dimension: int,
        metric: Metric = Metric.L2,
        capacity: int = MIN_CAPACITY,
        storage_dtype: torch.dtype = torch.float32,
        n_devices: Optional[int] = None,
        device="cuda",
        devices=None,
    ):
        self.mesh = _mesh(n_devices, device, devices)
        super().__init__(dimension, metric, capacity, storage_dtype, device=self.mesh.first)
        self.n_shards = self.mesh.size
        # capacity must divide evenly across shards
        if self.capacity % self.n_shards:
            raise (
                ErrorBuilder(IndexErrorKind.INVALID_CONFIGURATION)
                .message(f"capacity {self.capacity} must divide by the mesh size {self.n_shards}")
                .build()
            )

    def _sync_device(self, sqnorms: Optional[np.ndarray] = None):
        """(vectors, ||x||^2, 1/||x||, valid) as ShardedRows over the mesh
        (overrides the single-device placement)."""
        if self._dev is None:
            sqn = self._sqnorms() if sqnorms is None else sqnorms
            inv = np.where(sqn > 0, 1.0 / np.sqrt(np.maximum(sqn, 1e-30)), 0.0)
            # copies: on the CPU the shards must not alias the host mirrors
            shard = corpus_sharding(self.mesh)
            self._dev = tuple(
                shard.put(torch.from_numpy(a).to(dtype, copy=True))
                for a, dtype in ((self._vectors, self.storage_dtype), (sqn, torch.float32),
                                 (inv.astype(np.float32), torch.float32), (self._valid, torch.bool))
            )
        return self._dev

    def range_search(
        self,
        query,
        radius: float,
        max_results: int = 128,
        filter: Optional[FilterFn] = None,
    ) -> list[SearchResult]:
        """FlatIndex.range_search over the shards gathered on the mesh's
        first device."""
        q = np.asarray(query, dtype=np.float32)[None, :]
        if q.shape[1] != self.dimension:
            raise dimension_mismatch(self.dimension, q.shape[1], "range_search")
        if self.count == 0:
            return []
        vecs, sqn, inv, valid = (a.gather(self.device) for a in self._sync_device())
        if filter is not None:
            valid = torch.from_numpy(self._filter_valid(filter)).to(self.device)
        res = range_scan(
            torch.from_numpy(q).to(self.device), vecs, radius, metric=self.metric,
            max_results=min(max_results, self.capacity), valid=valid,
            x_sqnorms=sqn, x_invnorms=inv,
        )
        return self._results(res.dists.cpu().numpy(), res.ids.cpu().numpy(), max_results)[0]

    def batch_search(
        self,
        queries,
        k: int,
        filter: Optional[FilterFn] = None,
        *,
        allow_ids=None,
        deny_ids=None,
    ) -> list[list[SearchResult]]:
        """allow_ids / deny_ids fold into the sharded scan's validity mask
        before the per-shard top-k and the merge (the single-device path's
        pre-selection contract, reference IDFilter.swift:104)."""
        q = np.ascontiguousarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.shape[1] != self.dimension:
            raise dimension_mismatch(self.dimension, q.shape[1], "sharded_flat.search")
        if self.count == 0 or k <= 0:
            return [[] for _ in range(q.shape[0])]
        vecs, sqn, inv, valid = self._sync_device()
        if filter is not None or allow_ids is not None or deny_ids is not None:
            valid = torch.from_numpy(self._filter_valid(filter, allow_ids, deny_ids))
        kk = min(k, self.capacity)
        dist, ids = sharded_flat_search(
            self.mesh, torch.from_numpy(q).to(self.device), vecs, valid, kk, self.metric,
            x_sqnorms=sqn, x_invnorms=inv if self.metric == Metric.COSINE else None,
        )
        TELEM.record_kernel("scan_sharded", rows=q.shape[0] * self.count)
        dist = dist.cpu().numpy()
        debug.check_search_output("ShardedFlatIndex.batch_search", dist)
        return self._results(dist, ids.cpu().numpy(), k)

    def statistics(self) -> IndexStats:
        st = super().statistics()
        st.details["n_shards"] = self.n_shards
        st.details["mesh"] = str(self.mesh.shape)
        return st


class ShardedHNSWIndex(VectorIndex):
    """Graph index served from per-shard subgraphs with a top-k merge
    (BASELINE config 5's model-level surface; ops in parallel/sharded_hnsw).

    The bulk build gives immutable per-shard graphs; later inserts land in
    a host tail buffer that search scans exactly and merges with the graph
    candidates, so a single insert never rebuilds a shard. Graphs are
    rebuilt to absorb the tail only when it outgrows max(1024, built/8)
    rows, or on compact(). Removals are tombstones filtered at result
    assembly."""

    TYPE = "sharded_hnsw"

    def __init__(
        self,
        dimension: int,
        metric: Metric = Metric.L2,
        config: Optional[HNSWConfig] = None,
        n_devices: Optional[int] = None,
        device="cuda",
        devices=None,
    ):
        if metric not in (Metric.L2, Metric.INNER_PRODUCT, Metric.COSINE):
            raise (
                ErrorBuilder(IndexErrorKind.UNSUPPORTED_METRIC)
                .message(f"sharded HNSW supports L2/IP/cosine, got {metric.value}")
                .build()
            )
        self.dimension = dimension
        self.metric = metric
        self.config = config or HNSWConfig()
        self.mesh = _mesh(n_devices, device, devices)
        self.n_shards = self.mesh.size
        self._vectors: list[np.ndarray] = []
        self._ids: list[VectorID] = []
        self._metadata: list[Metadata] = []
        self._id_to_row: dict = {}
        self._dead: set[int] = set()
        self._state = None  # parallel.sharded_hnsw.ShardedHNSWState
        self._built_rows = 0
        self._stacked = None  # np.stack of the built rows (rescoring)

    # -- CRUD ----------------------------------------------------------

    @property
    def count(self) -> int:
        return len(self._ids) - len(self._dead)

    def insert(self, id: VectorID, vector, metadata: Metadata = None) -> None:
        if id in self._id_to_row:
            raise duplicate_id(id, "sharded_hnsw.insert")
        v = np.asarray(vector, dtype=np.float32).reshape(-1)
        if v.shape[0] != self.dimension:
            raise dimension_mismatch(self.dimension, v.shape[0], "sharded_hnsw")
        self._id_to_row[id] = len(self._ids)
        self._ids.append(id)
        self._vectors.append(v)
        self._metadata.append(metadata)
        # no state invalidation: the new row serves from the tail buffer
        # until _ensure_built decides a rebuild amortizes

    def insert_batch(self, ids, vectors, metadatas=None) -> None:
        vectors = np.asarray(vectors, dtype=np.float32)
        for i, id_ in enumerate(ids):
            self.insert(id_, vectors[i], None if metadatas is None else metadatas[i])

    def remove(self, id: VectorID) -> None:
        row = self._id_to_row.pop(id, None)
        if row is None:
            raise not_found(id, "sharded_hnsw.remove")
        self._dead.add(row)

    def contains(self, id: VectorID) -> bool:
        return id in self._id_to_row

    def update(self, id: VectorID, vector=None, metadata: Metadata = None):
        row = self._id_to_row[id]
        if vector is not None:
            meta = self._metadata[row] if metadata is None else metadata
            self.remove(id)
            self.insert(id, vector, meta)
        elif metadata is not None:
            self._metadata[row] = metadata

    # -- build + search ------------------------------------------------

    def _tail_count(self) -> int:
        return len(self._ids) - self._built_rows

    def _ensure_built(self):
        if self._state is not None:
            if self._tail_count() <= max(1024, self._built_rows // 8):
                return  # serve the tail from the exact side buffer
        x = np.stack(self._vectors) if self._vectors else np.zeros(
            (0, self.dimension), np.float32
        )
        self._stacked = x
        self._state = sharded_hnsw.build_sharded_hnsw(
            x, self.n_shards, self.metric, self.config,
            global_ids=np.arange(len(self._ids), dtype=np.int64),
            devices=list(self.mesh.devices.flat),
        )
        self._built_rows = len(self._ids)

    def _scores(self, q: np.ndarray, vs: np.ndarray) -> np.ndarray:
        """True-metric ascending scores, q [B, d] against vs [T, d] (every
        query) or [B, K, d] (each query its own rows)."""
        if self.metric == Metric.L2:
            if vs.ndim == 2:
                return np.linalg.norm(q[:, None, :] - vs[None], axis=-1)
            return np.linalg.norm(vs - q[:, None, :], axis=-1)
        if vs.ndim == 2:
            dots = q @ vs.T
            vn = np.linalg.norm(vs, axis=-1)[None]
        else:
            dots = np.einsum("bkd,bd->bk", vs, q)
            vn = np.linalg.norm(vs, axis=-1)
        if self.metric == Metric.INNER_PRODUCT:
            return -dots  # ascending internal convention
        qn = np.maximum(np.linalg.norm(q, axis=-1), 1e-30)[:, None]
        return -(dots / (np.maximum(vn, 1e-30) * qn))

    def batch_search(self, queries, k: int, filter: Optional[FilterFn] = None, *,
                     allow_ids=None, deny_ids=None):
        """allow_ids / deny_ids: external-id set filters. The sharded graph
        over-fetches ef >= 4k candidates per query (plus the exactly
        scanned tail buffer), and the sets mask during assembly: selective
        filters beyond ~75% should raise ef_search."""
        allow_set = None if allow_ids is None else set(allow_ids)
        deny_set = None if deny_ids is None else set(deny_ids)
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.shape[1] != self.dimension:
            raise dimension_mismatch(self.dimension, q.shape[1], "sharded_hnsw")
        if self.count == 0 or k <= 0:
            return [[] for _ in range(q.shape[0])]
        self._ensure_built()
        qg = q
        if self.metric == Metric.COSINE:
            qg = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-30)
        ef = max(self.config.ef_search, 4 * k)
        kk = min(ef, len(self._ids))
        dist, ids = sharded_hnsw.sharded_hnsw_search(
            self.mesh, torch.from_numpy(qg), self._state, ef=ef, iters=-(-ef // 4), k=kk,
        )
        debug.check_search_output("ShardedHNSWIndex.batch_search", dist)
        ids = ids.cpu().numpy()
        okg = (ids != INVALID_ID) & (ids >= 0)
        safe = np.where(okg, ids, 0)
        gscore = np.where(okg, self._scores(q, self._stacked[safe]), np.inf)  # [B, kk]
        # the tail buffer: rows inserted since the bulk build, scanned
        # exactly and merged (they are in no graph, so no dedup)
        tail_rows = np.arange(self._built_rows, len(self._ids), dtype=np.int64)
        if tail_rows.size:
            tscore = self._scores(q, np.stack(self._vectors[self._built_rows:]))  # [B, T]
            cand_rows = np.concatenate(
                [safe, np.broadcast_to(tail_rows, (q.shape[0], tail_rows.size))], axis=1)
            cand_scores = np.concatenate([gscore, tscore], axis=1)
        else:
            cand_rows, cand_scores = safe, gscore

        out = []
        for b in range(q.shape[0]):
            row = []
            for j in np.argsort(cand_scores[b], kind="stable"):
                if not np.isfinite(cand_scores[b, j]):
                    break
                r = int(cand_rows[b, j])
                if r in self._dead:
                    continue
                ext = self._ids[r]
                if allow_set is not None and ext not in allow_set:
                    continue
                if deny_set is not None and ext in deny_set:
                    continue
                meta = self._metadata[r]
                if filter is not None and not filter(meta):
                    continue
                val = float(cand_scores[b, j])
                if self.metric != Metric.L2:
                    val = -val  # public IP/cosine scores are higher-better
                row.append(SearchResult(id=ext, score=val, metadata=meta))
                if len(row) == k:
                    break
            out.append(row)
        return out

    def search(self, query, k: int, filter: Optional[FilterFn] = None, *,
               allow_ids=None, deny_ids=None):
        return self.batch_search(
            np.asarray(query)[None, :], k, filter, allow_ids=allow_ids, deny_ids=deny_ids,
        )[0]

    def statistics(self) -> IndexStats:
        self._ensure_built()
        return IndexStats(
            count=self.count,
            dimension=self.dimension,
            metric=self.metric.value,
            memory_bytes=int(
                sum(v.nbytes for v in self._vectors)
                + (sum(t.numel() * 4 for t in self._state.nbrs) if self._state is not None else 0)
            ),
            details={
                "n_shards": self.n_shards,
                "mesh": str(self.mesh.shape),
                "m": self.config.m,
                "ef_search": self.config.ef_search,
            },
        )

    def compact(self) -> None:
        live = [
            (self._ids[r], self._vectors[r], self._metadata[r])
            for r in range(len(self._ids))
            if r not in self._dead
        ]
        self.__init__(self.dimension, self.metric, self.config,
                      devices=list(self.mesh.devices.flat))
        for ext, v, meta in live:
            self.insert(ext, v, meta)

    def save(self, path: str) -> None:
        """Live records, every HNSWConfig field and the shard count (the JAX
        package reads m, ef_construction, ef_search and seed, and ignores
        the others)."""
        records = [
            PersistedRecord(id=self._ids[r], vector=self._vectors[r], metadata=self._metadata[r])
            for r in range(len(self._ids))
            if r not in self._dead
        ]
        save_snapshot(path, PersistedIndex(
            type=self.TYPE, dimension=self.dimension, metric=self.metric.value,
            records=records, config={**asdict(self.config), "n_shards": self.n_shards},
        ))

    @classmethod
    def load(cls, path: str, device="cuda", devices=None) -> "ShardedHNSWIndex":
        """A missing config key reads as the JAX load reads it (its
        ef_construction default is 200 here). Without `devices`, a snapshot
        that names its shard count gets that many shards over `device`'s
        mesh, its devices repeated as needed; the graphs are built again at
        the first search."""
        snap = load_snapshot(path, expected_type=cls.TYPE)
        c = snap.config
        cfg = HNSWConfig(**{f.name: c.get(f.name, f.default) for f in fields(HNSWConfig)})
        if devices is None and "n_shards" in c:
            base = list(_mesh(None, device, None).devices.flat)
            devices = [base[i % len(base)] for i in range(int(c["n_shards"]))]
        idx = cls(snap.dimension, Metric(snap.metric), cfg, device=device, devices=devices)
        for r in snap.records:
            idx.insert(r.id, r.vector, r.metadata)
        return idx
