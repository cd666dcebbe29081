"""FlatIndex — exact brute-force search, the minimum end-to-end slice.

Counterpart of vectorindex_tpu.models.flat (parity targets: the reference's
FlatIndexOptimized.swift:20-420 and FlatIndex.swift).

  - Host numpy mirrors are the control plane: a power-of-two-capacity
    [cap, d] f32 array, a validity mask, metadata, an id map and a free
    list. The device tensors (`device`, default "cuda") are rebuilt lazily
    after a mutation.
  - Removal = tombstone in the validity mask + free-list slot reuse;
    compact() repacks (reference FlatIndexOptimized.swift:91-114).
  - Storage is torch.float32 or torch.bfloat16 on the device.
  - Search routing follows the JAX package's: at capacity >=
    LARGE_SCAN_THRESHOLD with L2/IP/cosine and k <= 2*C, the fused kernels
    K1+K2 (kernels/scan_fused), at any width; at that capacity otherwise
    (manhattan/chebyshev, larger k) the verified two-phase selection (ops/scan.scan_topk_verified), but only
    when the [B, capacity] block has VERIFIED_MIN_BLOCK elements (on a
    smaller block its fixed cost outweighs the sort it saves, and the
    strict path runs); the strict path (ops/scan.scan_topk_strict) re-runs
    the queries the fused pair or the verified scan cannot prove exact
    (K2's count; a tie at the c-th candidate). Below the threshold the
    strict path is the whole search. All give the exact top-k under the
    (score, id) contract. The fused pair runs in the design
    scan_fused.scan_design picks (the wgmma tensor-core kernel on bf16, the
    CUDA cores' FMA kernel on f32).
  - utils/debug.enable() checks the search's distances for NaN and -inf
    before the results are built.
  - With TELEM enabled, batch_search's spans tile the call (upload,
    score_flat, fetch, rerank for the strict fallback, results), CUDA
    events time K1, K2 and the strict fallback on the card (stage_ms
    dev.k1, dev.k2, dev.strict), and the call's QueryStats is recorded
    once every span has closed.
  - range_search is one distance block and a compaction
    (ops/range_query.range_scan).
  - save_container / load_container write and read the binary container
    (persistence/container_index); META keeps storage_dtype and capacity,
    and the persisted norm cache pre-warms the device mirror.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from vectorindex_tpu_torch.kernels import scan_fused
from vectorindex_tpu_torch.models.base import (
    FilterFn,
    IndexStats,
    Metadata,
    SearchResult,
    VectorID,
    VectorIndex,
)
from vectorindex_tpu_torch.ops.filtering import slot_mask_np
from vectorindex_tpu_torch.ops.idmap import IDMap
from vectorindex_tpu_torch.ops.range_query import range_scan
from vectorindex_tpu_torch.ops.scan import pad_queries, scan_topk_strict, scan_topk_verified
from vectorindex_tpu_torch.ops.topk import INVALID_ID
from vectorindex_tpu_torch.persistence.container_index import (
    load_flat_container,
    save_flat_container,
)
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
)
from vectorindex_tpu_torch.utils.telemetry import TELEM, QueryStats

MIN_CAPACITY = 1024

#: capacity from which batch_search takes the fused kernels (read at call
#: time, so tests can lower it)
LARGE_SCAN_THRESHOLD = 1 << 17

#: least B x capacity for which the verified scan replaces the strict path
#: past that capacity. Both score the same [B, capacity] block; the verified
#: scan trades the strict path's stable sort of it for torch.topk and a
#: fixed tail of small operations, which costs more than the sort on a
#: small block. On an H100 80GB HBM3 at 700 W the strict path was faster at
#: 2^20 and the verified scan at 2^22 and past, on bf16 131,072 x 8,192 L2
#: and f32 1,048,576 x 128 manhattan rows (scripts/ab_verified_scan_torch.py)
VERIFIED_MIN_BLOCK = 1 << 22

_FUSED_METRICS = (Metric.L2, Metric.INNER_PRODUCT, Metric.COSINE)
_STORAGE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length() if n > 2 else max(n, 2)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


class FlatIndex(VectorIndex):
    """Exact index over a contiguous device tensor."""

    TYPE = "flat"

    def __init__(
        self,
        dimension: int,
        metric: Metric = Metric.L2,
        capacity: int = MIN_CAPACITY,
        storage_dtype: torch.dtype = torch.float32,
        device="cuda",
    ):
        if dimension <= 0:
            raise (
                ErrorBuilder(IndexErrorKind.INVALID_CONFIGURATION)
                .message(f"dimension must be positive, got {dimension}")
                .build()
            )
        if storage_dtype not in _STORAGE_DTYPES.values():
            raise (
                ErrorBuilder(IndexErrorKind.INVALID_CONFIGURATION)
                .message(f"storage_dtype must be float32 or bfloat16, got {storage_dtype}")
                .build()
            )
        self.dimension = dimension
        self.metric = metric
        self.storage_dtype = storage_dtype
        self.device = torch.device(device)
        cap = _next_pow2(max(capacity, MIN_CAPACITY))
        # host mirrors (control plane)
        self._vectors = np.zeros((cap, dimension), dtype=np.float32)
        self._valid = np.zeros((cap,), dtype=bool)
        self._metadata: list[Metadata] = [None] * cap
        self._idmap = IDMap()
        self._free: list[int] = []
        self._next_slot = 0
        # device tensors (data plane), rebuilt lazily after mutation
        self._dev = None

    @classmethod
    def from_state(cls, state: dict, device="cuda") -> "FlatIndex":
        """Rebuild an index from another index's state as plain numpy/python
        values, so both search the same slots. Keys: vectors [cap, d],
        valid [cap], metadata (list), ids (iterable of (external, slot)),
        free (list), next_slot, dimension, metric (name or Metric), and
        storage_dtype ("float32" or "bfloat16")."""
        vectors = np.asarray(state["vectors"], dtype=np.float32)
        metric = state["metric"]
        idx = cls(
            int(state["dimension"]),
            Metric(getattr(metric, "value", metric)),
            capacity=vectors.shape[0],
            storage_dtype=_STORAGE_DTYPES[str(state["storage_dtype"])],
            device=device,
        )
        if idx.capacity != vectors.shape[0]:
            raise (
                ErrorBuilder(IndexErrorKind.INVALID_CONFIGURATION)
                .message(f"capacity {vectors.shape[0]} is not a power of two >= {MIN_CAPACITY}")
                .build()
            )
        idx._vectors = vectors.copy()
        idx._valid = np.asarray(state["valid"], dtype=bool).copy()
        idx._metadata = list(state["metadata"])
        for ext, slot in state["ids"]:
            idx._idmap.append(ext, int(slot))
        idx._free = [int(s) for s in state["free"]]
        idx._next_slot = int(state["next_slot"])
        return idx

    # ------------------------------------------------------------------
    # storage management
    # ------------------------------------------------------------------

    @property
    def capacity(self) -> int:
        return self._vectors.shape[0]

    @property
    def count(self) -> int:
        return len(self._idmap)

    def _alloc_slot(self) -> int:
        if self._free:
            return self._free.pop()
        if self._next_slot >= self.capacity:
            self._grow()
        slot = self._next_slot
        self._next_slot += 1
        return slot

    def _grow(self) -> None:
        old_cap = self.capacity
        new_cap = old_cap * 2
        self._vectors = np.vstack([self._vectors, np.zeros_like(self._vectors)])
        self._valid = np.concatenate([self._valid, np.zeros(old_cap, dtype=bool)])
        self._metadata.extend([None] * (new_cap - len(self._metadata)))
        self._dev = None

    def _check_vector(self, vector) -> np.ndarray:
        v = np.asarray(vector, dtype=np.float32).reshape(-1)
        if v.shape[0] != self.dimension:
            raise dimension_mismatch(self.dimension, v.shape[0], "insert")
        if not np.all(np.isfinite(v)):
            raise (
                ErrorBuilder(IndexErrorKind.INVALID_VECTOR)
                .message("vector contains non-finite values")
                .build()
            )
        return v

    def _sqnorms(self) -> np.ndarray:
        """||x||^2 [cap] f32 of the f32 host rows (the norm cache)."""
        return np.einsum("nd,nd->n", self._vectors, self._vectors, dtype=np.float32)

    def _sync_device(self, sqnorms: Optional[np.ndarray] = None):
        """(vectors [cap, d] storage dtype, ||x||^2 [cap] f32, 1/||x|| [cap]
        f32, valid [cap] bool) on the device. Norms come from the f32 host
        vectors, as in the JAX package, or from `sqnorms` [cap], a persisted
        norm cache of the same rows (load_flat_container pre-warms with it)."""
        if self._dev is None:
            # copy=True: on the CPU the tensors must not alias the host mirrors
            vecs = torch.from_numpy(self._vectors).to(
                self.device, self.storage_dtype, copy=True
            )
            sqn = torch.from_numpy(
                self._sqnorms() if sqnorms is None else sqnorms
            ).to(self.device)
            inv = torch.where(
                sqn > 0, torch.rsqrt(torch.clamp_min(sqn, 1e-30)), 0.0
            )
            valid = torch.from_numpy(self._valid).to(self.device, copy=True)
            self._dev = (vecs, sqn, inv, valid)
        return self._dev

    # ------------------------------------------------------------------
    # CRUD
    # ------------------------------------------------------------------

    def insert(self, id: VectorID, vector, metadata: Metadata = None) -> None:
        if id in self._idmap:
            raise duplicate_id(id, "insert")
        v = self._check_vector(vector)
        slot = self._alloc_slot()
        self._vectors[slot] = v
        self._valid[slot] = True
        self._metadata[slot] = metadata
        self._idmap.append(id, slot)
        self._dev = None

    def insert_batch(
        self,
        ids: Sequence[VectorID],
        vectors,
        metadatas: Optional[Sequence[Metadata]] = None,
    ) -> None:
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self.dimension:
            raise dimension_mismatch(
                self.dimension, vectors.shape[-1], "insert_batch"
            )
        if len(ids) != vectors.shape[0]:
            raise (
                ErrorBuilder(IndexErrorKind.INVALID_ARGUMENT)
                .message("ids and vectors length mismatch")
                .build()
            )
        for id_ in ids:
            if id_ in self._idmap:
                raise duplicate_id(id_, "insert_batch")
        if not np.all(np.isfinite(vectors)):
            raise (
                ErrorBuilder(IndexErrorKind.INVALID_VECTOR)
                .message("batch contains non-finite values")
                .build()
            )
        n = vectors.shape[0]
        while self._next_slot + n > self.capacity and not self._free:
            self._grow()
        slots = np.fromiter(
            (self._alloc_slot() for _ in range(n)), dtype=np.int64, count=n
        )
        self._vectors[slots] = vectors
        self._valid[slots] = True
        for i, id_ in enumerate(ids):
            slot = int(slots[i])
            self._metadata[slot] = None if metadatas is None else metadatas[i]
            self._idmap.append(id_, slot)
        self._dev = None

    def remove(self, id: VectorID) -> None:
        slot = self._idmap.erase(id)
        self._valid[slot] = False
        self._metadata[slot] = None
        self._free.append(slot)
        self._dev = None

    def update(self, id: VectorID, vector=None, metadata: Metadata = None) -> None:
        slot = self._idmap.lookup(id)
        if vector is not None:
            self._vectors[slot] = self._check_vector(vector)
            self._dev = None
        if metadata is not None:
            self._metadata[slot] = metadata

    def contains(self, id: VectorID) -> bool:
        return id in self._idmap

    def get(self, id: VectorID):
        slot = self._idmap.lookup(id)
        return self._vectors[slot].copy(), self._metadata[slot]

    # ------------------------------------------------------------------
    # search
    # ------------------------------------------------------------------

    def _public_score(self, dist: np.ndarray) -> np.ndarray:
        """Internal ascending distance → public metric score. L2 gets the
        sqrt at the API boundary (reference HNSWIndex.swift:158)."""
        if self.metric == Metric.L2:
            return np.sqrt(np.maximum(dist, 0.0))
        if self.metric == Metric.INNER_PRODUCT:
            return -dist
        if self.metric == Metric.COSINE:
            return 1.0 - dist
        return dist

    def _filter_valid(
        self,
        filter: Optional[FilterFn],
        allow_ids=None,
        deny_ids=None,
    ) -> np.ndarray:
        idm = slot_mask_np(self.capacity, self._idmap, allow_ids, deny_ids)
        if filter is None and idm is None:
            return self._valid
        mask = self._valid.copy() if idm is None else (self._valid & idm)
        if filter is not None:
            for slot in np.nonzero(mask)[0]:
                if not filter(self._metadata[slot]):
                    mask[slot] = False
        return mask

    def batch_search(
        self,
        queries,
        k: int,
        filter: Optional[FilterFn] = None,
        *,
        allow_ids=None,
        deny_ids=None,
    ) -> list[list[SearchResult]]:
        """allow_ids / deny_ids: external-id set filters fused into the scan
        mask before top-k (reference IDFilter.swift:104) — exact k results
        under arbitrarily selective filters."""
        q = np.ascontiguousarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.shape[1] != self.dimension:
            raise dimension_mismatch(self.dimension, q.shape[1], "search")
        if self.count == 0 or k <= 0:
            return [[] for _ in range(q.shape[0])]
        vecs, sqn, inv, all_valid = self._sync_device()
        filtered = filter is not None or allow_ids is not None or deny_ids is not None
        if filtered:
            vmask = self._filter_valid(filter, allow_ids, deny_ids)
            valid = torch.from_numpy(vmask).to(self.device)
        elif self._free or self._next_slot < self.capacity:
            valid = all_valid
        else:
            valid = None  # every slot live: no mask op
        kk = min(k, self.capacity)
        stats = QueryStats(batch=q.shape[0], rows_scored=q.shape[0] * self.count)
        large = self.capacity >= LARGE_SCAN_THRESHOLD
        fused = large and self.metric in _FUSED_METRICS and kk <= 2 * scan_fused.C
        exact = None
        # the spans tile the call: upload, score_flat, fetch, rerank (the
        # strict fallback), results; the call record reads the device spans
        # once the host copies have waited for them
        with TELEM.call(stats):
            with TELEM.timer("upload", stats):
                qt = torch.from_numpy(q).to(self.device)
            with TELEM.timer("score_flat", stats):
                if fused:
                    # capacity is a power of two >= MIN_CAPACITY, so a multiple
                    # of C: the kernels take the device tensors unpadded
                    dist, ids, exact = scan_fused.scan_topk_fused(
                        qt, vecs, sqn, all_valid if valid is None else valid,
                        metric=self.metric, k=kk,
                    )
                    kernel = "scan_fused"
                elif large and q.shape[0] * self.capacity >= VERIFIED_MIN_BLOCK:
                    dist, ids, exact = scan_topk_verified(
                        qt, vecs, sqn, inv, valid, metric=self.metric, k=kk
                    )
                    kernel = "scan_verified"
                else:
                    dist, ids = scan_topk_strict(
                        qt, vecs, sqn, inv, valid, metric=self.metric, k=kk
                    )
                    kernel = "scan_strict"
                if exact is not None:
                    exact = exact.cpu().numpy()
            with TELEM.timer("fetch", stats):
                dist = dist.cpu().numpy()
                ids = ids.cpu().numpy()
            if exact is not None and not exact.all():
                # rerun only the queries the fused count or the verified tie
                # check could not prove exact through the always-exact strict
                # path and splice the results
                flagged = np.nonzero(~exact)[0]
                TELEM.inc("flat.verify_fallback", len(flagged))
                stats.flags.add("verify_fallback")
                with TELEM.timer("rerank", stats):
                    with TELEM.device_span("strict", qt):
                        qf, nf = pad_queries(qt[torch.from_numpy(flagged).to(self.device)])
                        fd, fi = scan_topk_strict(
                            qf, vecs, sqn, inv, valid, metric=self.metric, k=kk
                        )
                    dist[flagged] = fd[:nf].cpu().numpy()
                    ids[flagged] = fi[:nf].cpu().numpy()
                TELEM.record_kernel("scan_strict", rows=nf * self.count)
            stats.flags.add("dot_trick")
            stats.bytes_read["vecs"] = self.count * self.dimension * vecs.element_size()
            TELEM.add_bytes("vecs", stats.bytes_read["vecs"])
            # per-kernel sink (reference L2SqrKernel.swift:46-57 recorder),
            # naming the path that ran
            TELEM.record_kernel(
                kernel, rows=stats.rows_scored, bytes=stats.bytes_read["vecs"]
            )
            debug.check_search_output("FlatIndex.batch_search", dist)
            with TELEM.timer("results", stats):
                out = self._results(dist, ids, k)
        TELEM.record_query(stats)
        return out

    def _results(self, dist: np.ndarray, ids: np.ndarray, k: int):
        scores = self._public_score(dist)
        out: list[list[SearchResult]] = []
        for b in range(dist.shape[0]):
            row: list[SearchResult] = []
            for j in range(min(k, dist.shape[1])):
                slot = int(ids[b, j])
                if slot == INVALID_ID or not np.isfinite(dist[b, j]):
                    break
                row.append(
                    SearchResult(
                        id=self._idmap.external_for(slot),
                        score=float(scores[b, j]),
                        metadata=self._metadata[slot],
                    )
                )
            out.append(row)
        return out

    def search(
        self,
        query,
        k: int,
        filter: Optional[FilterFn] = None,
        *,
        allow_ids=None,
        deny_ids=None,
    ) -> list[SearchResult]:
        return self.batch_search(
            np.asarray(query)[None, :], k, filter,
            allow_ids=allow_ids, deny_ids=deny_ids,
        )[0]

    def range_search(
        self,
        query,
        radius: float,
        max_results: int = 128,
        filter: Optional[FilterFn] = None,
    ) -> list[SearchResult]:
        """Threshold query: all vectors within `radius` (L2 distance) or
        with score ≥ radius (IP/cosine), nearest-first, capped at
        max_results (reference rangeScanBlock compacted mode;
        ops/range_query.range_scan)."""
        q = np.asarray(query, dtype=np.float32)[None, :]
        if q.shape[1] != self.dimension:
            raise dimension_mismatch(self.dimension, q.shape[1], "range_search")
        if self.count == 0:
            return []
        vecs, sqn, inv, valid = self._sync_device()
        if filter is not None:
            valid = torch.from_numpy(self._filter_valid(filter)).to(self.device)
        res = range_scan(
            torch.from_numpy(q).to(self.device), vecs, radius, metric=self.metric,
            max_results=min(max_results, self.capacity), valid=valid,
            x_sqnorms=sqn, x_invnorms=inv,
        )
        return self._results(res.dists.cpu().numpy(), res.ids.cpu().numpy(), max_results)[0]

    # ------------------------------------------------------------------
    # maintenance
    # ------------------------------------------------------------------

    def compact(self) -> None:
        """Repack valid slots to the front (reference
        FlatIndexOptimized.swift:91-114)."""
        order = np.nonzero(self._valid)[0]
        remap = {int(old): new for new, old in enumerate(order)}
        self._vectors[: len(order)] = self._vectors[order]
        self._vectors[len(order) :] = 0.0
        new_meta: list[Metadata] = [None] * self.capacity
        for old, new in remap.items():
            new_meta[new] = self._metadata[old]
        self._metadata = new_meta
        self._valid[:] = False
        self._valid[: len(order)] = True
        self._idmap.remap_internal(remap)
        self._idmap.clear_tombstones()
        self._free = []
        self._next_slot = len(order)
        self._dev = None

    def statistics(self) -> IndexStats:
        mem = self._vectors.nbytes + self._valid.nbytes
        return IndexStats(
            count=self.count,
            dimension=self.dimension,
            metric=self.metric.value,
            memory_bytes=mem,
            details={
                "capacity": self.capacity,
                "free_slots": len(self._free),
                "storage_dtype": _dtype_name(self.storage_dtype),
            },
        )

    # ------------------------------------------------------------------
    # persistence: the binary container (CRC'd mmap sections,
    # persistence/container_index) and the JSON tier (reference
    # Persistence.swift)
    # ------------------------------------------------------------------

    def save_container(self, path: str) -> None:
        """Binary-container tier: the f32 rows, validity, the norm cache,
        the id map and metadata as sections; META keeps storage_dtype and
        capacity, so a load searches exactly as this index does."""
        save_flat_container(self, path)

    @classmethod
    def load_container(cls, path: str, device="cuda") -> "FlatIndex":
        """Load a container written by save_container (either package's);
        the device mirror is pre-warmed from the persisted norm cache."""
        return load_flat_container(path, device=device)

    def save(self, path: str) -> None:
        records = [
            PersistedRecord(
                id=ext,
                vector=self._vectors[slot],
                metadata=self._metadata[slot],
            )
            for ext, slot in sorted(self._idmap.items(), key=lambda kv: kv[1])
        ]
        save_snapshot(
            path,
            PersistedIndex(
                type=self.TYPE,
                dimension=self.dimension,
                metric=self.metric.value,
                records=records,
            ),
        )

    @classmethod
    def load(cls, path: str, device="cuda") -> "FlatIndex":
        snap = load_snapshot(path, expected_type=cls.TYPE)
        idx = cls(
            snap.dimension,
            Metric(snap.metric),
            capacity=max(len(snap.records), MIN_CAPACITY),
            device=device,
        )
        if snap.records:
            idx.insert_batch(
                [r.id for r in snap.records],
                np.stack([r.vector for r in snap.records]),
                [r.metadata for r in snap.records],
            )
        return idx
