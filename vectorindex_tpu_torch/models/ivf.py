"""IVFIndex — inverted-file index with a k-means coarse quantizer (IVF-Flat).

Counterpart of vectorindex_tpu.models.ivf (parity targets: the reference's
IVFIndex.swift — nlist/nprobe :15-22, optimize() :265-284 and :311-364,
kernel-30 search :862-985, JSON save/load re-running optimize() :657-665,
statistics :612-628).

  - Host numpy mirrors are the control plane (vectors by slot, metadata, id
    map, free slots); the lists live in ops/ivf.IVFListStore, whose device
    tensors sit on `device` (default "cuda").
  - optimize() trains ops/kmeans (Lloyd, seeded from (config.seed, 0)) on
    the device and assigns every row to its nearest centroid.
  - A trained index searches through kernels/ivf_probe.ivf_search_flat_probe:
    on a CUDA index the kernels K3/K4/K5, on a CPU index their plain
    versions. bf16 storage hands it an f32 rerank source in CSR row order.
    An untrained index scans every row exactly (ops/scan.scan_topk_strict).

IVFPQIndex adds residual product quantization on top (IVF-PQ): the lists
hold PQ codes of the residuals x − c_list beside the vectors, and a trained
index searches through kernels/adc_probe.ivf_search_pq_probe (K9/K10 on a
CUDA index, their plain versions on a CPU index) with the exact f32 rerank
of the ADC top-C from the device-resident vectors. With
IVFPQConfig(host_rerank=True) (the host-memory tier) the device holds the
codes and CSR metadata only: kernels/adc_probe.ivf_search_pq_hostrerank
brings the top-C candidates' CSR rows to the host and reranks them from the
store's packed host mirror; `serve_session` and `batch_search_stream` serve
it through models/serve.HostRerankSession.

Durable mode (enable_durable / checkpoint / close_durable / load_durable,
persistence/durable): the index writes a checkpoint container and journals
every later insert, remove and update through the container's WAL, at the
points where the JAX index does; load_durable rebuilds the lists in bulk and
replays the journal.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from vectorindex_tpu_torch.kernels.adc_probe import (
    candidate_count,
    ivf_search_pq_hostrerank,
    ivf_search_pq_probe,
)
from vectorindex_tpu_torch.kernels.ivf_probe import ivf_search_flat_probe
from vectorindex_tpu_torch.models.base import (
    FilterFn,
    IndexStats,
    Metadata,
    SearchResult,
    VectorID,
    VectorIndex,
)
from vectorindex_tpu_torch.models.serve import HostRerankSession
from vectorindex_tpu_torch.ops import kmeans as km
from vectorindex_tpu_torch.ops import pq as pq_ops
from vectorindex_tpu_torch.ops import rng as vrng
from vectorindex_tpu_torch.ops.dtypes import pack_u4
from vectorindex_tpu_torch.ops.filtering import slot_mask_np
from vectorindex_tpu_torch.ops.idmap import IDMap
from vectorindex_tpu_torch.ops.rerank import ArrayReader
from vectorindex_tpu_torch.ops.ivf import IVFListStore, nearest_two, probe_cap_for
from vectorindex_tpu_torch.ops.scan import scan_topk_strict
from vectorindex_tpu_torch.ops.topk import INVALID_ID
from vectorindex_tpu_torch.persistence import durable
from vectorindex_tpu_torch.persistence.container import Container
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

_STORAGE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class IVFConfig:
    """Reference IVFIndex.Configuration (IVFIndex.swift:15-22)."""

    nlist: int = 64
    nprobe: int = 8
    train_iters: int = 20  # reference maxIterations 20 (:311)
    seed: int = 42  # reference k-means seed 42 (:367)


class IVFIndex(VectorIndex):
    TYPE = "ivf"
    _ALLOWED_METRICS = (Metric.L2, Metric.INNER_PRODUCT, Metric.COSINE)
    _CONFIG = IVFConfig

    def __init__(
        self,
        dimension: int,
        metric: Metric = Metric.L2,
        config: IVFConfig = IVFConfig(),
        storage_dtype: torch.dtype = torch.float32,
        device="cuda",
    ):
        if metric not in self._ALLOWED_METRICS:
            allowed = "/".join(m.value for m in self._ALLOWED_METRICS)
            raise (
                ErrorBuilder(IndexErrorKind.UNSUPPORTED_METRIC)
                .message(f"{type(self).__name__} supports {allowed}, got {metric.value}")
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
        self.config = config
        self.storage_dtype = storage_dtype
        self.device = torch.device(device)
        # host control plane
        self._vectors: dict[int, np.ndarray] = {}  # slot -> vector
        self._metadata: dict[int, Metadata] = {}
        self._idmap = IDMap()
        self._next_slot = 0
        self._free: list[int] = []
        # quantizer + lists
        self._centroids: Optional[np.ndarray] = None
        self._centroids_dev: Optional[torch.Tensor] = None
        self._store = IVFListStore(config.nlist, dimension, device=self.device)
        self._slot_list: dict[int, int] = {}  # slot -> list id
        self._rerank_f32_cache = None
        # durable mode: the open container whose WAL journals each mutation
        self._durable: Optional[Container] = None
        self._durable_path: Optional[str] = None

    @classmethod
    def from_state(cls, state: dict, device="cuda") -> "IVFIndex":
        """Rebuild an index from another index's state as plain numpy/python
        values, so both hold the same lists in the same order and search
        the same rows. Keys: dimension, metric (name or Metric), config
        (dict of the config's fields), storage_dtype ("float32" or
        "bfloat16"), vectors {slot: vector}, metadata {slot: metadata},
        ids (iterable of (external, slot)), free (list), next_slot,
        centroids ([nlist, d] or None), lists (per list, its slots in
        order; ignored when centroids is None)."""
        metric = state["metric"]
        idx = cls(
            int(state["dimension"]),
            Metric(getattr(metric, "value", metric)),
            cls._CONFIG(**dict(state["config"])),
            storage_dtype=_STORAGE_DTYPES[str(state["storage_dtype"])],
            device=device,
        )
        idx._vectors = {
            int(s): np.array(v, dtype=np.float32) for s, v in state["vectors"].items()
        }
        idx._metadata = {int(s): m for s, m in state["metadata"].items()}
        for ext, slot in state["ids"]:
            idx._idmap.append(ext, int(slot))
        idx._free = [int(s) for s in state["free"]]
        idx._next_slot = int(state["next_slot"])
        if state.get("centroids") is not None:
            idx._set_centroids(np.asarray(state["centroids"], dtype=np.float32))
            for lst, slots in enumerate(state["lists"]):
                slots = [int(s) for s in slots]
                if slots:
                    vecs = np.stack([idx._vectors[s] for s in slots])
                    idx._store.append_batch([lst] * len(slots), slots, vecs)
                for s in slots:
                    idx._slot_list[s] = lst
        return idx

    # ------------------------------------------------------------------

    @property
    def count(self) -> int:
        return len(self._idmap)

    @property
    def trained(self) -> bool:
        return self._centroids is not None

    def _set_centroids(self, centroids: np.ndarray) -> None:
        self._centroids = np.array(centroids, dtype=np.float32)
        self._centroids_dev = torch.from_numpy(self._centroids).to(self.device, copy=True)

    def _alloc(self) -> int:
        if self._free:
            return self._free.pop()
        s = self._next_slot
        self._next_slot += 1
        return s

    def _check(self, vector) -> np.ndarray:
        v = np.asarray(vector, dtype=np.float32).reshape(-1)
        if v.shape[0] != self.dimension:
            raise dimension_mismatch(self.dimension, v.shape[0], "ivf.insert")
        if not np.all(np.isfinite(v)):
            raise (
                ErrorBuilder(IndexErrorKind.INVALID_VECTOR)
                .message("vector contains non-finite values")
                .build()
            )
        return v

    def _assign_lists(self, vecs: np.ndarray) -> np.ndarray:
        assign, _ = km.assign_clusters_chunked(
            torch.from_numpy(np.ascontiguousarray(vecs)).to(self.device), self._centroids_dev
        )
        return assign.cpu().numpy()

    def _sync_rerank_f32(self) -> torch.Tensor:
        """f32 CSR-ordered rerank source for bf16 scan storage (cached per
        store version; the store's packed host vectors are f32 in CSR row
        order)."""
        key = (self._store.version, self._store.layout_version)
        if self._rerank_f32_cache is not None and self._rerank_f32_cache[0] == key:
            return self._rerank_f32_cache[1]
        self._store.sync_device(self.storage_dtype)  # ensure packed
        src = torch.from_numpy(self._store._packed["vecs"]).to(self.device, copy=True)
        self._rerank_f32_cache = (key, src)
        return src

    # ------------------------------------------------------------------
    # CRUD
    # ------------------------------------------------------------------

    def insert(self, id: VectorID, vector, metadata: Metadata = None) -> None:
        if id in self._idmap:
            raise duplicate_id(id, "ivf.insert")
        v = self._check(vector)
        slot = self._alloc()
        self._vectors[slot] = v
        self._metadata[slot] = metadata
        self._idmap.append(id, slot)
        lst = -1
        if self.trained:
            lst = int(self._assign_lists(v[None, :])[0])
            self._store.append(lst, slot, v)
            self._slot_list[slot] = lst
        self._journal(durable.REC_INSERT, slot, lst, v, id, metadata)

    def _journal(self, kind: int, slot: int, lst: int, vec, ext_id, metadata=None) -> None:
        """Append one mutation record to the durable journal (no-op unless
        enable_durable is on)."""
        if self._durable is not None:
            durable.append_journal(self._durable, kind, slot, lst, vec, ext_id=ext_id,
                                   metadata=metadata)

    def insert_batch(self, ids, vectors, metadatas=None) -> None:
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self.dimension:
            raise dimension_mismatch(self.dimension, vectors.shape[-1], "ivf.insert_batch")
        for id_ in ids:
            if id_ in self._idmap:
                raise duplicate_id(id_, "ivf.insert_batch")
        slots = []
        for i, id_ in enumerate(ids):
            slot = self._alloc()
            self._vectors[slot] = vectors[i]
            self._metadata[slot] = None if metadatas is None else metadatas[i]
            self._idmap.append(id_, slot)
            slots.append(slot)
        lists = None
        if self.trained:
            lists = self._assign_lists(vectors)
            self._store.append_batch(lists, slots, vectors)
            for s, l in zip(slots, lists):
                self._slot_list[s] = int(l)
        if self._durable is not None:
            for i, (id_, s) in enumerate(zip(ids, slots)):
                self._journal(durable.REC_INSERT, s, -1 if lists is None else int(lists[i]),
                              vectors[i], id_, None if metadatas is None else metadatas[i])

    def remove(self, id: VectorID) -> None:
        slot = self._idmap.erase(id)
        self._vectors.pop(slot, None)
        self._metadata.pop(slot, None)
        self._free.append(slot)
        lst = self._slot_list.pop(slot, None)
        if lst is not None:
            self._store.remove(lst, slot)
        self._journal(durable.REC_REMOVE, slot, -1 if lst is None else lst, None, id)

    def update(self, id: VectorID, vector=None, metadata: Metadata = None) -> None:
        slot = self._idmap.lookup(id)
        if vector is not None:
            v = self._check(vector)
            self._vectors[slot] = v
            old = self._slot_list.pop(slot, None)
            if old is not None:
                self._store.remove(old, slot)
            lst = -1
            if self.trained:
                lst = int(self._assign_lists(v[None, :])[0])
                self._store.append(lst, slot, v)
                self._slot_list[slot] = lst
            self._journal(durable.REC_UPDATE, slot, lst, v, id, metadata)
        if metadata is not None:
            self._metadata[slot] = metadata
            if vector is None:
                self._journal(durable.REC_META, slot, -1, None, id, metadata)

    def contains(self, id: VectorID) -> bool:
        return id in self._idmap

    def ingest_flat(self, ids, vectors, assignments) -> None:
        """Bulk-ingest vectors with precomputed list assignments, bypassing
        the quantizer (reference ingestFlat, IVFIndex.swift:180)."""
        vectors = np.asarray(vectors, dtype=np.float32)
        assignments = np.asarray(assignments, dtype=np.int64)
        if vectors.ndim != 2 or vectors.shape[1] != self.dimension:
            raise dimension_mismatch(self.dimension, vectors.shape[-1], "ingest_flat")
        if assignments.min(initial=0) < 0 or assignments.max(initial=0) >= self.config.nlist:
            raise (
                ErrorBuilder(IndexErrorKind.OUT_OF_RANGE)
                .message("assignment outside [0, nlist)")
                .build()
            )
        for id_ in ids:
            if id_ in self._idmap:
                raise duplicate_id(id_, "ingest_flat")
        slots = []
        for i, id_ in enumerate(ids):
            slot = self._alloc()
            self._vectors[slot] = vectors[i]
            self._metadata[slot] = None
            self._idmap.append(id_, slot)
            slots.append(slot)
        self._store.append_batch(assignments, slots, vectors)
        for s, l in zip(slots, assignments):
            self._slot_list[s] = int(l)

    # ------------------------------------------------------------------
    # training (reference optimize(), IVFIndex.swift:265)
    # ------------------------------------------------------------------

    def _stacked(self) -> tuple[list[int], np.ndarray]:
        slots = sorted(self._vectors.keys())
        return slots, np.stack([self._vectors[s] for s in slots])

    def _reassign(self, slots: list[int], x: np.ndarray, assigns: np.ndarray) -> None:
        self._store.clear()
        self._store.append_batch(assigns, slots, x)
        self._slot_list = {s: int(l) for s, l in zip(slots, assigns)}

    def optimize(self) -> None:
        if self.count == 0:
            return
        slots, x = self._stacked()
        cfg = km.KMeansConfig(
            k=self.config.nlist, iters=self.config.train_iters, algo="lloyd",
            seed=self.config.seed,
        )
        res = km.kmeans(torch.from_numpy(x).to(self.device), cfg)
        self._set_centroids(res.centroids.cpu().numpy())
        self._reassign(slots, x, res.assignments.cpu().numpy())

    def refresh_quantizer(
        self, iters: int = 5, sample: int = 262144, chunk: int = km.ASSIGN_CHUNK
    ) -> dict:
        """Warm-start quantizer adaptation after distribution shift: a few
        minibatch k-means iterations seeded from the current centroids over
        a sample of live rows, then a full reassignment + repack. Returns
        {'moved_frac', 'seconds'}; a no-op when untrained or empty."""
        import time

        if not self.trained or self.count == 0:
            return {"moved_frac": 0.0, "seconds": 0.0}
        t0 = time.perf_counter()
        slots, x = self._stacked()
        xs = x
        if x.shape[0] > sample:
            rng = np.random.default_rng(self.config.seed ^ 0x5EED)
            xs = x[rng.choice(x.shape[0], sample, replace=False)]
        res = km.kmeans(
            torch.from_numpy(xs).to(self.device),
            km.KMeansConfig(
                k=self.config.nlist, iters=iters, algo="minibatch",
                batch_size=min(65536, xs.shape[0]), seed=self.config.seed,
            ),
            init=self._centroids_dev,
        )
        self._set_centroids(res.centroids.cpu().numpy())
        assign, _ = km.assign_clusters_chunked(
            torch.from_numpy(x).to(self.device), self._centroids_dev, chunk=chunk
        )
        assigns = assign.cpu().numpy().astype(np.int64)
        moved = sum(1 for s_, l_ in zip(slots, assigns) if self._slot_list.get(s_) != l_)
        self._reassign(slots, x, assigns)
        return {"moved_frac": moved / max(len(slots), 1), "seconds": time.perf_counter() - t0}

    # ------------------------------------------------------------------
    # search
    # ------------------------------------------------------------------

    def _public_score(self, dist: np.ndarray) -> np.ndarray:
        if self.metric == Metric.L2:
            return np.sqrt(np.maximum(dist, 0.0))
        if self.metric == Metric.INNER_PRODUCT:
            return -dist
        return 1.0 - dist

    def _row_allow_mask(self, allow_ids, deny_ids) -> Optional[torch.Tensor]:
        """[N_pad] bool allow mask in CSR row order from external-id sets
        (None when no id filter was requested), applied by the probed search
        before candidate selection (reference IDFilter.swift:104)."""
        smask = slot_mask_np(max(self._next_slot, 1), self._idmap, allow_ids, deny_ids)
        if smask is None:
            return None
        # the packed layout only: a sync would put the host-rerank tier's
        # vectors on the device
        rid = self._store.packed()["row_ids"]
        ra = np.zeros(rid.shape[0], dtype=bool)
        live = rid >= 0
        ra[live] = smask[rid[live]]
        return torch.from_numpy(ra).to(self.device)

    def batch_search(
        self,
        queries,
        k: int,
        filter: Optional[FilterFn] = None,
        *,
        allow_ids=None,
        deny_ids=None,
        disabled_lists=None,
    ) -> list[list[SearchResult]]:
        """allow_ids / deny_ids: external-id sets masked into the probed
        distances before top-k (k results survive selective filters).
        disabled_lists: list ids excluded from coarse routing (reference
        IVFSelectOpts.disabledLists, IVFSelect.swift:16-56)."""
        q = np.ascontiguousarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.shape[1] != self.dimension:
            raise dimension_mismatch(self.dimension, q.shape[1], "ivf.search")
        if self.count == 0 or k <= 0 or q.shape[0] == 0:
            return [[] for _ in range(q.shape[0])]
        # oversample when a host-side metadata filter will drop hits
        kk = min(k if filter is None else max(4 * k, k + 32), self.count)
        qt = torch.from_numpy(q).to(self.device)
        if not self.trained:
            # untrained: exact scan over every record
            slots, x = self._stacked()
            vmask = np.ones((len(slots),), bool)
            smask = slot_mask_np(max(self._next_slot, 1), self._idmap, allow_ids, deny_ids)
            if smask is not None:
                vmask = smask[np.asarray(slots, dtype=np.int64)]
            dist, idx = scan_topk_strict(
                qt, torch.from_numpy(x).to(self.device), None, None,
                torch.from_numpy(vmask).to(self.device), metric=self.metric,
                k=min(kk, len(slots)),
            )
            idx = idx.cpu().numpy()
            slots_arr = np.asarray(slots, dtype=np.int64)
            ok = (idx != INVALID_ID) & (idx >= 0) & (idx < len(slots))
            ids = np.where(ok, slots_arr[np.where(ok, idx, 0)], INVALID_ID)
            dist = dist.cpu().numpy()
        else:
            disabled = None
            if disabled_lists is not None:
                dm = np.zeros((self.config.nlist,), dtype=bool)
                dm[np.asarray(list(disabled_lists), dtype=np.int64)] = True
                disabled = torch.from_numpy(dm).to(self.device)
            arrays = self._store.sync_device(self.storage_dtype)
            cap = probe_cap_for(self._store.max_length)
            nprobe = min(self.config.nprobe, self.config.nlist)
            row_allow = self._row_allow_mask(allow_ids, deny_ids)
            # bf16 storage: the exact rerank reads an f32 CSR-ordered copy
            rerank_src = None if self.storage_dtype == torch.float32 else self._sync_rerank_f32()
            stats = QueryStats(
                batch=q.shape[0], lists_routed=q.shape[0] * nprobe,
                rows_scored=q.shape[0] * nprobe * cap,
            )
            with TELEM.timer("score_flat", stats):  # select fused in the search
                dist, ids = ivf_search_flat_probe(
                    qt, self._centroids_dev, arrays, rerank_src, row_allow, disabled,
                    nprobe=nprobe, probe_cap=cap, k=min(kk, max(self.count, 1)),
                    metric=self.metric,
                )
                dist, ids = dist.cpu().numpy(), ids.cpu().numpy()
            TELEM.record_kernel("ivf_probe", rows=stats.rows_scored)
            TELEM.record_query(stats)
        debug.check_search_output("IVFIndex.batch_search", dist)

        scores = self._public_score(dist)
        out: list[list[SearchResult]] = []
        for b in range(q.shape[0]):
            row: list[SearchResult] = []
            for j in range(ids.shape[1]):
                slot = int(ids[b, j])
                if slot == INVALID_ID or not np.isfinite(dist[b, j]):
                    break
                meta = self._metadata.get(slot)
                if filter is not None and not filter(meta):
                    continue
                row.append(SearchResult(
                    id=self._idmap.external_for(slot), score=float(scores[b, j]), metadata=meta,
                ))
                if len(row) == k:
                    break
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
        disabled_lists=None,
    ):
        return self.batch_search(
            np.asarray(query)[None, :], k, filter,
            allow_ids=allow_ids, deny_ids=deny_ids, disabled_lists=disabled_lists,
        )[0]

    # ------------------------------------------------------------------

    def statistics(self) -> IndexStats:
        st = self._store.list_stats()
        mem = sum(v.nbytes for v in self._vectors.values())
        return IndexStats(
            count=self.count,
            dimension=self.dimension,
            metric=self.metric.value,
            memory_bytes=mem,
            details={
                "nlist": self.config.nlist,
                "nprobe": self.config.nprobe,
                "trained": self.trained,
                "assigned": st["total"],
                "max_list_len": st["max_len"],
                "empty_lists": st["empty_lists"],
            },
        )

    def save(self, path: str) -> None:
        records = [
            PersistedRecord(id=ext, vector=self._vectors[slot], metadata=self._metadata.get(slot))
            for ext, slot in sorted(self._idmap.items(), key=lambda kv: kv[1])
        ]
        save_snapshot(
            path,
            PersistedIndex(
                type=self.TYPE,
                dimension=self.dimension,
                metric=self.metric.value,
                records=records,
                # the config's fields in order: the JAX package's keys (and
                # order), so the files are byte-compatible both ways
                config=dataclasses.asdict(self.config),
            ),
        )

    @classmethod
    def load(cls, path: str, device="cuda") -> "IVFIndex":
        """Load records and re-run optimize() (reference contract,
        IVFIndex.swift:657-665)."""
        snap = load_snapshot(path, expected_type=cls.TYPE)
        # a missing key takes the field's default (the JAX package's too)
        cfg = cls._CONFIG(**{
            f.name: snap.config.get(f.name, f.default) for f in dataclasses.fields(cls._CONFIG)
        })
        idx = cls(snap.dimension, Metric(snap.metric), cfg, device=device)
        if snap.records:
            idx.insert_batch(
                [r.id for r in snap.records],
                np.stack([r.vector for r in snap.records]),
                [r.metadata for r in snap.records],
            )
            idx.optimize()
        return idx

    # ------------------------------------------------------------------
    # durable binary container (reference enableKernel30Storage,
    # IVFIndex.swift:103-144; canonical format SURVEY.md §5.4)
    # ------------------------------------------------------------------

    def enable_durable(self, path: str) -> None:
        """Write a checkpoint container at `path` and journal every later
        mutation through its WAL (crash-consistent). The WAL holds about
        65k journaled mutations (durable.JOURNAL_CAPACITY); checkpoint()
        empties it, and an append past it raises."""
        self.close_durable()
        durable.save_ivf_container(self, path)
        self._durable = Container.open(path, writable=True)
        self._durable_path = path

    def checkpoint(self) -> None:
        """Rewrite the container from the current state, with an empty
        journal; the generation goes up by one."""
        if self._durable is None:
            return
        gen = self._durable.generation
        self._durable.close()
        self._durable = None
        durable.save_ivf_checkpoint(self, self._durable_path)
        self._durable = Container.open(self._durable_path, writable=True)
        for _ in range(gen):
            self._durable.bump_generation()

    def close_durable(self) -> None:
        if self._durable is not None:
            self._durable.close()
            self._durable = None

    @classmethod
    def load_durable(cls, path: str, device="cuda") -> "IVFIndex":
        """Restore from a container: the checkpoint, the WAL replay and the
        journal's mutations (reference open + mmap_wal_replay + IDMap blob
        restore). Returns an IVFIndex or IVFPQIndex, as the container holds."""
        return durable.load_ivf_container(path, device=device)


# ---------------------------------------------------------------------------
# IVF-PQ
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class IVFPQConfig(IVFConfig):
    """IVF-PQ knobs on top of IVFConfig (reference IVFAppendOpts.format
    pq8/pq4, IVFAppend.swift:30; PQTrainConfig, PQTrain.swift:20-43)."""

    m: int = 8  # PQ subspaces
    ks: int = 256  # codes per subspace (256 = pq8, 16 = pq4, packed two per byte)
    pq_iters: int = 15
    rerank: bool = True  # exact rerank of the ADC candidates (#40)
    rerank_c: int = 64  # ADC candidates fed to the rerank
    # host-memory rerank tier: the vectors stay in host RAM and only the
    # top-C candidates' rows are read, on the host, for the rerank
    host_rerank: bool = False
    # boundary multi-assignment ("list spill", ops.ivf.spill_assign): rows
    # whose 2nd-nearest centroid is within (1+eps)·d1 are also encoded into
    # that list; search dedups the copies. 0.0 = off.
    spill_eps: float = 0.0


class IVFPQIndex(IVFIndex):
    """IVF with residual product quantization and ADC scanning.

    Search (reference SURVEY.md §3.3 ADC variant): #29 select → per-query
    LUT (#21) → ADC over the probed code lists (K9/K10, #22) → exact rerank
    of the top-C against the stored vectors (#40 / IVFPostADC). Codes are
    residuals r = x − c_list (#23) of the packed CSR rows, encoded on the
    device whenever the store changes: in-place appends encode only the new
    rows, a repack re-encodes every row."""

    TYPE = "ivfpq"
    _ALLOWED_METRICS = (Metric.L2, Metric.INNER_PRODUCT)
    _CONFIG = IVFPQConfig

    def __init__(
        self,
        dimension: int,
        metric: Metric = Metric.L2,
        config: IVFPQConfig = IVFPQConfig(),
        storage_dtype: torch.dtype = torch.float32,
        device="cuda",
    ):
        if dimension % config.m != 0:
            raise (
                ErrorBuilder(IndexErrorKind.INVALID_CONFIGURATION)
                .message(f"dimension {dimension} not divisible by m={config.m}")
                .build()
            )
        if config.ks <= 16 and config.m % 2:
            raise (
                ErrorBuilder(IndexErrorKind.INVALID_CONFIGURATION)
                .message(
                    f"pq4 (ks={config.ks}) packs two codes per byte and needs "
                    f"an even m, got m={config.m}"
                )
                .build()
            )
        super().__init__(dimension, metric, config, storage_dtype, device)
        self._books: Optional[pq_ops.PQCodebooks] = None
        self._pq_cache: Optional[dict] = None  # codes of the packed layout
        self._slot_spill: dict[int, int] = {}  # slot -> spill list id
        self._host_reader_cache: Optional[tuple] = None  # (packed vecs, its reader)

    @classmethod
    def from_state(cls, state: dict, device="cuda") -> "IVFPQIndex":
        """IVFIndex.from_state, plus: books ([m, ks, dsub] PQ codebook
        centroids, or None while PQ is untrained), slot_list {slot: primary
        list} and slot_spill {slot: spill list}. With spill, `lists` holds
        every copy, so the primary list of a slot comes from slot_list."""
        idx = super().from_state(state, device)
        if state.get("slot_list") is not None:
            idx._slot_list = {int(s): int(l) for s, l in state["slot_list"].items()}
        idx._slot_spill = {int(s): int(l) for s, l in state.get("slot_spill", {}).items()}
        if state.get("books") is not None:
            cents = torch.from_numpy(np.array(state["books"], dtype=np.float32))
            idx._books = pq_ops.books_from_centroids(cents.to(idx.device))
        return idx

    @property
    def pq_trained(self) -> bool:
        return self._books is not None

    @property
    def _spill(self) -> bool:
        return self.config.spill_eps > 0.0

    # -- spill bookkeeping --

    def _spill_secondary(self, vecs: np.ndarray) -> np.ndarray:
        """Per row: the 2nd-nearest list when d2 <= (1+spill_eps)·d1, else
        -1 (ops.ivf.spill_assign's rule, for incremental row blocks)."""
        d, ids = nearest_two(torch.from_numpy(np.ascontiguousarray(vecs)).to(self.device),
                             self._centroids_dev)
        d, ids = d.cpu().numpy(), ids.cpu().numpy()
        ok = d[:, 1] <= (1.0 + self.config.spill_eps) * np.maximum(d[:, 0], 1e-30)
        return np.where(ok, ids[:, 1], -1).astype(np.int64)

    def _append_spill(self, slots, vecs: np.ndarray) -> None:
        """Append spill copies for the given rows (after their primary)."""
        if not (self._spill and self.trained):
            return
        vecs = np.atleast_2d(vecs)
        sec = self._spill_secondary(vecs)
        for i, s in enumerate(np.atleast_1d(slots)):
            if sec[i] >= 0:
                self._store.append(int(sec[i]), int(s), vecs[i])
                self._slot_spill[int(s)] = int(sec[i])

    def _drop_spill(self, slot: int) -> None:
        lst = self._slot_spill.pop(slot, None)
        if lst is not None:
            self._store.remove(lst, slot)

    def _respill_all(self, chunk: int = 131072) -> None:
        """Rebuild every spill copy against the current centroids (after
        optimize/refresh repacked the store with primary assignments)."""
        self._slot_spill.clear()
        if not (self._spill and self.trained and self.count):
            return
        slots = sorted(self._vectors.keys())
        for s in range(0, len(slots), chunk):
            blk = slots[s : s + chunk]
            self._append_spill(blk, np.stack([self._vectors[sl] for sl in blk]))

    def _refuse_durable_spill(self) -> None:
        """A spill index journals no insert: the reference's refusal, kept
        (its insert record names one list)."""
        if self._spill and self._durable is not None:
            raise (
                ErrorBuilder(IndexErrorKind.INVALID_CONFIGURATION)
                .message("spill_eps with durable journaling is unsupported")
                .build()
            )

    def insert(self, id: VectorID, vector, metadata: Metadata = None) -> None:
        self._refuse_durable_spill()
        super().insert(id, vector, metadata)
        if self._spill and self.trained:
            slot = self._idmap.lookup(id)
            self._append_spill([slot], self._vectors[slot][None, :])

    def insert_batch(self, ids, vectors, metadatas=None) -> None:
        self._refuse_durable_spill()
        super().insert_batch(ids, vectors, metadatas)
        if self._spill and self.trained:
            self._append_spill([self._idmap.lookup(i) for i in ids],
                               np.asarray(vectors, dtype=np.float32))

    def remove(self, id: VectorID) -> None:
        self._drop_spill(self._idmap.lookup(id))
        super().remove(id)

    def update(self, id: VectorID, vector=None, metadata: Metadata = None) -> None:
        if vector is not None:
            self._drop_spill(self._idmap.lookup(id))
        super().update(id, vector, metadata)
        if vector is not None and self._spill and self.trained:
            slot = self._idmap.lookup(id)
            self._append_spill([slot], self._vectors[slot][None, :])

    # -- training and encoding --

    def optimize(self) -> None:
        """Coarse k-means + respill + residual PQ training on every row
        (reference optimize + pq_train_f32 residual mode). PQ draws come
        from the stream (config.seed, 1)."""
        super().optimize()
        self._respill_all()
        if not self.trained or self.count == 0:
            return
        slots, x = self._stacked()
        assigns = np.array([self._slot_list[s] for s in slots], dtype=np.int64)
        self._books = pq_ops.pq_train_residual(
            vrng.make_generator(self.config.seed, 1, device=self.device),
            torch.from_numpy(x).to(self.device),
            self._centroids_dev,
            torch.from_numpy(assigns).to(self.device),
            m=self.config.m, ks=self.config.ks, iters=self.config.pq_iters,
        )
        self._pq_cache = None

    def refresh_quantizer(
        self, iters: int = 5, sample: int = 262144, chunk: int = km.ASSIGN_CHUNK
    ) -> dict:
        out = super().refresh_quantizer(iters=iters, sample=sample, chunk=chunk)
        self._respill_all()
        return out

    def _encode_rows(self, vecs: torch.Tensor, row_list: torch.Tensor):
        """Residual-encode a row block on the device → (codes, tcorr). Codes
        pack to u4 when ks ≤ 16 (reference IVFFormat.pq4); tcorr is the
        per-row constant of the decomposed residual LUT
        (pq_row_corrections), zeros for IP."""
        codes = pq_ops.pq_encode_residual(vecs, self._centroids_dev, row_list, self._books,
                                          chunk=65536)
        if self.metric == Metric.L2:
            tcorr = pq_ops.pq_row_corrections(codes, row_list, self._centroids_dev, self._books)
        else:
            tcorr = torch.zeros(codes.shape[0], dtype=torch.float32, device=codes.device)
        if self.config.ks <= 16:
            codes = pack_u4(codes)
        return codes, tcorr

    def _sync_pq(self):
        """(device lists, codes, tcorr) for the current packed layout.

        Incremental: while the CSR layout is stable (in-place appends only),
        only the rows appended since the last sync (the store's patch log)
        are encoded and copied into the cached code and correction tensors,
        in place. A repack (list overflow / remove / retrain) changes
        layout_version and re-encodes every row."""
        store = self._store
        arrays = store.sync_device(self.storage_dtype, with_vecs=not self.config.host_rerank)
        cache = self._pq_cache
        if cache is not None and cache["version"] == store.version:
            return arrays, cache["codes"], cache["tcorr"]
        if cache is not None and cache["layout"] == store.layout_version:
            new = [(row, lst) for v, row, lst in store._patch_log if v > cache["version"]]
            if new:
                rows_np = np.asarray([r for r, _ in new], dtype=np.int64)
                rows = torch.from_numpy(rows_np).to(self.device)
                lists = torch.tensor([l for _, l in new], dtype=torch.int64, device=self.device)
                # from the host packed mirror: f32 CSR order, full precision
                # under bf16 device storage
                vecs = torch.from_numpy(store._packed["vecs"][rows_np]).to(self.device)
                codes_new, tcorr_new = self._encode_rows(vecs, lists)
                cache["codes"].index_copy_(0, rows, codes_new)
                cache["tcorr"].index_copy_(0, rows, tcorr_new)
                cache["version"] = store.version
                return arrays, cache["codes"], cache["tcorr"]
        # full rebuild (new layout / first sync)
        p = store._packed
        row_list = np.zeros(p["row_ids"].shape[0], dtype=np.int64)  # dead rows: list 0
        for lst, (s, n) in enumerate(zip(p["starts"], p["lengths"])):
            row_list[s : s + n] = lst
        codes, tcorr = self._encode_rows(torch.from_numpy(p["vecs"]).to(self.device),
                                         torch.from_numpy(row_list).to(self.device))
        self._pq_cache = {"version": store.version, "layout": store.layout_version,
                          "codes": codes, "tcorr": tcorr}
        return arrays, codes, tcorr

    # -- search --

    def batch_search(
        self,
        queries,
        k: int,
        filter: Optional[FilterFn] = None,
        *,
        allow_ids=None,
        deny_ids=None,
        disabled_lists=None,
    ) -> list[list[SearchResult]]:
        q = np.ascontiguousarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.shape[1] != self.dimension:
            raise dimension_mismatch(self.dimension, q.shape[1], "ivfpq.search")
        if self.count == 0 or k <= 0 or q.shape[0] == 0:
            return [[] for _ in range(q.shape[0])]
        if not (self.trained and self.pq_trained):
            return super().batch_search(queries, k, filter, allow_ids=allow_ids,
                                        deny_ids=deny_ids, disabled_lists=disabled_lists)
        # oversample when a host-side metadata filter will drop hits
        kk = min(k if filter is None else max(4 * k, k + 32), self.count)
        arrays, codes, tcorr = self._sync_pq()
        cap = probe_cap_for(self._store.max_length)
        nprobe = min(self.config.nprobe, self.config.nlist)
        row_allow = self._row_allow_mask(allow_ids, deny_ids)
        disabled = None
        if disabled_lists is not None:
            dm = np.zeros((self.config.nlist,), dtype=bool)
            dm[np.asarray(list(disabled_lists), dtype=np.int64)] = True
            disabled = torch.from_numpy(dm).to(self.device)
        u4 = self.config.ks <= 16
        code_bytes = self.config.m // 2 if u4 else self.config.m
        stats = QueryStats(
            batch=q.shape[0], lists_routed=q.shape[0] * nprobe,
            codes_scanned=q.shape[0] * nprobe * cap,
            bytes_read={"codes": q.shape[0] * nprobe * cap * code_bytes},
            flags={f for f, on in (("u4", u4), ("host_rerank", self.config.host_rerank)) if on},
        )
        with TELEM.timer("scan_adc", stats):
            dist, ids = self._pq_dispatch(q, kk, arrays, codes, tcorr, cap, nprobe, stats,
                                          row_allow, disabled)
        TELEM.record_kernel("adc_probe", rows=stats.codes_scanned,
                            bytes=stats.bytes_read["codes"])
        TELEM.record_query(stats)
        debug.check_search_output("IVFPQIndex.batch_search", dist)
        return self._results(dist, ids, k, filter)

    def _results(self, dist: np.ndarray, ids: np.ndarray, k: int,
                 filter: Optional[FilterFn] = None) -> list[list[SearchResult]]:
        """Rows of SearchResult from internal (dist, ids), each row cut at
        its first missing slot and at k hits that pass `filter`."""
        scores = self._public_score(dist)
        out: list[list[SearchResult]] = []
        for b in range(ids.shape[0]):
            row: list[SearchResult] = []
            for j in range(ids.shape[1]):
                slot = int(ids[b, j])
                if slot == INVALID_ID or not np.isfinite(dist[b, j]):
                    break
                meta = self._metadata.get(slot)
                if filter is not None and not filter(meta):
                    continue
                row.append(SearchResult(
                    id=self._idmap.external_for(slot), score=float(scores[b, j]), metadata=meta,
                ))
                if len(row) == k:
                    break
            out.append(row)
        return out

    def _host_reader(self) -> ArrayReader:
        """VectorReader over the store's packed host mirror (f32, CSR row
        order), cached by the array's identity: in-place appends write into
        the same array, a repack replaces it and so the reader."""
        pv = self._store.packed()["vecs"]
        cache = self._host_reader_cache
        if cache is None or cache[0] is not pv:
            cache = (pv, ArrayReader(pv))
            self._host_reader_cache = cache
        return cache[1]

    def _pq_dispatch(self, q, kk, arrays, codes, tcorr, cap, nprobe, stats, row_allow, disabled):
        """One query batch → (dist, ids) as numpy, on every device through
        the TPU's route (K9/K10 on a CUDA index, their plain versions on a
        CPU index): on the host-rerank tier ivf_search_pq_hostrerank (the
        candidates' rows read from the host mirror, reranked on the host),
        else ivf_search_pq_probe (reranked from the device's vectors)."""
        if self.config.host_rerank and self.config.rerank:
            dist, ids = ivf_search_pq_hostrerank(
                q, self._centroids_dev, arrays, codes, tcorr, self._books, self._host_reader(),
                nprobe=nprobe, probe_cap=cap, k=kk, rerank_c=self.config.rerank_c,
                metric=self.metric, packed_u4=self.config.ks <= 16, row_allow=row_allow,
                disabled_lists=disabled, dedup=self._spill,
            )
            n_gather = q.shape[0] * candidate_count(self.config.rerank_c, kk, nprobe,
                                                    self.config.nlist, cap)
            TELEM.add_bytes("vecs", n_gather * self.dimension * 4)
            stats.candidates_kept = n_gather
            return dist, ids
        dist, ids = ivf_search_pq_probe(
            torch.from_numpy(q).to(self.device), self._centroids_dev, arrays, codes, tcorr,
            self._books, nprobe=nprobe, probe_cap=cap, k=kk, metric=self.metric,
            packed_u4=self.config.ks <= 16,
            rerank_c=self.config.rerank_c if self.config.rerank else 0,
            row_allow=row_allow, disabled_lists=disabled, dedup=self._spill,
        )
        return dist.cpu().numpy(), ids.cpu().numpy()

    def serve_session(self, *, lookahead: int = 3, allow_ids=None,
                      deny_ids=None) -> HostRerankSession:
        """Long-lived serving session of the host-rerank tier over the
        current index state (reference IVFIndex.swift:413: serving flows
        through the index). Snapshot semantics: the state is synced when
        the session is made; after a mutation, make a new session."""
        if not (self.config.host_rerank and self.config.rerank):
            raise ValueError(
                "serve_session requires the host-rerank tier "
                "(IVFPQConfig(rerank=True, host_rerank=True))"
            )
        if not (self.trained and self.pq_trained):
            raise ValueError("serve_session requires a trained index (optimize())")
        row_allow = self._row_allow_mask(allow_ids, deny_ids)
        arrays, codes, tcorr = self._sync_pq()
        return HostRerankSession(
            centroids=self._centroids_dev, arrays=arrays, codes=codes, tcorr=tcorr,
            books=self._books, reader=self._host_reader(),
            nprobe=min(self.config.nprobe, self.config.nlist),
            probe_cap=probe_cap_for(self._store.max_length), rerank_c=self.config.rerank_c,
            metric=self.metric, packed_u4=self.config.ks <= 16, dedup=self._spill,
            row_allow=row_allow, lookahead=lookahead, device=self.device,
        )

    def batch_search_stream(self, q_batches, k: int, *, lookahead: int = 3,
                            allow_ids=None, deny_ids=None):
        """Serve a stream of query batches, yielding batch_search's rows per
        batch, in order. On a trained host-rerank tier the batches are
        pipelined through serve_session().stream (up to `lookahead` in
        flight); elsewhere every batch is one batch_search call (its search
        is already one device dispatch)."""
        if not (self.config.host_rerank and self.config.rerank
                and self.trained and self.pq_trained):
            for qb in q_batches:
                yield self.batch_search(qb, k, allow_ids=allow_ids, deny_ids=deny_ids)
            return
        sess = self.serve_session(lookahead=lookahead, allow_ids=allow_ids, deny_ids=deny_ids)

        def checked(batches):
            for qb in batches:
                q = np.asarray(qb, dtype=np.float32)
                if q.ndim == 1:
                    q = q[None, :]
                if q.shape[1] != self.dimension:
                    raise dimension_mismatch(self.dimension, q.shape[1],
                                             "ivfpq.batch_search_stream")
                yield q

        for dist, ids in sess.stream(checked(q_batches), min(k, self.count)):
            yield self._results(dist, ids, k)

    def statistics(self) -> IndexStats:
        st = super().statistics()
        st.details.update({
            "pq_m": self.config.m,
            "pq_ks": self.config.ks,
            "pq_trained": self.pq_trained,
            "rerank": self.config.rerank,
            "code_bytes_per_vector": self.config.m if self.config.ks > 16 else self.config.m // 2,
        })
        return st
