"""HNSWIndex — hierarchical small-world graph index, batched-frontier style.

Counterpart of vectorindex_tpu.models.hnsw (parity target: the reference's
HNSWIndex.swift — configuration :14-27, insert :438-516, entry promotion
:507-510, tombstone delete :77-92, search :102-170, save/load :755-781).

  - The graph is a fixed-degree neighbor table per level (M0 = 2M at level
    0, M above), host-authoritative numpy, with a device mirror (`device`,
    default "cuda") patched in place (`index_copy_`) after each
    construction chunk, so a chunk uploads O(chunk · M) rows.
  - Construction and search run in chunks / batches through ops/graph:
    greedy descent over the upper levels, one batched beam at level 0, the
    diversity selection and the prune on the device; the chunk-internal
    candidates, reverse edges, level-0 refinement and orphan repair are the
    JAX package's host numpy, copied as numpy.
  - Levels are drawn with numpy from (seed, counter) exactly as the JAX
    index draws them, so both packages sample the same levels.
  - Cosine routes normalized vectors (L2 order == cosine order);
    INNER_PRODUCT routes through the virtual MIPS→L2 transform (uniform
    squared norm R² ≥ max‖x‖²).
  - `device_search` is the whole no-filter search as enqueued device work
    with fixed trip counts and no host synchronisation; `batch_search_stream`
    keeps up to `lookahead` of them in flight and lands their [B, k] outputs
    in pinned buffers (kernels/adc_probe.PinnedLanding).
  - Save writes every HNSWConfig field (the JAX package writes five, so a
    graph built at another build_chunk reloads differently there); load
    reads a missing key as the JAX load does and rebuilds by reinsertion.

HNSW runs no hand-written kernel: the JAX package has no Pallas kernel here
(its search is XLA), and the port's is plain torch.
"""

from __future__ import annotations

from collections import deque
from dataclasses import asdict, dataclass, fields
from typing import Optional

import numpy as np
import torch

from vectorindex_tpu_torch.kernels.adc_probe import PinnedLanding
from vectorindex_tpu_torch.models.base import (
    FilterFn,
    IndexStats,
    Metadata,
    SearchResult,
    VectorID,
    VectorIndex,
)
from vectorindex_tpu_torch.ops import graph as gops
from vectorindex_tpu_torch.ops.filtering import slot_mask_np
from vectorindex_tpu_torch.ops.idmap import IDMap
from vectorindex_tpu_torch.ops.topk import INVALID_DIST, INVALID_ID, topk
from vectorindex_tpu_torch.persistence.json_snapshot import (
    PersistedIndex,
    PersistedRecord,
    load_snapshot,
    save_snapshot,
)
from vectorindex_tpu_torch.utils.config import Metric
from vectorindex_tpu_torch.utils.errors import (
    ErrorBuilder,
    IndexErrorKind,
    dimension_mismatch,
    duplicate_id,
)
from vectorindex_tpu_torch.utils.telemetry import TELEM, QueryStats

Tensor = torch.Tensor

#: beam slots expanded per search iteration (construction: build_expand)
SEARCH_EXPAND = 4


@dataclass(frozen=True)
class HNSWConfig:
    """Reference HNSWIndex.Configuration (HNSWIndex.swift:14-27)."""

    m: int = 16
    ef_construction: int = 200  # reference efConstruction=200 (HNSWIndex.swift:20)
    ef_search: int = 64
    seed: int = 0xDEADBEEFCAFEBABE
    stream: int = 0
    build_chunk: int = 1024  # nodes inserted per batched construction step
    # construction beam relaxation: expand 8 beam slots per iteration
    build_expand: int = 8


class _Level:
    """One graph level: fixed-degree table over level-local rows with a
    global-id lookup (compact upper levels; level 0 is slot-indexed)."""

    def __init__(self, max_degree: int):
        self.max_degree = max_degree
        self.node_ids: list[int] = []  # row -> global slot
        self.nbrs = np.full((0, max_degree), -1, dtype=np.int32)

    def add_node(self, slot: int) -> int:
        row = len(self.node_ids)
        self.node_ids.append(slot)
        if row >= self.nbrs.shape[0]:
            # a power-of-two backing, as in the JAX package (the device
            # mirror's shape is the backing's)
            new_cap = max(64, 1 << row.bit_length())
            grown = np.full((new_cap, self.max_degree), -1, dtype=np.int32)
            grown[: self.nbrs.shape[0]] = self.nbrs
            self.nbrs = grown
        return row

    @property
    def count(self) -> int:
        return len(self.node_ids)


def _normalize(q: Tensor) -> Tensor:
    return q / torch.clamp_min(torch.linalg.norm(q, dim=-1, keepdim=True), 1e-30)


def _fused_search(
    qg: Tensor,  # [B, d] graph-space queries
    gv: Tensor,  # [N, d] graph-space vectors
    sqn: Tensor,  # [N] graph sqnorms (virtual R² for IP)
    valid: Tensor,  # [N] bool allow mask (tombstones False)
    entry: Tensor,  # [B] i32 entry ids
    hi_layers,  # tuple of (nbrs, lookup) pairs, top layer first
    nbrs0: Tensor,
    lookup0: Tensor,
    *,
    steps: tuple,  # per-hi-layer greedy descent step counts
    ef: int,
    iters: int,
    expand: int,
    k: int,
    metric: Metric,
):
    """Whole search — descent, beam, tombstone mask, top-k by graph
    distance, and the true-metric rescore of just the k winners → (slots
    [B, kk] i32, scores [B, kk] f32, ok [B, kk] bool), all on qg's device
    with no host synchronisation."""
    for (nbrs, lookup), st in zip(hi_layers, steps):
        entry = gops.greedy_descent(qg, gv, sqn, nbrs, lookup, entry, steps=st)
    beam = gops.beam_search(
        qg, gv, sqn, nbrs0, lookup0, entry, ef=ef, iters=iters, expand=expand
    )
    ids, dists = beam.ids, beam.dists
    okb = (ids != INVALID_ID) & (ids >= 0)
    safe = torch.where(okb, ids, 0)
    allow = okb & valid[safe.long()]
    masked = torch.where(allow, dists, INVALID_DIST)
    kk = min(k, masked.shape[1])
    pos = torch.arange(masked.shape[1], dtype=torch.int32, device=qg.device)
    # rank by GRAPH distance (ties by beam position)
    kd, kpos = topk(masked, kk, ids=pos, strict_ties=False)
    kok = torch.isfinite(kd)
    kslot = torch.gather(safe, 1, torch.where(kok, kpos, 0).long())
    # true-metric rescore of ONLY the k winners: gv is the rescore source
    # for every metric (cosine routes normalized rows, and the cosine score
    # IS the normalized dot)
    xg = gv[kslot.long()].float()  # [B, kk, d]
    qf = qg.float()
    if metric == Metric.L2:
        diff = xg - qf[:, None, :]
        score = torch.sqrt(torch.clamp_min(torch.sum(diff * diff, dim=-1), 0.0))
    else:  # IP: raw dot; COSINE: normalized dot — the same contraction
        score = torch.einsum("bkd,bd->bk", xg, qf)
    return kslot, score, kok


class HNSWIndex(VectorIndex):
    TYPE = "hnsw"

    def __init__(
        self,
        dimension: int,
        metric: Metric = Metric.L2,
        config: HNSWConfig = HNSWConfig(),
        device="cuda",
    ):
        if metric not in (Metric.L2, Metric.INNER_PRODUCT, Metric.COSINE):
            raise (
                ErrorBuilder(IndexErrorKind.UNSUPPORTED_METRIC)
                .message(f"HNSW supports L2/IP/cosine, got {metric.value}")
                .build()
            )
        self.dimension = dimension
        self.metric = metric
        self.config = config
        self.device = torch.device(device)
        cap = 1024
        # virtual MIPS R² (reference R2Parameter, MIPSTransform.swift:31-62):
        # every stored point reports the uniform squared norm R² ≥ max‖x‖²,
        # so routed distances ‖q‖² + R² − 2⟨q,x⟩ are IP-ordered
        self._r2 = 0.0
        self._vectors = np.zeros((cap, dimension), dtype=np.float32)  # raw
        self._graph_vecs = np.zeros((cap, dimension), dtype=np.float32)  # search space
        self._valid = np.zeros((cap,), dtype=bool)
        self._levels = np.full((cap,), -1, dtype=np.int32)
        self._metadata: list[Metadata] = [None] * cap
        self._idmap = IDMap()
        self._next_slot = 0
        self._pending: list[int] = []  # slots awaiting graph insertion
        self._layers: list[_Level] = [_Level(2 * config.m)]
        self._lookup0 = np.full((cap,), -1, dtype=np.int32)
        self._entry: int = -1
        self._level_counter = 0
        self._dev = None  # (vecs, sqn) device mirror
        self._dev_valid = None  # [cap] bool device mirror of _valid
        self._dev_layers = None  # list of (nbrs_dev, lookup_dev)
        self._dirty_rows0: set[int] = set()  # level-0 rows to patch on device
        self._dirty_lookup0: set[int] = set()  # slots whose L0 row changed
        self._dirty_vecs: set[int] = set()  # slots whose graph vector changed

    @classmethod
    def from_state(cls, state: dict, device="cuda") -> "HNSWIndex":
        """Rebuild an index from another index's host state as plain
        numpy/python values, so both search the same graph. Keys: dimension,
        metric (name or Metric), config (dict of HNSWConfig fields), vectors,
        graph_vecs, valid, levels, metadata, ids (iterable of (external,
        slot)), next_slot, pending, layers (list of (node_ids, nbrs)),
        lookup0, entry, r2, level_counter."""
        metric = state["metric"]
        cfg = HNSWConfig(**dict(state["config"]))
        idx = cls(int(state["dimension"]), Metric(getattr(metric, "value", metric)), cfg,
                  device=device)
        idx._vectors = np.array(state["vectors"], dtype=np.float32)
        idx._graph_vecs = np.array(state["graph_vecs"], dtype=np.float32)
        idx._valid = np.array(state["valid"], dtype=bool)
        idx._levels = np.array(state["levels"], dtype=np.int32)
        idx._metadata = list(state["metadata"])
        for ext, slot in state["ids"]:
            idx._idmap.append(ext, int(slot))
        idx._next_slot = int(state["next_slot"])
        idx._pending = [int(s) for s in state["pending"]]
        idx._layers = []
        for l, (node_ids, nbrs) in enumerate(state["layers"]):
            layer = _Level(2 * cfg.m if l == 0 else cfg.m)
            layer.node_ids = [int(s) for s in node_ids]
            layer.nbrs = np.array(nbrs, dtype=np.int32).reshape(-1, layer.max_degree)
            idx._layers.append(layer)
        idx._lookup0 = np.array(state["lookup0"], dtype=np.int32)
        idx._entry = int(state["entry"])
        idx._r2 = float(state["r2"])
        idx._level_counter = int(state["level_counter"])
        return idx

    # ------------------------------------------------------------------
    # storage
    # ------------------------------------------------------------------

    @property
    def count(self) -> int:
        return len(self._idmap)

    @property
    def capacity(self) -> int:
        return self._vectors.shape[0]

    def _grow(self) -> None:
        old = self.capacity
        self._vectors = np.vstack([self._vectors, np.zeros_like(self._vectors)])
        self._graph_vecs = np.vstack([self._graph_vecs, np.zeros_like(self._graph_vecs)])
        self._valid = np.concatenate([self._valid, np.zeros(old, bool)])
        self._levels = np.concatenate([self._levels, np.full(old, -1, dtype=np.int32)])
        self._lookup0 = np.concatenate([self._lookup0, np.full(old, -1, dtype=np.int32)])
        self._metadata.extend([None] * old)
        self._dev = None
        self._dev_valid = None
        self._dev_layers = None

    def _to_graph_space(self, v: np.ndarray, query: bool = False) -> np.ndarray:
        """Raw vectors → the routed space. COSINE → normalize (L2 order ==
        cosine order); INNER_PRODUCT / L2 → raw (IP order comes from the
        virtual-R² squared norms, see _sync_vec_device)."""
        if self.metric == Metric.COSINE:
            n = np.linalg.norm(v, axis=-1, keepdims=True)
            return v / np.maximum(n, 1e-30)
        return v

    def _ensure_r2(self, sqnorm: float) -> None:
        """Track R² ≥ max‖x‖² with ×1.25 headroom (reference R2Parameter
        staleness, MIPSTransform.swift:31-62). R² is uniform, so growing it
        never changes the routed order; only the device sqnorms refresh."""
        if self.metric != Metric.INNER_PRODUCT or sqnorm <= self._r2:
            return
        self._r2 = float(sqnorm) * 1.25
        if self._dev is not None:
            self._dev[1].fill_(float(np.float32(self._r2)))

    def _host_dist_from(self, base: np.ndarray, others: np.ndarray) -> np.ndarray:
        """Host-side graph distance from one base point to rows of `others`,
        in ops/graph._dist_rows' convention. L2/cosine: squared L2 in graph
        space; IP: the virtual MIPS distance ‖base‖² + R² − 2⟨base, x⟩."""
        if self.metric == Metric.INNER_PRODUCT:
            qn = float(np.dot(base, base))
            return qn + self._r2 - 2.0 * (others @ base)
        diff = others - base
        return np.einsum("...d,...d->...", diff, diff)

    def _check(self, vector) -> np.ndarray:
        v = np.asarray(vector, dtype=np.float32).reshape(-1)
        if v.shape[0] != self.dimension:
            raise dimension_mismatch(self.dimension, v.shape[0], "hnsw.insert")
        if not np.all(np.isfinite(v)):
            raise (
                ErrorBuilder(IndexErrorKind.INVALID_VECTOR)
                .message("vector contains non-finite values")
                .build()
            )
        return v

    # ------------------------------------------------------------------
    # CRUD
    # ------------------------------------------------------------------

    def insert(self, id: VectorID, vector, metadata: Metadata = None) -> None:
        if id in self._idmap:
            raise duplicate_id(id, "hnsw.insert")
        v = self._check(vector)
        while self._next_slot >= self.capacity:
            self._grow()
        slot = self._next_slot
        self._next_slot += 1
        self._vectors[slot] = v
        self._ensure_r2(float(np.dot(v, v)))
        self._graph_vecs[slot] = self._to_graph_space(v)
        self._dirty_vecs.add(slot)
        self._valid[slot] = True
        self._metadata[slot] = metadata
        self._idmap.append(id, slot)
        self._pending.append(slot)

    def insert_batch(self, ids, vectors, metadatas=None) -> None:
        """Row by row, as the JAX package: a duplicate id mid-batch raises
        after the rows before it are inserted."""
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self.dimension:
            raise dimension_mismatch(self.dimension, vectors.shape[-1], "hnsw.insert_batch")
        for i, id_ in enumerate(ids):
            self.insert(id_, vectors[i], None if metadatas is None else metadatas[i])

    def remove(self, id: VectorID) -> None:
        """Tombstone delete (reference :77-92): the node stays routable and
        search masks it out via the allow mask."""
        slot = self._idmap.erase(id)
        self._valid[slot] = False
        self._metadata[slot] = None
        if slot in self._pending:
            self._pending.remove(slot)
        # graph vectors are untouched: only the allow mask changes
        self._dev_valid = None

    def update(self, id: VectorID, vector=None, metadata: Metadata = None) -> None:
        slot = self._idmap.lookup(id)
        if vector is not None:
            # re-position = remove + reinsert as a new slot
            meta = self._metadata[slot] if metadata is None else metadata
            self.remove(id)
            self.insert(id, vector, meta)
            return
        if metadata is not None:
            self._metadata[slot] = metadata

    def contains(self, id: VectorID) -> bool:
        return id in self._idmap

    # ------------------------------------------------------------------
    # device mirrors
    # ------------------------------------------------------------------

    def _upload(self, a: np.ndarray) -> Tensor:
        # copy=True: on the CPU the tensor must not alias the host array
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device, copy=True)

    def _upload_queries(self, q: np.ndarray) -> Tensor:
        """Graph-space queries on the device without waiting for its queue:
        to the card from pinned memory (a pageable upload synchronises the
        stream, so a search could not be enqueued behind another)."""
        t = torch.from_numpy(np.ascontiguousarray(self._to_graph_space(q, query=True)))
        if self.device.type != "cuda":
            return t.clone()
        return t.pin_memory().to(self.device, non_blocking=True)

    def _patch(self, dev: Tensor, idx: np.ndarray, rows: np.ndarray) -> None:
        """Write host rows (one per index of idx) into the device mirror in
        place."""
        dev.index_copy_(0, self._upload(idx.astype(np.int64)), self._upload(rows))

    @staticmethod
    def _sqnorms(rows: np.ndarray) -> np.ndarray:
        return np.einsum("nd,nd->n", rows, rows, dtype=np.float32)

    def _sync_vec_device(self):
        if self._dev is not None and self._dirty_vecs:
            gv, sqn = self._dev
            slots = np.fromiter(self._dirty_vecs, dtype=np.int64)
            if (slots < gv.shape[0]).all():
                # incremental patch: only the rows written since the last sync
                self._dirty_vecs.clear()
                rows = self._graph_vecs[slots]
                self._patch(gv, slots, rows)
                if self.metric != Metric.INNER_PRODUCT:
                    self._patch(sqn, slots, self._sqnorms(rows))
                # IP: sqn is the uniform R², which new slots already carry
            else:
                self._dev = None  # backing grew: full resync
        if self._dev is None:
            gv = self._upload(self._graph_vecs)
            if self.metric == Metric.INNER_PRODUCT:
                sqn = torch.full((gv.shape[0],), float(np.float32(self._r2)), device=self.device)
            else:
                sqn = self._upload(self._sqnorms(self._graph_vecs))
            self._dev = (gv, sqn)
            self._dirty_vecs.clear()
        return self._dev

    def _sync_valid_device(self):
        if self._dev_valid is None:
            self._dev_valid = self._upload(self._valid)
        return self._dev_valid

    def _sync_layer_device(self, l: int):
        if self._dev_layers is None:
            self._dev_layers = [None] * len(self._layers)
        while len(self._dev_layers) < len(self._layers):
            self._dev_layers.append(None)
        if l == 0 and self._dev_layers[0] is not None and self._dirty_rows0:
            # incremental patch: only the touched rows (~chunk·(m+1) a chunk)
            nbrs_dev, lookup_dev = self._dev_layers[0]
            layer = self._layers[0]
            if any(r >= nbrs_dev.shape[0] for r in self._dirty_rows0):
                self._dev_layers[0] = None  # backing grew: full resync
            else:
                rows = np.fromiter(self._dirty_rows0, dtype=np.int64)
                if rows.size:
                    self._patch(nbrs_dev, rows, layer.nbrs[rows])
                if self._dirty_lookup0:
                    ls = np.fromiter(self._dirty_lookup0, dtype=np.int64)
                    if (ls < lookup_dev.shape[0]).all():
                        self._patch(lookup_dev, ls, self._lookup0[ls])
                    else:
                        lookup_dev = self._upload(self._lookup0)
                    self._dirty_lookup0.clear()
                self._dev_layers[0] = (nbrs_dev, lookup_dev)
                self._dirty_rows0.clear()
                return self._dev_layers[0]
            self._dirty_rows0.clear()
        if self._dev_layers[l] is None:
            layer = self._layers[l]
            if l == 0:
                self._dirty_rows0.clear()  # a full sync supersedes patches
                self._dirty_lookup0.clear()
            nbrs = self._upload(
                layer.nbrs if layer.nbrs.shape[0] else np.full((1, layer.max_degree), -1, np.int32)
            )
            lookup = self._upload(self._row_lookup(l))
            self._dev_layers[l] = (nbrs, lookup)
        return self._dev_layers[l]

    def _invalidate_layer(self, l: int):
        if self._dev_layers is not None and l < len(self._dev_layers):
            self._dev_layers[l] = None

    def _hi_layers(self):
        """(((nbrs, lookup) per upper level, top first), their descent steps)."""
        top = range(len(self._layers) - 1, 0, -1)
        return (tuple(self._sync_layer_device(l) for l in top),
                tuple(self._descent_steps(l) for l in top))

    # ------------------------------------------------------------------
    # construction (batched chunks)
    # ------------------------------------------------------------------

    def _ensure_built(self) -> None:
        """Flush pending slots into the graph in batched chunks."""
        if not self._pending:
            return
        self._dev_valid = None
        pending = self._pending
        self._pending = []
        # doubling schedule: early chunks are small so every node sees a
        # meaningfully built graph
        n_before = self._layers[0].count
        i = 0
        while i < len(pending):
            c = min(self.config.build_chunk, max(8, self._layers[0].count))
            self._build_chunk(pending[i : i + c])
            i += c
        # refinement after a bulk build: batched insertion strands early
        # nodes whose reverse edges got pruned; one pass of re-deriving each
        # node's out-edges from a self-search + symmetrization restores them
        if len(pending) >= max(64, n_before // 4):
            self._refine_level0()
        self._repair_orphans()

    def _beam_params(self, ef_target: int, expand: int = 1):
        """(ef, iters): total expansions ≈ ef, ~expand× fewer iterations."""
        return ef_target, -(-ef_target // expand)

    def _descent_steps(self, l: int) -> int:
        """pow2-bucketed greedy-descent step count per level."""
        want = max(4, int(np.log2(max(self._layers[l].count, 2))) + 2)
        return 1 << (want - 1).bit_length()

    def _sample_levels(self, n: int) -> list[int]:
        """Geometric levels, one host draw per chunk, from
        numpy's default_rng((seed ^ golden) + counter): the JAX index's
        draw, so both packages give every node the same level."""
        rng = np.random.default_rng((self.config.seed ^ 0x9E3779B97F4A7C15) + self._level_counter)
        self._level_counter += n
        u = rng.uniform(1e-12, 1.0, n)
        ml = 1.0 / np.log(max(float(self.config.m), 2.0))
        return np.minimum(np.floor(-np.log(u) * ml), gops.LEVEL_CAP).astype(int).tolist()

    def _build_chunk(self, slots: list[int]) -> None:
        cfg = self.config
        chunk_levels = self._sample_levels(len(slots))

        if self._entry < 0:
            # bootstrap: the first node becomes the entry at its level
            first, *rest = slots
            lvl = chunk_levels[0]
            self._levels[first] = lvl
            for l in range(0, lvl + 1):
                self._ensure_layer(l)
                row = self._layers[l].add_node(first)
                if l == 0:
                    self._lookup0[first] = row
                self._invalidate_layer(l)
            self._entry = first
            if not rest:
                return
            slots = rest
            chunk_levels = chunk_levels[1:]

        gv, sqn = self._sync_vec_device()
        b = len(slots)
        slots_arr = np.asarray(slots, dtype=np.int64)
        xc = self._graph_vecs[slots_arr]
        q = self._upload(xc)
        max_level = len(self._layers) - 1
        entry = torch.full((b,), self._entry, dtype=torch.int32, device=self.device)

        # greedy descent through the upper levels
        for l in range(max_level, 0, -1):
            nbrs, lookup = self._sync_layer_device(l)
            entry = gops.greedy_descent(q, gv, sqn, nbrs, lookup, entry,
                                        steps=self._descent_steps(l))

        # level-0 candidates via the batched beam
        nbrs0, lookup0 = self._sync_layer_device(0)
        ef, iters = self._beam_params(cfg.ef_construction, expand=cfg.build_expand)
        beam = gops.beam_search(q, gv, sqn, nbrs0, lookup0, entry, ef=ef, iters=iters,
                                expand=cfg.build_expand)
        # chunk-internal candidates: chunk members are not in the graph yet,
        # so each member's within-chunk nearest neighbors join its pool
        int_ids = np.full((b, cfg.m), INVALID_ID, dtype=np.int32)
        int_d = np.full((b, cfg.m), np.inf, dtype=np.float32)
        if b > 1:
            qn = np.einsum("nd,nd->n", xc, xc)
            if self.metric == Metric.INNER_PRODUCT:
                dcc = (qn[:, None] + self._r2 - 2.0 * (xc @ xc.T)).astype(np.float32)
            else:
                dcc = np.maximum(qn[:, None] + qn[None, :] - 2.0 * (xc @ xc.T), 0.0).astype(
                    np.float32)
            np.fill_diagonal(dcc, np.inf)
            n_int = min(cfg.m, b - 1)
            part = np.argpartition(dcc, n_int - 1, axis=1)[:, :n_int]
            pd = np.take_along_axis(dcc, part, axis=1)
            o2 = np.argsort(pd, axis=1, kind="stable")
            order = np.take_along_axis(part, o2, axis=1)
            int_ids[:, :n_int] = slots_arr.astype(np.int32)[order]
            int_d[:, :n_int] = np.take_along_axis(dcc, order, axis=1)
        all_d = torch.cat([beam.dists, self._upload(int_d)], dim=1)
        all_i = torch.cat([beam.ids, self._upload(int_ids)], dim=1)
        sd, si = gops._sort2(all_d, all_i)
        selected = self._select_neighbors(sd[:, :ef], si[:, :ef], gv, sqn, cfg.m)

        # register all chunk rows first so intra-chunk reverse edges resolve
        layer0 = self._layers[0]
        for j, slot in enumerate(slots):
            self._levels[slot] = chunk_levels[j]
            row = layer0.add_node(slot)
            self._lookup0[slot] = row
            self._dirty_lookup0.add(int(slot))

        # connect at level 0: forward edges as one block write, reverse
        # edges through the grouped append
        rows_new = self._lookup0[slots_arr]
        sel_np = np.where(selected == INVALID_ID, -1, selected).astype(np.int32)
        layer0.nbrs[rows_new, : sel_np.shape[1]] = sel_np
        self._dirty_rows0.update(int(r) for r in rows_new)
        src = np.repeat(slots_arr, sel_np.shape[1]).astype(np.int32)
        dst = sel_np.ravel()
        live = dst >= 0
        self._append_reverse_edges(0, dst[live], src[live])

        # upper-level insertion, batched per (chunk, level)
        lvl_arr = np.asarray(chunk_levels, dtype=np.int32)
        top = int(lvl_arr.max()) if len(lvl_arr) else -1
        for l in range(1, top + 1):
            self._ensure_layer(l)
            members = slots_arr[lvl_arr >= l]
            if members.size:
                self._insert_upper_batch(members, l)
                self._invalidate_layer(l)
        for j, slot in enumerate(slots):
            lvl = chunk_levels[j]
            if lvl > max_level and lvl >= 0:
                self._entry = slot  # entry promotion (reference :507-510)
                max_level = lvl

    def _refine_level0(self) -> None:
        """Re-derive level-0 adjacency: for every node, beam-search its own
        vector, merge (search candidates ∪ old out-edges ∪ old in-edges),
        re-select diverse + fill, then symmetrize reverse edges."""
        layer0 = self._layers[0]
        n = layer0.count
        if n < 16:
            return
        cfg = self.config
        gv, sqn = self._sync_vec_device()
        slots_all = np.asarray(layer0.node_ids, dtype=np.int64)
        old_nbrs = layer0.nbrs[:n].copy()
        deg0 = layer0.max_degree
        # reverse adjacency as a padded per-row matrix
        rev_cap = 3 * deg0
        rev_pad = np.full((n, rev_cap), INVALID_ID, dtype=np.int32)
        srcs = np.repeat(slots_all.astype(np.int32), deg0)
        tgts = old_nbrs.ravel()
        live_e = tgts >= 0
        srcs, tgts = srcs[live_e], tgts[live_e]
        trows = self._lookup0[tgts]
        live_e = trows >= 0
        srcs, trows = srcs[live_e], trows[live_e]
        if trows.size:
            order_e = np.argsort(trows, kind="stable")
            trows_s, srcs_s = trows[order_e], srcs[order_e]
            _, ustart, ucnt = np.unique(trows_s, return_index=True, return_counts=True)
            pos = np.arange(trows_s.size) - np.repeat(ustart, ucnt)
            keep_e = pos < rev_cap
            rev_pad[trows_s[keep_e], pos[keep_e]] = srcs_s[keep_e]

        self._invalidate_layer(0)
        nbrs0, lookup0 = self._sync_layer_device(0)
        ef, iters = self._beam_params(cfg.ef_construction, expand=cfg.build_expand)
        new_nbrs = np.full_like(old_nbrs, -1)
        ex_width = 4 * layer0.max_degree
        big = np.int64(2**62)
        for i in range(0, n, cfg.build_chunk):
            bs = slots_all[i : i + cfg.build_chunk]
            xb = self._graph_vecs[bs]  # [c, d]
            entry = torch.full((bs.size,), self._entry, dtype=torch.int32, device=self.device)
            beam = gops.beam_search(self._upload(xb), gv, sqn, nbrs0, lookup0, entry, ef=ef,
                                    iters=iters, expand=cfg.build_expand)
            # merge old out/in edges into the candidate pool (fixed width:
            # ids ascending with INVALID last, dups and self masked)
            rows_b = self._lookup0[bs]
            ex_raw = np.concatenate(
                [np.where(old_nbrs[rows_b] >= 0, old_nbrs[rows_b], INVALID_ID), rev_pad[rows_b]],
                axis=1,
            ).astype(np.int64)
            ex_sorted = np.sort(np.where(ex_raw == INVALID_ID, big, ex_raw), axis=1)
            dup = np.zeros_like(ex_sorted, dtype=bool)
            dup[:, 1:] = ex_sorted[:, 1:] == ex_sorted[:, :-1]
            kill_e = dup | (ex_sorted >= big) | (ex_sorted == bs[:, None])
            ex_sorted = np.sort(np.where(kill_e, big, ex_sorted), axis=1)[:, :ex_width]
            ex = np.where(ex_sorted >= big, INVALID_ID, ex_sorted).astype(np.int32)
            ex_safe = np.where(ex != INVALID_ID, ex, 0)
            xe = self._graph_vecs[ex_safe]  # [c, ex_width, d]
            g = np.einsum("cd,ced->ce", xb, xe)
            bn = np.einsum("cd,cd->c", xb, xb)
            if self.metric == Metric.INNER_PRODUCT:
                exd_rows = bn[:, None] + self._r2 - 2.0 * g
            else:
                en = np.einsum("ced,ced->ce", xe, xe)
                exd_rows = np.maximum(bn[:, None] + en - 2.0 * g, 0.0)
            exd = np.where(ex != INVALID_ID, exd_rows, np.inf).astype(np.float32)
            all_d = torch.cat([beam.dists, self._upload(exd)], dim=1)
            all_i = torch.cat([beam.ids, self._upload(ex)], dim=1)
            sd, si = gops._sort2(all_d, all_i)
            # drop self + duplicates (candidates are (d, i)-sorted, so
            # duplicate ids sit adjacent)
            ci_np = si[:, :ef].cpu().numpy()
            cd_np = sd[:, :ef].cpu().numpy()
            kill = ci_np == bs[:, None]
            kill[:, 1:] |= ci_np[:, 1:] == ci_np[:, :-1]
            cd_np[kill] = np.inf
            ci_np[kill] = INVALID_ID
            sel = self._select_neighbors(self._upload(cd_np), self._upload(ci_np), gv, sqn, cfg.m)
            # each row's picks in order, INVALID dropped
            sel = np.take_along_axis(sel, np.argsort(sel == INVALID_ID, axis=1, kind="stable"),
                                     axis=1)
            rows = self._lookup0[bs]
            new_nbrs[rows, : sel.shape[1]] = np.where(sel == INVALID_ID, -1, sel)

        layer0.nbrs[:n] = new_nbrs
        # symmetrize: each out-edge gets a reverse edge
        sym_src = np.repeat(slots_all.astype(np.int32), new_nbrs.shape[1])
        sym_dst = new_nbrs.ravel()
        sym_live = sym_dst >= 0
        self._append_reverse_edges(0, sym_dst[sym_live], sym_src[sym_live])
        self._invalidate_layer(0)

    def _repair_orphans(self) -> None:
        """Guarantee in-degree ≥ 1: link each orphan from its nearest node."""
        layer0 = self._layers[0]
        n = layer0.count
        if n < 2:
            return
        indeg = np.zeros(self.capacity, dtype=np.int64)
        nb = layer0.nbrs[:n]
        np.add.at(indeg, nb[nb >= 0], 1)
        orphans = [s for s in layer0.node_ids if indeg[s] == 0 and s != self._entry]
        if not orphans:
            return
        slots_all = np.asarray(layer0.node_ids, dtype=np.int64)
        orph = np.asarray(orphans, dtype=np.int64)
        base = self._graph_vecs[orph]  # [O, d]
        others = self._graph_vecs[slots_all]  # [n, d]
        gmat = base @ others.T
        bn = np.einsum("od,od->o", base, base)
        if self.metric == Metric.INNER_PRODUCT:
            d = bn[:, None] + self._r2 - 2.0 * gmat
        else:
            on = np.einsum("nd,nd->n", others, others)
            d = bn[:, None] + on[None, :] - 2.0 * gmat
        d[orph[:, None] == slots_all[None, :]] = np.inf
        nearest = slots_all[np.argmin(d, axis=1)]
        for u, v in zip(orph, nearest):
            vrow = self._lookup0[v]
            lst = layer0.nbrs[vrow]
            free = np.nonzero(lst < 0)[0]
            if len(free):
                lst[free[0]] = u
            else:
                lst[-1] = u  # force the link; connectivity beats diversity
            self._dirty_rows0.add(int(vrow))
        self._invalidate_layer(0)

    def _ensure_layer(self, l: int) -> None:
        while len(self._layers) <= l:
            self._layers.append(_Level(self.config.m))

    # ------------------------------------------------------------------
    # vectorized edge machinery
    # ------------------------------------------------------------------

    def _row_lookup(self, l: int) -> np.ndarray:
        if l == 0:
            return self._lookup0
        layer = self._layers[l]
        lk = np.full((self.capacity,), -1, dtype=np.int32)
        if layer.node_ids:
            lk[np.asarray(layer.node_ids, dtype=np.int64)] = np.arange(layer.count, dtype=np.int32)
        return lk

    def _prune_overflow(self, base_slots: np.ndarray, cand: np.ndarray, deg: int) -> np.ndarray:
        """Prune overflowed lists back to deg entries. cand is [V, C]
        valid-first (−1 padded). L2/cosine: the diversity rule on the device
        (ops/graph.prune_neighbors); INNER_PRODUCT: nearest-deg on the host
        (see _select_neighbors)."""
        if self.metric == Metric.INNER_PRODUCT:
            safe = np.maximum(cand, 0)
            xe = self._graph_vecs[safe]  # [V, C, d]
            base = self._graph_vecs[base_slots]  # [V, d]
            d = -np.einsum("vcd,vd->vc", xe, base)  # IP order (R² const)
            d = np.where(cand >= 0, d, np.inf)
            order = np.argsort(d, axis=1, kind="stable")[:, :deg]
            out = np.take_along_axis(cand, order, axis=1)
            return np.where(np.take_along_axis(d, order, axis=1) < np.inf, out, -1).astype(
                np.int32)
        gv, sqn = self._sync_vec_device()
        cand = np.where(cand >= 0, cand, INVALID_ID).astype(np.int32)
        pruned = gops.prune_neighbors(
            self._upload(base_slots.astype(np.int32)), self._upload(cand), gv, sqn, m=deg
        ).cpu().numpy()
        return np.where(pruned != INVALID_ID, pruned, -1).astype(np.int32)

    def _append_reverse_edges(self, l: int, dst: np.ndarray, src: np.ndarray) -> None:
        """Grouped reverse-edge append: add src[i] into dst[i]'s level-l
        neighbor list; duplicates dropped; incoming capped at deg per target
        per call; overflowed lists batch-pruned."""
        if dst.size == 0:
            return
        layer = self._layers[l]
        deg = layer.max_degree
        lookup = self._row_lookup(l)
        rows = lookup[dst]
        keep = rows >= 0
        rows, src = rows[keep], src[keep]
        if rows.size == 0:
            return
        order = np.argsort(rows, kind="stable")
        rows_s, src_s = rows[order], src[order].astype(np.int32)
        urows, ustarts, counts = np.unique(rows_s, return_index=True, return_counts=True)
        u = len(urows)
        cmax = int(min(counts.max(), deg))
        inc = np.full((u, cmax), -1, dtype=np.int32)
        pos = np.arange(rows_s.size) - np.repeat(ustarts, counts)
        sel = pos < cmax
        inc[np.repeat(np.arange(u), counts)[sel], pos[sel]] = src_s[sel]
        lists = layer.nbrs[urows]  # [U, deg]
        present = (inc[:, :, None] == lists[:, None, :]).any(-1)
        if cmax > 1:
            # duplicate source within one target's incoming block: keep the
            # first occurrence only
            earlier = np.tril(np.ones((cmax, cmax), dtype=bool), k=-1)
            present |= ((inc[:, :, None] == inc[:, None, :]) & earlier[None]).any(-1)
        inc = np.where(present | (inc < 0), -1, inc)
        cand = np.concatenate([lists, inc], axis=1)
        validm = cand >= 0
        nvalid = validm.sum(1)
        idx = np.argsort(np.where(validm, 0, 1), axis=1, kind="stable")
        cand_c = np.take_along_axis(cand, idx, axis=1)
        ok = nvalid <= deg
        if ok.any():
            layer.nbrs[urows[ok]] = cand_c[ok, :deg]
        over = ~ok
        if over.any():
            node_arr = np.asarray(layer.node_ids, dtype=np.int64)
            base_slots = node_arr[urows[over]]
            # fixed candidate width 2·deg
            cw = 2 * deg
            co = cand_c[over]
            if co.shape[1] < cw:
                co = np.concatenate(
                    [co, np.full((co.shape[0], cw - co.shape[1]), -1, np.int32)], axis=1)
            else:
                co = co[:, :cw]
            layer.nbrs[urows[over]] = self._prune_overflow(base_slots, co, deg)
        if l == 0:
            self._dirty_rows0.update(int(r) for r in urows)
        else:
            self._invalidate_layer(l)

    def _select_neighbors(self, cand_d: Tensor, cand_i: Tensor, gv, sqn, m: int) -> np.ndarray:
        """Neighbor selection per metric → numpy [C, m]: L2/cosine use the
        diversity heuristic (#34); INNER_PRODUCT takes the nearest m (the
        diversity rule under IP prunes almost every edge toward high-norm
        hubs — the ip-NSW finding). Candidates arrive (dist, id)-sorted."""
        if self.metric == Metric.INNER_PRODUCT:
            return cand_i[:, :m].cpu().numpy()
        return gops.select_neighbors_diverse(cand_d, cand_i, gv, sqn, m=m).cpu().numpy()

    def _insert_upper_batch(self, members: np.ndarray, l: int) -> None:
        """Batched upper-level insertion (level l ≥ 1): register the chunk's
        level-l members, one BLAS distance block against the whole layer
        (members included, so intra-chunk upper edges form), diversity-
        select m, then forward + grouped reverse connect."""
        layer = self._layers[l]
        cfg = self.config
        n_prev = layer.count
        for s in members:
            layer.add_node(int(s))
        all_ids = np.asarray(layer.node_ids, dtype=np.int64)
        if all_ids.size < 2:
            return
        rows_new = np.arange(n_prev, n_prev + members.size, dtype=np.int64)

        base = self._graph_vecs[members]  # [g, d]
        others = self._graph_vecs[all_ids]  # [L, d]
        gmat = base @ others.T
        bn = np.einsum("gd,gd->g", base, base)
        if self.metric == Metric.INNER_PRODUCT:
            d = bn[:, None] + self._r2 - 2.0 * gmat
        else:
            on = np.einsum("ld,ld->l", others, others)
            d = np.maximum(bn[:, None] + on[None, :] - 2.0 * gmat, 0.0)
        d[members[:, None] == all_ids[None, :]] = np.inf
        d = d.astype(np.float32)

        ef = cfg.ef_construction
        if d.shape[1] > ef:
            part = np.argpartition(d, ef - 1, axis=1)[:, :ef]
            dd = np.take_along_axis(d, part, axis=1)
            o2 = np.argsort(dd, axis=1, kind="stable")
            cand_idx = np.take_along_axis(part, o2, axis=1)
            cand_d = np.take_along_axis(dd, o2, axis=1)
        else:
            cand_idx = np.argsort(d, axis=1, kind="stable")
            cand_d = np.take_along_axis(d, cand_idx, axis=1)
        cand_i = all_ids[cand_idx].astype(np.int32)
        finite = np.isfinite(cand_d)
        cand_i = np.where(finite, cand_i, INVALID_ID)
        cand_d = np.where(finite, cand_d, np.inf).astype(np.float32)
        if cand_d.shape[1] < ef:  # fixed width ef
            padw = ef - cand_d.shape[1]
            cand_d = np.pad(cand_d, ((0, 0), (0, padw)), constant_values=np.inf)
            cand_i = np.pad(cand_i, ((0, 0), (0, padw)), constant_values=INVALID_ID)
        gv, sqn = self._sync_vec_device()
        sel = self._select_neighbors(self._upload(cand_d), self._upload(cand_i), gv, sqn, cfg.m)
        sel_np = np.where(sel == INVALID_ID, -1, sel).astype(np.int32)
        sel_np = sel_np[:, : layer.max_degree]
        layer.nbrs[rows_new, : sel_np.shape[1]] = sel_np
        src = np.repeat(members.astype(np.int32), sel_np.shape[1])
        dst = sel_np.ravel()
        live = dst >= 0
        self._append_reverse_edges(l, dst[live], src[live])

    # ------------------------------------------------------------------
    # search
    # ------------------------------------------------------------------

    def _rescore(self, slots: np.ndarray, q: np.ndarray) -> np.ndarray:
        """True-metric public score for result slots (graph distances route;
        final scores come from the raw vectors)."""
        v = self._vectors[slots]
        if self.metric == Metric.L2:
            return np.linalg.norm(v - q, axis=-1)
        if self.metric == Metric.INNER_PRODUCT:
            return v @ q
        qn = q / max(np.linalg.norm(q), 1e-30)
        vn = v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-30)
        return vn @ qn

    def device_search(self, queries_dev: Tensor, k: int):
        """Device-only fused search → (slots [B, kk] i32, scores [B, kk] f32,
        ok [B, kk] bool) as device tensors: the core of batch_search's
        no-filter fast lane. Once the mirrors are warm and the queries lie
        on the device, it enqueues its work with no host synchronisation, so
        a caller can keep several in flight (batch_search_stream)."""
        self._ensure_built()
        q = queries_dev
        if self.metric == Metric.COSINE:  # graph space = normalized
            q = _normalize(q)
        gv, sqn = self._sync_vec_device()
        entry = torch.full((q.shape[0],), self._entry, dtype=torch.int32, device=q.device)
        ef, iters = self._beam_params(max(self.config.ef_search, k), expand=SEARCH_EXPAND)
        nbrs0, lookup0 = self._sync_layer_device(0)
        hi, steps = self._hi_layers()
        return _fused_search(
            q.float(), gv, sqn, self._sync_valid_device(), entry, hi, nbrs0, lookup0,
            steps=steps, ef=ef, iters=iters, expand=SEARCH_EXPAND, k=k, metric=self.metric,
        )

    def device_search_closure(self, k: int):
        """(fn, args) where fn(q_dev, *args) → (slots, scores, ok) reads all
        device state from its arguments, not from the index: for timing
        harnesses and serving loops."""
        self._ensure_built()
        gv, sqn = self._sync_vec_device()
        valid = self._sync_valid_device()
        nbrs0, lookup0 = self._sync_layer_device(0)
        hi, steps = self._hi_layers()
        ef, iters = self._beam_params(max(self.config.ef_search, k), expand=SEARCH_EXPAND)
        entry_id = self._entry
        metric = self.metric
        nhi = len(hi)
        hi_flat = tuple(a for pair in hi for a in pair)

        def fn(q, gv, sqn, valid, nbrs0, lookup0, *hi_flat):
            if metric == Metric.COSINE:
                q = _normalize(q)
            entry = torch.full((q.shape[0],), entry_id, dtype=torch.int32, device=q.device)
            hi_pairs = tuple((hi_flat[2 * i], hi_flat[2 * i + 1]) for i in range(nhi))
            return _fused_search(
                q.float(), gv, sqn, valid, entry, hi_pairs, nbrs0, lookup0, steps=steps,
                ef=ef, iters=iters, expand=SEARCH_EXPAND, k=k, metric=metric,
            )

        return fn, (gv, sqn, valid, nbrs0, lookup0) + hi_flat

    def batch_search_stream(self, q_batches, k: int, *, lookahead: int = 3):
        """Pipelined serving over a stream of query batches: the fused
        search of up to `lookahead` batches is enqueued before batch i's
        results are assembled on the host. Each batch's [B, k] outputs are
        copied into a pinned buffer (non_blocking, an event after the copy;
        PinnedLanding), and assembly waits on that event only. Yields
        assemble_results rows per batch, in order."""
        self._ensure_built()
        if self.count == 0 or k <= 0 or self._entry < 0:
            for qb in q_batches:
                q = np.asarray(qb)
                yield [[] for _ in range(1 if q.ndim == 1 else q.shape[0])]
            return
        fn, fargs = self.device_search_closure(k)
        depth = max(lookahead, 1)
        landing = PinnedLanding(depth + 1)

        def dispatch(qb):
            q = np.asarray(qb, dtype=np.float32)
            if q.ndim == 1:
                q = q[None, :]
            if q.shape[1] != self.dimension:
                raise dimension_mismatch(self.dimension, q.shape[1], "hnsw.batch_search_stream")
            kslot, kscore, kok = fn(self._upload_queries(q), *fargs)
            # int32 views land in one pinned buffer: the scores' bits, the
            # flags as 0/1
            return landing.land((kslot, kscore.view(torch.int32), kok.to(torch.int32)))

        def finish(landed):
            try:
                kslot, kscore, kok = landing.wait(landed)
                return self.assemble_results(kslot, kscore.view(np.float32), kok.astype(bool))
            finally:
                landing.release(landed)

        pending = deque()
        for qb in q_batches:
            # drain before dispatching: at most `lookahead` batches in flight
            if len(pending) >= depth:
                yield finish(pending.popleft())
            pending.append(dispatch(qb))
        while pending:
            yield finish(pending.popleft())

    def assemble_results(
        self, kslot: np.ndarray, kscore: np.ndarray, kok: np.ndarray
    ) -> list[list[SearchResult]]:
        """Host half of the fast lane: device_search outputs → public
        SearchResult rows (external ids via the idmap, metadata attached)."""
        ext = self._idmap.external_for
        out: list[list[SearchResult]] = []
        for i in range(kslot.shape[0]):
            row: list[SearchResult] = []
            for j in range(kslot.shape[1]):
                if not kok[i, j]:
                    break  # dead entries sort last (INVALID_DIST)
                slot = int(kslot[i, j])
                row.append(SearchResult(id=ext(slot), score=float(kscore[i, j]),
                                        metadata=self._metadata[slot]))
            out.append(row)
        return out

    def _id_filtered_search(
        self, q: np.ndarray, k: int, filter, allow_ids, deny_ids
    ) -> list[list[SearchResult]]:
        """ID-set filtered search (reference allow-bitset threaded through
        traversal, HNSWTraversal.swift:25 + IDFilter.swift:104), in two
        regimes by selectivity:
        - a small allowed set → an EXACT scan over just the allowed rows;
        - a large one → the fused beam with the allow mask ANDed into the
          tombstone mask and ef scaled by 1/selectivity (pow2-bucketed),
          candidates masked before the final top-k."""
        b = q.shape[0]
        mask = slot_mask_np(self.capacity, self._idmap, allow_ids, deny_ids)
        allow = self._valid & mask
        if filter is not None:
            for slot in np.nonzero(allow)[0]:
                if not filter(self._metadata[slot]):
                    allow[slot] = False
        n_allowed = int(allow.sum())
        if n_allowed == 0:
            return [[] for _ in range(b)]

        if n_allowed <= max(4 * k, 2048):
            slots = np.nonzero(allow)[0]
            v = self._vectors[slots]  # [A, d] raw vectors, public metric
            if self.metric == Metric.L2:
                sq = np.einsum("ad,ad->a", v, v)
                qn = np.einsum("bd,bd->b", q, q)
                scores = np.sqrt(np.maximum(qn[:, None] + sq[None, :] - 2.0 * (q @ v.T), 0.0))
                order = np.argsort(scores, axis=1, kind="stable")
            elif self.metric == Metric.INNER_PRODUCT:
                scores = q @ v.T
                order = np.argsort(-scores, axis=1, kind="stable")
            else:  # COSINE
                vn = v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-30)
                qn_ = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-30)
                scores = qn_ @ vn.T
                order = np.argsort(-scores, axis=1, kind="stable")
            out: list[list[SearchResult]] = []
            for i in range(b):
                row = []
                for j in order[i, : min(k, len(slots))]:
                    slot = int(slots[j])
                    row.append(SearchResult(id=self._idmap.external_for(slot),
                                            score=float(scores[i, j]),
                                            metadata=self._metadata[slot]))
                out.append(row)
            return out

        # beam path: the allow mask into the fused search, ef / selectivity
        live = int(self._valid.sum())
        sel = n_allowed / max(live, 1)
        ef_target = max(self.config.ef_search, k, int(4 * k / max(sel, 0.02)))
        ef_target = 1 << (min(ef_target, 4096) - 1).bit_length()
        qg = self._upload_queries(q)
        if self.metric == Metric.COSINE:
            qg = _normalize(qg)
        gv, sqn = self._sync_vec_device()
        entry = torch.full((b,), self._entry, dtype=torch.int32, device=self.device)
        ef, iters = self._beam_params(ef_target, expand=SEARCH_EXPAND)
        nbrs0, lookup0 = self._sync_layer_device(0)
        hi, steps = self._hi_layers()
        kslot, kscore, kok = _fused_search(
            qg.float(), gv, sqn, self._upload(allow), entry, hi, nbrs0, lookup0,
            steps=steps, ef=ef, iters=iters, expand=SEARCH_EXPAND, k=k, metric=self.metric,
        )
        return self.assemble_results(kslot.cpu().numpy(), kscore.cpu().numpy(),
                                     kok.cpu().numpy())

    def batch_search(
        self,
        queries,
        k: int,
        filter: Optional[FilterFn] = None,
        *,
        allow_ids=None,
        deny_ids=None,
    ) -> list[list[SearchResult]]:
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.shape[1] != self.dimension:
            raise dimension_mismatch(self.dimension, q.shape[1], "hnsw.search")
        if self.count == 0 or k <= 0:
            return [[] for _ in range(q.shape[0])]
        self._ensure_built()
        if self._entry < 0:
            return [[] for _ in range(q.shape[0])]
        if allow_ids is not None or deny_ids is not None:
            return self._id_filtered_search(q, k, filter, allow_ids, deny_ids)

        qg = self._upload_queries(q)
        gv, sqn = self._sync_vec_device()
        b = q.shape[0]
        ef, iters = self._beam_params(max(self.config.ef_search, k), expand=SEARCH_EXPAND)

        if filter is None:
            # fast lane: the whole search is enqueued device work and only
            # [B, k] outputs cross back
            deg0 = self._layers[0].max_degree
            stats = QueryStats(
                batch=b,
                # beam expansions × fixed degree: the graph-side analog of
                # rows_scored (reference HNSWTraversal.swift:12-23)
                rows_scored=b * iters * SEARCH_EXPAND * deg0,
                candidates_emitted=b * ef,
            )
            with TELEM.timer("traverse", stats):
                kslot, kscore, kok = (t.cpu().numpy() for t in self.device_search(qg, k))
            stats.candidates_kept = int(kok.sum())
            gvecs_bytes = b * iters * SEARCH_EXPAND * deg0 * self.dimension * 4
            stats.bytes_read["vecs"] = gvecs_bytes
            TELEM.add_bytes("vecs", gvecs_bytes)
            TELEM.record_kernel("hnsw_fused_search", rows=stats.rows_scored, bytes=gvecs_bytes)
            with TELEM.timer("merge", stats):
                out = self.assemble_results(kslot, kscore, kok)
            TELEM.record_query(stats)
            return out

        # metadata filter: the beam on the device, the mask and the rescore
        # of the whole beam on the host
        entry = torch.full((b,), self._entry, dtype=torch.int32, device=self.device)
        nbrs0, lookup0 = self._sync_layer_device(0)
        hi, steps = self._hi_layers()
        for (nbrs, lookup), st in zip(hi, steps):
            entry = gops.greedy_descent(qg, gv, sqn, nbrs, lookup, entry, steps=st)
        beam = gops.beam_search(qg, gv, sqn, nbrs0, lookup0, entry, ef=ef, iters=iters,
                                expand=SEARCH_EXPAND)
        # exclude tombstones (allow-bitset, reference :112-119) + final top-k
        ids = beam.ids.cpu().numpy()
        dists = beam.dists.cpu().numpy()
        okb = (ids != INVALID_ID) & (ids >= 0)
        safe = np.where(okb, ids, 0)
        allow = np.where(okb, self._valid[safe], False)
        v = self._vectors[safe]  # [B, ef, d]
        if self.metric == Metric.L2:
            scores = np.linalg.norm(v - q[:, None, :], axis=-1)
        elif self.metric == Metric.INNER_PRODUCT:
            scores = np.einsum("bed,bd->be", v, q)
        else:
            vn = v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-30)
            qn = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-30)
            scores = np.einsum("bed,bd->be", vn, qn)
        out: list[list[SearchResult]] = []
        for i in range(b):
            order = np.argsort(np.where(allow[i], dists[i], np.inf), kind="stable")
            row: list[SearchResult] = []
            seen: set[int] = set()
            for j in order:
                if not allow[i, j]:
                    break
                slot = int(ids[i, j])
                if slot in seen:
                    continue
                seen.add(slot)
                meta = self._metadata[slot]
                if not filter(meta):
                    continue
                row.append(SearchResult(id=self._idmap.external_for(slot),
                                        score=float(scores[i, j]), metadata=meta))
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
    ):
        return self.batch_search(
            np.asarray(query)[None, :], k, filter, allow_ids=allow_ids, deny_ids=deny_ids
        )[0]

    # ------------------------------------------------------------------
    # maintenance / stats / persistence
    # ------------------------------------------------------------------

    def compact(self) -> None:
        """Rebuild the graph from live records by reinsertion (the load
        path's contract; reference compact() remaps, :783-857)."""
        live = [
            (ext, self._vectors[slot].copy(), self._metadata[slot])
            for ext, slot in sorted(self._idmap.items(), key=lambda kv: kv[1])
        ]
        self.__init__(self.dimension, self.metric, self.config, device=self.device)
        for ext, v, meta in live:
            self.insert(ext, v, meta)
        self._ensure_built()

    def statistics(self) -> IndexStats:
        self._ensure_built()
        l0 = self._layers[0]
        deg = float((l0.nbrs[: l0.count] >= 0).sum(axis=1).mean()) if l0.count else 0.0
        return IndexStats(
            count=self.count,
            dimension=self.dimension,
            metric=self.metric.value,
            memory_bytes=int(self._vectors.nbytes + sum(layer.nbrs.nbytes for layer in self._layers)),
            details={
                "max_level": len(self._layers) - 1,
                "avg_degree_l0": deg,  # reference avgDegreeL0 (:374-395)
                "m": self.config.m,
                "ef_construction": self.config.ef_construction,
                "ef_search": self.config.ef_search,
                "entry_point": self._entry,
                "pending": len(self._pending),
            },
        )

    def save(self, path: str) -> None:
        """Flat records and every HNSWConfig field; load rebuilds the graph
        by reinsertion (reference HNSWIndex.swift:755-781)."""
        records = [
            PersistedRecord(id=ext, vector=self._vectors[slot], metadata=self._metadata[slot])
            for ext, slot in sorted(self._idmap.items(), key=lambda kv: kv[1])
        ]
        save_snapshot(path, PersistedIndex(type=self.TYPE, dimension=self.dimension,
                                           metric=self.metric.value, records=records,
                                           config=asdict(self.config)))

    def save_container(self, path: str) -> None:
        raise NotImplementedError(
            "HNSWIndex.save_container is not ported yet (ROADMAP.md Queue 1 item 9: "
            "persistence)"
        )

    @classmethod
    def load_container(cls, path: str, device="cuda") -> "HNSWIndex":
        raise NotImplementedError(
            "HNSWIndex.load_container is not ported yet (ROADMAP.md Queue 1 item 9: "
            "persistence)"
        )

    @classmethod
    def load(cls, path: str, device="cuda") -> "HNSWIndex":
        """A missing config key reads as the JAX load reads it (its
        ef_construction default is 100)."""
        snap = load_snapshot(path, expected_type=cls.TYPE)
        c = snap.config
        defaults = {f.name: f.default for f in fields(HNSWConfig)}
        defaults["ef_construction"] = 100
        cfg = HNSWConfig(**{name: c.get(name, default) for name, default in defaults.items()})
        idx = cls(snap.dimension, Metric(snap.metric), cfg, device=device)
        for r in snap.records:
            idx.insert(r.id, r.vector, r.metadata)
        idx._ensure_built()
        return idx
