"""Binary-container persistence for the Flat and HNSW indexes.

Counterpart of vectorindex_tpu.persistence.container_index, in the same
section layout, so a container written by either package loads in the
other. The reference persists Flat/HNSW as JSON records and rebuilds the
HNSW graph by reinsertion on load (HNSWIndex.swift:755-781); here the graph
itself (per-layer neighbor tables, node tables, levels, entry point) is
restored from sections, with no construction step.

Sections:
  META          json blob: type/dimension/metric/config/counters
  VECS          raw vectors [next_slot, d] f32
  TOMBSTONES    live mask [next_slot] u8
  NORMS_SQ      (Flat) ||x||^2 [next_slot] f32, the persisted norm cache
  IDMAP         external<->slot blob (ops/idmap)
  TELEMETRY     metadata json blob (aligned with slots)
  GRAPH_NBRS    (HNSW, nth=layer) fixed-degree neighbor tables i32
  GRAPH_NODES   (HNSW, nth=layer) row -> slot tables i32
  LEVELS        (HNSW) per-slot level i32

The port writes more into META than the JAX package reads, and reads a
missing key as the JAX loader does:
  - Flat: "storage_dtype" (missing: float32; the JAX package writes none, so
    a bf16 index reloads there as f32) and "capacity" (missing: next_slot);
    the free list keeps its order, so slots are reused as before the save.
  - HNSW: every HNSWConfig field, and "layer_backings", each layer's
    neighbor-table rows, so the device tables keep their shape (missing: the
    live index's power-of-two rule).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from vectorindex_tpu_torch.persistence.container import Container, SectionType
from vectorindex_tpu_torch.utils.config import Metric
from vectorindex_tpu_torch.utils.errors import ErrorBuilder, IndexErrorKind


def _json(obj) -> bytes:
    return json.dumps(obj).encode()


def _metadata_blob(metadata_list, n) -> bytes:
    return json.dumps([metadata_list[i] for i in range(n)]).encode()


def _check_type(meta: dict, expected: str):
    if meta.get("type") != expected:
        raise (
            ErrorBuilder(IndexErrorKind.CORRUPT_DATA)
            .message(f"container holds a {meta.get('type')!r} index, expected {expected!r}")
            .build()
        )


def _next_pow2(n: int) -> int:
    """The slot capacity an index grown from 1,024 has at n slots."""
    return 1 << max(10, (max(n, 1) - 1).bit_length())


def read_meta(c: Container) -> dict:
    """The META section as a dict; one that does not parse is CORRUPT_DATA."""
    try:
        return json.loads(c.read_blob(SectionType.META))
    except ValueError as e:
        raise (
            ErrorBuilder(IndexErrorKind.CORRUPT_DATA)
            .message("container META section is unparseable")
            .caused_by(e)
            .build()
        ) from e


# ---------------------------------------------------------------------------
# FlatIndex
# ---------------------------------------------------------------------------


def save_flat_container(idx, path: str) -> None:
    from vectorindex_tpu_torch.models.flat import _dtype_name

    n = idx._next_slot
    with Container.create(path) as c:
        c.add_blob(SectionType.META, _json({
            "type": "flat",
            "dimension": idx.dimension,
            "metric": idx.metric.value,
            "next_slot": n,
            "free": [int(s) for s in idx._free],
            "storage_dtype": _dtype_name(idx.storage_dtype),
            "capacity": idx.capacity,
        }))
        c.add_array(SectionType.VECS, idx._vectors[:n])
        c.add_array(SectionType.TOMBSTONES, idx._valid[:n].astype(np.uint8))
        # the norm cache (reference NormCacheHeader, Norms.swift:244), by
        # the index's own formula: a pre-warmed mirror equals a recomputed one
        c.add_array(SectionType.NORMS_SQ, idx._sqnorms()[:n])
        c.add_blob(SectionType.IDMAP, idx._idmap.to_blob())
        c.add_blob(SectionType.TELEMETRY, _metadata_blob(idx._metadata, n))


def load_flat_container(path: str, device="cuda"):
    from vectorindex_tpu_torch.models.flat import _STORAGE_DTYPES, FlatIndex
    from vectorindex_tpu_torch.ops.idmap import IDMap

    with Container.open(path) as c:
        c.verify_all()
        meta = read_meta(c)
        _check_type(meta, "flat")
        n, d = int(meta["next_slot"]), int(meta["dimension"])
        idx = FlatIndex(
            d, Metric(meta["metric"]), capacity=max(int(meta.get("capacity", n)), n, 1),
            storage_dtype=_STORAGE_DTYPES[meta.get("storage_dtype", "float32")], device=device,
        )
        if n:
            idx._vectors[:n] = c.read_array(SectionType.VECS).reshape(n, d)
            idx._valid[:n] = c.read_array(SectionType.TOMBSTONES).astype(bool)
        idx._idmap = IDMap.from_blob(c.read_blob(SectionType.IDMAP))
        for i, m in enumerate(json.loads(c.read_blob(SectionType.TELEMETRY))):
            idx._metadata[i] = m
        idx._next_slot = n
        idx._free = [int(s) for s in meta["free"]]
        if n and c.find(SectionType.NORMS_SQ) >= 0:
            # pre-warm the device mirror from the persisted norm cache; the
            # pad rows are zero vectors, whose norms are exactly 0. Any later
            # mutation drops the mirror, so nothing can go stale.
            sqn = np.zeros(idx.capacity, np.float32)
            sqn[:n] = c.read_array(SectionType.NORMS_SQ)  # a copy: the view dies with c
            idx._sync_device(sqn)
        return idx


# ---------------------------------------------------------------------------
# HNSWIndex
# ---------------------------------------------------------------------------


def save_hnsw_container(idx, path: str) -> None:
    idx._ensure_built()  # persist a fully-constructed graph
    n = idx._next_slot
    with Container.create(path) as c:
        c.add_blob(SectionType.META, _json({
            "type": "hnsw",
            "dimension": idx.dimension,
            "metric": idx.metric.value,
            "config": dataclasses.asdict(idx.config),
            "next_slot": n,
            "entry": idx._entry,
            "r2": idx._r2,
            "level_counter": idx._level_counter,
            "n_layers": len(idx._layers),
            "layer_degrees": [l.max_degree for l in idx._layers],
            "layer_backings": [int(l.nbrs.shape[0]) for l in idx._layers],
        }))
        c.add_array(SectionType.VECS, idx._vectors[:n])
        c.add_array(SectionType.TOMBSTONES, idx._valid[:n].astype(np.uint8))
        c.add_array(SectionType.LEVELS, idx._levels[:n].astype(np.int32))
        for layer in idx._layers:
            c.add_array(SectionType.GRAPH_NBRS, np.ascontiguousarray(layer.nbrs[: layer.count]))
            c.add_array(SectionType.GRAPH_NODES, np.asarray(layer.node_ids, dtype=np.int32))
        c.add_blob(SectionType.IDMAP, idx._idmap.to_blob())
        c.add_blob(SectionType.TELEMETRY, _metadata_blob(idx._metadata, n))


def _backing_rows(rows: int) -> int:
    """Neighbor-table rows of a live layer of `rows` nodes (_Level.add_node's
    power-of-two rule)."""
    return 0 if rows == 0 else max(64, 1 << (rows - 1).bit_length())


def load_hnsw_container(path: str, device="cuda"):
    from vectorindex_tpu_torch.models.hnsw import HNSWConfig, HNSWIndex, _Level
    from vectorindex_tpu_torch.ops.idmap import IDMap

    with Container.open(path) as c:
        c.verify_all()
        meta = read_meta(c)
        _check_type(meta, "hnsw")
        known = {f.name for f in dataclasses.fields(HNSWConfig)}
        cfg = HNSWConfig(**{k: v for k, v in meta["config"].items() if k in known})
        d, n = int(meta["dimension"]), int(meta["next_slot"])
        idx = HNSWIndex(d, Metric(meta["metric"]), cfg, device=device)
        cap = _next_pow2(n)
        idx._vectors = np.zeros((cap, d), dtype=np.float32)
        idx._graph_vecs = np.zeros((cap, d), dtype=np.float32)
        idx._valid = np.zeros((cap,), dtype=bool)
        idx._levels = np.full((cap,), -1, dtype=np.int32)
        idx._lookup0 = np.full((cap,), -1, dtype=np.int32)
        idx._metadata = [None] * cap
        if n:
            idx._vectors[:n] = c.read_array(SectionType.VECS).reshape(n, d)
            idx._valid[:n] = c.read_array(SectionType.TOMBSTONES).astype(bool)
            idx._levels[:n] = c.read_array(SectionType.LEVELS)
            idx._graph_vecs[:n] = idx._to_graph_space(idx._vectors[:n])
        idx._next_slot = n
        idx._entry = int(meta["entry"])
        idx._r2 = float(meta["r2"])
        idx._level_counter = int(meta["level_counter"])
        backings = meta.get("layer_backings")
        idx._layers = []
        for li in range(int(meta["n_layers"])):
            layer = _Level(int(meta["layer_degrees"][li]))
            nodes = c.read_array(SectionType.GRAPH_NODES, nth=li).astype(np.int64)
            rows = nodes.shape[0]
            layer.node_ids = nodes.tolist()
            bcap = int(backings[li]) if backings is not None else _backing_rows(rows)
            layer.nbrs = np.full((max(bcap, rows), layer.max_degree), -1, np.int32)
            if rows:
                layer.nbrs[:rows] = c.read_array(SectionType.GRAPH_NBRS, nth=li).reshape(
                    rows, layer.max_degree)
            if li == 0 and rows:
                idx._lookup0[nodes] = np.arange(rows, dtype=np.int32)
            idx._layers.append(layer)
        if not idx._layers:
            idx._layers = [_Level(2 * cfg.m)]
        idx._idmap = IDMap.from_blob(c.read_blob(SectionType.IDMAP))
        for i, m in enumerate(json.loads(c.read_blob(SectionType.TELEMETRY))):
            idx._metadata[i] = m
        return idx
