"""Durable IVF storage: the binary container as the checkpoint, and a
WAL-appended journal of the mutations made since.

Counterpart of vectorindex_tpu.persistence.durable (parity target: the
reference's IVFIndex.enableKernel30Storage, IVFIndex.swift:103-144, with
crash-consistent appends through the WAL, SURVEY.md §5.3/5.4), in the same
layout and journal format, so a container written by either package loads
in the other.

Layout:
  META        json: {type, dimension, metric, config, storage_dtype,
              next_slot, trained[, pq]}
  CENTROIDS   [kc, d] f32 (present iff trained)
  VECS        trained: the f32 rows of the lists in CSR order, list after
              list with no gaps [n_rows, d]; untrained: the rows by slot
  IDS         row ids [n_rows] i32 (the slot of each VECS row)
  IDS nth=1   (IVF-PQ with spill) the spill copies [n_spill, 2] i32:
              (slot, spill list); every other row of a slot is its primary
  LISTS_DESC  [kc, 2] i32 (start, length) into VECS/IDS
  CODEBOOKS   (IVF-PQ, once PQ is trained) [m, ks·dsub] f32
  IDMAP       blob (external↔internal mapping + tombstones)
  TOMBSTONES  [n_free] i32 free slots, in the index's order
  TELEMETRY   metadata json {slot: metadata}
  FREELIST    the journal: a growable record stream (WAL-durable appends)

Journal records (little-endian):
  u32 kind (1=insert, 2=remove, 3=update_vec, 4=set_metadata) | i32 slot |
  i32 list | u32 ext_len | u32 meta_len | ext_id json bytes |
  metadata json bytes | f32 vec[d] (kinds 1,3 only)

Where the port differs from the JAX package (whose loader reads what it
knows and ignores the rest):
  - META's config holds every config field (spill_eps, host_rerank...) and
    META holds storage_dtype; a missing storage_dtype reads as float32 and a
    missing config field as its default (spill_eps 0.0), as the JAX loader
    reads them. The JAX writer keeps neither, so there a bf16 index reloads
    as f32 and a spill index reloads with both copies of every spilled row
    and dedup off.
  - A spill index records which copy of each row is the spill (IDS nth=1),
    and replaying a journaled update or remove moves or drops the spill copy
    as the live index did, so a reload holds each slot's primary and spill
    lists and searches without duplicate ids.
  - The loader rebuilds the lists in bulk (IVFListStore.append_batch), in
    the saved order, not row by row.
  - A checkpoint is written beside the container and renamed over it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from vectorindex_tpu_torch.persistence.container import Container, SectionType
from vectorindex_tpu_torch.persistence.container_index import read_meta
from vectorindex_tpu_torch.utils.errors import ErrorBuilder, IndexErrorKind

if TYPE_CHECKING:
    from vectorindex_tpu_torch.models.ivf import IVFIndex

REC_INSERT = 1
REC_REMOVE = 2
REC_UPDATE = 3
REC_META = 4

_REC_HEAD = "<IiiII"

#: WAL bytes of a durable container: at 32 B a record and at least two
#: records an append, about 65k journaled mutations between checkpoints
JOURNAL_CAPACITY = 1 << 22


def _journal_record(kind: int, slot: int, list_id: int, ext_id, vec: Optional[np.ndarray],
                    metadata=None) -> np.ndarray:
    ext = json.dumps(ext_id).encode() if ext_id is not None else b""
    meta = json.dumps(metadata).encode() if metadata is not None else b""
    head = struct.pack(_REC_HEAD, kind, slot, list_id, len(ext), len(meta))
    body = np.asarray(vec, dtype="<f4").tobytes() if vec is not None else b""
    return np.frombuffer(head + ext + meta + body, dtype=np.uint8)


def _csr_rows(starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Row indices of every list's live rows, list after list."""
    total = int(lengths.sum())
    base = np.repeat(starts.astype(np.int64) - np.cumsum(lengths) + lengths, lengths)
    return base + np.arange(total, dtype=np.int64)


def save_ivf_container(idx: "IVFIndex", path: str, journal_capacity: int = JOURNAL_CAPACITY) -> None:
    """Write a full checkpoint (the canonical binary format, SURVEY.md §5.4)."""
    from vectorindex_tpu_torch.models.flat import _dtype_name

    meta = {
        "type": idx.TYPE,
        "dimension": idx.dimension,
        "metric": idx.metric.value,
        "config": dataclasses.asdict(idx.config),
        "storage_dtype": _dtype_name(idx.storage_dtype),
        "next_slot": idx._next_slot,
        "trained": idx.trained,
    }
    books = getattr(idx, "_books", None)
    if books is not None:
        meta["pq"] = {"m": int(books.m), "ks": int(books.ks), "dsub": int(books.dsub)}

    with Container.create(path, wal_capacity=journal_capacity) as c:
        c.add_blob(SectionType.META, json.dumps(meta).encode())
        if idx.trained:
            c.add_array(SectionType.CENTROIDS, np.asarray(idx._centroids, dtype=np.float32))
            p = idx._store.packed()  # host CSR mirror: the f32 rows; uploads nothing
            rows = _csr_rows(p["starts"], p["lengths"])
            c.add_array(SectionType.VECS, p["vecs"][rows])
            c.add_array(SectionType.IDS, p["row_ids"][rows].astype(np.int32))
            starts = np.concatenate([[0], np.cumsum(p["lengths"])[:-1]])
            c.add_array(SectionType.LISTS_DESC,
                        np.stack([starts, p["lengths"]], axis=1).astype(np.int32))
            if getattr(idx, "_spill", False):
                spill = getattr(idx, "_slot_spill", {})
                c.add_array(SectionType.IDS, np.asarray(
                    sorted(spill.items()), dtype=np.int32).reshape(-1, 2))
        else:
            slots = sorted(idx._vectors.keys())
            vecs = (np.stack([idx._vectors[s] for s in slots]) if slots
                    else np.zeros((0, idx.dimension), np.float32))
            c.add_array(SectionType.VECS, vecs.astype(np.float32, copy=False))
            c.add_array(SectionType.IDS, np.asarray(slots, dtype=np.int32))
        if books is not None:
            c.add_array(SectionType.CODEBOOKS,
                        books.centroids.detach().float().cpu().numpy().reshape(books.m, -1))
        c.add_blob(SectionType.IDMAP, idx._idmap.to_blob())
        c.add_array(SectionType.TOMBSTONES, np.asarray(idx._free, dtype=np.int32))
        metas = {str(slot): m for slot, m in idx._metadata.items() if m is not None}
        c.add_blob(SectionType.TELEMETRY, json.dumps(metas).encode())
        c.add_array(SectionType.FREELIST, np.zeros((0,), dtype=np.uint8),
                    capacity_bytes=1 << 16)
        # close() recomputes the section CRCs and syncs the whole map


def save_ivf_checkpoint(idx: "IVFIndex", path: str) -> None:
    """save_ivf_container into a file beside `path`, renamed over it once
    complete: a crash mid-checkpoint leaves the previous container."""
    tmp = f"{path}.checkpoint"
    save_ivf_container(idx, tmp)
    os.replace(tmp, path)


def append_journal(c: Container, kind: int, slot: int, list_id: int, vec, ext_id=None,
                   metadata=None) -> None:
    """Crash-consistent mutation append (reference durable ivf_append via
    the IndexMmap WAL)."""
    c.append(SectionType.FREELIST,
             _journal_record(kind, slot, list_id, ext_id, vec, metadata=metadata))


def _config_from(cls, cfg_d: dict):
    """The config from META: a missing field takes its default (the JAX
    loader's reading: spill_eps 0.0, host_rerank False, ...)."""
    return cls._CONFIG(**{f.name: cfg_d.get(f.name, f.default)
                          for f in dataclasses.fields(cls._CONFIG)})


def load_ivf_container(path: str, device="cuda") -> "IVFIndex":
    """Open + WAL replay + rebuild the index state + journal replay."""
    from vectorindex_tpu_torch.models.flat import _STORAGE_DTYPES
    from vectorindex_tpu_torch.models.ivf import IVFIndex, IVFPQIndex
    from vectorindex_tpu_torch.ops import pq as pq_ops
    from vectorindex_tpu_torch.ops.idmap import IDMap
    from vectorindex_tpu_torch.utils.config import Metric

    with Container.open(path) as c:
        c.verify_all()
        meta = read_meta(c)
        d = int(meta["dimension"])
        cfg_d = meta["config"]
        is_pq = meta["type"] == "ivfpq" or ("m" in cfg_d and "ks" in cfg_d and meta.get("pq"))
        cls = IVFPQIndex if is_pq else IVFIndex
        idx = cls(d, Metric(meta["metric"]), _config_from(cls, cfg_d),
                  storage_dtype=_STORAGE_DTYPES[meta.get("storage_dtype", "float32")],
                  device=device)
        idx._idmap = IDMap.from_blob(c.read_blob(SectionType.IDMAP))
        idx._next_slot = int(meta["next_slot"])
        idx._free = [int(s) for s in c.read_array(SectionType.TOMBSTONES)]
        for k, v in json.loads(c.read_blob(SectionType.TELEMETRY)).items():
            idx._metadata[int(k)] = v

        vecs = np.array(c.read_array(SectionType.VECS), dtype=np.float32).reshape(-1, d)
        row_ids = np.array(c.read_array(SectionType.IDS), dtype=np.int64)
        if meta["trained"]:
            idx._set_centroids(np.array(c.read_array(SectionType.CENTROIDS)).reshape(-1, d))
            desc = np.array(c.read_array(SectionType.LISTS_DESC), dtype=np.int64).reshape(-1, 2)
            rows = _csr_rows(desc[:, 0], desc[:, 1])
            if not np.array_equal(rows, np.arange(rows.shape[0])):
                vecs, row_ids = vecs[rows], row_ids[rows]  # a file with gaps
            lists = np.repeat(np.arange(desc.shape[0], dtype=np.int64), desc[:, 1])
            spill = np.full(max(idx._next_slot, 1), -1, dtype=np.int64)
            if is_pq and idx._spill and c.find(SectionType.IDS, 1) >= 0:
                sp = np.array(c.read_array(SectionType.IDS, 1), dtype=np.int64).reshape(-1, 2)
                spill[sp[:, 0]] = sp[:, 1]
                idx._slot_spill = dict(zip(sp[:, 0].tolist(), sp[:, 1].tolist()))
            primary = spill[row_ids] != lists
            idx._store.append_batch(lists, row_ids, vecs)
            idx._slot_list = dict(zip(row_ids[primary].tolist(), lists[primary].tolist()))
            prim_vecs = vecs if primary.all() else vecs[primary]
            idx._vectors = dict(zip(row_ids[primary].tolist(), prim_vecs))
            if is_pq and meta.get("pq") and c.find(SectionType.CODEBOOKS) >= 0:
                pq = meta["pq"]
                cents = np.array(c.read_array(SectionType.CODEBOOKS), dtype=np.float32)
                idx._books = pq_ops.books_from_centroids(
                    torch.from_numpy(cents.reshape(pq["m"], pq["ks"], pq["dsub"])).to(idx.device))
        else:
            idx._vectors = dict(zip(row_ids.tolist(), vecs))
        journal = c.read_array(SectionType.FREELIST).tobytes()

    _replay_journal(idx, journal, d)
    # A post-checkpoint insert may have reused a slot that the checkpointed
    # TOMBSTONES still lists as free: drop live slots and duplicates from the
    # free list, keeping its order (else a later insert overwrites a live row).
    seen: set = set()
    free = []
    for s in idx._free:
        if s not in idx._vectors and s not in seen:
            seen.add(s)
            free.append(s)
    idx._free = free
    if idx._vectors and idx._next_slot <= max(idx._vectors):
        raise (
            ErrorBuilder(IndexErrorKind.CORRUPT_DATA)
            .message(f"durable container {path}: next_slot behind a live slot")
            .build()
        )
    return idx


def _replay_journal(idx: "IVFIndex", journal: bytes, d: int) -> None:
    """Apply the journaled mutations in order, as the live index made them."""
    spill = getattr(idx, "_spill", False) and idx.trained
    off = 0
    rec_head = struct.calcsize(_REC_HEAD)
    while off + rec_head <= len(journal):
        kind, slot, list_id, ext_len, meta_len = struct.unpack_from(_REC_HEAD, journal, off)
        off += rec_head
        ext_id = json.loads(journal[off: off + ext_len].decode()) if ext_len else None
        off += ext_len
        metadata = json.loads(journal[off: off + meta_len].decode()) if meta_len else None
        off += meta_len
        if kind in (REC_INSERT, REC_UPDATE):
            v = np.frombuffer(journal, dtype="<f4", count=d, offset=off).astype(np.float32)
            off += 4 * d
            idx._vectors[slot] = v
            if metadata is not None:
                idx._metadata[slot] = metadata
            if kind == REC_INSERT and ext_id is not None:
                idx._idmap.append(ext_id, slot)
                idx._next_slot = max(idx._next_slot, slot + 1)
            if kind == REC_UPDATE:
                if spill:
                    idx._drop_spill(slot)
                if slot in idx._slot_list:
                    idx._store.remove(idx._slot_list.pop(slot), slot)
            if idx.trained and list_id >= 0:
                idx._store.append(list_id, slot, v)
                idx._slot_list[slot] = list_id
                if spill:
                    idx._append_spill([slot], v[None, :])
        elif kind == REC_REMOVE:
            if ext_id is not None and ext_id in idx._idmap:
                idx._idmap.erase(ext_id)
            if spill:
                idx._drop_spill(slot)
            idx._vectors.pop(slot, None)
            idx._metadata.pop(slot, None)
            idx._free.append(slot)
            lst = idx._slot_list.pop(slot, None)
            if lst is not None:
                idx._store.remove(lst, slot)
        elif kind == REC_META:
            idx._metadata[slot] = metadata
        else:
            break
