"""Sharded HNSW: independent per-shard graphs + a top-k merge.

Counterpart of vectorindex_tpu.parallel.sharded_hnsw (BASELINE config 5:
an HNSW graph per shard with a cross-shard top-k merge). The corpus shards
by contiguous row range; each shard is one HNSWIndex of the port built on
its own device, and its level-0 table is re-rowed (local row → local
neighbor rows) and padded to a common row count. A query batch runs the
port's batched beam (ops/graph.beam_search) from each shard's entry point
on its device, the local rows map to global ids, and the per-shard top-k
lists merge on the mesh's first device under the strict (score, id)
contract (parallel/sharded_search.gather_merge).

Inner product routes by ONE virtual R² across the shards: a per-shard R²
would make the routed distances ‖q‖² + R² − 2⟨q, x⟩ incomparable at the
merge.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from vectorindex_tpu_torch.ops import graph as gops
from vectorindex_tpu_torch.ops.topk import INVALID_DIST, INVALID_ID, topk
from vectorindex_tpu_torch.parallel.mesh import DATA_AXIS, Mesh
from vectorindex_tpu_torch.parallel.sharded_search import gather_merge
from vectorindex_tpu_torch.utils.config import Metric

Tensor = torch.Tensor


class ShardedHNSWState(NamedTuple):
    """Per-shard level-0 graph state; each field holds one entry a shard,
    on that shard's device."""

    vecs: tuple  # [rows_pad, d] graph-space vectors (dead rows zero)
    sqn: tuple  # [rows_pad] routed squared norms (+inf dead rows)
    nbrs: tuple  # [rows_pad, deg] local neighbor rows (-1 empty)
    entries: tuple  # int: the local entry row of each shard
    row_global: tuple  # [rows_pad] int64: local row -> global id (-1 dead)


def build_sharded_hnsw(
    x: np.ndarray,
    mesh_size: int,
    metric: Metric = Metric.L2,
    config=None,
    global_ids: Optional[np.ndarray] = None,
    devices=None,
) -> ShardedHNSWState:
    """Contiguous row partition, one HNSWIndex a shard built on its device
    (`devices`, one a shard; default: "cuda" for each), its level-0 table
    extracted, re-rowed, padded and placed there. The builds run one after
    another (one process)."""
    from vectorindex_tpu_torch.models.hnsw import HNSWConfig, HNSWIndex

    cfg = config or HNSWConfig()
    devs = [torch.device(d) for d in (devices or ["cuda"] * mesh_size)]
    if len(devs) != mesh_size:
        raise ValueError(f"{len(devs)} devices for {mesh_size} shards")
    n, d = x.shape
    if global_ids is None:
        global_ids = np.arange(n, dtype=np.int64)
    bounds = np.linspace(0, n, mesh_size + 1).astype(np.int64)

    per = []
    rows_max = 0
    r2_global = 0.0
    for s in range(mesh_size):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        idx = HNSWIndex(d, metric, cfg, device=devs[s])
        idx.insert_batch([str(i) for i in range(hi - lo)], x[lo:hi])
        idx._ensure_built()
        layer0 = idx._layers[0]
        rows = layer0.count
        rows_max = max(rows_max, rows)
        r2_global = max(r2_global, idx._r2)
        # slot-id edges -> local-row edges
        nbrs_slots = layer0.nbrs[:rows]
        nbrs_rows = np.where(
            nbrs_slots >= 0, idx._lookup0[np.maximum(nbrs_slots, 0)], -1
        ).astype(np.int32)
        node_slots = np.asarray(layer0.node_ids, dtype=np.int64)
        gvecs = idx._graph_vecs[node_slots]
        per.append((
            gvecs,  # [rows, d] graph space
            np.einsum("rd,rd->r", gvecs, gvecs).astype(np.float32),
            nbrs_rows,
            int(idx._lookup0[idx._entry]),
            global_ids[lo:hi][node_slots],
        ))
    if metric == Metric.INNER_PRODUCT:
        per = [
            (v, np.full_like(sq, np.float32(r2_global)), nb, ent, gl)
            for (v, sq, nb, ent, gl) in per
        ]

    rp = max(8, 1 << (rows_max - 1).bit_length())
    deg = per[0][2].shape[1]
    out = ([], [], [], [], [])
    for dev, (v, sq, nb, ent, gl) in zip(devs, per):
        r = v.shape[0]
        vecs = np.zeros((rp, d), np.float32)
        sqn = np.full((rp,), np.inf, np.float32)
        nbrs = np.full((rp, deg), -1, np.int32)
        row_global = np.full((rp,), -1, np.int64)
        vecs[:r], sqn[:r], nbrs[:r], row_global[:r] = v, sq, nb, gl
        for acc, a in zip(out, (vecs, sqn, nbrs, None, row_global)):
            acc.append(ent if a is None else torch.from_numpy(a).to(dev))
    return ShardedHNSWState(*(tuple(a) for a in out))


def sharded_hnsw_search(
    mesh: Mesh,
    q: Tensor,  # [B, d] graph-space queries
    state: ShardedHNSWState,
    *,
    ef: int,
    iters: int,
    k: int,
    expand: int = 4,
    axis: str = DATA_AXIS,
):
    """Queries × per-shard subgraphs → merged global top-k.

    Returns (dist [B, k] routed-space ascending, global ids [B, k]) on the
    mesh's first device. Per shard: the batched beam from the shard's entry
    → local top-k → the partials' gather and the strict (score, id)
    merge."""
    parts = []
    for s, dev in enumerate(mesh.axis_devices(axis)):
        qs = q.to(dev).float()
        b = qs.shape[0]
        beam = gops.beam_search(
            qs, state.vecs[s], state.sqn[s], state.nbrs[s], None,
            torch.full((b,), state.entries[s], dtype=torch.int32, device=dev),
            ef=ef, iters=iters, expand=expand,
        )
        # local rows -> global ids; dead/INVALID rows stay INVALID
        dead = beam.ids == INVALID_ID
        gl = state.row_global[s][torch.clamp_min(beam.ids, 0).long()].to(torch.int32)
        gl = torch.where(dead, INVALID_ID, gl)
        dist = torch.where(dead, INVALID_DIST, beam.dists)
        parts.append(topk(dist, k, ids=gl, strict_ties=True))
    return gather_merge(parts, mesh.first, k)
