"""Sharded exact search: per-shard scan + deterministic top-k merge.

Counterpart of vectorindex_tpu.parallel.sharded_search (parity targets: the
reference's partition-then-merge, IVFSelect.swift:127-145 partitions rows
across threads and TopKMerge.swift:11 merges the partials; SURVEY.md §2.4).

Each shard scores its rows on its own device and keeps a local top-k with
global ids (shard s, row j → s·n_shard + j); the [S, B, k] partials are
copied to the mesh's first device (the all-gather's counterpart) and merged
under the strict (score, id) contract (ops/topk.merge_topk). No
torch.distributed: one process enqueues every shard's work.

Each shard scores its rows in blocks of min(SCAN_BLOCK, n_shard) rows and
keeps each block's top-k. A block's products have the same shape wherever
the block lies, so where the shard sizes are multiples of SCAN_BLOCK the
results are equal bit for bit whatever the shard count (and the [B, N]
distance block is never held whole).
"""

from __future__ import annotations

import torch

from vectorindex_tpu_torch.ops import scoring
from vectorindex_tpu_torch.ops.topk import merge_topk, topk_padded
from vectorindex_tpu_torch.parallel.mesh import DATA_AXIS, REPLICA_AXIS, Mesh, shard_rows
from vectorindex_tpu_torch.utils.config import Metric

Tensor = torch.Tensor

#: rows a shard scores in one product
SCAN_BLOCK = 65536


def gather_merge(parts, device, k: int):
    """[(dist [B, k_s], ids [B, k_s]) per shard] → merged (dist [B, k],
    ids [B, k]) on `device`: the partials' copy (the all-gather) and the
    strict (score, id) merge."""
    d = torch.stack([p[0].to(device) for p in parts], dim=1)  # [B, S, k]
    i = torch.stack([p[1].to(device) for p in parts], dim=1)
    return merge_topk(d, i, k)


def _shard_topk(q, x, valid, sqn, inv, metric: Metric, k: int, offset: int):
    """Local top-k of one shard with global ids offset + row."""
    n = x.shape[0]
    block = min(SCAN_BLOCK, n)
    parts = []
    for start in range(0, n, block):
        stop = min(start + block, n)
        norms = scoring.NormCache(
            sq=None if sqn is None else sqn[start:stop],
            inv=None if inv is None else inv[start:stop],
        )
        dist = scoring.distance_block(q, x[start:stop], metric, norms=norms)
        ids = torch.arange(offset + start, offset + stop, dtype=torch.int32, device=x.device)
        ok = torch.ones_like(ids, dtype=torch.bool) if valid is None else valid[start:stop]
        # ids ascend with the row, so ties by position are ties by id
        parts.append(topk_padded(dist, ok[None, :], k, ids=ids[None, :], strict_ties=False))
    if len(parts) == 1:
        return parts[0]
    return gather_merge(parts, x.device, k)


def _shards(mesh: Mesh, t, axis: str):
    return None if t is None else shard_rows(mesh, t, axis).shards


def sharded_flat_search(
    mesh: Mesh,
    q: Tensor,
    x,
    valid,
    k: int,
    metric: Metric = Metric.L2,
    x_sqnorms=None,
    x_invnorms=None,
    axis: str = DATA_AXIS,
):
    """Exact top-k over a row-sharded corpus.

    q: [B, d]. x: [N, d] as a tensor or ShardedRows (N divisible by the
    axis size; use pad_rows and a valid mask); valid, x_sqnorms, x_invnorms
    [N] alike, or None. Returns (dist [B, k], global ids [B, k]) on the
    mesh's first device, ascending distances."""
    xs = shard_rows(mesh, x, axis).shards
    vs, ss, iv = (_shards(mesh, t, axis) for t in (valid, x_sqnorms, x_invnorms))
    parts = []
    offset = 0
    for s, xl in enumerate(xs):
        parts.append(_shard_topk(
            q.to(xl.device), xl, None if vs is None else vs[s],
            None if ss is None else ss[s], None if iv is None else iv[s], metric, k, offset,
        ))
        offset += xl.shape[0]
    return gather_merge(parts, mesh.first, k)


def make_sharded_search_fn(mesh: Mesh, k: int, metric: Metric, axis: str = DATA_AXIS):
    """Closure for repeated querying: run(q, x, valid, sqn, inv)."""

    def run(q, x, valid, sqn, inv):
        return sharded_flat_search(
            mesh, q, x, valid, k, metric, x_sqnorms=sqn, x_invnorms=inv, axis=axis
        )

    return run


def sharded_flat_search_2d(
    mesh: Mesh,
    q: Tensor,
    x,
    valid,
    k: int,
    metric: Metric = Metric.L2,
    replica_axis: str = REPLICA_AXIS,
    data_axis: str = DATA_AXIS,
):
    """Exact top-k on a 2-D (replica × data) mesh: the corpus shards along
    `data` within each replica group, the query batch splits across
    `replica`, and each group merges its own queries' partials. q: [B, d]
    with B divisible by the replica-axis size. Returns (dist [B, k],
    ids [B, k]) on the mesh's first device, in q's order."""
    grid = mesh.devices if mesh.axis_names.index(replica_axis) == 0 else mesh.devices.T
    n_rep = grid.shape[0]
    if q.shape[0] % n_rep:
        raise ValueError(f"B={q.shape[0]} does not split across {n_rep} replicas")
    per = q.shape[0] // n_rep
    out_d, out_i = [], []
    for r in range(n_rep):
        group = Mesh(grid[r], (data_axis,))
        d, i = sharded_flat_search(group, q[r * per : (r + 1) * per], x, valid, k, metric,
                                   axis=data_axis)
        out_d.append(d.to(mesh.first))
        out_i.append(i.to(mesh.first))
    return torch.cat(out_d), torch.cat(out_i)
