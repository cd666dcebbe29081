"""Sharded IVF: inverted lists partitioned across a device mesh.

Counterpart of vectorindex_tpu.parallel.sharded_ivf (the reference is
single-node; SURVEY.md §5.8 maps its partition-then-merge threading to
this): centroids replicate, the CSR list storage shards by *list* (whole
lists greedily balanced by row count), every shard scores the probed lists
it owns for the whole query batch, and the per-shard top-k lists merge on
the mesh's first device under the strict (score, id) contract.

Search contract: the results of a single-device probed search at the same
nprobe (each probed list lives on exactly one shard; the union of the
shards' candidates is the union of the probes). The JAX functions are XLA
gathers, not kernels, so plain torch is their counterpart here; queries run
in chunks of `query_chunk` to bound the [chunk, nprobe·probe_cap, d] gather.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from vectorindex_tpu_torch.ops import pq as pq_ops
from vectorindex_tpu_torch.ops.dtypes import unpack_u4
from vectorindex_tpu_torch.ops.ivf import IVFListStore, _gram_rows, ivf_select
from vectorindex_tpu_torch.ops.topk import topk_padded
from vectorindex_tpu_torch.parallel.mesh import DATA_AXIS, Mesh
from vectorindex_tpu_torch.parallel.sharded_search import gather_merge
from vectorindex_tpu_torch.utils.config import Metric

Tensor = torch.Tensor


class ShardedIVFArrays(NamedTuple):
    """Per-shard CSR views, shard s on the s-th device of the mesh axis.
    Each field is a tuple with one tensor a shard."""

    vecs: tuple  # [rows_per_shard, d] storage dtype
    row_ids: tuple  # [rows_per_shard] int32 (-1 dead)
    sqnorms: tuple  # [rows_per_shard] f32
    starts: tuple  # [kc] int32 local start (-1: list not on this shard)
    lengths: tuple  # [kc] int32 local length (0 when absent)
    rows_per_shard: int
    codes: Optional[tuple] = None  # [rows_per_shard, m or m//2] PQ codes


def partition_store(
    store: IVFListStore, mesh: Mesh, storage_dtype=torch.float32, codes=None,
    axis: str = DATA_AXIS,
) -> ShardedIVFArrays:
    """Greedy-balance whole lists across shards by row count (longest list
    first, ties by list id), pack each shard's lists contiguously, pad the
    shards to a common row count (a multiple of 128). PQ `codes` in the
    store's CSR layout ([N_pad, m] u8 or packed u4) shard row for row with
    the vectors."""
    devs = mesh.axis_devices(axis)
    s = len(devs)
    p = store.packed()
    lengths = p["lengths"]
    kc = store.n_lists
    order = np.argsort(-lengths, kind="stable")
    shard_rows = np.zeros(s, dtype=np.int64)
    shard_of = np.zeros(kc, dtype=np.int32)
    for l in order:
        t = int(np.argmin(shard_rows))
        shard_of[l] = t
        shard_rows[t] += int(lengths[l])
    rows_per_shard = int(max(1, ((shard_rows.max() + 127) // 128) * 128))

    d = store.dim
    codes_np = None if codes is None else (
        codes.cpu().numpy() if isinstance(codes, torch.Tensor) else np.asarray(codes))
    vecs = np.zeros((s * rows_per_shard, d), dtype=np.float32)
    row_ids = np.full(s * rows_per_shard, -1, dtype=np.int32)
    scodes = (
        None if codes_np is None
        else np.zeros((s * rows_per_shard, codes_np.shape[1]), dtype=codes_np.dtype)
    )
    starts = np.full((s, kc), -1, dtype=np.int32)
    lens = np.zeros((s, kc), dtype=np.int32)
    cursor = np.zeros(s, dtype=np.int64)
    for l in range(kc):
        n = int(lengths[l])
        if n == 0:
            continue
        t = int(shard_of[l])
        src0 = int(p["starts"][l])
        dst0 = t * rows_per_shard + int(cursor[t])
        vecs[dst0 : dst0 + n] = p["vecs"][src0 : src0 + n, :d]
        row_ids[dst0 : dst0 + n] = p["row_ids"][src0 : src0 + n]
        if scodes is not None:
            scodes[dst0 : dst0 + n] = codes_np[src0 : src0 + n]
        starts[t, l] = int(cursor[t])
        lens[t, l] = n
        cursor[t] += n
    sqn = np.einsum("nd,nd->n", vecs, vecs, dtype=np.float32)

    def rows(a, dtype=None):
        r = rows_per_shard
        return tuple(torch.from_numpy(a[i * r : (i + 1) * r]).to(dev, dtype, copy=True)
                     for i, dev in enumerate(devs))

    return ShardedIVFArrays(
        vecs=rows(vecs, storage_dtype),
        row_ids=rows(row_ids),
        sqnorms=rows(sqn),
        starts=tuple(torch.from_numpy(starts[i]).to(dev) for i, dev in enumerate(devs)),
        lengths=tuple(torch.from_numpy(lens[i]).to(dev) for i, dev in enumerate(devs)),
        rows_per_shard=rows_per_shard,
        codes=None if scodes is None else rows(scodes),
    )


def _probe_rows(pl, starts, lens, probe_cap: int):
    """(rows [C, P, cap], valid [C, P, cap]) of the probed lists one shard
    owns: local rows, 0 where masked."""
    my_starts = starts[pl]  # [C, P] (-1 if not mine)
    my_lens = lens[pl]
    offs = torch.arange(probe_cap, device=pl.device)[None, None, :]
    vmask = (my_starts >= 0)[:, :, None] & (offs < my_lens[:, :, None])
    rows = torch.where(vmask, torch.clamp_min(my_starts, 0)[:, :, None].long() + offs, 0)
    return rows, vmask


def sharded_ivf_search(
    mesh: Mesh,
    q: Tensor,  # [B, d]
    centroids: Tensor,  # [kc, d]
    arrays: ShardedIVFArrays,
    *,
    nprobe: int,
    probe_cap: int,
    k: int,
    axis: str = DATA_AXIS,
    query_chunk: int = 16,
):
    """Probed L2 search over list-sharded storage → (dist [B, k], ids
    [B, k]) on the mesh's first device. Every shard scans the probed lists
    it owns (others masked), then the k-lists merge."""
    q = q.float()
    _, probe_lists = ivf_select(q, centroids, nprobe=nprobe)
    parts = []
    for s, dev in enumerate(mesh.axis_devices(axis)):
        vecs, sqn, ids = arrays.vecs[s], arrays.sqnorms[s], arrays.row_ids[s]
        out_d, out_i = [], []
        for c0 in range(0, q.shape[0], query_chunk):
            qc = q[c0 : c0 + query_chunk].to(dev)
            pl = probe_lists[c0 : c0 + query_chunk].to(dev).long()
            rows, vmask = _probe_rows(pl, arrays.starts[s], arrays.lengths[s], probe_cap)
            cand = rows.reshape(qc.shape[0], -1)
            xg = vecs[cand]  # [C, P·cap, d]
            # q rounded to the storage dtype, as the JAX package's einsum does
            g = _gram_rows(qc.to(xg.dtype), xg)
            dist = (qc * qc).sum(dim=-1)[:, None] + sqn[cand] - 2.0 * g
            d, i = topk_padded(dist, vmask.reshape(qc.shape[0], -1), k, ids=ids[cand])
            out_d.append(d)
            out_i.append(i)
        parts.append((torch.cat(out_d), torch.cat(out_i)))
    d, i = gather_merge(parts, mesh.first, k)
    return torch.clamp_min(d, 0.0), i


def sharded_ivf_pq_search(
    mesh: Mesh,
    q: Tensor,  # [B, d]
    centroids: Tensor,  # [kc, d]
    arrays: ShardedIVFArrays,  # with .codes sharded alongside rows
    books: pq_ops.PQCodebooks,
    *,
    nprobe: int,
    probe_cap: int,
    k: int,
    rerank_c: int = 0,  # 0 = pure ADC; >0 = per-shard exact rerank of its top-C
    packed_u4: bool = False,
    metric: Optional[Metric] = None,
    axis: str = DATA_AXIS,
    query_chunk: int = 8,
):
    """IVF-PQ ADC search over list-sharded storage → (dist [B, k], ids
    [B, k]) on the mesh's first device; codes shard like vectors.

    Per shard: the residual LUTs (L2) or the IP LUT, ADC over the probed
    lists the shard owns, then either the ADC partials merge directly or
    each shard exact-reranks its own top-C against its vectors first (a
    superset of the global top-C restricted to this shard, so the merged
    rerank is exact for the probed candidate set); then one gather and the
    strict (score, id) merge."""
    metric = Metric.L2 if metric is None else metric
    if arrays.codes is None:
        raise ValueError("partition_store(..., codes=...) required")
    if metric not in (Metric.L2, Metric.INNER_PRODUCT):
        raise ValueError("sharded IVF-PQ supports L2 and IP")
    q = q.float()
    m, ks, _ = books.centroids.shape
    _, probe_lists = ivf_select(q, centroids, nprobe=nprobe, metric=metric)
    parts = []
    for s, dev in enumerate(mesh.axis_devices(axis)):
        codes = arrays.codes[s]
        if packed_u4:
            codes = unpack_u4(codes)
        cents = centroids.to(dev).float()
        bk = pq_ops.PQCodebooks(books.centroids.to(dev), books.sqnorms.to(dev))
        offsets = torch.arange(m, device=dev) * ks
        out_d, out_i = [], []
        for c0 in range(0, q.shape[0], query_chunk):
            qc = q[c0 : c0 + query_chunk].to(dev)
            pl = probe_lists[c0 : c0 + query_chunk].to(dev).long()
            c, p = pl.shape
            if metric == Metric.L2:
                lut = pq_ops.pq_lut_residual_l2(qc, cents, pl, bk)  # [C, P, m, ks]
            else:
                lut = pq_ops.pq_lut_ip(qc, bk)[:, None].expand(c, p, m, ks)
            rows, vmask = _probe_rows(pl, arrays.starts[s], arrays.lengths[s], probe_cap)
            flat = codes[rows].long() + offsets  # [C, P, cap, m]
            adc = torch.gather(lut.reshape(c, p, m * ks), 2, flat.reshape(c, p, -1))
            adc = adc.reshape(c, p, probe_cap, m).sum(dim=-1)
            if metric == Metric.INNER_PRODUCT:
                adc = adc - torch.bmm(cents[pl], qc[:, :, None])[:, :, 0][:, :, None]
            adc_flat = adc.reshape(c, -1)
            vm_flat = vmask.reshape(c, -1)
            rows_flat = rows.reshape(c, -1)
            if rerank_c:
                cc = min(rerank_c, adc_flat.shape[1])
                # local ADC top-C by candidate position, then the exact rerank
                pos = torch.arange(adc_flat.shape[1], dtype=torch.int32, device=dev)
                cd, cpos = topk_padded(adc_flat, vm_flat, cc, ids=pos[None, :])
                missing = ~torch.isfinite(cd)
                crows = torch.gather(
                    rows_flat, 1, torch.clamp_max(cpos.long(), rows_flat.shape[1] - 1))
                crows = torch.where(missing, 0, crows)
                g = _gram_rows(qc.to(arrays.vecs[s].dtype), arrays.vecs[s][crows])
                if metric == Metric.L2:
                    qn = (qc * qc).sum(dim=-1)
                    ex = torch.clamp_min(qn[:, None] + arrays.sqnorms[s][crows] - 2.0 * g, 0.0)
                else:
                    ex = -g
                d, i = topk_padded(ex, ~missing, k, ids=arrays.row_ids[s][crows])
            else:
                d, i = topk_padded(adc_flat, vm_flat, k, ids=arrays.row_ids[s][rows_flat])
            out_d.append(d)
            out_i.append(i)
        parts.append((torch.cat(out_d), torch.cat(out_i)))
    return gather_merge(parts, mesh.first, k)
