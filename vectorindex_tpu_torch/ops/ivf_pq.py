"""IVF-PQ probed search by gathering: residual LUTs + ADC over probed lists,
and the exact rerank of candidates by internal id.

Counterpart of vectorindex_tpu.ops.ivf_pq (parity targets: the reference's
pq_lut_residual_l2 PQLUT.swift:287 → adc_scan_u8 over probed lists
ADCScan.swift:99 → IVFPostADC.rerankTopKFlat, IVFPostADC.swift:21).

This is the JAX package's XLA route, which its IVFPQIndex runs off the TPU.
The port keeps it as a public op and as a plain reference for the tests; its
index searches through kernels/adc_probe.ivf_search_pq_probe on every
device, the counterpart of the TPU route.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vectorindex_tpu_torch.ops import pq as pq_ops
from vectorindex_tpu_torch.ops import scoring
from vectorindex_tpu_torch.ops.dtypes import unpack_u4
from vectorindex_tpu_torch.ops.ivf import IVFListArrays, _gram_rows, ivf_select
from vectorindex_tpu_torch.ops.topk import INVALID_ID, topk_padded
from vectorindex_tpu_torch.utils.config import Metric

Tensor = torch.Tensor


def ivf_search_pq(
    q: Tensor,
    centroids: Tensor,
    arrays: IVFListArrays,  # starts/lengths/row_ids used
    codes: Tensor,  # [N_pad, m] uint8 (or [N_pad, m//2] packed u4), CSR layout
    books: pq_ops.PQCodebooks,
    *,
    nprobe: int,
    probe_cap: int,
    k: int,
    metric: Metric = Metric.L2,
    query_chunk: int = 8,
    packed_u4: bool = False,
    row_allow: Optional[Tensor] = None,  # [N_pad] bool, CSR row order
    disabled_lists: Optional[Tensor] = None,  # [kc] bool
) -> Tuple[Tensor, Tensor]:
    """ADC search over probed lists → (adc_dist [B, k], internal ids [B, k]),
    strict (score, id) order.

    L2 uses residual LUTs (IVF-PQ codes are residuals r = x − c_list); IP
    uses the plain IP LUT, then subtracts ⟨q, c_list⟩ per list."""
    if metric not in (Metric.L2, Metric.INNER_PRODUCT):
        raise ValueError("ivf_search_pq supports L2 and IP")
    q = q.float()
    b = q.shape[0]
    m, ks, _ = books.centroids.shape
    if packed_u4:
        codes = unpack_u4(codes)
    sel_d, probe_lists = ivf_select(q, centroids, nprobe=nprobe, metric=metric,
                                    disabled=disabled_lists)
    probe_lists = probe_lists.long()
    lens_all = arrays.lengths[probe_lists]
    if disabled_lists is not None:
        lens_all = torch.where(torch.isfinite(sel_d), lens_all, 0)
    starts_all = arrays.starts[probe_lists].long()
    offs = torch.arange(probe_cap, device=q.device)
    offsets = torch.arange(m, device=q.device) * ks
    out_d, out_i = [], []
    for s in range(0, b, query_chunk):
        qc, pl = q[s : s + query_chunk], probe_lists[s : s + query_chunk]
        c, p = pl.shape
        if metric == Metric.L2:
            lut = pq_ops.pq_lut_residual_l2(qc, centroids, pl, books)  # [C, P, m, ks]
        else:
            lut = pq_ops.pq_lut_ip(qc, books)[:, None].expand(c, p, m, ks)
        vmask = offs[None, None, :] < lens_all[s : s + c, :, None]  # [C, P, cap]
        rows = torch.where(vmask, starts_all[s : s + c, :, None] + offs, 0)
        if row_allow is not None:
            vmask = vmask & row_allow[rows]
        flat = codes[rows].long() + offsets  # [C, P, cap, m]
        adc = torch.gather(lut.reshape(c, p, m * ks), 2, flat.reshape(c, p, -1))
        adc = adc.reshape(c, p, probe_cap, m).sum(dim=-1)
        if metric == Metric.INNER_PRODUCT:
            coarse_dot = torch.bmm(centroids.float()[pl], qc[:, :, None])[:, :, 0]  # [C, P]
            adc = adc - coarse_dot[:, :, None]
        d, i = topk_padded(adc.reshape(c, -1), vmask.reshape(c, -1), k,
                           ids=arrays.row_ids[rows].reshape(c, -1))
        out_d.append(d)
        out_i.append(i)
    if not out_d:
        return (torch.empty((0, k), device=q.device),
                torch.empty((0, k), dtype=torch.int32, device=q.device))
    return torch.cat(out_d), torch.cat(out_i)


def rerank_rows(
    q: Tensor,
    cand_ids: Tensor,  # [B, C] internal ids (INVALID_ID padded)
    slot_rows: Tensor,  # [max_slot+1] int32: internal id -> CSR row (-1 absent)
    vecs: Tensor,
    sqnorms: Tensor,
    *,
    k: int,
    metric: Metric = Metric.L2,
) -> Tuple[Tensor, Tensor]:
    """Exact rerank of ADC candidates against the stored vectors (reference
    IVFPostADC.rerankTopKFlat + #40). Candidate ids map to CSR rows through
    the slot→row table."""
    q = q.float()
    missing = cand_ids == INVALID_ID
    rows = slot_rows[torch.where(missing, 0, cand_ids).long()]
    missing = missing | (rows < 0)
    rows = torch.where(missing, 0, rows).long()
    xg = vecs[rows].float()
    sg = sqnorms[rows].float()
    g = _gram_rows(q, xg)
    if metric == Metric.L2:
        qn = (q * q).sum(dim=-1)
        dist = torch.clamp_min(qn[:, None] + sg - 2.0 * g, 0.0)
    elif metric == Metric.INNER_PRODUCT:
        dist = -g
    else:
        qinv = scoring.inv_norms(q)
        xinv = torch.where(sg > 0, torch.rsqrt(torch.clamp_min(sg, 1e-30)), 0.0)
        dist = 1.0 - g * qinv[:, None] * xinv
    return topk_padded(dist, ~missing, k, ids=cand_ids)
