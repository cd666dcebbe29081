"""Range / threshold queries.

Counterpart of vectorindex_tpu.ops.range_query (parity target: the
reference's RangeQuery.swift — rangeScanBlock :218, rangeMaskBlock :316,
rangeScanADC_u8/_u4 :389/:469, the output modes compacted / mask /
reservoir :65).

One distance block ([B, N], ops/scoring.distance_block at full f32, or the
ADC scan of ops/pq.adc_scan) and a comparison give the keep-mask; 'count'
sums it; 'compacted' returns fixed-width [B, max_results] distance and id
buffers in strict (dist, id) order, padded with (+inf, INVALID_ID), beside
the true match counts; the reservoir mode streams corpus chunks through
ops/reservoir. The radius is an f32, as in the JAX package: L2 keeps
d² ≤ r·r (r·r rounded to f32), IP keeps score ≥ r, cosine 1 − dist ≥ r.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from vectorindex_tpu_torch.ops import pq as pq_ops
from vectorindex_tpu_torch.ops import scoring
from vectorindex_tpu_torch.ops.dtypes import unpack_u4
from vectorindex_tpu_torch.ops.reservoir import Reservoir, reservoir_init, reservoir_push_masked
from vectorindex_tpu_torch.ops.topk import INVALID_DIST, INVALID_ID
from vectorindex_tpu_torch.utils.config import Metric

Tensor = torch.Tensor


def _range_mask_from_dist(dist: Tensor, radius: float, metric: Metric) -> Tensor:
    """Inclusive threshold in the metric's native convention: L2 keeps
    d ≤ τ (τ a true distance, so d² ≤ τ²); IP/cosine keep score ≥ τ
    (internal dist = −score / 1 − sim)."""
    r = np.float32(radius)
    if metric == Metric.L2:
        return dist <= float(r * r)
    if metric == Metric.INNER_PRODUCT:
        return -dist >= float(r)
    if metric == Metric.COSINE:
        return (1.0 - dist) >= float(r)
    return dist <= float(r)


def _distances(q, x, metric, x_sqnorms=None, x_invnorms=None) -> Tensor:
    norms = scoring.NormCache(sq=x_sqnorms, inv=x_invnorms)
    return scoring.distance_block(q, x, metric, norms=norms)


def range_mask(
    q: Tensor,
    x: Tensor,
    radius: float,
    *,
    metric: Metric = Metric.L2,
    valid: Optional[Tensor] = None,
    x_sqnorms: Optional[Tensor] = None,
    x_invnorms: Optional[Tensor] = None,
) -> Tensor:
    """Boolean keep-mask [B, N] (reference rangeMaskBlock, RangeQuery.swift:316)."""
    mask = _range_mask_from_dist(_distances(q, x, metric, x_sqnorms, x_invnorms), radius, metric)
    if valid is not None:
        mask = mask & valid[None, :]
    return mask


def range_count(
    q: Tensor,
    x: Tensor,
    radius: float,
    *,
    metric: Metric = Metric.L2,
    valid: Optional[Tensor] = None,
) -> Tensor:
    """Per-query match count [B] int32."""
    return range_mask(q, x, radius, metric=metric, valid=valid).sum(dim=-1).to(torch.int32)


class RangeResult(NamedTuple):
    dists: Tensor  # [B, max_results] native-convention internal distance
    ids: Tensor  # [B, max_results] int32 (INVALID_ID padded)
    counts: Tensor  # [B] int32 true number of matches (may exceed max_results)


def _compact(dist: Tensor, mask: Tensor, max_results: int) -> RangeResult:
    """The matches of each row, nearest first by (dist, id), in
    [B, min(max_results, N)] buffers, and the true counts. Ids are the
    column positions, ascending along the row, so one stable sort by
    distance gives the two-key order. Non-matches sort as NaN, after every
    match (a match at +inf included), and come out as (+inf, INVALID_ID)."""
    mr = min(max_results, dist.shape[1])
    key = torch.where(mask, dist.float(), float("nan"))
    sd, pos = torch.sort(key, dim=-1, stable=True)
    sd, pos = sd[:, :mr], pos[:, :mr]
    hit = torch.gather(mask, 1, pos)
    return RangeResult(
        torch.where(hit, sd, INVALID_DIST),
        torch.where(hit, pos.to(torch.int32), INVALID_ID),
        mask.sum(dim=-1).to(torch.int32),
    )


def range_scan(
    q: Tensor,
    x: Tensor,
    radius: float,
    *,
    metric: Metric = Metric.L2,
    max_results: int = 128,
    valid: Optional[Tensor] = None,
    x_sqnorms: Optional[Tensor] = None,
    x_invnorms: Optional[Tensor] = None,
) -> RangeResult:
    """Compacted range scan (reference rangeScanBlock, RangeQuery.swift:218):
    fixed-width result buffers, nearest-first by (dist, id), with the true
    match count for overflow detection."""
    dist = _distances(q, x, metric, x_sqnorms, x_invnorms)
    mask = _range_mask_from_dist(dist, radius, metric)
    if valid is not None:
        mask = mask & valid[None, :]
    return _compact(dist, mask, max_results)


def range_scan_adc(
    codes: Tensor,
    lut: Tensor,
    radius: float,
    *,
    max_results: int = 128,
    strategy: str = "gather",
    chunk: int = 8192,
    valid: Optional[Tensor] = None,
) -> RangeResult:
    """ADC range scan over PQ codes (reference rangeScanADC_u8,
    RangeQuery.swift:389): ADC distances (ops/pq.adc_scan; strategy="auto"
    is kernel K6 on a CUDA tensor) against τ², compacted output."""
    dist = pq_ops.adc_scan(codes, lut, strategy=strategy, chunk=chunk)
    mask = _range_mask_from_dist(dist, radius, Metric.L2)
    if valid is not None:
        mask = mask & valid[None, :]
    return _compact(dist, mask, max_results)


def range_scan_adc_u4(packed_codes: Tensor, lut: Tensor, radius: float, **kw) -> RangeResult:
    """u4 variant (reference rangeScanADC_u4, RangeQuery.swift:469): unpack,
    then range_scan_adc."""
    return range_scan_adc(unpack_u4(packed_codes), lut, radius, **kw)


def range_scan_reservoir(
    q: Tensor,
    x: Tensor,
    radius: float,
    capacity: int,
    *,
    metric: Metric = Metric.L2,
    valid: Optional[Tensor] = None,
    chunk: int = 65536,
) -> Reservoir:
    """Reservoir output mode (reference RangeScanConfig output .reservoir,
    RangeQuery.swift:65): stream corpus chunks through a bounded top-C
    reservoir keeping the nearest in-radius matches — the memory-bounded
    variant for huge expected match counts."""
    b, n = q.shape[0], x.shape[0]
    res = reservoir_init(b, capacity, device=q.device)
    for start in range(0, n, chunk):
        dist = scoring.distance_block(q, x[start : start + chunk], metric)
        mask = _range_mask_from_dist(dist, radius, metric)
        if valid is not None:
            mask = mask & valid[start : start + chunk][None, :]
        ids = torch.arange(start, start + dist.shape[1], dtype=torch.int32, device=q.device)
        res = reservoir_push_masked(res, dist, ids[None, :], mask)
    return res
