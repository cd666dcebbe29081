"""Exact corpus scan: strict top-k and the verified two-phase selection.

Counterpart of vectorindex_tpu.ops.scan.

  - `scan_topk_strict` is the always-exact selection path: the whole search
    below the large-scan threshold or on a block too small for
    `scan_topk_verified` to pay (models/flat.VERIFIED_MIN_BLOCK), and the
    fallback for queries that the fused kernels (kernels/scan_fused) or
    `scan_topk_verified` cannot prove exact.
  - `scan_topk_verified` serves the large corpora the fused kernels cannot
    take: manhattan/chebyshev, and k above their candidate cap. Candidates: `torch.topk(dist, c, largest=False)`
    over the distance block (the JAX package's approx_min_k PartialReduce),
    c = candidate_count(k); then a strict (score, id) top-k of those c.
    The caller re-runs the queries it flags through `scan_topk_strict`.

`torch.topk` is exact, so the JAX package's count pass (the corpus scored
again in chunks, rows below tau counted), which proves its approximate
candidates exact, has nothing to find here. What `torch.topk` leaves open is
the order of ties: it picks among tied values in no fixed order, so a tie
group that straddles the c-th candidate may lose its lowest ids. A query is
therefore flagged when its k-th distance tau equals its largest candidate
distance; when tau is below it, every row at or below tau is a candidate and
the strict top-k of the candidates is the (score, id) top-k of the corpus.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vectorindex_tpu_torch.ops import scoring
from vectorindex_tpu_torch.ops.topk import INVALID_DIST, topk, topk_padded
from vectorindex_tpu_torch.utils.config import Metric, ScoreOpts

Tensor = torch.Tensor

_NOCLAMP = ScoreOpts(clamp=False)

#: candidate pool size (per query) of the first phase
DEFAULT_CANDIDATES = 256


def candidate_count(k: int, c: int = DEFAULT_CANDIDATES) -> int:
    """Candidates a query keeps: at least 4k, rounded up to 128."""
    c = max(c, 4 * k)
    return ((c + 127) // 128) * 128


def _masked_distance(q, x, metric, sqnorms, invnorms, valid):
    """[B, N] ascending distances; dead slots (valid False) are +inf.
    Unclamped: selection is monotone-invariant, only survivors clamp."""
    norms = scoring.NormCache(sq=sqnorms, inv=invnorms)
    dist = scoring.distance_block(q, x, metric, norms=norms, opts=_NOCLAMP)
    if valid is None:
        return dist
    return torch.where(valid[None, :], dist, INVALID_DIST)


def scan_topk_strict(
    q: Tensor,
    x: Tensor,
    sqnorms: Optional[Tensor],
    invnorms: Optional[Tensor],
    valid: Optional[Tensor],
    *,
    metric: Metric,
    k: int,
) -> Tuple[Tensor, Tensor]:
    """Always-exact top-k over the whole corpus → (dist [B,k] f32,
    ids [B,k] int32). Ids are corpus positions, and ties break by lowest
    position (a stable sort), which is the (score, id) contract."""
    dist = _masked_distance(q, x, metric, sqnorms, invnorms, valid)
    d, i = topk(dist, k, strict_ties=False)
    if metric == Metric.L2:
        d = torch.clamp_min(d, 0.0)
    return d, i


def scan_topk_verified(
    q: Tensor,
    x: Tensor,
    sqnorms: Optional[Tensor],
    invnorms: Optional[Tensor],
    valid: Optional[Tensor],
    *,
    metric: Metric,
    k: int,
    candidates: int = DEFAULT_CANDIDATES,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Exact-verified top-k over the whole corpus → (dist [B,k] f32,
    ids [B,k] int32, exact [B] bool). Rows with exact False must be re-run
    through scan_topk_strict (the caller's fallback)."""
    n = x.shape[0]
    b = q.shape[0]
    dist = _masked_distance(q, x, metric, sqnorms, invnorms, valid)
    c = min(candidate_count(k, candidates), n)
    if c >= n:
        if valid is None:
            sd, si = topk(dist, k, strict_ties=True)
        else:
            sd, si = topk_padded(dist, valid[None, :], k)
        exact = torch.ones((b,), dtype=torch.bool, device=q.device)
    else:
        cd, ci = torch.topk(dist, c, dim=-1, largest=False, sorted=False)
        del dist
        sd, si = topk(cd, k, ids=ci.to(torch.int32), strict_ties=True)
        tau = sd[:, k - 1]
        # a non-finite tau means fewer than k finite candidates: exact only
        # if they are every live row (the JAX package tests n_valid <= c,
        # which also passes a live row whose distance is not finite)
        n_valid = n if valid is None else valid.sum()
        exact = torch.where(
            torch.isfinite(tau), tau < cd.max(dim=-1).values,
            torch.isfinite(sd).sum(dim=-1) == n_valid,
        )
    if metric == Metric.L2:
        sd = torch.clamp_min(sd, 0.0)  # clamp only the k survivors
    return sd, si, exact


def pad_queries(q: Tensor, multiple: int = 8) -> Tuple[Tensor, int]:
    """Pad a flagged-query subset to a power-of-two batch (at least
    `multiple`) so the fallback sees few distinct shapes; returns
    (padded, original count)."""
    b = q.shape[0]
    target = max(multiple, 1 << (b - 1).bit_length())
    if target == b:
        return q, b
    pad = q.new_zeros((target - b,) + tuple(q.shape[1:]))
    return torch.cat([q, pad], dim=0), b
