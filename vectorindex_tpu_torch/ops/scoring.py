"""Block scoring — the single scoring choke point.

Parity targets (reference kernels #01-#04, #09):
  - L2² block kernel      Operations/Scoring/L2SqrKernel.swift:101 (l2sqr_f32_block)
  - inner product          Operations/Scoring/InnerProduct.swift:8
  - cosine (fused norms)   Operations/Scoring/Cosine.swift:38,139
  - ScoreBlock dispatcher  Operations/Scoring/ScoreBlock.swift:24
  - norm cache             Operations/Support/Norms.swift:36

Counterpart of vectorindex_tpu.ops.scoring. Every matmul-form metric is one
Gram product `Q @ X.T` in f32 with an epilogue:

  L2²:    ‖q‖² + ‖x‖² − 2·QXᵀ   (the "dot trick")
  IP:     QXᵀ
  cosine: QXᵀ ⊙ (1/‖q‖)(1/‖x‖)ᵀ  (fused with a precomputed inverse-norm cache)

Manhattan/chebyshev have no matmul form; they broadcast over corpus chunks so
the [B, chunk, d] intermediate stays bounded.

Precision: the Gram product runs at full f32, as the JAX package's
`Precision.HIGHEST` does. bf16 operands are widened to f32 first (bf16×bf16
products are exact in f32), and on CUDA the product refuses to run while
TF32 matmuls are enabled (`torch.backends.cuda.matmul.allow_tf32`), because
TF32 keeps ~3 decimal digits and the dot-trick epilogue turns Gram error into
distance error.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from vectorindex_tpu_torch.utils.config import Metric, ScoreOpts

Tensor = torch.Tensor

#: elements of the [B, chunk, d] intermediate in the broadcasting metrics
_BROADCAST_ELEMS = 16 * 1024 * 1024


# ---------------------------------------------------------------------------
# Norm cache (#09)
# ---------------------------------------------------------------------------


@dataclass
class NormCache:
    """Precomputed row norms (reference Norms.swift:36 NormCache).

    sq:  ‖x‖² per row — consumed by the L2 dot-trick epilogue.
    inv: 1/‖x‖ per row — consumed by fused cosine.
    Either may be None (mode none/inv/sq/both, Norms.swift:12). dtype may be
    f32 or bf16 (reference also supports f16, Norms.swift:22).
    """

    sq: Optional[Tensor] = None
    inv: Optional[Tensor] = None

    @staticmethod
    def build(x: Tensor, mode: str = "both", dtype=torch.float32) -> "NormCache":
        sq = inv = None
        sqn = squared_norms(x)
        if mode in ("sq", "both"):
            sq = sqn.to(dtype)
        if mode in ("inv", "both"):
            # zero vectors get inv-norm 0 so cosine against them scores 0
            # rather than inf/nan
            inv = _guarded_rsqrt(sqn).to(dtype)
        return NormCache(sq=sq, inv=inv)


def _guarded_rsqrt(sqn: Tensor) -> Tensor:
    return torch.where(
        sqn > 0, torch.rsqrt(torch.clamp_min(sqn, 1e-30)), torch.zeros_like(sqn)
    )


def squared_norms(x: Tensor) -> Tensor:
    """‖x‖² per row, f32 accumulate."""
    xf = x.float()
    return (xf * xf).sum(dim=-1)


def inv_norms(x: Tensor) -> Tensor:
    """1/‖x‖ per row with zero-guard."""
    return _guarded_rsqrt(squared_norms(x))


# ---------------------------------------------------------------------------
# Core matmul-form metrics
# ---------------------------------------------------------------------------


def check_full_f32(t: Tensor) -> None:
    """Raise where a CUDA f32 product would run in TF32."""
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "f32 Gram products need torch.backends.cuda.matmul.allow_tf32 = "
            "False (TF32 keeps ~3 decimal digits)"
        )


def _gram(q: Tensor, x: Tensor) -> Tensor:
    """Q @ Xᵀ at full f32. [B,d]·[N,d] → [B,N]."""
    check_full_f32(q)
    return q.float() @ x.float().T


def l2sqr_block(
    q: Tensor,
    x: Tensor,
    x_sqnorms: Optional[Tensor] = None,
    q_sqnorms: Optional[Tensor] = None,
    clamp: bool = True,
) -> Tensor:
    """Squared L2 distances [B,N] via the dot-trick (reference
    l2sqr_f32_block, L2SqrKernel.swift:101). clamp=False skips the
    max(·, 0); selection pipelines rank identically without it and clamp
    only the k survivors."""
    if x_sqnorms is None:
        x_sqnorms = squared_norms(x)
    if q_sqnorms is None:
        q_sqnorms = squared_norms(q)
    g = _gram(q, x)
    d2 = q_sqnorms[:, None].float() + x_sqnorms[None, :].float() - 2.0 * g
    return torch.clamp_min(d2, 0.0) if clamp else d2


def _broadcast_block(q: Tensor, x: Tensor, reduce: Callable[[Tensor], Tensor]) -> Tensor:
    """reduce(q[:, None, :] - x[None, :, :]) over corpus chunks → [B, N]."""
    b, d = q.shape
    n = x.shape[0]
    chunk = max(1, min(n, _BROADCAST_ELEMS // max(b * d, 1)))
    qf = q.float()[:, None, :]
    parts = [
        reduce(qf - x[s : s + chunk].float()[None, :, :])
        for s in range(0, n, chunk)
    ]
    if not parts:
        return torch.empty((b, 0), dtype=torch.float32, device=q.device)
    return torch.cat(parts, dim=1)


def l2sqr_block_direct(q: Tensor, x: Tensor) -> Tensor:
    """Direct Σ(q−x)² — the strict/oracle path (reference strictFP +
    `L2Sqr.runScalarRef`, L2Sqr.swift:88-100)."""
    return _broadcast_block(q, x, lambda diff: (diff * diff).sum(dim=-1))


def inner_product_block(q: Tensor, x: Tensor) -> Tensor:
    """⟨q,x⟩ [B,N] (reference InnerProduct.swift:8)."""
    return _gram(q, x)


def cosine_block(
    q: Tensor,
    x: Tensor,
    x_invnorms: Optional[Tensor] = None,
    q_invnorms: Optional[Tensor] = None,
) -> Tensor:
    """Cosine similarity in [-1,1] [B,N], fused with cached inverse norms
    (reference Cosine.swift:38 / runF16 :139 with f16 inv-norm cache)."""
    if x_invnorms is None:
        x_invnorms = inv_norms(x)
    if q_invnorms is None:
        q_invnorms = inv_norms(q)
    g = _gram(q, x)
    sim = g * q_invnorms[:, None].float() * x_invnorms[None, :].float()
    return torch.clamp(sim, -1.0, 1.0)


def manhattan_block(q: Tensor, x: Tensor) -> Tensor:
    """Σ|q−x| (reference slow fallback ScoreBlock.swift:53-63)."""
    return _broadcast_block(q, x, lambda diff: diff.abs().sum(dim=-1))


def chebyshev_block(q: Tensor, x: Tensor) -> Tensor:
    """max|q−x|."""
    return _broadcast_block(q, x, lambda diff: diff.abs().amax(dim=-1))


# ---------------------------------------------------------------------------
# ScoreBlock dispatcher (#04)
# ---------------------------------------------------------------------------


def score_block(
    q: Tensor,
    x: Tensor,
    metric: Metric,
    norms: Optional[NormCache] = None,
    q_norms: Optional[NormCache] = None,
    opts: ScoreOpts = ScoreOpts(),
) -> Tensor:
    """Metric dispatcher → [B,N] raw scores (reference ScoreBlock.run,
    ScoreBlock.swift:24). L2 → squared distance, IP → dot, cosine →
    similarity, manhattan/chebyshev → distance. Use `as_distance` to
    normalize for selection."""
    if metric == Metric.L2:
        if opts.use_dot_trick is False or opts.strict_fp:
            return l2sqr_block_direct(q, x)
        return l2sqr_block(
            q,
            x,
            x_sqnorms=None if norms is None else norms.sq,
            q_sqnorms=None if q_norms is None else q_norms.sq,
            clamp=opts.clamp,
        )
    if metric == Metric.INNER_PRODUCT:
        return inner_product_block(q, x)
    if metric == Metric.COSINE:
        return cosine_block(
            q,
            x,
            x_invnorms=None if norms is None else norms.inv,
            q_invnorms=None if q_norms is None else q_norms.inv,
        )
    if metric == Metric.MANHATTAN:
        return manhattan_block(q, x)
    if metric == Metric.CHEBYSHEV:
        return chebyshev_block(q, x)
    raise ValueError(f"unsupported metric: {metric}")


def as_distance(scores: Tensor, metric: Metric) -> Tensor:
    """Native scores → the ascending 'distance' convention of all internal
    pipelines (reference HNSWTraversal.swift:60-70: L2 = d², IP = −dot,
    cosine = 1 − sim)."""
    if metric == Metric.INNER_PRODUCT:
        return -scores
    if metric == Metric.COSINE:
        return 1.0 - scores
    return scores


def from_distance(dist: Tensor, metric: Metric) -> Tensor:
    """Invert `as_distance` back to the metric's native score. For L2 the
    public API also applies sqrt (reference HNSWIndex.swift:158); that
    happens at the index layer, not here."""
    if metric == Metric.INNER_PRODUCT:
        return -dist
    if metric == Metric.COSINE:
        return 1.0 - dist
    return dist


def distance_block(
    q: Tensor,
    x: Tensor,
    metric: Metric,
    norms: Optional[NormCache] = None,
    q_norms: Optional[NormCache] = None,
    opts: ScoreOpts = ScoreOpts(),
) -> Tensor:
    """score_block + as_distance: ascending-is-better [B,N] distances."""
    return as_distance(score_block(q, x, metric, norms, q_norms, opts), metric)


def pairwise_distance(a: Tensor, b: Tensor, metric: Metric) -> Tensor:
    """distance_block for small pairwise blocks (construction paths;
    reference DistanceUtils.swift:12)."""
    return distance_block(a, b, metric)
