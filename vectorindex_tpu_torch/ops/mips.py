"""MIPS→L2 transform: maximum-inner-product search through L2 indices.

Counterpart of vectorindex_tpu.ops.mips (parity target: the reference's
Operations/Transform/MIPSTransform.swift):
  - augmentation x′ = [x; √(R²−‖x‖²)], q′ = [q; 0] (:155, :187), so that
    argmax⟨q,x⟩ == argmin‖q′−x′‖;
  - modes explicit / virtual / hybrid (:19-23): materialize the augmented
    vectors (padded dim); keep raw vectors and convert L2 scores back
    analytically (:204); one score block with the virtual correction (:226);
  - R² with staleness tracking (:31-62);
  - the padded dimension rounds d+1 up to 128, the JAX package's multiple
    (the reference rounds to 16), so both packages augment to one width.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from vectorindex_tpu_torch.ops import scoring

Tensor = torch.Tensor

LANE = 128


def padded_dim(d: int, multiple: int = LANE) -> int:
    """Augmented dimension d+1 rounded up to `multiple` (reference
    paddedDimension, LayoutTransforms.swift:86)."""
    return ((d + 1 + multiple - 1) // multiple) * multiple


@dataclass
class R2Parameter:
    """Max squared norm with staleness (reference R2Parameter,
    MIPSTransform.swift:31-62)."""

    r2: float = 0.0
    stale: bool = False

    def update(self, sqnorm_max: float) -> None:
        if sqnorm_max > self.r2:
            self.r2 = float(sqnorm_max)
            self.stale = True  # existing augmentation under-estimates R²

    def materialized(self) -> None:
        self.stale = False


def mips_materialize_augmentation(x: Tensor, r2: float, out_dim: int) -> Tensor:
    """x′ = [x; √(R²−‖x‖²); 0…] in x's dtype (reference
    mipsMaterializeAugmentation, MIPSTransform.swift:155). out_dim ≥ d+1
    (use padded_dim)."""
    n, d = x.shape
    sq = scoring.squared_norms(x)
    aug = torch.sqrt(torch.clamp_min(float(r2) - sq, 0.0))  # r2 rounds to f32
    out = x.new_zeros((n, out_dim))
    out[:, :d] = x
    out[:, d] = aug.to(x.dtype)
    return out


def mips_augment_query(q: Tensor, out_dim: int) -> Tensor:
    """q′ = [q; 0; 0…] (reference mipsAugmentQuery, MIPSTransform.swift:187)."""
    b, d = q.shape
    out = q.new_zeros((b, out_dim))
    out[:, :d] = q
    return out


def mips_virtual_to_l2_scores(ip_scores: Tensor, q_sqnorms: Tensor, r2: float) -> Tensor:
    """Virtual mode: raw IP scores → the L2² distances the explicit
    augmentation would give (reference mipsVirtualToL2Scores,
    MIPSTransform.swift:204): ‖q′−x′‖² = ‖q‖² + R² − 2⟨q,x⟩."""
    return torch.clamp_min(q_sqnorms[:, None] + float(r2) - 2.0 * ip_scores, 0.0)


def mips_hybrid_score_block(q: Tensor, x: Tensor, r2: float) -> Tensor:
    """Hybrid mode: augmented-L2 distances from raw vectors in one block
    (reference mipsHybridScoreBlock, MIPSTransform.swift:226): the Gram
    product, then the R² epilogue."""
    ip = scoring.inner_product_block(q, x)
    return mips_virtual_to_l2_scores(ip, scoring.squared_norms(q), r2)
