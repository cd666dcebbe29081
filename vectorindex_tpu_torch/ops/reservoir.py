"""Candidate reservoir: bounded top-C accumulation across scan stages.

Counterpart of vectorindex_tpu.ops.reservoir (parity target: the reference's
CandidateReservoir.swift — pushBatch :205, extractTopK :297, τ tracking,
stableTies).

The reservoir is a pair of [B, C] tensors kept sorted by (dist, id), padded
with (+inf, INVALID_ID). push = concatenate + strict (dist, id) selection
(ops/topk.topk) + truncate; τ, the current C-th best, is the last column.
Functions return a new Reservoir and leave their inputs as they are.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from vectorindex_tpu_torch.ops.topk import INVALID_DIST, INVALID_ID, topk

Tensor = torch.Tensor


class Reservoir(NamedTuple):
    """Sorted-by-(dist, id) bounded buffer per query."""

    dists: Tensor  # [B, C] ascending, INVALID_DIST padded
    ids: Tensor  # [B, C] int32, INVALID_ID padded

    @property
    def capacity(self) -> int:
        return self.dists.shape[-1]


def reservoir_init(batch: int, capacity: int, device="cpu") -> Reservoir:
    return Reservoir(
        torch.full((batch, capacity), INVALID_DIST, device=device),
        torch.full((batch, capacity), INVALID_ID, dtype=torch.int32, device=device),
    )


def reservoir_push(res: Reservoir, dists: Tensor, ids: Tensor) -> Reservoir:
    """Merge a candidate block [B, W] (reference pushBatch, :205): entries
    at or above the current τ sort out; ties keep the lower id (stableTies)."""
    all_d = torch.cat([res.dists, dists.float()], dim=1)
    all_i = torch.cat([res.ids, torch.broadcast_to(ids, dists.shape).to(torch.int32)], dim=1)
    return Reservoir(*topk(all_d, res.capacity, ids=all_i, strict_ties=True))


def reservoir_push_masked(res: Reservoir, dists: Tensor, ids: Tensor, valid: Tensor) -> Reservoir:
    """pushBatch with a validity mask (masked slots never enter)."""
    d = torch.where(valid, dists.float(), INVALID_DIST)
    i = torch.where(valid, torch.broadcast_to(ids, dists.shape).to(torch.int32), INVALID_ID)
    return reservoir_push(res, d, i)


def reservoir_tau(res: Reservoir) -> Tensor:
    """Current rejection threshold τ = worst kept distance per query
    (+inf while not full)."""
    return res.dists[:, -1]


def reservoir_count(res: Reservoir) -> Tensor:
    """Live entries per query [B] int32."""
    return torch.isfinite(res.dists).sum(dim=-1).to(torch.int32)


def reservoir_extract_topk(res: Reservoir, k: int) -> Tuple[Tensor, Tensor]:
    """Final top-k (reference extractTopK, :297): the reservoir is already
    sorted, so this is the strict selection of its first k columns."""
    return topk(res.dists, k, ids=res.ids, strict_ties=True)
