"""Candidate deduplication / visited-set strategies.

Counterpart of vectorindex_tpu.ops.dedup (parity target: the reference's
Operations/Dedup/CandidateDedup.swift — VisitedSet :21, fixedBitset :29,
visitedInit/Reset/TestAndSet/MaskAndMark/dedupInPlace :674-765).

  - Visited bitsets are [B, ⌈n/32⌉] words with functional test-and-set. The
    words are int32 tensors holding the JAX package's uint32 bit patterns
    (torch's uint32 lacks the shift and bitwise kernels), so bit 31 is the
    sign bit and `.view(torch.int32)`-level equality with the JAX words holds.
  - `dedup_mask` / `dedup_candidates`: value-level dedup of id lists by a
    stable sort on the ids, the batch analog of dedupInPlace.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vectorindex_tpu_torch.ops.topk import INVALID_DIST, INVALID_ID, topk

Tensor = torch.Tensor

WORD = 32


def visited_init(batch: int, n: int, device="cpu") -> Tensor:
    """Fresh per-query bitsets [B, ⌈n/32⌉] (reference visitedInit)."""
    return torch.zeros((batch, (n + WORD - 1) // WORD), dtype=torch.int32, device=device)


def visited_test(bits: Tensor, ids: Tensor) -> Tensor:
    """Vectorized membership: ids [B, W] → bool [B, W] (reference
    visitedTestAndSet's test half). Negative ids report visited=True so
    padding never gets processed."""
    safe = torch.clamp_min(ids.long(), 0)
    word = torch.gather(bits, 1, safe // WORD)
    bit = (word >> (safe % WORD).to(torch.int32)) & 1
    return (bit == 1) | (ids < 0)


def visited_mark(bits: Tensor, ids: Tensor) -> Tensor:
    """Functional set: mark ids [B, W] visited → new bitsets (reference
    MaskAndMark's mark half), one read-modify-write OR per column so two
    ids of one row in the same word both land."""
    safe = torch.clamp_min(ids.long(), 0)
    words = safe // WORD
    masks = torch.where(ids >= 0, torch.ones_like(ids, dtype=torch.int32) << (safe % WORD).to(torch.int32), 0)
    rows = torch.arange(bits.shape[0], device=bits.device)
    out = bits.clone()
    for j in range(ids.shape[1]):
        out[rows, words[:, j]] = out[rows, words[:, j]] | masks[:, j]
    return out


def visited_test_and_mark(bits: Tensor, ids: Tensor) -> Tuple[Tensor, Tensor]:
    """Combined test+set (reference visitedTestAndSet / MaskAndMark):
    returns (was_visited [B, W], new_bits). Duplicates *within* the same ids
    row are also flagged (first occurrence wins), matching the sequential
    semantics of per-candidate test-and-set."""
    seen_before = visited_test(bits, ids)
    w = ids.shape[1]
    earlier = torch.tril(torch.ones((w, w), dtype=torch.bool, device=ids.device), diagonal=-1)
    dup_in_row = ((ids[:, :, None] == ids[:, None, :]) & earlier[None]).any(dim=-1)
    return seen_before | dup_in_row, visited_mark(bits, ids)


def dedup_mask(ids: Tensor, missing: Tensor) -> Tensor:
    """Position-preserving dedup: returns `missing` with all-but-the-first
    occurrence of each id additionally marked (reference dedupInPlace
    contract, CandidateDedup.swift:741), so slots stay index-matched with
    their companion arrays. The sort is stable, so of candidates arriving
    rank-ordered the best-ranked copy survives. Used by kernels/adc_probe
    under spill multi-assignment (ops.ivf.spill_assign)."""
    sid, order = torch.sort(ids, dim=1, stable=True)
    dup_sorted = torch.zeros_like(missing)
    dup_sorted[:, 1:] = sid[:, 1:] == sid[:, :-1]
    dup = torch.zeros_like(missing).scatter_(1, order, dup_sorted)
    return missing | dup


def dedup_candidates(dists: Tensor, ids: Tensor) -> Tuple[Tensor, Tensor]:
    """Batch dedupInPlace (reference :741): sort candidate lists by id, blank
    duplicate ids to (+inf, INVALID_ID), then restore (dist, id) order.
    Output shapes match the input; duplicates sort to the tail."""
    si, order = torch.sort(ids.to(torch.int32), dim=-1, stable=True)
    sd = torch.gather(dists.float(), -1, order)
    dup = torch.zeros_like(si, dtype=torch.bool)
    dup[..., 1:] = si[..., 1:] == si[..., :-1]
    sd = torch.where(dup, INVALID_DIST, sd)
    si = torch.where(dup, INVALID_ID, si)
    return topk(sd, sd.shape[-1], ids=si, strict_ties=True)
