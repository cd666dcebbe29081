"""Graph-index ops: level sampling, batched greedy descent, batched beam
search, diversity neighbor selection/pruning.

Counterpart of vectorindex_tpu.ops.graph (parity targets: the reference's
Kernels/HNSWTraversal.swift:282-307, HNSWNeighborSelection.swift:132,253 and
HNSWLevelAssignment.swift:77). Plain torch on tensors of any device; the JAX
package runs these as XLA programs and has no kernel here.

The design is the JAX package's batched frontier: a query batch walks the
graph together with fixed iteration counts and masked state, each iteration
expands `expand` beam slots per query, scores their fixed-width neighbor rows
as one [B, W] block and merges by a two-key (distance, id) sort; the visited
set is an append-only ring of expanded ids per query. Its semantics are kept
exactly:

  - fixed `steps` / `iters`, converged queries masked (no early exit);
  - argmin / argmax take the first index of a tie (bool cast to an integer
    type before argmax);
  - `lax.sort((d, i, x), num_keys=2)` is a stable sort by id, then a stable
    sort by distance, the expanded flag gathered along (ops/topk's idea);
  - f32 products: on CUDA they refuse to run while TF32 matmuls are enabled.

No loop here synchronises with the host: no `.item()`, no one-argument
`torch.where` / `nonzero`, no boolean-mask indexing. A whole search is
enqueued work. Gathers clamp their indices into range where the JAX package
relies on XLA's clamping; the rows read there are masked by the caller.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from vectorindex_tpu_torch.ops.scoring import check_full_f32
from vectorindex_tpu_torch.ops.topk import INVALID_DIST, INVALID_ID

Tensor = torch.Tensor

LEVEL_CAP = 16  # reference cap (HNSWLevelAssignment.swift)


# ---------------------------------------------------------------------------
# #35 — level assignment
# ---------------------------------------------------------------------------


def sample_levels(gen: torch.Generator, n: int, m: int, cap: int = LEVEL_CAP) -> Tensor:
    """Geometric levels l = ⌊−ln(u)·mL⌋, mL = 1/ln(M), capped (reference
    hnswSampleLevel), u uniform on [1e-12, 1). Deterministic per generator
    (ops/rng); the draws are not the JAX package's threefry bits."""
    u = torch.rand(n, generator=gen, device=gen.device, dtype=torch.float64)
    u = 1e-12 + (1.0 - 1e-12) * u
    ml = 1.0 / torch.log(torch.tensor(max(float(m), 2.0), dtype=torch.float64))
    return torch.clamp_max(torch.floor(-torch.log(u) * ml), cap).to(torch.int32)


# ---------------------------------------------------------------------------
# scoring helper (dense [B, W] neighbor block)
# ---------------------------------------------------------------------------


def _safe_rows(rows: Tensor, n: int) -> Tensor:
    """Rows clamped into [0, n) as gather indices (int64)."""
    rows = rows.long()
    return torch.where((rows >= 0) & (rows < n), rows, 0)


def _dist_rows(q: Tensor, rows: Tensor, vecs: Tensor, sqn: Tensor) -> Tensor:
    """d²(q_b, vecs[rows[b, j]]) for a row table rows [B, W] → [B, W].
    Invalid rows (< 0 or INVALID_ID) must be masked by the caller."""
    check_full_f32(q)
    safe = _safe_rows(rows, vecs.shape[0])
    xg = vecs[safe].float()  # [B, W, d]
    sg = sqn[safe]
    qf = q.float()
    g = torch.einsum("bd,bwd->bw", qf, xg)
    qn = torch.sum(qf * qf, dim=-1)
    return torch.clamp_min(qn[:, None] + sg - 2.0 * g, 0.0)


def _sort2(d: Tensor, i: Tensor, *rest: Tensor):
    """Sort rows by (d, i) ascending — lax.sort(num_keys=2) — carrying the
    `rest` tensors along: a stable sort by id, then a stable sort by
    distance."""
    i, p = torch.sort(i, dim=-1, stable=True)
    d = torch.gather(d, -1, p)
    rest = [torch.gather(r, -1, p) for r in rest]
    d, p = torch.sort(d, dim=-1, stable=True)
    return (d, torch.gather(i, -1, p), *(torch.gather(r, -1, p) for r in rest))


def _first_true(mask: Tensor) -> Tensor:
    """Index of the first True per row (0 where none): jnp.argmax on bool."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


# ---------------------------------------------------------------------------
# #33 — greedy descent (upper levels)
# ---------------------------------------------------------------------------


def greedy_descent(
    q: Tensor,  # [B, d]
    vecs: Tensor,  # [N, d] global vector table
    sqn: Tensor,  # [N]
    nbrs: Tensor,  # [n_l, M] neighbor rows (global ids, −1 empty)
    lookup: Tensor,  # [N] global id → level-local row (−1 absent)
    entry: Tensor,  # [B] global entry ids
    *,
    steps: int,
) -> Tensor:
    """Batched greedy walk: move to the closest neighbor when it improves;
    fixed `steps` iterations with converged queries masked (reference
    greedyDescent_core, HNSWTraversal.swift:176-211)."""
    cur = entry.to(torch.int32)
    cur_d = _dist_rows(q, cur[:, None], vecs, sqn)[:, 0]
    for _ in range(steps):
        rows = lookup[cur.long()]  # [B]
        nb = nbrs[torch.clamp_min(rows, 0).long()]  # [B, M] global ids
        valid = (nb >= 0) & (rows >= 0)[:, None]
        nd = torch.where(valid, _dist_rows(q, nb, vecs, sqn), INVALID_DIST)
        j = torch.argmin(nd, dim=1, keepdim=True)
        best_d = torch.gather(nd, 1, j)[:, 0]
        best_i = torch.gather(nb, 1, j)[:, 0]
        better = best_d < cur_d
        cur = torch.where(better, best_i, cur)
        cur_d = torch.where(better, best_d, cur_d)
    return cur


# ---------------------------------------------------------------------------
# #33 — batched beam search (base layer ef-search)
# ---------------------------------------------------------------------------


class BeamResult(NamedTuple):
    dists: Tensor  # [B, ef] ascending
    ids: Tensor  # [B, ef] global ids (INVALID_ID padded)


def beam_search(
    q: Tensor,  # [B, d]
    vecs: Tensor,
    sqn: Tensor,
    nbrs: Tensor,  # [n, M] (level 0: rows are reached through lookup or are ids)
    lookup: Optional[Tensor],  # None: nbrs rows are global ids (identity)
    entry: Tensor,  # [B] global entry ids
    *,
    ef: int,
    iters: int,
    expand: int = 1,
) -> BeamResult:
    """Batched bounded best-first search (reference efSearch_core,
    HNSWTraversal.swift:221-280).

    State per query: a beam of (dist, id, expanded) sorted ascending and an
    append-only visited ring of expanded ids. Each iteration expands the
    `expand` best unexpanded beam slots; their neighbor rows are scored as
    one block; candidates already visited, in the beam or earlier in the
    block are masked; beam = the first ef of (beam ∪ candidates) by
    (dist, id). expand > 1 trades strict best-first order for ~expand×
    fewer sequential iterations (the standard beam-width relaxation)."""
    b = q.shape[0]
    m = nbrs.shape[1]
    e = expand
    w = e * m  # candidates per iteration
    dev = q.device

    beam_d = torch.full((b, ef), INVALID_DIST, device=dev)
    beam_i = torch.full((b, ef), INVALID_ID, dtype=torch.int32, device=dev)
    beam_x = torch.zeros((b, ef), dtype=torch.int32, device=dev)  # expanded flag
    entry = entry.to(torch.int32)
    beam_d[:, 0] = _dist_rows(q, entry[:, None], vecs, sqn)[:, 0]
    beam_i[:, 0] = entry
    visited = torch.full((b, iters * e), INVALID_ID, dtype=torch.int32, device=dev)
    slot = torch.arange(e, device=dev)[None, :]
    earlier = torch.tril(torch.ones((w, w), dtype=torch.bool, device=dev), diagonal=-1)

    for t in range(iters):
        # the e best unexpanded slots: the beam is sorted ascending, so a
        # stable argsort on the expanded flag keeps beam order among them
        unexp = (beam_x == 0) & (beam_i != INVALID_ID)
        order = torch.argsort((~unexp).to(torch.uint8), dim=1, stable=True)[:, :e]
        has = slot < unexp.sum(dim=1, keepdim=True)
        cur = torch.where(has, torch.gather(beam_i, 1, order), 0)
        # mark expanded + record in the visited ring
        marks = torch.where(has, 1, torch.gather(beam_x, 1, order)).to(torch.int32)
        beam_x = beam_x.scatter(1, order, marks)
        visited[:, t * e : (t + 1) * e] = torch.where(has, cur, INVALID_ID)

        rws = lookup[cur.long()] if lookup is not None else cur  # [B, e]
        nb = nbrs[torch.clamp_min(rws, 0).long()]  # [B, e, M]
        valid = (nb >= 0) & (rws >= 0)[:, :, None] & has[:, :, None]
        nb = nb.reshape(b, w)
        valid = valid.reshape(b, w)
        # mask already-visited / in-beam candidates and duplicates within
        # this iteration's block
        seen_v = torch.any(nb[:, :, None] == visited[:, None, :], dim=-1)
        seen_b = torch.any(nb[:, :, None] == beam_i[:, None, :], dim=-1)
        dup_row = torch.any((nb[:, :, None] == nb[:, None, :]) & earlier, dim=-1)
        valid = valid & ~seen_v & ~seen_b & ~dup_row
        nd = torch.where(valid, _dist_rows(q, nb, vecs, sqn), INVALID_DIST)
        nbm = torch.where(valid, nb, INVALID_ID)

        # merge beam ∪ candidates → the first ef by (dist, id), flags along
        all_d = torch.cat([beam_d, nd], dim=1)
        all_i = torch.cat([beam_i, nbm], dim=1)
        all_x = torch.cat([beam_x, torch.zeros_like(nbm)], dim=1)
        sd, si, sx = _sort2(all_d, all_i, all_x)
        beam_d, beam_i, beam_x = sd[:, :ef], si[:, :ef], sx[:, :ef]
    return BeamResult(beam_d, beam_i)


# ---------------------------------------------------------------------------
# #34 — diversity neighbor selection / pruning
# ---------------------------------------------------------------------------


def select_neighbors_diverse(
    cand_d: Tensor,  # [C, ef] candidate distances to the new point (ascending)
    cand_i: Tensor,  # [C, ef] candidate global ids (INVALID_ID padded)
    vecs: Tensor,
    sqn: Tensor,
    *,
    m: int,
) -> Tensor:
    """Heuristic selection (reference hnsw_select_neighbors_f32_swift,
    HNSWNeighborSelection.swift:132): walk candidates by ascending distance;
    keep c iff d(c, new) < min over selected s of d(c, s). Returns
    [C, min(m, ef)] global ids (INVALID_ID padded).

    Batched as in the JAX package: the alive set (valid and closer to the
    new point than to every selection) only shrinks, so the next sequential
    pick is the first alive candidate; min(m, ef) steps of "pick the first
    alive" equal the sequential walk. The rest of the row is filled with the
    nearest pruned candidates ("keep pruned connections")."""
    c, ef = cand_d.shape
    check_full_f32(cand_d)
    valid = cand_i != INVALID_ID
    safe = _safe_rows(cand_i, vecs.shape[0])
    cv = vecs[safe].float()  # [C, ef, d]
    csq = sqn[safe].float()
    col = torch.arange(ef, device=cand_d.device)[None, :]
    selected = torch.zeros((c, ef), dtype=torch.bool, device=cand_d.device)
    min_d = torch.full((c, ef), INVALID_DIST, device=cand_d.device)
    for _ in range(min(m, ef)):
        alive = valid & (cand_d < min_d)
        any_alive = torch.any(alive, dim=1, keepdim=True)
        j = _first_true(alive)[:, None]  # first alive = next sequential pick
        selected = selected | (alive & (col == j))
        # distances from every candidate to the picked one (dot trick)
        vsel = torch.gather(cv, 1, j[:, :, None].expand(c, 1, cv.shape[2]))  # [C, 1, d]
        ssel = torch.gather(csq, 1, j)  # [C, 1]
        dot = torch.einsum("ced,cfd->ce", cv, vsel)
        dsel = torch.clamp_min(csq + ssel - 2.0 * dot, 0.0)
        dsel = torch.where(any_alive, dsel, INVALID_DIST)
        min_d = torch.minimum(min_d, dsel)
    # compact: diversity-selected first (by rank), then the nearest pruned,
    # invalid last (distinct keys: the order is unique)
    rank = torch.where(selected, col, ef + col)
    rank = torch.where(valid, rank, 2 * ef + col)
    order = torch.argsort(rank, dim=1, stable=True)[:, :m]
    out = torch.gather(cand_i, 1, order)
    ok = torch.gather(valid, 1, order)
    return torch.where(ok, out, INVALID_ID)


def prune_neighbors(
    node_ids: Tensor,  # [C] nodes whose lists overflowed
    lists: Tensor,  # [C, L] candidate neighbor ids (incl. the new edges)
    vecs: Tensor,
    sqn: Tensor,
    *,
    m: int,
) -> Tensor:
    """Prune overflowed neighbor lists back to m by the same diversity rule
    (reference hnsw_prune_neighbors_f32_swift, HNSWNeighborSelection.swift:253).
    Returns [C, min(m, L)]."""
    base = vecs[node_ids.long()]  # [C, d]
    d = _dist_rows(base, lists, vecs, sqn)
    d = torch.where(lists != INVALID_ID, d, INVALID_DIST)
    sd, si = _sort2(d, lists.to(torch.int32))
    return select_neighbors_diverse(sd, si, vecs, sqn, m=m)
