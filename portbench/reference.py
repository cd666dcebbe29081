"""The plain reference: exact top-k by (distance, id), in float64.

It imports nothing of the program. It works its answers out from the rows
and queries the benchmark generated (the host arrays it handed to the
program), on the device in blocks of rows and queries, so that it fits
beside nothing else once the program's state is freed.

Distances ascend: L2 is the squared distance, inner product its negation,
cosine 1 - cos. Public scores are what the index API states: the L2
distance (its square root, rounded to float32 as the API's scores are),
the inner product, the cosine similarity.

The reference rounds the rows to the configuration's storage dtype, as the
index stores them, and keeps the queries as generated. The control rounds
rows and queries to the nearest precision below the one the configuration
states (float8_e4m3 below bfloat16, tf32 below float32), to show that the
comparison fails it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

ROW_BLOCK = 1 << 19
QUERY_BLOCK = 512


def round_to(x: torch.Tensor, precision: Optional[str]) -> torch.Tensor:
    """x (any float dtype) rounded to `precision`, returned as float64."""
    x = x.to(torch.float32)
    if precision is None or precision == "float32":
        return x.to(torch.float64)
    if precision == "bfloat16":
        return x.to(torch.bfloat16).to(torch.float64)
    if precision == "float8_e4m3":
        return x.to(torch.float8_e4m3fn).to(torch.float64)
    if precision == "tf32":
        # round to nearest, ties to even, on the 13 mantissa bits TF32 drops
        bits = x.contiguous().view(torch.int32)
        lsb = (bits >> 13) & 1
        bits = (bits + 0xFFF + lsb) & ~0x1FFF
        return bits.view(torch.float32).to(torch.float64)
    raise ValueError(f"unknown precision {precision!r}")


def _distances(q: torch.Tensor, x: torch.Tensor, metric: str) -> torch.Tensor:
    """[Q, R] ascending distances, float64 inputs."""
    if metric == "l2":
        return (q * q).sum(1)[:, None] + (x * x).sum(1)[None, :] - 2.0 * (q @ x.T)
    if metric == "ip":
        return -(q @ x.T)
    if metric == "cosine":
        qn = q / torch.clamp_min(torch.linalg.vector_norm(q, dim=1, keepdim=True), 1e-300)
        xn = x / torch.clamp_min(torch.linalg.vector_norm(x, dim=1, keepdim=True), 1e-300)
        return 1.0 - qn @ xn.T
    raise ValueError(f"unknown metric {metric!r}")


def _lex_topk(dist: torch.Tensor, ids: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest of each row by (dist, id): sort by id, then stably by
    dist."""
    ids, order = torch.sort(ids, dim=1, stable=True)
    dist = torch.gather(dist, 1, order)
    dist, order = torch.sort(dist, dim=1, stable=True)
    return dist[:, :k], torch.gather(ids, 1, order[:, :k])


def _block_topk(dist: torch.Tensor, col_ids: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact (dist, id) top-k of a [Q, R] block whose column c holds the row
    col_ids[c] (ascending). Every column at or below the k-th value is a
    candidate, so ties at the boundary keep their lowest ids."""
    kk = min(k, dist.shape[1])
    tau = torch.topk(dist, kk, dim=1, largest=False).values[:, kk - 1 :]
    q_idx, col = torch.nonzero(dist <= tau, as_tuple=True)
    counts = torch.bincount(q_idx, minlength=dist.shape[0])
    width = int(counts.max())
    # scatter each query's candidates into a padded [Q, width] block
    start = torch.cumsum(counts, 0) - counts
    slot = torch.arange(q_idx.numel(), device=dist.device) - start[q_idx]
    cd = torch.full((dist.shape[0], width), float("inf"), dtype=dist.dtype, device=dist.device)
    ci = torch.full((dist.shape[0], width), np.iinfo(np.int64).max, dtype=torch.int64, device=dist.device)
    cd[q_idx, slot] = dist[q_idx, col]
    ci[q_idx, slot] = col_ids[col]
    return _lex_topk(cd, ci, kk)


def exact_topk(
    rows: np.ndarray,
    queries: np.ndarray,
    metric: str,
    k: int,
    device: torch.device,
    row_precision: Optional[str] = None,
    query_precision: Optional[str] = None,
    allowed: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """(ids [Q, k] int64, dist [Q, k] float64) of every query over `rows`,
    or over the rows that `allowed` (a bool mask over them) marks. A query
    with fewer than k such rows pads its answer with id -1 at distance
    inf."""
    nq = queries.shape[0]
    best_d = torch.full((nq, 0), float("inf"), dtype=torch.float64, device=device)
    best_i = torch.zeros((nq, 0), dtype=torch.int64, device=device)
    qall = round_to(torch.from_numpy(queries).to(device), query_precision)
    for s in range(0, rows.shape[0], ROW_BLOCK):
        block = rows[s : s + ROW_BLOCK]
        col_ids = np.arange(s, s + block.shape[0])
        if allowed is not None:
            keep = allowed[s : s + ROW_BLOCK]
            block, col_ids = block[keep], col_ids[keep]
            if not block.shape[0]:
                continue
        x = round_to(torch.from_numpy(np.ascontiguousarray(block)).to(device), row_precision)
        col_ids = torch.from_numpy(col_ids).to(device)
        parts_d, parts_i = [], []
        for qs in range(0, nq, QUERY_BLOCK):
            d, i = _block_topk(_distances(qall[qs : qs + QUERY_BLOCK], x, metric), col_ids, k)
            parts_d.append(d)
            parts_i.append(i)
        best_d, best_i = _lex_topk(
            torch.cat([best_d, torch.cat(parts_d)], 1), torch.cat([best_i, torch.cat(parts_i)], 1), k
        )
    if best_d.shape[1] < k:
        pad = k - best_d.shape[1]
        best_d = torch.cat([best_d, torch.full((nq, pad), float("inf"), dtype=best_d.dtype, device=device)], 1)
        best_i = torch.cat([best_i, torch.full((nq, pad), -1, dtype=best_i.dtype, device=device)], 1)
    return best_i.cpu().numpy(), best_d.cpu().numpy()


def distances_of(
    rows: np.ndarray,
    queries: np.ndarray,
    ids: np.ndarray,
    metric: str,
    device: torch.device,
    row_precision: Optional[str] = None,
) -> np.ndarray:
    """[Q, k] float64 reference distances of the given row ids (ids [Q, k],
    each in range)."""
    q = round_to(torch.from_numpy(queries).to(device), None)
    x = round_to(torch.from_numpy(rows[ids.reshape(-1)]).to(device), row_precision)
    x = x.view(*ids.shape, -1)
    if metric == "l2":
        out = ((x - q[:, None, :]) ** 2).sum(-1)
    elif metric == "ip":
        out = -(x * q[:, None, :]).sum(-1)
    elif metric == "cosine":
        qn = q / torch.clamp_min(torch.linalg.vector_norm(q, dim=1, keepdim=True), 1e-300)
        xn = x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-300)
        out = 1.0 - (xn * qn[:, None, :]).sum(-1)
    else:
        raise ValueError(f"unknown metric {metric!r}")
    return out.cpu().numpy()


def public_scores(dist: np.ndarray, metric: str) -> np.ndarray:
    """Reference distances as the index API's public scores."""
    if metric == "l2":
        return np.sqrt(np.maximum(dist, 0.0).astype(np.float32)).astype(np.float64)
    if metric == "ip":
        return -dist
    if metric == "cosine":
        return 1.0 - dist
    raise ValueError(f"unknown metric {metric!r}")
