"""Comparison rules shared by the port's parity tests and chip_smoke.py.

Two exact top-k answers computed with f32 sums in different orders may
order near-equal distances differently. `ids_match_up_to_ties` accepts
exactly that and nothing else: ids must be equal at every rank, except at a
rank whose reference distance lies within the tolerance of a neighbouring
rank's.
"""

from __future__ import annotations

import numpy as np

#: f32 distances summed in another order (bf16 products are exact in f32)
RTOL, ATOL = 2e-4, 2e-5


def ids_match_up_to_ties(ids_a, ids_b, dist_ref, k: int, rtol=RTOL, atol=ATOL) -> bool:
    """ids_a[:, :k] == ids_b[:, :k] except at near-tied ranks of dist_ref.
    Give dist_ref k+1 columns where it has them, so a swap across rank k is
    recognised as a tie too."""
    ids_a = np.asarray(ids_a)[:, :k]
    ids_b = np.asarray(ids_b)[:, :k]
    d = np.asarray(dist_ref, dtype=np.float64)
    tol = atol + rtol * np.abs(d)
    near_prev = np.zeros(d.shape, dtype=bool)
    with np.errstate(invalid="ignore"):
        near_prev[:, 1:] = np.abs(d[:, 1:] - d[:, :-1]) <= tol[:, 1:]
    near_next = np.zeros_like(near_prev)
    near_next[:, :-1] = near_prev[:, 1:]
    tie = (near_prev | near_next)[:, :k]
    return bool(((ids_a == ids_b) | tie).all())


# ---------------------------------------------------------------------------
# the tensor-core rule: a bf16 corpus scanned by mma (kernels/scan_fused)
# ---------------------------------------------------------------------------

#: one f32 ulp at 1.0
F32_ULP = 2.0**-23


def _scale(metric, colscale, rows):
    """The factor on the dot product in kernel space at `rows`."""
    from vectorindex_tpu_torch.utils.config import Metric

    if metric == Metric.L2:
        return 2.0
    if metric == Metric.INNER_PRODUCT:
        return 1.0
    return colscale[rows].double()


def tensor_core_reference(q, x, bias, colscale, rows, metric):
    """(exact float64 kernel-space distances, tolerance), both [B, R], at
    corpus rows `rows` [B, R] (out-of-range ids read row 0) for queries
    q [B, d] f32 over a bf16 corpus x. The tensor cores sum the exact bf16
    products in another order than IEEE f32: each sum of d terms is within
    2 d 2^-23 sum_k |q_k x_k| of the exact one; the metric scales it (2 for
    L2, colscale for cosine) and the rounded epilogue adds 2^-22 |dist|."""
    import torch

    rows = torch.where((rows >= 0) & (rows < x.shape[0]), rows, 0).long()
    qb = q.to(x.dtype).double()
    xr = x[rows].double()  # [B, R, d]
    g = torch.einsum("bd,brd->br", qb, xr)
    s = torch.einsum("bd,brd->br", qb.abs(), xr.abs())
    scale = _scale(metric, colscale, rows)
    exact = bias[rows].double() - scale * g
    tol = 2.0 * q.shape[1] * F32_ULP * s * scale + 2.0 * F32_ULP * exact.abs()
    return exact, tol


def tensor_core_candidates_ok(kd, ki, rd, ri, q, x, bias, colscale, metric):
    """Hold a kernel's per-class candidates (kd, ki) [B, 3, C] on a bf16
    corpus to the plain version's (rd, ri) under the tensor-core rule ->
    (ok, largest |kernel - exact| over finite candidates): the same tiers are
    finite; each kernel distance is within tolerance of the exact distance
    at its row; each candidate is no worse than its class's plain third
    tier by more than the two rows' tolerances."""
    b = kd.shape[0]
    finite = kd.isfinite()
    if not finite.eq(rd.isfinite()).all():
        return False, float("inf")
    exact, tol = tensor_core_reference(q, x, bias, colscale, ki.view(b, -1), metric)
    err = (kd.view(b, -1).double() - exact).abs().where(finite.view(b, -1), 0.0)
    if not (err <= tol).all():
        return False, float(err.max())
    _, tol3 = tensor_core_reference(q, x, bias, colscale, ri[:, 2].reshape(b, -1), metric)
    bound = rd[:, 2:3].double() + tol.view(kd.shape) + tol3.view(b, 1, -1)
    worse = finite & rd[:, 2:3].isfinite() & (kd.double() > bound)
    return not bool(worse.any()), float(err.max())


def count_near(q, x, bias, colscale, tau, metric, chunk: int = 65536):
    """Per query, rows whose plain distance lies within twice the
    tensor-core tolerance of tau [B]: the most by which a bf16 kernel's
    counts below tau may differ from the plain version's."""
    import torch

    from vectorindex_tpu_torch.kernels.scan_fused import _dist_ref

    qb = q.to(x.dtype).float()
    near = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    for start in range(0, x.shape[0], chunk):
        stop = min(start + chunk, x.shape[0])
        dist = _dist_ref(q, x, bias, colscale, metric, start, stop).double()
        s = (qb.abs() @ x[start:stop].float().abs().T).double()
        scale = _scale(metric, colscale, torch.arange(start, stop, device=q.device))
        tol = 2.0 * q.shape[1] * F32_ULP * s * scale + 2.0 * F32_ULP * dist.abs()
        near += ((dist - tau[:, None].double()).abs() <= 2.0 * tol).sum(dim=1)
    return near
