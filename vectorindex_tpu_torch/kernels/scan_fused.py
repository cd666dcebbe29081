"""Fused flat-scan exact top-k: kernels K1 and K2 and their wrapper.

Counterpart of vectorindex_tpu/kernels/scan_fused.py. Two corpus passes
that never materialise the [B, N] distance matrix:

  K1 `bin_candidates`: kernel-space distances (below), then per query and
      per residue class c = row mod C the 3 smallest finite (dist, row)
      pairs in strict (dist, row) order -> 3 x [B, C] candidates.
  epilogue: strict (score, id) top-k over the 3C candidates; tau = k-th.
  K2 `count_below`: the same distances, counting dist < tau and dist <= tau
      per query. K2 recomputes K1's floats bit for bit, so
      count(all < tau) == count(selected < tau) and count(all <= tau) == k
      prove the selection exact; the caller re-runs the other queries
      through the strict path (ops/scan.scan_topk_strict).

Kernel-space distances omit ||q||^2 (monotone per query; added back for L2):

  L2:  bias - 2 (q.x)        bias = ||x||^2 (+inf dead)
  IP:  bias - (q.x)          bias = 0 (+inf dead)
  COS: bias - (q.x) cs       bias = 0 (+inf dead), cs = 1/||x||, q normalised

q is rounded to the corpus dtype before the product. The CUDA kernels live in
csrc/scan_fused.cu. `bin_candidates_ref` and `count_below_ref` are their
plain PyTorch versions: CPU tensors take them, CUDA tensors always launch the
kernel. The plain versions share one distance function with one chunking, so
on a given device K2-ref recomputes K1-ref's floats bit for bit too.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vectorindex_tpu_torch.ops.topk import INVALID_DIST, INVALID_ID, topk
from vectorindex_tpu_torch.utils.config import Metric

Tensor = torch.Tensor

#: residue classes per query (rows per tile); candidates per query = TIERS*C
C = 256
TIERS = 3
#: queries per CTA in the CUDA kernels (csrc/scan_fused.cu kTB)
QUERY_BLOCK = 8
#: CTAs a pass aims for: 4 per SM of the H100's 132
TARGET_CTAS = 4 * 132
#: most shared memory a CTA may use (the q block, QUERY_BLOCK x d f32)
MAX_SMEM_BYTES = 232_448
#: corpus rows per distance chunk in the plain versions
REF_CHUNK = 256 * C

_METRIC_CODE = {Metric.L2: 0, Metric.INNER_PRODUCT: 1, Metric.COSINE: 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches per wrapper since the last reset (plain versions do not count)
LAUNCHES = {"bin_candidates": 0, "count_below": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _dist_ref(q, x, bias, colscale, metric: Metric, start: int, stop: int) -> Tensor:
    """Kernel-space distances of rows [start, stop) -> [B, stop - start]."""
    g = q.to(x.dtype).float() @ x[start:stop].float().T
    b = bias[start:stop]
    if metric == Metric.L2:
        return b - 2.0 * g
    if metric == Metric.INNER_PRODUCT:
        return b - g
    return b - g * colscale[start:stop]


def class_top3_init(b: int, device) -> Tuple[Tensor, Tensor]:
    """Empty per-class tiers: (+inf [B, 3, C] f32, INVALID_ID [B, 3, C] int32)."""
    return (
        torch.full((b, TIERS, C), INVALID_DIST, device=device),
        torch.full((b, TIERS, C), INVALID_ID, dtype=torch.int32, device=device),
    )


def class_top3_fold(best_d: Tensor, best_i: Tensor, dist: Tensor, start: int) -> Tuple[Tensor, Tensor]:
    """Fold the distances of rows [start, start + W) (dist [B, W], W a
    multiple of C, every row above the tiers' rows) into the running
    per-class tiers: per class the 3 smallest finite (dist, row) in (dist,
    row) order. The selection of plain K1 and plain K8."""
    b = dist.shape[0]
    rows = torch.arange(start, start + dist.shape[1], dtype=torch.int32, device=dist.device)
    # running tiers first: their rows are all smaller than the chunk's, and
    # min() returns the first index of a tie, so each round takes the
    # smallest (dist, row)
    cat_d = torch.cat([best_d, dist.view(b, -1, C)], dim=1)
    cat_i = torch.cat([best_i, rows.view(1, -1, C).expand(b, -1, -1)], dim=1)
    picked_d, picked_i = [], []
    for _ in range(TIERS):
        v, pos = torch.min(cat_d, dim=1, keepdim=True)
        picked_d.append(v)
        picked_i.append(torch.gather(cat_i, 1, pos))
        cat_d = cat_d.scatter(1, pos, INVALID_DIST)
    best_d = torch.cat(picked_d, dim=1)
    best_i = torch.cat(picked_i, dim=1)
    return best_d, torch.where(torch.isfinite(best_d), best_i, INVALID_ID)


def bin_candidates_ref(
    q: Tensor, x: Tensor, bias: Tensor, colscale: Optional[Tensor], *, metric: Metric
) -> Tuple[Tensor, Tensor]:
    """Plain K1: per (query, class) the 3 smallest finite (dist, row) in
    (dist, row) order -> (dist [B, 3, C] f32, row [B, 3, C] int32); unfilled
    tiers are (+inf, INVALID_ID)."""
    n = x.shape[0]
    best_d, best_i = class_top3_init(q.shape[0], q.device)
    for start in range(0, n, REF_CHUNK):
        dist = _dist_ref(q, x, bias, colscale, metric, start, min(start + REF_CHUNK, n))
        best_d, best_i = class_top3_fold(best_d, best_i, dist, start)
    return best_d, best_i


def count_below_ref(
    q: Tensor,
    x: Tensor,
    bias: Tensor,
    colscale: Optional[Tensor],
    thresh: Tensor,
    *,
    metric: Metric,
) -> Tuple[Tensor, Tensor]:
    """Plain K2: per query, rows with dist < thresh and dist <= thresh ->
    (lt [B] int32, le [B] int32)."""
    n = x.shape[0]
    lt = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    le = torch.zeros_like(lt)
    t = thresh[:, None]
    for start in range(0, n, REF_CHUNK):
        dist = _dist_ref(q, x, bias, colscale, metric, start, min(start + REF_CHUNK, n))
        lt += (dist < t).sum(dim=1)
        le += (dist <= t).sum(dim=1)
    return lt.to(torch.int32), le.to(torch.int32)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_inputs(q, x, bias, colscale, metric: Metric) -> None:
    if metric not in _METRIC_CODE:
        raise ValueError(f"fused scan supports L2/IP/cosine, got {metric}")
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, x {tuple(x.shape)}")
    if q.dtype != torch.float32:
        raise TypeError(f"q must be float32, got {q.dtype}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.shape[0] % C:
        raise ValueError(f"corpus rows must be a multiple of {C} (pad_corpus)")
    need = [("bias", bias)] + ([("colscale", colscale)] if metric == Metric.COSINE else [])
    for name, t in need:
        if t is None or t.dtype != torch.float32 or t.shape != (x.shape[0],):
            raise ValueError(f"{name} must be float32 [{x.shape[0]}]")
    tensors = [q, x] + [t for _, t in need]
    if any(t.device != x.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")


def _grid(nq: int, n: int, d: int) -> Tuple[int, int]:
    """(splits, tiles per split) for a pass over n rows."""
    if QUERY_BLOCK * d * 4 > MAX_SMEM_BYTES:
        raise ValueError(f"d={d} exceeds the kernels' shared-memory limit")
    ntiles = n // C
    qblocks = -(-nq // QUERY_BLOCK)
    splits = max(1, min(ntiles, -(-TARGET_CTAS // qblocks)))
    per = -(-ntiles // splits)
    return -(-ntiles // per), per


def _ptr(t: Optional[Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def bin_candidates(
    q: Tensor, x: Tensor, bias: Tensor, colscale: Optional[Tensor], *, metric: Metric
) -> Tuple[Tensor, Tensor]:
    """K1 -> (dist [B, 3, C] f32, row [B, 3, C] int32). CUDA tensors launch
    the kernel (or raise); CPU tensors take bin_candidates_ref."""
    _check_inputs(q, x, bias, colscale, metric)
    if x.device.type == "cpu":
        return bin_candidates_ref(q, x, bias, colscale, metric=metric)
    from vectorindex_tpu_torch.kernels import _build

    nq, d = q.shape
    n = x.shape[0]
    out_d = torch.empty((nq, TIERS, C), dtype=torch.float32, device=x.device)
    out_i = torch.empty((nq, TIERS, C), dtype=torch.int32, device=x.device)
    if nq == 0 or n == 0:
        return out_d.fill_(INVALID_DIST), out_i.fill_(INVALID_ID)
    splits, per = _grid(nq, n, d)
    part_d = torch.empty((splits, nq, TIERS, C), dtype=torch.float32, device=x.device)
    part_i = torch.empty((splits, nq, TIERS, C), dtype=torch.int32, device=x.device)
    lib = _build.load()
    err = lib.vi_bin_candidates(
        q.data_ptr(), x.data_ptr(), bias.data_ptr(), _ptr(colscale),
        nq, n, d, _DTYPE_CODE[x.dtype], _METRIC_CODE[metric], splits, per,
        part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, err, "bin_candidates")
    LAUNCHES["bin_candidates"] += 1
    return out_d, out_i


def count_below(
    q: Tensor,
    x: Tensor,
    bias: Tensor,
    colscale: Optional[Tensor],
    thresh: Tensor,
    *,
    metric: Metric,
) -> Tuple[Tensor, Tensor]:
    """K2 -> (lt [B] int32, le [B] int32). CUDA tensors launch the kernel
    (or raise); CPU tensors take count_below_ref."""
    _check_inputs(q, x, bias, colscale, metric)
    if thresh.dtype != torch.float32 or thresh.shape != (q.shape[0],):
        raise ValueError(f"thresh must be float32 [{q.shape[0]}]")
    if thresh.device != x.device or not thresh.is_contiguous():
        raise ValueError("thresh must be contiguous and on the corpus device")
    if x.device.type == "cpu":
        return count_below_ref(q, x, bias, colscale, thresh, metric=metric)
    from vectorindex_tpu_torch.kernels import _build

    nq, d = q.shape
    n = x.shape[0]
    # zeroed, not empty: the kernel adds into them with atomics
    lt = torch.zeros(nq, dtype=torch.int32, device=x.device)
    le = torch.zeros(nq, dtype=torch.int32, device=x.device)
    if nq == 0 or n == 0:
        return lt, le
    splits, per = _grid(nq, n, d)
    lib = _build.load()
    err = lib.vi_count_below(
        q.data_ptr(), x.data_ptr(), bias.data_ptr(), _ptr(colscale),
        thresh.data_ptr(), nq, n, d, _DTYPE_CODE[x.dtype], _METRIC_CODE[metric],
        splits, per, lt.data_ptr(), le.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, err, "count_below")
    LAUNCHES["count_below"] += 1
    return lt, le


# ---------------------------------------------------------------------------
# corpus padding and the exact top-k wrapper
# ---------------------------------------------------------------------------


def pad_corpus(
    x: Tensor, sqnorms: Optional[Tensor], valid: Optional[Tensor]
) -> Tuple[Tensor, Tensor, Tensor]:
    """Pad corpus rows to a multiple of C; returns (x_pad, sq_pad, valid_pad)
    with padded rows dead. Unpadded inputs are returned as they are."""
    n = x.shape[0]
    rpad = (-n) % C
    if sqnorms is None:
        xf = x.float()
        sqnorms = (xf * xf).sum(dim=1)
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=x.device)
    if rpad:
        x = torch.cat([x, x.new_zeros((rpad, x.shape[1]))])
        sqnorms = torch.cat([sqnorms, sqnorms.new_zeros(rpad)])
        valid = torch.cat([valid, valid.new_zeros(rpad)])
    return x.contiguous(), sqnorms.float().contiguous(), valid


def kernel_inputs(
    q: Tensor, sq_pad: Tensor, valid_pad: Tensor, metric: Metric
) -> Tuple[Tensor, Tensor, Optional[Tensor], Optional[Tensor]]:
    """(q_kernel, bias, colscale, qsq): the K1/K2 operands of scan_topk_fused
    for queries q [B, d] over a padded corpus; qsq is ||q||^2 for L2."""
    q = q.float().contiguous()
    bias = torch.where(valid_pad, 0.0, INVALID_DIST)
    if metric == Metric.L2:
        return q, torch.where(valid_pad, sq_pad, INVALID_DIST), None, (q * q).sum(dim=1)
    if metric == Metric.INNER_PRODUCT:
        return q, bias, None, None
    colscale = torch.where(
        valid_pad & (sq_pad > 0), torch.rsqrt(torch.clamp_min(sq_pad, 1e-30)), 0.0
    )
    qn = torch.sqrt(torch.clamp_min((q * q).sum(dim=1, keepdim=True), 1e-30))
    return (q / qn).contiguous(), bias, colscale, None


def scan_topk_fused(
    q: Tensor,
    x_pad: Tensor,
    sq_pad: Tensor,
    valid_pad: Tensor,
    *,
    metric: Metric,
    k: int,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Exact-verified top-k via K1 + K2 -> (dist [B,k] f32, ids [B,k] int32,
    exact [B] bool); rows with exact=False must be re-run through
    scan_topk_strict. x_pad, sq_pad, valid_pad come from pad_corpus."""
    b = q.shape[0]
    qk, bias, colscale, qsq = kernel_inputs(q, sq_pad, valid_pad, metric)
    cd, ci = bin_candidates(qk, x_pad, bias, colscale, metric=metric)
    kk = min(k, 2 * C)
    sd, si = topk(cd.view(b, -1), kk, ids=ci.view(b, -1), strict_ties=True)
    tau = sd[:, kk - 1].contiguous()  # kernel space: bit-identical to K2's
    counts_lt, counts_le = count_below(qk, x_pad, bias, colscale, tau, metric=metric)
    result_below = (sd < tau[:, None]).sum(dim=1)
    n_valid = valid_pad.sum()
    # exact requires (a) every strictly-better row selected and (b) no corpus
    # tau-ties beyond the kk selected: with extra rows at dist == tau the
    # strict (score, id) contract may demand a lower-id tie the candidates
    # dropped, so such queries go to the strict path. A non-finite tau means
    # fewer than kk candidates: exact only if they are every live row (K1
    # keeps 3 per class, so a 4th live row of one class can be missing; the
    # JAX package's n_valid <= kk test misses that)
    exact = torch.where(
        torch.isfinite(tau),
        (counts_lt == result_below) & (counts_le == kk),
        torch.isfinite(sd).sum(dim=1) == n_valid,
    )
    # kernel space -> public ascending distances
    finite = torch.isfinite(sd)
    if metric == Metric.L2:
        sd = torch.where(finite, torch.clamp_min(sd + qsq[:, None], 0.0), sd)
    elif metric == Metric.COSINE:
        sd = 1.0 + sd
    si = torch.where(finite, si, INVALID_ID)
    if k > kk:
        # ranks >= kk are padding, so the result is not the exact top-k
        # unless every live row was already selected
        sd = torch.cat([sd, sd.new_full((b, k - kk), INVALID_DIST)], dim=1)
        si = torch.cat([si, si.new_full((b, k - kk), INVALID_ID)], dim=1)
        exact = exact & (n_valid <= kk)
    return sd, si, exact
