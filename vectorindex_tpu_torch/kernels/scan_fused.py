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
csrc/scan_fused.cu: on a bf16 corpus they run on the tensor cores
(mma.sync, f32 accumulation), on an f32 corpus on the CUDA cores (one f32
FMA chain per dot product). `bin_candidates_ref` and `count_below_ref` are
their plain PyTorch versions: CPU tensors take them, CUDA tensors always
launch the kernel. The plain versions share one distance function with one
chunking, so on a given device K2-ref recomputes K1-ref's floats bit for bit
too. Kernel against plain version: equal bit for bit on f32 corpora and on
integer-valued bf16 data (every partial sum exact); on other bf16 data each
kernel distance lies within 2 d 2^-23 sum_k |q_k x_k| (times 2 for L2,
times colscale for cosine) of the exact one, as the tensor cores' sum order
is not cuBLAS's.

K11 `bin_candidates_tree` (the round-5 A/B kernel of scripts/ab_flat_tree.py,
mode "tree") is K1 keeping, per query, class and block of `tile` rows, only
the block's smallest distance and its first row, folded into the same 3
tiers. `bin_candidates_fma` runs K1's earlier CUDA-core design on a bf16
corpus, for the A/B only (scripts/ab_flat_tree_torch.py).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from vectorindex_tpu_torch.ops.topk import INVALID_DIST, INVALID_ID, topk
from vectorindex_tpu_torch.utils.config import Metric

Tensor = torch.Tensor

#: residue classes per query (rows per tile); candidates per query = TIERS*C
C = 256
TIERS = 3
#: queries per CTA of the CUDA-core (f32) kernels (csrc/scan_fused.cu kTB)
QUERY_BLOCK = 8
#: the tensor-core (bf16) kernels: a warp computes MMA_TILE corpus rows x
#: MMA_TILE queries; a CTA holds up to MMA_WARPS warps, split into query and
#: class warps, and streams its rows through MMA_STAGES shared-memory stages
#: of about MMA_STAGE_ROWS rows (whole 256-row tiles' class-group rows),
#: with MMA_PAD bf16 of padding after each row (kMmaTile, kMmaWarps,
#: kStages, kMmaPad)
MMA_TILE, MMA_WARPS, MMA_STAGES, MMA_STAGE_ROWS, MMA_PAD = 16, 8, 2, 128, 8
#: the H100's SMs, and the shared memory of one SM
SMS, SM_SMEM_BYTES = 132, 233_472
#: CTAs a pass of the CUDA-core kernels aims for: 4 per SM
TARGET_CTAS = 4 * SMS
#: most shared memory a CTA may use
MAX_SMEM_BYTES = 232_448
#: corpus rows per distance chunk in the plain versions
REF_CHUNK = 256 * C

_METRIC_CODE = {Metric.L2: 0, Metric.INNER_PRODUCT: 1, Metric.COSINE: 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches per wrapper since the last reset (plain versions do not count)
LAUNCHES = dict.fromkeys(
    ("bin_candidates", "count_below", "bin_candidates_tree", "bin_candidates_fma"), 0)


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
    return _fold_rows(best_d, best_i, dist.view(b, -1, C), rows.view(1, -1, C).expand(b, -1, -1))


def _fold_rows(
    best_d: Tensor, best_i: Tensor, cand_d: Tensor, cand_i: Tensor
) -> Tuple[Tensor, Tensor]:
    """Fold candidates cand_d/cand_i [B, J, C] into the per-class tiers; per
    class the candidates' rows grow along J and lie above the tiers' rows."""
    # running tiers first: their rows are all smaller than the candidates',
    # and min() returns the first index of a tie, so each round takes the
    # smallest (dist, row)
    cat_d = torch.cat([best_d, cand_d], dim=1)
    cat_i = torch.cat([best_i, cand_i], dim=1)
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


def bin_candidates_tree_ref(
    q: Tensor, x: Tensor, bias: Tensor, *, metric: Metric, tile: int
) -> Tuple[Tensor, Tensor]:
    """Plain K11: per (query, class) and block of `tile` rows the smallest
    distance and its first row, folded by (dist, row) into 3 tiers ->
    (dist [B, 3, C] f32, row [B, 3, C] int32); unfilled tiers are (+inf,
    INVALID_ID). n must be a multiple of tile, tile of C."""
    n, b = x.shape[0], q.shape[0]
    best_d, best_i = class_top3_init(b, q.device)
    chunk = tile * max(1, REF_CHUNK // tile)
    cls = torch.arange(C, dtype=torch.int32, device=q.device)
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        dist = _dist_ref(q, x, bias, None, metric, start, stop).view(b, -1, tile // C, C)
        # min() over the block's rows of one class returns the first of a tie
        m1, j = torch.min(dist, dim=2)
        blocks = torch.arange(start, stop, tile, dtype=torch.int32, device=q.device)
        rows = blocks.view(1, -1, 1) + j.to(torch.int32) * C + cls
        best_d, best_i = _fold_rows(best_d, best_i, m1, rows)
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


def _splits(splits: int, ntiles: int, align: int = 1) -> Tuple[int, int]:
    """(splits, tiles per split) for about `splits` splits of ntiles tiles;
    each split holds a multiple of `align` tiles (ntiles is one too)."""
    units = ntiles // align
    per = -(-units // max(1, min(units, splits))) * align
    return -(-ntiles // per), per


def _mma_smem(d: int, qw: int, cw: int, tps: int) -> int:
    """Shared bytes of a tensor-core CTA: the query block, then MMA_STAGES
    stages of `tps` tiles' class-group rows, each row with its bias and
    colscale."""
    kp = -(-d // MMA_TILE) * MMA_TILE + MMA_PAD
    return 2 * MMA_TILE * (kp * qw + MMA_STAGES * tps * cw * (kp + 4))


def _mma_config(nq: int, d: int) -> Tuple[int, int, int]:
    """(query warps, class warps, tiles per stage) of the tensor-core
    kernels: enough query warps for the batch (up to MMA_WARPS), the other
    warps on classes, stages of about MMA_STAGE_ROWS rows, shrunk (tiles per
    stage, class warps, query warps) until the CTA's shared memory fits. K1,
    K2 and K11 take the same geometry for the same (nq, d), so their
    distances agree bit for bit."""
    qw = 1
    while qw < MMA_WARPS and qw * MMA_TILE < nq:
        qw *= 2
    cw = MMA_WARPS // qw
    tps = max(1, MMA_STAGE_ROWS // (MMA_TILE * cw))
    while _mma_smem(d, qw, cw, tps) > MAX_SMEM_BYTES:
        if tps > 1:
            tps //= 2
        elif cw > 1:
            cw //= 2
        elif qw > 1:
            qw //= 2
        else:
            raise ValueError(f"d={d} exceeds the kernels' shared-memory limit")
    return qw, cw, tps


def _grid(nq: int, n: int, d: int, mma: bool, block_tiles: int = 1) -> Tuple[int, ...]:
    """(query warps, class warps, tiles per stage, splits, tiles per split)
    of a pass over n rows; query warps 0 selects the CUDA-core (FMA)
    design."""
    if not mma:
        if QUERY_BLOCK * d * 4 > MAX_SMEM_BYTES:
            raise ValueError(f"d={d} exceeds the kernels' shared-memory limit")
        return (0, 0, 0) + _splits(-(-TARGET_CTAS // -(-nq // QUERY_BLOCK)), n // C)
    qw, cw, tps = _mma_config(nq, d)
    ctas = -(-nq // (MMA_TILE * qw)) * (C // (MMA_TILE * cw))
    # one wave of resident CTAs (at most 2 an SM; 1 KB of each SM's shared
    # memory is reserved per CTA): the fewer the splits, the longer each
    # CTA's run of tiles and the rarer its per-class inserts
    resident = SMS * min(2, SM_SMEM_BYTES // (_mma_smem(d, qw, cw, tps) + 1024))
    return (qw, cw, tps) + _splits(resident // ctas, n // C, math.lcm(tps, block_tiles))


def _ptr(t: Optional[Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _stream(x: Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch_candidates(name: str, q: Tensor, x: Tensor, bias: Tensor, colscale: Optional[Tensor],
                       metric: Metric, mma: bool, tile: int = C) -> Tuple[Tensor, Tensor]:
    """Launch K1 (`tile` = C) or K11 and the split merge -> (dist, row)."""
    from vectorindex_tpu_torch.kernels import _build

    nq, d = q.shape
    n = x.shape[0]
    out_d = torch.empty((nq, TIERS, C), dtype=torch.float32, device=x.device)
    out_i = torch.empty((nq, TIERS, C), dtype=torch.int32, device=x.device)
    if nq == 0 or n == 0:
        return out_d.fill_(INVALID_DIST), out_i.fill_(INVALID_ID)
    qw, cw, tps, splits, per = _grid(nq, n, d, mma, tile // C)
    part_d = torch.empty((splits, nq, TIERS, C), dtype=torch.float32, device=x.device)
    part_i = torch.empty((splits, nq, TIERS, C), dtype=torch.int32, device=x.device)
    lib = _build.load()
    if name == "bin_candidates_tree":
        err = lib.vi_bin_candidates_tree(
            q.data_ptr(), x.data_ptr(), bias.data_ptr(), nq, n, d, _METRIC_CODE[metric],
            qw, cw, tps, splits, per, tile // C,
            part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr(), _stream(x),
        )
    else:
        err = lib.vi_bin_candidates(
            q.data_ptr(), x.data_ptr(), bias.data_ptr(), _ptr(colscale),
            nq, n, d, _DTYPE_CODE[x.dtype], _METRIC_CODE[metric], qw, cw, tps, splits, per,
            part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr(), _stream(x),
        )
    _build.check(lib, err, name)
    LAUNCHES[name] += 1
    return out_d, out_i


def bin_candidates(
    q: Tensor, x: Tensor, bias: Tensor, colscale: Optional[Tensor], *, metric: Metric
) -> Tuple[Tensor, Tensor]:
    """K1 -> (dist [B, 3, C] f32, row [B, 3, C] int32). CUDA tensors launch
    the kernel (tensor cores on bf16, CUDA cores on f32) or raise; CPU
    tensors take bin_candidates_ref."""
    _check_inputs(q, x, bias, colscale, metric)
    if x.device.type == "cpu":
        return bin_candidates_ref(q, x, bias, colscale, metric=metric)
    return _launch_candidates("bin_candidates", q, x, bias, colscale, metric,
                              mma=x.dtype == torch.bfloat16)


def bin_candidates_fma(
    q: Tensor, x: Tensor, bias: Tensor, colscale: Optional[Tensor], *, metric: Metric
) -> Tuple[Tensor, Tensor]:
    """K1 on the CUDA cores whatever the corpus dtype: on bf16 the earlier
    design of K1, kept to time against the tensor-core one
    (scripts/ab_flat_tree_torch.py). CUDA tensors only."""
    _check_inputs(q, x, bias, colscale, metric)
    if x.device.type == "cpu":
        raise ValueError("bin_candidates_fma times a CUDA kernel: pass CUDA tensors")
    return _launch_candidates("bin_candidates_fma", q, x, bias, colscale, metric, mma=False)


def bin_candidates_tree(
    q: Tensor, x: Tensor, bias: Tensor, *, metric: Metric, tile: int
) -> Tuple[Tensor, Tensor]:
    """K11 -> (dist [B, 3, C] f32, row [B, 3, C] int32): per (query, class)
    and block of `tile` rows (a multiple of C dividing n) one candidate, the
    smallest distance and its first row, in 3 tiers by (dist, row). bf16
    corpora, L2 or IP (the JAX body takes no colscale). CUDA tensors launch
    the kernel or raise; CPU tensors take bin_candidates_tree_ref."""
    if metric not in (Metric.L2, Metric.INNER_PRODUCT):
        raise ValueError(f"bin_candidates_tree supports L2/IP, got {metric}")
    _check_inputs(q, x, bias, None, metric)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"bin_candidates_tree runs on bf16 corpora, got {x.dtype}")
    if tile <= 0 or tile % C or x.shape[0] % tile:
        raise ValueError(
            f"tile must be a multiple of {C} dividing the {x.shape[0]} rows, got {tile}")
    if x.device.type == "cpu":
        return bin_candidates_tree_ref(q, x, bias, metric=metric, tile=tile)
    return _launch_candidates("bin_candidates_tree", q, x, bias, None, metric, mma=True, tile=tile)


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
    (in K1's design and geometry) or raise; CPU tensors take count_below_ref."""
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
    qw, cw, tps, splits, per = _grid(nq, n, d, mma=x.dtype == torch.bfloat16)
    lib = _build.load()
    err = lib.vi_count_below(
        q.data_ptr(), x.data_ptr(), bias.data_ptr(), _ptr(colscale),
        thresh.data_ptr(), nq, n, d, _DTYPE_CODE[x.dtype], _METRIC_CODE[metric],
        qw, cw, tps, splits, per, lt.data_ptr(), le.data_ptr(), _stream(x),
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
