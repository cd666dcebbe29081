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
csrc/scan_fused.cu, in two designs that `scan_design` chooses from the
corpus dtype alone, at any width: on a bf16 corpus Hopper's asynchronous
tensor cores (`scan_wgmma_kernel`: wgmma m64n32k16 with f32 accumulation,
the corpus through a TMA-fed ring, read once a pass where the batch fits
one CTA (up to 128 queries; 256 at d <= 128, the wide tile of two units a
warpgroup, K1's tiers in shared memory behind one compare a pair), the
query block resident in registers or shared memory, or past d = 448 (and
past 64 queries from d = 129 on 16-byte rows) its k chunk riding in each
stage beside the rows (four tiles' past 64 queries);
`wgmma_plan` sizes each launch); on an f32 corpus the CUDA cores (one
f32 FMA chain per dot product, register-tiled over staged corpus tiles,
rows streamed in k chunks where they do not fit whole; `fma_plan` sizes
each launch).
`bin_candidates_ref` and `count_below_ref` are
their plain PyTorch versions: CPU tensors take them, CUDA tensors always
launch the kernel. The plain versions share one distance function with one
chunking, so on a given device K2-ref recomputes K1-ref's floats bit for bit
too. Kernel against plain version: equal bit for bit on f32 corpora and on
integer-valued bf16 data (every partial sum exact); on other bf16 data each
kernel distance lies within 2 d 2^-23 sum_k |q_k x_k| (times 2 for L2,
times colscale for cosine) of the exact one, as the tensor cores' and
cuBLAS's sum orders differ. The FMA design computes the same floats as its
first design (one thread a row, 8 queries a CTA), which stays as
`bin_candidates_fma_v1` / `count_below_fma_v1` for timing only; the first
tensor-core design (mma.sync m16n8k16 over a 2-stage cp.async ring, up to
128 queries a CTA) stays as `bin_candidates_mma_v1` / `count_below_mma_v1`
/ `bin_candidates_tree_v1`, for timing only too.

K11 `bin_candidates_tree` (the round-5 A/B kernel of scripts/ab_flat_tree.py,
mode "tree") is K1 keeping, per query, class and block of `tile` rows, only
the block's smallest distance and its first row, folded into the same 3
tiers. `bin_candidates_fma` / `count_below_fma` run K1's / K2's FMA design
on any corpus dtype, to time the CUDA-core design on bf16 rows against the
tensor cores (scripts/ab_flat_tree_torch.py, scripts/ab_scan_wgmma_torch.py,
chip_smoke.py); scripts/ab_scan_fma_torch.py sweeps the design's plans.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from vectorindex_tpu_torch.ops.topk import INVALID_DIST, INVALID_ID, topk
from vectorindex_tpu_torch.utils.config import Metric
from vectorindex_tpu_torch.utils.telemetry import TELEM

Tensor = torch.Tensor

#: residue classes per query (rows per tile); candidates per query = TIERS*C
C = 256
TIERS = 3
#: the first tensor-core (bf16) design, kept for timing: a warp computes
#: MMA_TILE corpus rows x MMA_TILE queries; a CTA holds up to MMA_WARPS
#: warps, split into query and class warps, and streams its rows through
#: MMA_STAGES shared-memory stages of about MMA_STAGE_ROWS rows (whole
#: 256-row tiles' class-group rows), with MMA_PAD bf16 of padding after each
#: row (kMmaTile, kMmaWarps, kStages, kMmaPad)
MMA_TILE, MMA_WARPS, MMA_STAGES, MMA_STAGE_ROWS, MMA_PAD = 16, 8, 2, 128, 8
#: the wgmma design (csrc scan_wgmma_kernel): WG_THREADS threads, two
#: consumer warpgroups and one producer warpgroup; a consumer warpgroup owns
#: `units` units (1, or 2 in the wide tile), each one m64n32k16 product
#: (WG_M queries x WG_N classes), so a CTA covers 64 qt queries x
#: 64 units / qt classes (qt = 1 or 2 query tiles at one unit, 4 at two).
#: Rows are staged as WG_SLAB-value k slabs of 128 bytes (kWgThreads, kWgN,
#: kSlab)
WG_THREADS, WG_M, WG_N, WG_SLAB = 384, 64, 32, 64
WG_CONSUMERS = 2
#: shared bytes before the regions (barriers, alignment), most ring stages
#: (kWgHeader, kWgMaxStages)
WG_HEADER, WG_MAX_STAGES = 2048, 8
#: K11's tiers in shared memory: a distance and a row in 3 tiers of each
#: consumer thread's WG_N / 2 pairs (kWgTierBytes)
WG_TIER_BYTES = 2 * (WG_N // 2) * TIERS * 256 * 4
#: K1's tiers out of registers (the wide tile, wg_queued): WG_TIER_WORDS
#: words a pair of each consumer thread (3 distances, 3 tile indices of 10
#: bits, so a split holds at most WG_MAX_SPLIT_TILES tiles), behind a queue
#: of hits of WG_QUEUE_ENTRY bytes an entry, at least WG_QUEUE_MIN entries a
#: thread (kWgTierWords, kWgQueueEntry, kWgMaxSplitTiles)
WG_TIER_WORDS, WG_QUEUE_ENTRY, WG_QUEUE_MIN, WG_MAX_SPLIT_TILES = 4, 8, 8, 1023
#: stages a ring of whole rows keeps beside K1's tiers and queue (the queue,
#: which every tile's hits enter, takes the rest)
WG_QUEUED_STAGES = 3
#: corpus bytes a stage aims for
WG_STAGE_BYTES = 16384
#: ring tiles a chunked stage of K1/K2 holds, each in its own accumulator, so
#: that each query chunk brought from L2 serves that many tiles (K11: 1); past
#: one query tile (B > 64) the wide tile's WG_WIDE_TILES at two query tiles
#: (8 tiles' 128 accumulators spill: ptxas holds a consumer thread to the
#: launch bound's 168 registers)
WG_CHUNK_TILES, WG_WIDE_TILES = 2, 4
#: by a chunked stage's tiles: its bytes at most, and the fewest stages of
#: its ring. K1/K2: 4 slabs of 2 tiles' 64 class rows and 64 query rows in
#: 2 stages; K11: 4 slabs of one tile's in 3. Fewer bytes a stage took
#: longer at d = 768-8,192 (each stage pays a wait; 3 slabs in 3 stages
#: 1.0-1.1x, 1 slab in 8 stages 1.2-1.8x, scripts/ab_scan_wgmma_torch.py).
#: The wide tile: 3 slabs of 4 tiles' 32 class rows and 128 query rows (K1,
#: whose tiers and queue take 80 KiB: 2 slabs)
WG_CHUNK_RING = {1: (65536, 3), 2: (98304, 2), 4: (98304, 2)}
#: registers a consumer thread holds (setmaxnreg, kConsumerRegs: the
#: producer warpgroup keeps kProducerRegs of the launch bound's 65,536 /
#: WG_THREADS = 168), of which WG_REG_BUDGET may be live state of the
#: consumers' loop (wgmma_registers)
WG_CONSUMER_REGS, WG_PRODUCER_REGS, WG_REG_BUDGET = 224, 56, 176
#: the H100's SMs, and the shared memory of one SM
SMS, SM_SMEM_BYTES = 132, 233_472
#: CTAs a pass of the first FMA design aims for: 4 per SM
TARGET_CTAS = 4 * SMS
#: most shared memory a CTA may use
MAX_SMEM_BYTES = 232_448
#: queries per CTA of the first FMA design (csrc/scan_fused.cu kTB); its
#: query block in shared memory bounds that design (the _fma_v1 timing
#: wrappers) to d <= FMA_MAX_D = 7,264; the FMA design streams wider rows
V1_QUERY_BLOCK = 8
FMA_MAX_D = MAX_SMEM_BYTES // (4 * V1_QUERY_BLOCK)
#: the FMA design (csrc scan_fma_kernel): FMA_THREADS threads a CTA, a warp's
#: lanes FMA_ROW_LANES classes x FMA_QUERY_LANES queries; a thread owns one
#: class and tm queries, and its tm x tm micro-tile is its class's row in
#: each of a stage's tm tiles against its queries. A CTA covers qb queries x
#: g = 8 FMA_THREADS / (32 qb / (4 tm)) classes
FMA_THREADS, FMA_ROW_LANES, FMA_QUERY_LANES = 256, 8, 4
#: query blocks each micro-tile edge takes, and the balanced one (a stage's
#: tm g rows = qb: the fewest staged bytes a product)
FMA_QUERY_BLOCKS = {4: (16, 32, 64, 128), 8: (32, 64, 128, 256)}
FMA_BALANCED_QB = {4: 64, 8: 128}
#: batches up to this many queries take the 4 x 4 tile (a byte-bound pass:
#: every class in one CTA, fewer padded queries), larger ones 8 x 8
FMA_SMALL_BATCH = 16
#: k chunks (multiples of 16) tried, largest first, when a whole row's stage
#: does not fit; ring stages tried, in order; at most FMA_MAX_STAGES
FMA_K_CHUNKS = (512, 256, 128, 64, 32, 16)
FMA_STAGES, FMA_MAX_STAGES = (3, 2), 4
#: registers a thread may hold live in the loop (fma_registers); ptxas keeps
#: the rest of its 255 for addresses and loop state
FMA_REG_BUDGET = 200
#: corpus rows per distance chunk in the plain versions
REF_CHUNK = 256 * C

_METRIC_CODE = {Metric.L2: 0, Metric.INNER_PRODUCT: 1, Metric.COSINE: 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches per wrapper since the last reset (plain versions do not count)
LAUNCHES = dict.fromkeys(
    ("bin_candidates", "count_below", "bin_candidates_tree", "bin_candidates_fma",
     "count_below_fma", "bin_candidates_fma_v1", "count_below_fma_v1", "bin_candidates_mma_v1",
     "count_below_mma_v1", "bin_candidates_tree_v1"), 0)
#: K1's and K2's launches by the design they ran (scan_design)
DESIGN_LAUNCHES = {design: {"bin_candidates": 0, "count_below": 0} for design in ("wgmma", "fma")}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for counts in DESIGN_LAUNCHES.values():
        for name in counts:
            counts[name] = 0


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
    """(query warps, class warps, tiles per stage) of the first tensor-core
    design: enough query warps for the batch (up to MMA_WARPS), the other
    warps on classes, stages of about MMA_STAGE_ROWS rows, shrunk (tiles per
    stage, class warps, query warps) until the CTA's shared memory fits. Its
    K1, K2 and K11 take the same geometry for the same (nq, d), so their
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


def scan_design(d: int, dtype: torch.dtype) -> str:
    """The design K1 and K2 run over a corpus of this dtype, at any width d:
    "wgmma" (tensor cores) for bf16, "fma" (CUDA cores, one f32 FMA chain a
    dot product) for f32. K1 and K2 both take their design from here: the
    exactness proof needs K2 to recompute K1's floats bit for bit, so they
    must never run two designs on one corpus. (K11 stays on the tensor
    cores.)"""
    return "wgmma" if dtype == torch.bfloat16 else "fma"


def _grid(nq: int, n: int, d: int, mma: bool, block_tiles: int = 1) -> Tuple[int, ...]:
    """(query warps, class warps, tiles per stage, splits, tiles per split)
    of a pass of the first tensor-core design over n rows (mma), or of the
    first FMA design's (query warps 0: query blocks of V1_QUERY_BLOCK, about
    TARGET_CTAS CTAs). The shipping designs take wgmma_plan's and fma_plan's
    plans instead."""
    if not mma:
        if V1_QUERY_BLOCK * d * 4 > MAX_SMEM_BYTES:
            raise ValueError(f"d={d} exceeds the kernels' shared-memory limit")
        return (0, 0, 0) + _splits(-(-TARGET_CTAS // -(-nq // V1_QUERY_BLOCK)), n // C)
    qw, cw, tps = _mma_config(nq, d)
    ctas = -(-nq // (MMA_TILE * qw)) * (C // (MMA_TILE * cw))
    # one wave of resident CTAs (at most 2 an SM; 1 KB of each SM's shared
    # memory is reserved per CTA): the fewer the splits, the longer each
    # CTA's run of tiles and the rarer its per-class inserts
    resident = SMS * min(2, SM_SMEM_BYTES // (_mma_smem(d, qw, cw, tps) + 1024))
    return (qw, cw, tps) + _splits(resident // ctas, n // C, math.lcm(tps, block_tiles))


class WgmmaPlan(NamedTuple):
    """One launch of the wgmma design (csrc scan_wgmma_kernel)."""

    qt: int  # 64-query tiles a CTA (1, 2; 4 at two units)
    g: int  # classes a CTA: its rows of each 256-row tile (64 units / qt)
    qblocks: int  # CTAs along the batch: ceil(nq / 64 qt)
    a_regs: int  # k16 steps of the query block in registers (4, 8; a wide chunked stage's 4 cs); 0: smem
    chunked: bool  # the query block's k chunk rides in each stage (wide rows)
    cs: int  # 64-value k slabs a stage holds (every slab unless chunked)
    tps: int  # 256-row tiles a stage holds (chunked: multiplied at once, 1, 2 or 8)
    stages: int  # shared-memory ring stages
    splits: int
    tiles_per_split: int
    smem: int  # shared bytes a CTA uses
    units: int = 1  # 64-query tiles a consumer warpgroup multiplies (2: the wide tile)
    queue: int = 0  # K1's hit queue, entries a thread, where its tiers leave the registers


def _slabs(d: int) -> int:
    return -(-d // WG_SLAB)


def wg_queued(units: int, tps: int) -> bool:
    """K1 keeps its tiers out of registers, behind a queue of hits (csrc
    wg_queued): two units a warpgroup, or more than two accumulators (a
    chunked stage's tiles) beside them."""
    return units > 1 or tps > 2


def wgmma_smem(d: int, qt: int, a_regs: int, chunked: bool, cs: int, tps: int,
               stages: int, tiers: bool = False, units: int = 1,
               queue: int = 0) -> Tuple[int, int]:
    """(bytes a ring stage, shared bytes a CTA) of the wgmma design (csrc
    wg_layout): the header, the query block once (k slabs of 64 qt rows of
    128 bytes, when neither in registers nor chunked), K11's tiers (tiers)
    or, for K1's queue of `queue` entries a thread (> 0: its tiers out of
    registers), K1's tiers and the queue, then `stages` stages of cs slabs
    of the tps tiles' 64 units / qt class rows, the query block's cs slabs
    when chunked, and the tiles' bias and colscale (128-byte aligned), each
    stage rounded up to 1,024 bytes."""
    g, qb = WG_CONSUMERS * units * WG_N // qt, WG_M * qt
    q_res = _slabs(d) * qb * 128 if a_regs == 0 and not chunked else 0
    bb = -(-tps * g * 4 // 128) * 128
    stage = cs * tps * g * 128 + (cs * qb * 128 if chunked else 0) + 2 * bb
    stage = -(-stage // 1024) * 1024
    threads = WG_CONSUMERS * 128
    own = WG_TIER_BYTES if tiers else 0
    if queue:
        own = WG_TIER_WORDS * 4 * (WG_N // 2) * units * threads + queue * WG_QUEUE_ENTRY * threads
    return stage, WG_HEADER + q_res + own + stages * stage


def wgmma_registers(a_regs: int, kernel: str, tps: int = 1, units: int = 1) -> int:
    """Registers a consumer thread of the wgmma design holds live in its
    loop: its accumulator (WG_N / 2) for each unit of each of the tps tiles
    it multiplies at once, each unit's A fragments (4 a k16 step) when in
    registers, and K1's tiers (a distance and a row in each of 3 tiers of
    its WG_N / 2 (query, class) pairs) and the tile's distances, or where
    they leave the registers (wg_queued) one threshold a pair, the queue's
    length and an entry; K11's block minima and their rows (its tiers are in
    shared memory), or K2's tau and two counts of each unit's 2 queries and
    a tile's distances."""
    pairs = units * WG_N // 2
    own = {"bin_candidates": pairs + 2 if wg_queued(units, tps) else pairs * (2 * TIERS + 1),
           "bin_candidates_tree": pairs * 2,
           "count_below": units * 2 * 3 + pairs}[kernel]
    return tps * pairs + units * 4 * a_regs + own


def _wgmma_ring(d: int, qt: int, a_regs: int, chunked: bool, tiers: bool,
                chunk_tiles: int = 1, units: int = 1,
                queued: bool = False) -> Tuple[int, int, int, int]:
    """(cs, tps, stages, queue) of a wgmma CTA's ring: stages of about
    WG_STAGE_BYTES of whole rows (up to 8 tiles) in as many stages (up to
    WG_MAX_STAGES) as fit, fewer tiles a stage until 3 stages fit; chunked
    plans chunk_tiles tiles a stage, of at most WG_CHUNK_RING's bytes of
    rows and query chunk, fewer slabs a stage until its fewest stages fit,
    and where the stage's query chunk goes into registers (WG_WIDE_TILES
    tiles a stage: its stages always hold every slab) the fewest slabs that
    keep its number of k chunks, so that a row pads as few zero slabs as it
    can (d = 256: 2 chunks of 2, not of 3). K1 with its tiers out of
    registers (queued) fits them and a queue of at least WG_QUEUE_MIN
    entries first, and its queue takes what the stages leave (whole rows:
    WG_QUEUED_STAGES stages). stages is 0 where none fits."""
    slabs = _slabs(d)
    g, qb = WG_CONSUMERS * units * WG_N // qt, WG_M * qt
    least = WG_QUEUE_MIN if queued else 0

    def depth(cs: int, tps: int) -> int:
        stage, base = wgmma_smem(d, qt, a_regs, chunked, cs, tps, 0, tiers, units, least)
        return max(0, min(WG_MAX_STAGES, (MAX_SMEM_BYTES - base) // stage))

    if chunked:
        tps = chunk_tiles
        most, fewest = WG_CHUNK_RING[tps]
        cs = max(1, min(slabs, most // ((tps * g + qb) * 128)))
        while depth(cs, tps) < fewest and cs > 1:
            cs -= 1
        if tps == WG_WIDE_TILES:
            chunks = -(-slabs // cs)
            cs = -(-slabs // chunks)
    else:
        cs = slabs
        tps = max(1, min(8, WG_STAGE_BYTES // (slabs * g * 128)))
        while depth(slabs, tps) < 3 and tps > 1:
            tps //= 2
    stages = depth(cs, tps)
    queue = 0
    if queued and not chunked:
        stages = min(stages, WG_QUEUED_STAGES)
    if queued:
        stage, base = wgmma_smem(d, qt, a_regs, chunked, cs, tps, stages, tiers, units, 1)
        queue = 1 + (MAX_SMEM_BYTES - base) // (WG_QUEUE_ENTRY * WG_CONSUMERS * 128)
    return cs, tps, stages, queue


def band_chunked(d: int) -> bool:
    """Rows of the band between the register-resident and the streamed
    query block (128 < d <= 448) whose batches past one query tile take the
    wide chunked tile rather than the narrow tile's resident block: the
    rows TMA can address (d % 8 == 0), where the wide tile was the faster
    at every width timed in turns from the band's first (d = 136); the
    producer's copies of the other rows fed its two stages slower than the
    resident block's ring (scripts/ab_scan_wgmma_torch.py)."""
    return 2 * WG_SLAB < d <= 448 and d % 8 == 0


def wgmma_plan(nq: int, n: int, d: int, *, block_tiles: int = 1, a_mode: Optional[str] = None,
               kernel: str = "bin_candidates", qt: Optional[int] = None,
               chunk_tiles: Optional[int] = None) -> WgmmaPlan:
    """The wgmma design's launch for `kernel` over nq queries and n rows of
    width d. K1, K2 and K11 (whose splits also hold whole blocks of
    `block_tiles` tiles, and whose tiers take shared memory) take the same
    query tiles, class groups and splits for one (nq, d), so that their
    distances agree bit for bit: the fewest 64-query tiles that hold the
    batch (up to 2, so every query of a batch up to 128 is in one CTA and
    the corpus is read once a pass), the query block in registers while a
    row is at most 2 slabs (d <= 128), else resident in shared memory for
    the whole pass (with fewer query tiles a CTA if that is what fits beside
    3 stages of whole rows), else streamed with each stage's k chunk at one
    query tile beside WG_CHUNK_TILES tiles' k chunk (K11: one tile's), each
    tile in its own accumulator, so each query chunk crosses from L2 once for
    that many tiles; as many row splits as fill the card once with one CTA an
    SM (chunked: each split a multiple of the stage's tiles): the narrow
    tile, one unit a warpgroup. Batches up to 64 queries and K11 keep it at
    every width. Past one query tile (B > 64) K1 and K2 take the wide tile,
    K1's tiers out of registers (wg_queued): at d <= 128 four query tiles a
    CTA, two units a warpgroup (every query of a batch up to 256 in one
    CTA); past d = 128 (streamed rows, d > 448, and the band 128 < d <= 448
    where band_chunked: the band's other rows keep the narrow tile's
    resident block) two query tiles beside WG_WIDE_TILES ring tiles a
    chunked stage (128 queries x 128 rows, each stage's query chunk read
    into registers once for its tiles: a_regs = 4 cs, with the fewest slabs
    a stage that keep its k chunks); splits of at most WG_MAX_SPLIT_TILES
    tiles. a_mode places the query block ("regs", "smem" or "chunked"), qt
    sets the query tiles (4: two units a warpgroup, from registers) and
    chunk_tiles a chunked stage's tiles (1, 2 or WG_WIDE_TILES) by hand
    (the A/B sweep's variants: the same floats bit for bit, which the cuda
    tests check; qt=2 below d = 129, qt=2 with chunk_tiles=2 in the band
    and chunk_tiles=2 past d = 448 give the narrow tile at any batch); a
    plan that does not fit raises."""
    if d < 1:
        raise ValueError(f"d={d} is outside the wgmma route (d >= 1)")
    if kernel not in _WGMMA_MODES:
        raise ValueError(f"wgmma_plan plans {tuple(_WGMMA_MODES)}, got {kernel}")
    if qt not in (None, 1, 2, 4):
        raise ValueError(f"qt must be 1, 2 or 4, got {qt}")
    tiers = kernel == "bin_candidates_tree"
    if tiers and qt == 4:
        raise ValueError("qt must be 1 or 2 for K11, whose plan stays one unit a warpgroup")
    wide = not tiers and nq > WG_M  # the wide tile's batches
    if chunk_tiles is None:  # one query tile by hand: the narrow tile's stages
        chunk_tiles = 1 if tiers else (WG_WIDE_TILES if wide and qt != 1 else WG_CHUNK_TILES)
    if chunk_tiles not in (1, 2, WG_WIDE_TILES) or (tiers and chunk_tiles != 1):
        raise ValueError(f"chunk_tiles must be 1, 2 or {WG_WIDE_TILES} (K11: 1), got {chunk_tiles}")
    slabs = _slabs(d)
    if a_mode is None:
        band = wide and band_chunked(d) and chunk_tiles == WG_WIDE_TILES
        a_mode = "regs" if slabs <= 2 else "chunked" if band else "smem"
    if a_mode != "regs" and qt == 4:
        raise ValueError("qt=4 (two units a warpgroup) takes the query block from registers")
    chunked_qt = 2 if chunk_tiles == WG_WIDE_TILES else 1
    if a_mode == "regs":
        if slabs > 2:
            raise ValueError(f"d={d}: the query block goes in registers only up to d = 128")
        qt = qt or (1 if nq <= WG_M else 2 if nq <= 2 * WG_M or not wide else 4)
        a_regs, chunked = 4 * slabs, False
    elif a_mode == "smem":
        qt_want = qt or (1 if nq <= WG_M else 2)
        qt = next((t for t in (2, 1) if t <= qt_want and (qt is None or t == qt)
                   and _wgmma_ring(d, t, 0, False, False)[2] >= 3), None)
        a_regs, chunked = 0, qt is None
        qt = qt or chunked_qt
    elif a_mode == "chunked":
        qt, a_regs, chunked = qt or chunked_qt, 0, True
    else:
        raise ValueError(f"a_mode must be 'regs', 'smem' or 'chunked', got {a_mode!r}")
    units = 2 if qt == 4 else 1
    queued = kernel == "bin_candidates" and wg_queued(units, chunk_tiles if chunked else 1)
    cs, tps, stages, queue = _wgmma_ring(d, qt, a_regs, chunked, tiers, chunk_tiles, units, queued)
    if tiers and a_regs == 0 and not chunked and stages < 3:
        # K11's tiers leave no room for the resident query block: its k
        # chunks ride in each stage, at K1's query tiles
        chunked = True
        cs, tps, stages, queue = _wgmma_ring(d, qt, a_regs, chunked, tiers, chunk_tiles)
    if stages < 2 or (queued and queue < WG_QUEUE_MIN):
        raise ValueError(f"no wgmma stage ring fits d={d} at qt={qt}, a_mode={a_mode}, "
                         f"chunk_tiles={chunk_tiles}")
    if chunked and tps == WG_WIDE_TILES:
        a_regs = 4 * cs  # the wide tile reads each stage's query chunk into registers
    g, qb = WG_CONSUMERS * units * WG_N // qt, WG_M * qt
    qblocks = -(-max(nq, 1) // qb)
    ntiles = max(1, n // C)
    align = math.lcm(tps, block_tiles) if chunked else block_tiles
    splits, per = _splits(max(1, SMS // (qblocks * (C // g))), ntiles, align)
    if wg_queued(units, tps if chunked else 1) and per > WG_MAX_SPLIT_TILES:
        # K1 keeps a tier's row as its tile's index in the split (K2 takes
        # the same splits)
        most = WG_MAX_SPLIT_TILES // align * align
        splits, per = _splits(-(-ntiles // most), ntiles, align)
    return WgmmaPlan(qt, g, qblocks, a_regs, chunked, cs, tps, stages, splits, per,
                     wgmma_smem(d, qt, a_regs, chunked, cs, tps, stages, tiers, units, queue)[1],
                     units, queue)


def wgmma_placement(kernel: str, metric: Metric, d: int,
                    nq: Optional[int] = None) -> Optional[str]:
    """The query block's placement `kernel` takes (wgmma_plan's a_mode)
    for nq queries (None: a batch of at most 128): the plan's own, except
    that cosine K1 takes it from shared memory where the plan would hold it
    in registers (d <= 128) beside K1's tiers in registers (B <= 128): its
    tiers and colscale leave no registers for the A fragments. (K11 keeps
    its tiers in shared memory, and the wide tile K1's, so their A fragments
    fit.) The placement does not change the floats (the cuda tests hold
    every placement's K1 to the others' bit for bit), so K2 still
    recomputes cosine K1's floats."""
    takes_smem = kernel == "bin_candidates" and metric == Metric.COSINE
    in_registers = nq is None or nq <= 2 * WG_M
    return "smem" if takes_smem and _slabs(d) <= 2 and in_registers else None


def wgmma_thread_map(plan: WgmmaPlan) -> Tuple[Tensor, Tensor]:
    """(queries [256, 16 units], classes [256, 16 units]): the (query,
    class) pairs of the CTA's block and group each consumer thread of a
    wgmma CTA owns, as csrc scan_wgmma_kernel maps them: thread t is lane
    t % 32 of warp (t // 32) % 4 of consumer warpgroup w = t // 128, whose
    unit u is the CTA's unit i = units w + u, query tile i % qt against class
    block i // qt; pair 16 u + 4 j + e is query 64 (i % qt) + 16 warp +
    lane // 4 + 8 (e // 2) and class 32 (i // qt) + 8 j + 2 (lane % 4) +
    e % 2. Its classes' rows are its pairs' rows in every tile."""
    t = torch.arange(WG_CONSUMERS * 128)
    wg, warp, lane = t // 128, (t // 32) % 4, t % 32
    pair = torch.arange(plan.units * WG_N // 2)
    u, j, e = pair // 16, (pair % 16) // 4, pair % 4
    unit = plan.units * wg[:, None] + u
    queries = WG_M * (unit % plan.qt) + 16 * warp[:, None] + (lane // 4)[:, None] + 8 * (e // 2)
    classes = WG_N * (unit // plan.qt) + 8 * j + 2 * (lane % 4)[:, None] + e % 2
    return queries, classes


class FmaPlan(NamedTuple):
    """One launch of the FMA design (csrc scan_fma_kernel)."""

    tm: int  # micro-tile edge: a thread's class in tm tiles x tm queries
    qb: int  # queries a CTA
    g: int  # classes a CTA: its rows of each 256-row tile
    kc: int  # k values a stage holds; d > kc streams each row in chunks
    stages: int  # shared-memory ring stages of tm tiles' g rows
    splits: int
    tiles_per_split: int
    smem: int  # shared bytes a CTA


def fma_smem(d: int, itemsize: int, tm: int, qb: int, g: int, kc: int, stages: int) -> int:
    """Shared bytes of an FMA CTA (csrc fma_smem_bytes): the query block once
    (d <= kc), then `stages` stages of tm tiles' g rows (row stride kc + one
    16-byte pad), two f32 a row (bias, colscale) and, when d > kc, the query
    block's k chunk (row stride kc + 4 f32)."""
    qbytes = qb * (kc + 4) * 4
    chunked = d > kc
    rows = tm * g
    stage = rows * (kc + 16 // itemsize) * itemsize + rows * 8 + (qbytes if chunked else 0)
    return (0 if chunked else qbytes) + stages * stage


def fma_registers(tm: int, kernel: str) -> int:
    """Registers a thread of the FMA design holds live in its loop: tm x tm
    accumulators, one k step's fragments (4 values of each of its tm rows
    and tm queries) and K1's tiers (a distance and a row in each of 3 tiers
    of its tm (query, class) pairs) or K2's tau and two counts a query."""
    own = 2 * TIERS * tm if kernel == "bin_candidates" else 3 * tm
    return tm * tm + 2 * 4 * tm + own


def fma_plan(nq: int, n: int, d: int, dtype: torch.dtype, kernel: str, *,
             tm: Optional[int] = None, qb: Optional[int] = None, kc: Optional[int] = None,
             stages: Optional[int] = None, splits: Optional[int] = None) -> FmaPlan:
    """The FMA design's launch for `kernel` ("bin_candidates" or
    "count_below") over nq queries and n rows of width d: an 8 x 8
    micro-tile and the smallest query block that holds the batch, up to the
    balanced one; small batches (B <= FMA_SMALL_BATCH, bound by the corpus
    bytes) 4 x 4 with every query in one block. Whole rows a stage where a
    ring of FMA_STAGES fits, else the largest k chunk that does; one CTA an
    SM (the micro-tile's registers allow no second) and as many row splits
    as fill the card once, with the query blocks innermost. Keyword
    arguments override a choice (the sweep of scripts/ab_scan_fma_torch.py);
    a plan that does not fit raises."""
    if kernel not in ("bin_candidates", "count_below"):
        raise ValueError(f"fma_plan plans bin_candidates or count_below, got {kernel}")
    if tm is None:
        tm = 4 if nq <= FMA_SMALL_BATCH else 8
    if tm not in FMA_QUERY_BLOCKS:
        raise ValueError(f"{kernel} takes no {tm} x {tm} micro-tile")
    blocks = FMA_QUERY_BLOCKS[tm]
    if qb is None:
        want = min(nq, FMA_BALANCED_QB[tm])
        qb = next(b for b in blocks if b >= want)
    if qb not in blocks:
        raise ValueError(f"qb={qb} is not one of {blocks} for a {tm} x {tm} micro-tile")
    g = FMA_ROW_LANES * (FMA_THREADS // 32) * FMA_QUERY_LANES * tm // qb
    item = 2 if dtype == torch.bfloat16 else 4
    whole = -(-d // 16) * 16
    ring = [stages] if stages is not None else list(FMA_STAGES)
    if kc is not None:
        order = [(kc, s) for s in ring]
    else:  # whole rows, else the largest chunk, in the deepest ring that fits
        chunks = [c for c in FMA_K_CHUNKS if c < whole]
        order = [(c, s) for c in [whole] + chunks for s in ring]
    fits = [(c, s) for c, s in order if fma_smem(d, item, tm, qb, g, c, s) <= MAX_SMEM_BYTES]
    if not fits:
        raise ValueError(f"no FMA stage ring fits d={d} at qb={qb}, tm={tm}")
    kc, stages = fits[0]
    if kc % 16 or kc < 16 or not 2 <= stages <= FMA_MAX_STAGES:
        raise ValueError(f"kc={kc} must be a multiple of 16, stages={stages} in 2..{FMA_MAX_STAGES}")
    columns = -(-nq // qb) * (C // g)
    ntiles = max(1, n // C)
    want = max(1, SMS // columns) if splits is None else splits
    # a multiple of tm tiles a split: only the last split ends mid-stage
    per = -(-(-(-ntiles // min(want, ntiles))) // tm) * tm
    splits = -(-ntiles // per)
    return FmaPlan(tm, qb, g, kc, stages, splits, per, fma_smem(d, item, tm, qb, g, kc, stages))


def fma_thread_map(plan: FmaPlan) -> Tuple[Tensor, Tensor]:
    """(classes [FMA_THREADS], queries [FMA_THREADS, tm]): the class (within
    the CTA's group) and the block queries each thread of an FMA CTA owns,
    as csrc scan_fma_kernel maps them: thread t is lane t % 32 of warp
    t // 32; warp w is query warp w % qwarps of row warp w // qwarps; class
    8 rw + lane % 8, queries j0 + 4 j. Its rows are its class's in every
    tile."""
    qwarps = plan.qb // (FMA_QUERY_LANES * plan.tm)
    t = torch.arange(FMA_THREADS)
    warp, lane = t // 32, t % 32
    cls = (warp // qwarps) * FMA_ROW_LANES + lane % FMA_ROW_LANES
    j0 = (warp % qwarps) * (FMA_QUERY_LANES * plan.tm) + lane // FMA_ROW_LANES
    return cls, j0[:, None] + FMA_QUERY_LANES * torch.arange(plan.tm)


def fma_attributes() -> dict:
    """{(kernel, dtype, metric, tm): (registers a thread, local bytes a
    thread)} of every kernel of the FMA design, from the CUDA runtime: local
    bytes above 0 mean ptxas spilled."""
    import ctypes

    from vectorindex_tpu_torch.kernels import _build

    lib = _build.load()
    out = {}
    for kernel, mode, tms in (("bin_candidates", 0, (4, 8)), ("count_below", 2, (4, 8))):
        for dtype, dcode in _DTYPE_CODE.items():
            for metric, mcode in _METRIC_CODE.items():
                for tm in tms:
                    regs, local = ctypes.c_int(), ctypes.c_int()
                    err = lib.vi_scan_fma_attributes(dcode, mcode, mode, tm, ctypes.byref(regs),
                                                     ctypes.byref(local))
                    _build.check(lib, err, "vi_scan_fma_attributes")
                    out[(kernel, str(dtype).split(".")[-1], metric.value, tm)] = (regs.value,
                                                                                 local.value)
    return out


def wgmma_attributes() -> dict:
    """{(kernel, metric, a_regs, tps, units): (registers a thread, local
    bytes a thread)} of every kernel of the wgmma design (tps: the tiles a
    warpgroup multiplies at once, 2 or WG_WIDE_TILES in K1's and K2's
    chunked plans, the latter with a stage's 2 or 3 slabs of A in
    registers; units: 2 in their wide tile from registers), from the CUDA
    runtime: local bytes above 0 mean ptxas spilled."""
    import ctypes

    from vectorindex_tpu_torch.kernels import _build

    lib = _build.load()
    out = {}
    for kernel, mode in (("bin_candidates", 0), ("bin_candidates_tree", 1), ("count_below", 2)):
        for metric, mcode in _METRIC_CODE.items():
            if kernel == "bin_candidates_tree" and metric == Metric.COSINE:
                continue
            # the placements the kernel is built for (wgmma_placement), the
            # chunked plans' tiles a stage and the wide tile's two units
            # from registers (K1, K2)
            builds = [(a, 1, 1) for a in
                      ((0,) if wgmma_placement(kernel, metric, 128) else (0, 4, 8))]
            if kernel != "bin_candidates_tree":
                builds += [(0, WG_CHUNK_TILES, 1), (8, WG_WIDE_TILES, 1), (12, WG_WIDE_TILES, 1),
                           (4, 1, 2), (8, 1, 2)]
            for a_regs, tps, units in builds:
                regs, local = ctypes.c_int(), ctypes.c_int()
                err = lib.vi_scan_wgmma_attributes(mcode, mode, a_regs, tps, units,
                                                   ctypes.byref(regs), ctypes.byref(local))
                _build.check(lib, err, "vi_scan_wgmma_attributes")
                out[(kernel, metric.value, a_regs, tps, units)] = (regs.value, local.value)
    return out


def _ptr(t: Optional[Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _stream(x: Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


_WGMMA_MODES = {"bin_candidates": 0, "bin_candidates_tree": 1, "count_below": 2}


def _query_block(q: Tensor, plan: WgmmaPlan) -> Tensor:
    """q rounded to bf16, zero-padded to [query blocks x 64 qt, slabs x 64]:
    the query block a chunked plan's stages bring in by TMA (otherwise the
    kernel rounds q itself; the plain versions round the same way)."""
    nq, d = q.shape
    qp = torch.zeros((plan.qblocks * WG_M * plan.qt, _slabs(d) * WG_SLAB), dtype=torch.bfloat16,
                     device=q.device)
    qp[:nq, :d] = q
    return qp


def _aligned16(t: Optional[Tensor]) -> Optional[Tensor]:
    """t, or a copy of it on a 16-byte boundary (a tensor map's base)."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


def _wgmma_launch(name: str, q: Tensor, x: Tensor, bias: Tensor, colscale: Optional[Tensor],
                  metric: Metric, thresh: Optional[Tensor] = None, tile: int = C,
                  plan: Optional[WgmmaPlan] = None):
    """Launch K1, K11 (`tile` > C rows a block) or K2 (`name`) on the wgmma
    design under wgmma_plan's plan unless given (and K1's and K11's split
    merge) -> (dist, row) or (lt, le)."""
    from vectorindex_tpu_torch.kernels import _build

    nq, d = q.shape
    n = x.shape[0]
    count = name == "count_below"
    if count:  # zeroed, not empty: the kernel adds into them with atomics
        out, parts = tuple(torch.zeros((2, nq), dtype=torch.int32, device=x.device)), (None, None)
    else:
        out = (torch.empty((nq, TIERS, C), dtype=torch.float32, device=x.device),
               torch.empty((nq, TIERS, C), dtype=torch.int32, device=x.device))
    if nq == 0 or n == 0:
        return out if count else (out[0].fill_(INVALID_DIST), out[1].fill_(INVALID_ID))
    p = plan or wgmma_plan(nq, n, d, block_tiles=tile // C,
                           a_mode=wgmma_placement(name, metric, d, nq), kernel=name)
    qp = _query_block(q, p) if p.chunked else None
    bias, colscale = _aligned16(bias), _aligned16(colscale)
    if not count:
        parts = (torch.empty((p.splits, nq, TIERS, C), dtype=torch.float32, device=x.device),
                 torch.empty((p.splits, nq, TIERS, C), dtype=torch.int32, device=x.device))
    lib = _build.load()
    err = lib.vi_scan_wgmma(
        _WGMMA_MODES[name], q.data_ptr(), _ptr(qp), x.data_ptr(), bias.data_ptr(), _ptr(colscale),
        _ptr(thresh), nq, n, d, _METRIC_CODE[metric], p.qt, p.units, p.a_regs, int(p.chunked),
        p.cs, p.tps, p.stages, p.queue, p.splits, p.tiles_per_split, tile // C, _ptr(parts[0]),
        _ptr(parts[1]),
        None if count else out[0].data_ptr(), None if count else out[1].data_ptr(),
        out[0].data_ptr() if count else None, out[1].data_ptr() if count else None, _stream(x),
    )
    _build.check(lib, err, name)
    LAUNCHES[name] += 1
    return out


def _launch_candidates(name: str, q: Tensor, x: Tensor, bias: Tensor, colscale: Optional[Tensor],
                       metric: Metric, mma: bool, tile: int = C) -> Tuple[Tensor, Tensor]:
    """Launch K1 in the first tensor-core design (mma) or in its first FMA
    design, or K11 in the first tensor-core design (`tile` > C), and the
    split merge -> (dist, row)."""
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
    if name == "bin_candidates_tree_v1":
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


def _storage_rounded(q: Tensor, dtype: torch.dtype) -> Tensor:
    """q rounded to the corpus dtype, as f32: the FMA design's operand (the
    plain versions round the same way)."""
    return q if dtype == torch.float32 else q.to(dtype).float()


def _fma_candidates(name: str, q: Tensor, x: Tensor, bias: Tensor, colscale: Optional[Tensor],
                    metric: Metric, plan: Optional[FmaPlan]) -> Tuple[Tensor, Tensor]:
    """Launch K1 in the FMA design (fma_plan's plan unless given) and the
    split merge -> (dist, row)."""
    from vectorindex_tpu_torch.kernels import _build

    nq, d = q.shape
    n = x.shape[0]
    out_d = torch.empty((nq, TIERS, C), dtype=torch.float32, device=x.device)
    out_i = torch.empty((nq, TIERS, C), dtype=torch.int32, device=x.device)
    if nq == 0 or n == 0:
        return out_d.fill_(INVALID_DIST), out_i.fill_(INVALID_ID)
    p = plan or fma_plan(nq, n, d, x.dtype, "bin_candidates")
    qk = _storage_rounded(q, x.dtype)
    part_d = torch.empty((p.splits, nq, TIERS, C), dtype=torch.float32, device=x.device)
    part_i = torch.empty((p.splits, nq, TIERS, C), dtype=torch.int32, device=x.device)
    lib = _build.load()
    err = lib.vi_bin_candidates_fma(
        qk.data_ptr(), x.data_ptr(), bias.data_ptr(), _ptr(colscale), nq, n, d,
        _DTYPE_CODE[x.dtype], _METRIC_CODE[metric], p.tm, p.qb, p.kc, p.stages, p.splits,
        p.tiles_per_split, part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(),
        out_i.data_ptr(), _stream(x),
    )
    _build.check(lib, err, name)
    LAUNCHES[name] += 1
    return out_d, out_i


def bin_candidates(
    q: Tensor, x: Tensor, bias: Tensor, colscale: Optional[Tensor], *, metric: Metric
) -> Tuple[Tensor, Tensor]:
    """K1 -> (dist [B, 3, C] f32, row [B, 3, C] int32). CUDA tensors launch
    the kernel in the design of scan_design (raising where none fits); CPU
    tensors take bin_candidates_ref."""
    _check_inputs(q, x, bias, colscale, metric)
    if x.device.type == "cpu":
        return bin_candidates_ref(q, x, bias, colscale, metric=metric)
    design = scan_design(x.shape[1], x.dtype)
    if design == "wgmma":
        out = _wgmma_launch("bin_candidates", q, x, bias, colscale, metric)
    else:
        out = _fma_candidates("bin_candidates", q, x, bias, colscale, metric, None)
    DESIGN_LAUNCHES[design]["bin_candidates"] += 1
    return out


def _check_first_design(name: str, x: Tensor) -> None:
    if x.device.type == "cpu":
        raise ValueError(f"{name} times a CUDA kernel: pass CUDA tensors")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name} runs on bf16 corpora, got {x.dtype}")


def bin_candidates_mma_v1(
    q: Tensor, x: Tensor, bias: Tensor, colscale: Optional[Tensor], *, metric: Metric
) -> Tuple[Tensor, Tensor]:
    """K1 in its first tensor-core design (mma.sync m16n8k16, a 2-stage
    cp.async ring, up to 128 queries a CTA), kept to time the wgmma design
    against; never on a main path. bf16 CUDA tensors only."""
    _check_inputs(q, x, bias, colscale, metric)
    _check_first_design("bin_candidates_mma_v1", x)
    return _launch_candidates("bin_candidates_mma_v1", q, x, bias, colscale, metric, mma=True)


def bin_candidates_fma(
    q: Tensor, x: Tensor, bias: Tensor, colscale: Optional[Tensor], *, metric: Metric
) -> Tuple[Tensor, Tensor]:
    """K1 in the FMA design whatever the corpus dtype: on bf16 rows the
    CUDA-core design the tensor cores replaced, kept to time them against;
    never on a main path. CUDA tensors only."""
    _check_inputs(q, x, bias, colscale, metric)
    if x.device.type == "cpu":
        raise ValueError("bin_candidates_fma times a CUDA kernel: pass CUDA tensors")
    return _fma_candidates("bin_candidates_fma", q, x, bias, colscale, metric, None)


def bin_candidates_fma_v1(
    q: Tensor, x: Tensor, bias: Tensor, colscale: Optional[Tensor], *, metric: Metric
) -> Tuple[Tensor, Tensor]:
    """K1 in its first FMA design (one thread a row, 8 queries a CTA), kept
    to time the FMA design against; never on a main path. CUDA tensors
    only."""
    _check_inputs(q, x, bias, colscale, metric)
    if x.device.type == "cpu":
        raise ValueError("bin_candidates_fma_v1 times a CUDA kernel: pass CUDA tensors")
    return _launch_candidates("bin_candidates_fma_v1", q, x, bias, colscale, metric, mma=False)


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
    return _wgmma_launch("bin_candidates_tree", q, x, bias, None, metric, tile=tile)


def bin_candidates_tree_v1(
    q: Tensor, x: Tensor, bias: Tensor, *, metric: Metric, tile: int
) -> Tuple[Tensor, Tensor]:
    """K11 in the first tensor-core design (K1's first design, tree mode),
    kept to time the wgmma design against; never on a main path. CUDA
    tensors only."""
    if metric not in (Metric.L2, Metric.INNER_PRODUCT):
        raise ValueError(f"bin_candidates_tree_v1 supports L2/IP, got {metric}")
    _check_inputs(q, x, bias, None, metric)
    _check_first_design("bin_candidates_tree_v1", x)
    if tile <= 0 or tile % C or x.shape[0] % tile:
        raise ValueError(
            f"tile must be a multiple of {C} dividing the {x.shape[0]} rows, got {tile}")
    return _launch_candidates("bin_candidates_tree_v1", q, x, bias, None, metric, mma=True,
                              tile=tile)


def _check_thresh(q: Tensor, x: Tensor, thresh: Tensor) -> None:
    if thresh.dtype != torch.float32 or thresh.shape != (q.shape[0],):
        raise ValueError(f"thresh must be float32 [{q.shape[0]}]")
    if thresh.device != x.device or not thresh.is_contiguous():
        raise ValueError("thresh must be contiguous and on the corpus device")


def _launch_counts(name: str, q: Tensor, x: Tensor, bias: Tensor, colscale: Optional[Tensor],
                   thresh: Tensor, metric: Metric, design: str,
                   plan: Optional[FmaPlan] = None) -> Tuple[Tensor, Tensor]:
    """Launch K2 in `design` ("fma" under fma_plan's plan unless given;
    "mma_v1" or "fma_v1", the first tensor-core or FMA design) -> (lt,
    le)."""
    from vectorindex_tpu_torch.kernels import _build

    nq, d = q.shape
    n = x.shape[0]
    # zeroed, not empty: the kernel adds into them with atomics
    lt = torch.zeros(nq, dtype=torch.int32, device=x.device)
    le = torch.zeros(nq, dtype=torch.int32, device=x.device)
    if nq == 0 or n == 0:
        return lt, le
    lib = _build.load()
    if design == "fma":
        p = plan or fma_plan(nq, n, d, x.dtype, "count_below")
        qk = _storage_rounded(q, x.dtype)
        err = lib.vi_count_below_fma(
            qk.data_ptr(), x.data_ptr(), bias.data_ptr(), _ptr(colscale), thresh.data_ptr(),
            nq, n, d, _DTYPE_CODE[x.dtype], _METRIC_CODE[metric], p.tm, p.qb, p.kc,
            p.stages, p.splits, p.tiles_per_split, lt.data_ptr(), le.data_ptr(), _stream(x),
        )
    else:
        qw, cw, tps, splits, per = _grid(nq, n, d, mma=design == "mma_v1")
        err = lib.vi_count_below(
            q.data_ptr(), x.data_ptr(), bias.data_ptr(), _ptr(colscale),
            thresh.data_ptr(), nq, n, d, _DTYPE_CODE[x.dtype], _METRIC_CODE[metric],
            qw, cw, tps, splits, per, lt.data_ptr(), le.data_ptr(), _stream(x),
        )
    _build.check(lib, err, name)
    LAUNCHES[name] += 1
    return lt, le


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
    (in K1's design; on the tensor cores K1's wgmma_plan too) or raise; CPU
    tensors take count_below_ref."""
    _check_inputs(q, x, bias, colscale, metric)
    _check_thresh(q, x, thresh)
    if x.device.type == "cpu":
        return count_below_ref(q, x, bias, colscale, thresh, metric=metric)
    design = scan_design(x.shape[1], x.dtype)
    if design == "wgmma":
        out = _wgmma_launch("count_below", q, x, bias, colscale, metric, thresh)
    else:
        out = _launch_counts("count_below", q, x, bias, colscale, thresh, metric, "fma")
    DESIGN_LAUNCHES[design]["count_below"] += 1
    return out


def count_below_mma_v1(
    q: Tensor,
    x: Tensor,
    bias: Tensor,
    colscale: Optional[Tensor],
    thresh: Tensor,
    *,
    metric: Metric,
) -> Tuple[Tensor, Tensor]:
    """K2 in its first tensor-core design, kept to time the wgmma design
    against; never on a main path. bf16 CUDA tensors only."""
    _check_inputs(q, x, bias, colscale, metric)
    _check_thresh(q, x, thresh)
    _check_first_design("count_below_mma_v1", x)
    return _launch_counts("count_below_mma_v1", q, x, bias, colscale, thresh, metric, "mma_v1")


def count_below_fma(
    q: Tensor,
    x: Tensor,
    bias: Tensor,
    colscale: Optional[Tensor],
    thresh: Tensor,
    *,
    metric: Metric,
) -> Tuple[Tensor, Tensor]:
    """K2 in the FMA design whatever the corpus dtype (bin_candidates_fma's
    pair), kept to time the tensor cores against; never on a main path.
    CUDA tensors only."""
    _check_inputs(q, x, bias, colscale, metric)
    _check_thresh(q, x, thresh)
    if x.device.type == "cpu":
        raise ValueError("count_below_fma times a CUDA kernel: pass CUDA tensors")
    return _launch_counts("count_below_fma", q, x, bias, colscale, thresh, metric, "fma")


def count_below_fma_v1(
    q: Tensor,
    x: Tensor,
    bias: Tensor,
    colscale: Optional[Tensor],
    thresh: Tensor,
    *,
    metric: Metric,
) -> Tuple[Tensor, Tensor]:
    """K2 in its first FMA design, kept to time the FMA design against;
    never on a main path. CUDA tensors only."""
    _check_inputs(q, x, bias, colscale, metric)
    _check_thresh(q, x, thresh)
    if x.device.type == "cpu":
        raise ValueError("count_below_fma_v1 times a CUDA kernel: pass CUDA tensors")
    return _launch_counts("count_below_fma_v1", q, x, bias, colscale, thresh, metric, "fma_v1")


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
    # K1 and K2 timed by CUDA events as dev.k1 / dev.k2 of the caller's open
    # TELEM call record (none open, or TELEM off: nothing recorded)
    with TELEM.device_span("k1", qk):
        cd, ci = bin_candidates(qk, x_pad, bias, colscale, metric=metric)
    kk = min(k, 2 * C)
    sd, si = topk(cd.view(b, -1), kk, ids=ci.view(b, -1), strict_ties=True)
    tau = sd[:, kk - 1].contiguous()  # kernel space: bit-identical to K2's
    with TELEM.device_span("k2", qk):
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
