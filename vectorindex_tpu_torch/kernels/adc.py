"""Full-corpus ADC: kernels K6, K7 and K8.

Counterpart of vectorindex_tpu/kernels/adc.py. For B queries' LUTs
lut [B, m, ks] f32 (ops/pq.pq_lut_l2 / pq_lut_ip) over n PQ-coded rows:

  K6 `adc_scan_u8` (the JAX package's `adc_scan_pallas`): dist[b, i] =
      Σ_j lut[b, j, codes[i, j]] over u8 codes [n, m] → [B, n] f32.
  K7 `adc_scan_u4` (`adc_scan_u4_pallas`): the same over packed u4 codes
      [n, m/2] (ks ≤ 16, m even; ops/dtypes.pack_u4: subspace 2i in the low
      nibble of byte i, read as it is).
  K8 `adc_topk_fused` (`adc_topk_fused`): K6's scan and K1's per-class
      selection in one corpus pass, so the [B, n] matrix never exists: per
      query and class c = row mod C the 3 smallest finite (dist, row), then
      the strict (dist, row) top-min(k, 2C) of the 3C candidates →
      (dist [B, kk] f32, rows [B, kk] int32), padded with (+inf,
      INVALID_ID). No verify pass: ADC distances are approximate and the
      caller reranks. The exact per-class top-3 is a superset of what the
      TPU kernel keeps (2 per class per 1,024-row tile), so where three of a
      query's nearest rows share a class and a tile the port returns the
      scan-then-sort answer and the TPU drops one.

K6 and K7 run one kernel with queries on the lanes (csrc/adc.cu,
adc_qlane_scan_kernel): it takes the LUTs per block of
scan_query_block(m, ks) queries, [blocks, m, k8_ks_pad(ks), qb]
(`lut_blocks`), scores scan_lane_queries(qb) queries a lane with K8's
lookups (two read by one 8-byte load), and writes each warp group's tile
of scan_tile_rows(qb) rows from shared memory by bulk async copies (plain
stores where n % 4 != 0); `scan_grid` sizes its grid to whole waves.
`adc_scan_u8_v1` / `adc_scan_u4_v1` launch their first design (rows on the
lanes), kept to time against it (scripts/ab_adc_torch.py).

K8's kernel (csrc/adc_topk.cu, adc_ring_candidates_kernel) runs the plan
of `k8_plan(m, ks, B)`: qb queries a CTA, four a lane (one 16-byte load),
their LUTs laid out by `lut_blocks(lut, qb, ql, skew)` so that, with each
row slot of a 128-byte wavefront `skew` phases of m / skew subspaces behind
the last, one lookup instruction's rows read distinct bank groups; the codes
reach shared memory by bulk async copies of a producer warp,
k8_tiles_per_stage tiles a ring stage; `k8_ctas` persistent CTAs each take
one contiguous range of (query block, class group, tile) units. `k8_route(m,
ks, B)` sends the shapes whose tables and code ring do not fit (m from 214
with ks > 16) to the second design (csrc/adc.cu adc_qlane_candidates_kernel:
queries on the lanes, one a lane, the LUTs by entry [m, ks, B] from
`lut_by_entry`, sized by `k8_query_block`, `k8_warps` and `k8_grid`),
counted under its own key.
`adc_topk_fused_v2` launches that design and `adc_topk_fused_v1` the first
(rows on the lanes, the [B, m, ks] layout of K6/K7), kept to time against
the kernel (scripts/ab_adc_torch.py); nothing else calls them.

Every code must be < ks. The kernels (csrc/adc.cu, adc_topk.cu) sum j =
0..m−1 in order from 0, each add rounded; the plain versions (`*_ref`) do
exactly these adds in this order (a Python loop over j), so kernel and plain
version agree bit for bit on any device, and K8's candidate distances equal
K6's output at those rows. The LUT stays f32 (the TPU casts it to bf16 for the MXU).
CPU tensors take the plain versions; CUDA tensors always launch the kernel.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from vectorindex_tpu_torch.kernels.scan_fused import (
    MAX_SMEM_BYTES,
    SMS,
    TARGET_CTAS,
    TIERS,
    C,
    _splits,
    class_top3_fold,
    class_top3_init,
)
from vectorindex_tpu_torch.ops.topk import INVALID_DIST, topk

Tensor = torch.Tensor

#: candidate bins per query (residue classes); K8 keeps TIERS per bin
C_BINS = C
#: most queries per CTA of K6/K7/K8's first designs (csrc/adc.cu kMaxQB);
#: fewer where their LUTs would not fit in shared memory
MAX_QUERY_BLOCK = 8
#: K8's second design: most queries per CTA (one a lane), (query, class)
#: pairs a thread owns and most warps a CTA holds (csrc/adc.cu kPairs,
#: kK8Warps); the most queries a CTA of either design
K8_MAX_QUERY_BLOCK, K8_PAIRS, K8_MAX_WARPS = 32, 4, 16
#: K8's second design's grid: the fewest splits whose waves of resident CTAs
#: are this full
K8_WAVE_FILL = 0.9
#: K8 (csrc/adc_topk.cu): most consumer warps a CTA, most classes a thread
#: (kRingWarps, kRingPairs), most stages of the code ring (at least 2), and
#: queries a lane (read by one 16-byte load; fewer where a block holds fewer)
K8_RING_WARPS, K8_RING_PAIRS, K8_RING_STAGES, K8_LANE_QUERIES = 16, 2, 4, 4
#: K6/K7: warps a CTA (csrc/adc.cu kScanWarps), warp groups (each with its
#: own output tiles and barrier), least rows of a group's output tile and
#: queries a lane (one 8-byte lookup serves two where a block holds two)
SCAN_WARPS, SCAN_GROUPS, SCAN_TILE_ROWS, SCAN_LANE_QUERIES = 16, 2, 256, 2
#: code rows per chunk in the plain versions (a multiple of C)
REF_ROWS = 256 * C

#: kernel launches per wrapper since the last reset (plain versions do not count)
LAUNCHES = dict.fromkeys(("adc_scan_u8", "adc_scan_u4", "adc_topk_fused", "adc_scan_u8_v1",
                         "adc_scan_u4_v1", "adc_topk_fused_v1", "adc_topk_fused_v2"), 0)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def query_block(m: int, ks: int) -> int:
    """Queries per CTA of the first designs of K6/K7/K8: as many LUTs
    (m·ks f32 each) as shared memory holds, at most MAX_QUERY_BLOCK."""
    return min(MAX_QUERY_BLOCK, MAX_SMEM_BYTES // (4 * m * ks))


def k8_ks_pad(ks: int) -> int:
    """Entries of a subspace's table as K6/K7/K8 stage it: 16 or 256, so
    the kernels' subspace stride is a constant (csrc/adc.cu k8_ks_pad)."""
    return 16 if ks <= 16 else 256


def k8_query_block(m: int, ks: int) -> int:
    """Queries per CTA of K8's second design: the largest power of two <=
    K8_MAX_QUERY_BLOCK whose LUTs (qb·m·k8_ks_pad(ks) f32) fit in shared
    memory. A warp's lookup then touches 32/qb segments of qb consecutive
    banks."""
    qb = K8_MAX_QUERY_BLOCK
    while qb > 1 and 4 * qb * m * k8_ks_pad(ks) > MAX_SMEM_BYTES:
        qb //= 2
    return qb


def k8_warps(qb: int) -> Tuple[int, int]:
    """(warps per CTA of K8's second design, class groups): a warp scores
    32/qb rows at once and a thread owns K8_PAIRS classes, so a warp covers
    K8_PAIRS·32/qb classes and the C classes take 2·qb warps: at most
    K8_MAX_WARPS in one CTA, the rest in class groups of the grid."""
    need = C // (K8_PAIRS * (32 // qb))
    warps = min(need, K8_MAX_WARPS)
    return warps, need // warps


def k8_grid(nq: int, qb: int, groups: int, ntiles: int, resident: int) -> Tuple[int, int]:
    """(splits, tiles of C rows per split) of K8's second design's grid
    (query blocks x class groups x splits CTAs) over ntiles tiles,
    `resident` CTAs running at once: the fewest splits whose waves, once
    each split holds whole tiles, are at least K8_WAVE_FILL full, else the
    fullest, at most one split a tile."""
    blocks = -(-nq // qb) * groups
    best, best_fill = _splits(1, ntiles), 0.0
    for want in range(1, ntiles + 1):
        grid = _splits(want, ntiles)  # whole tiles a split: may round the splits down
        ctas = blocks * grid[0]
        fill = ctas / (-(-ctas // resident) * resident)
        if fill > best_fill:
            best, best_fill = grid, fill
        if fill >= K8_WAVE_FILL:
            break
    return best


def scan_lane_queries(qb: int) -> int:
    """Queries a K6/K7 lane scores: SCAN_LANE_QUERIES, one where the
    block holds one query."""
    return min(SCAN_LANE_QUERIES, qb)


def scan_pass_rows(qb: int, groups: int = 1, ql: int = 1) -> int:
    """Rows one warp group of a K6/K7 CTA scores in one pass: its
    SCAN_WARPS/groups warps of 32·ql/qb row slots (ql queries a lane),
    K8_PAIRS consecutive rows a slot (csrc/adc.cu scan_pass_rows)."""
    return SCAN_WARPS // groups * (32 * ql // qb) * K8_PAIRS


def scan_tile_rows(qb: int, groups: int = SCAN_GROUPS, ql: Optional[int] = None) -> int:
    """Rows of a warp group's output tile: SCAN_TILE_ROWS, or one pass
    where a pass is longer."""
    ql = scan_lane_queries(qb) if ql is None else ql
    return max(SCAN_TILE_ROWS, scan_pass_rows(qb, groups, ql))


def scan_tile_stride(lpr: int, rows: int) -> int:
    """Floats between two queries' rows of an output tile whose rows lpr
    lanes share (csrc/adc.cu scan_tile_stride): a multiple of 4 (16-byte
    aligned segments for the bulk copy), padded so that the 8 lanes of a
    quarter-warp's float4 stores fall on 8 distinct 16-byte bank groups."""
    return rows + 32 // min(lpr, 8)


def scan_smem(qb: int, m: int, ks: int, rows: int, groups: int = SCAN_GROUPS,
              ql: Optional[int] = None) -> int:
    """Shared-memory bytes of a K6/K7 CTA: the LUTs [m][k8_ks_pad(ks)][qb]
    and two output tiles [qb][stride] a warp group."""
    ql = scan_lane_queries(qb) if ql is None else ql
    return 4 * (qb * m * k8_ks_pad(ks) + 2 * groups * qb * scan_tile_stride(qb // ql, rows))


def scan_query_block(m: int, ks: int) -> int:
    """Queries per K6/K7 CTA: the largest power of two <= 32 whose LUTs
    and output tiles (scan_smem at scan_tile_rows(qb)) fit in shared
    memory; ValueError where not even one query's do."""
    qb = K8_MAX_QUERY_BLOCK
    while scan_smem(qb, m, ks, scan_tile_rows(qb)) > MAX_SMEM_BYTES:
        if qb == 1:
            raise ValueError(f"m={m} tables of {k8_ks_pad(ks)} entries and K6's output tiles "
                             "exceed shared memory")
        qb //= 2
    return qb


def scan_grid(nq: int, qb: int, ntiles: int, resident: int) -> Tuple[int, int]:
    """(splits, CTA steps per split) of K6/K7's grid (query blocks x
    splits) over ntiles steps: whole waves of `resident` CTAs, as K8's."""
    return k8_grid(nq, qb, 1, ntiles, resident)


def lut_blocks(lut: Tensor, qb: int, ql: int = 1, skew: int = 1) -> Tensor:
    """The LUTs [B, m, ks] as K6/K7's and K8's kernels stage them:
    [ceil(B/qb), mb, k8_ks_pad(ks), skew·qb], contiguous, zero past ks and
    past B, so a CTA copies its block as it lies. With ql = 2 queries a
    lane, lane q's queries q and q + qb/2 lie side by side (columns 2q,
    2q + 1), one 8-byte load. skew > 1 (K8) cuts the m subspaces, padded
    with zero tables to mb·skew (mb = ceil(m/skew)), into skew sub-blocks
    of mb: line (i, code) holds, in segment h of qb columns, subspace
    h·mb + i; skew = 1 is the plain [m][code][qb]."""
    b, m, ks = lut.shape
    nblk, mb = -(-b // qb), -(-m // skew)
    padded = torch.nn.functional.pad(lut, (0, k8_ks_pad(ks) - ks, 0, mb * skew - m,
                                           0, nblk * qb - b))
    # [block, e, q, sub-block h, i, code] -> [block, i, code, h, q, e]: column
    # q * ql + e of segment h holds query q + e * qb / ql, subspace h * mb + i
    blocks = padded.view(nblk, ql, qb // ql, skew, mb, -1).permute(0, 4, 5, 3, 2, 1)
    return blocks.reshape(nblk, mb, -1, skew * qb).contiguous()


class K8Plan(NamedTuple):
    """One launch of K8 (csrc/adc_topk.cu adc_ring_candidates_kernel)."""

    qb: int      # queries a CTA
    ql: int      # queries a lane
    skew: int    # phases a row: the row slots of a wavefront group, each a phase behind the last
    warps: int   # consumer warps a CTA (one producer warp besides)
    groups: int  # class groups: CTAs that share a tile's rows
    stages: int  # stages of the code ring


def k8_cnt(m: int, skew: int) -> int:
    """The row width K8's kernel compiles its loop for: m = 8, 16, 32 or 64
    where each sub-block of m/skew codes is whole 4-byte words, else 0 (m
    read at run time, a code byte a load)."""
    return m if m in (8, 16, 32, 64) and (m // skew) % 4 == 0 else 0


def k8_skew(qb: int, m: int) -> int:
    """K8's skew at qb queries a CTA: 32/qb row slots share one 128-byte
    wavefront (a quarter-warp's 16-byte loads at 4 queries a lane, a
    half-warp's 8-byte ones at 2) at qb = 8 and 16, where rows of at least
    4·(32/qb) codes take it (a phase of 4 subspaces or more); 1 elsewhere
    (at qb = 32 a row fills a wavefront as it is)."""
    return 32 // qb if qb in (8, 16) and m >= 128 // qb else 1


def k8_geometry(qb: int, ql: int, groups: int = 0) -> Tuple[int, int, int]:
    """(classes a thread, consumer warps a CTA, class groups): a warp holds
    32·ql/qb row slots; a thread as many classes as K8_RING_WARPS warps need
    to cover the C classes, 1 to K8_RING_PAIRS and 4/ql (csrc/adc_topk.cu
    ring_pairs); the warps, at most K8_RING_WARPS, cover C/groups. groups >
    0 asks for more class groups, so fewer warps and smaller code-ring
    stages."""
    slots = 32 * ql // qb
    pairs = min(K8_RING_PAIRS, 4 // ql, max(1, C // (K8_RING_WARPS * slots)))
    groups = max(groups, C // (min(K8_RING_WARPS, C // (pairs * slots)) * pairs * slots))
    return pairs, C // (groups * pairs * slots), groups


def k8_tiles_per_stage(m: int, skew: int, pairs: int) -> int:
    """Tiles a K8 code-ring stage holds (csrc/adc_topk.cu ring_tps): where
    k8_cnt compiles the row width, as many as keep a thread's code words of
    a stage within 16 registers, 1 to 8; else 1."""
    cnt = k8_cnt(m, skew)
    return max(1, min(8, 64 // (cnt * pairs))) if cnt else 1


def k8_smem(qb: int, ql: int, skew: int, m: int, ks: int, groups: int, stages: int) -> int:
    """Shared-memory bytes of a K8 CTA (csrc/adc_topk.cu ring_smem): the
    LUTs [mb][k8_ks_pad(ks)][skew][qb], the code ring (each stage
    k8_tiles_per_stage tiles of C/groups rows, each padded to 16 bytes; 16
    bytes past it) and 2·stages + 2 mbarriers."""
    tps = k8_tiles_per_stage(m, skew, k8_geometry(qb, ql)[0])
    mb, tile = -(-m // skew), (C // groups * m + 15) & ~15
    return 4 * qb * mb * skew * k8_ks_pad(ks) + stages * tps * tile + 16 + 8 * (2 * stages + 2)


@functools.lru_cache(maxsize=None)
def k8_plan(m: int, ks: int, b: int, *, ql: Optional[int] = None, skew: Optional[int] = None,
            stages: Optional[int] = None) -> Optional[K8Plan]:
    """K8's plan for B queries of m subspaces of ks codes: the largest
    power-of-two query block up to K8_MAX_QUERY_BLOCK and B rounded up to a
    power of two, K8_LANE_QUERIES queries a lane (qb where qb is fewer),
    k8_skew (or none, where the padded tables do not fit skewed), and the
    most code-ring stages (up to K8_RING_STAGES, at least 2) that fit in
    shared memory beside the tables; at one query a CTA, fewer warps (so
    smaller stages) where the tables leave too little room. None where not
    even that fits. The A/B (scripts/ab_adc_torch.py) fixes ql, skew or
    stages."""
    qb = min(K8_MAX_QUERY_BLOCK, 1 << (max(b, 1) - 1).bit_length())
    while qb >= 1:
        lq = min(ql or K8_LANE_QUERIES, qb)
        for sk in (skew,) if skew else dict.fromkeys((k8_skew(qb, m), 1)):
            _, warps, groups = k8_geometry(qb, lq)
            while warps >= 1:
                for st in (stages,) if stages else range(K8_RING_STAGES, 1, -1):
                    if k8_smem(qb, lq, sk, m, ks, groups, st) <= MAX_SMEM_BYTES:
                        return K8Plan(qb, lq, sk, warps, groups, st)
                if qb > 1:
                    break
                _, warps, groups = k8_geometry(qb, lq, 2 * groups)
        qb //= 2
    return None


@functools.lru_cache(maxsize=None)
def k8_route(m: int, ks: int, b: int) -> str:
    """The K8 design that adc_topk_fused launches on CUDA tensors:
    "ring" (csrc/adc_topk.cu) wherever k8_plan fits, but where a warp's 32
    lanes read the codes of 32 rows (qb <= 4) a byte a load (m read at run
    time) at a pitch of a multiple of 32 bytes (m = 96, 128, ...): 8-way
    bank conflicts and worse, 2.7x slower than the second design at m = 128;
    else "qlanes" (the second design, csrc/adc.cu) where one query's padded
    tables fit without a code ring; ValueError where neither does."""
    plan = k8_plan(m, ks, b)
    if plan is not None and (plan.qb > 4 or m % 32 or k8_cnt(m, plan.skew)):
        return "ring"
    if 4 * m * k8_ks_pad(ks) <= MAX_SMEM_BYTES:
        return "qlanes"
    raise ValueError(f"m={m} tables of {k8_ks_pad(ks)} entries exceed K8's shared memory")


def k8_ctas(plan: K8Plan, nq: int, n: int, resident: int) -> int:
    """K8's persistent CTAs: the `resident` ones the SMs hold at once, at
    most one a (query block, class group, tile) unit, rounded down to whole
    CTAs a (query block, class group) stream where that keeps K8_WAVE_FILL
    of them: no CTA then crosses a stream, whose second LUT load and second
    set of tiers (inserts start over) cost more than the SMs left idle
    (bench_adc's B=256: 128 of 132)."""
    streams = -(-nq // plan.qb) * plan.groups
    ctas = min(resident, streams * -(-n // C))
    whole = ctas // streams * streams
    return whole if whole >= K8_WAVE_FILL * ctas else ctas


def k8_part_slots(plan: K8Plan, nq: int, n: int, ctas: int) -> int:
    """Partial top-3 slots K8's scratch holds a stream: at most the CTAs
    that cut one stream of ceil(n/C) units, when each CTA takes at least
    units // ctas of them and the two at its ends may take fewer."""
    ntiles = -(-n // C)
    return ntiles // (-(-nq // plan.qb) * plan.groups * ntiles // ctas) + 2


def lut_by_entry(lut: Tensor) -> Tensor:
    """The LUTs [B, m, ks] as K8's kernel reads them: [m, ks, B],
    contiguous (a query's entries of one (subspace, code) side by side)."""
    return lut.permute(1, 2, 0).contiguous()


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _adc_rows_ref(codes: Tensor, lut: Tensor, packed_u4: bool) -> Tensor:
    """Σ_j lut[b, j, code_j] of a block of code rows → [B, rows] f32, one
    rounded add per subspace, in order."""
    c = codes.long()
    b, m, _ = lut.shape
    acc = torch.zeros((b, c.shape[0]), dtype=torch.float32, device=lut.device)
    for j in range(m):
        if packed_u4:
            byte = c[:, j // 2]
            code = (byte >> 4) if j % 2 else (byte & 0xF)
        else:
            code = c[:, j]
        acc = acc + lut[:, j][:, code]
    return acc


def _adc_scan_ref(codes: Tensor, lut: Tensor, packed_u4: bool) -> Tensor:
    n = codes.shape[0]
    out = torch.empty((lut.shape[0], n), dtype=torch.float32, device=lut.device)
    for s in range(0, n, REF_ROWS):
        out[:, s : s + REF_ROWS] = _adc_rows_ref(codes[s : s + REF_ROWS], lut, packed_u4)
    return out


def adc_scan_u8_ref(codes: Tensor, lut: Tensor) -> Tensor:
    """Plain K6 → [B, n] f32."""
    return _adc_scan_ref(codes, lut, False)


def adc_scan_u4_ref(packed_codes: Tensor, lut: Tensor) -> Tensor:
    """Plain K7 → [B, n] f32."""
    return _adc_scan_ref(packed_codes, lut, True)


def _select(cand_d: Tensor, cand_i: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """Strict (dist, row) top-min(k, 2C) of the [B, 3, C] candidates."""
    b = cand_d.shape[0]
    return topk(cand_d.view(b, -1), min(k, 2 * C_BINS), ids=cand_i.view(b, -1), strict_ties=True)


def adc_topk_candidates_ref(codes: Tensor, lut: Tensor) -> Tuple[Tensor, Tensor]:
    """Plain K8's candidates: plain K6's distances, then per (query, class)
    the 3 smallest finite (dist, row) → (dist [B, 3, C], rows [B, 3, C])."""
    b, n = lut.shape[0], codes.shape[0]
    best_d, best_i = class_top3_init(b, lut.device)
    for start in range(0, n, REF_ROWS):
        dist = _adc_rows_ref(codes[start : start + REF_ROWS], lut, False)
        pad = (-dist.shape[1]) % C
        if pad:  # rows >= n: +inf, never kept
            dist = torch.cat([dist, dist.new_full((b, pad), INVALID_DIST)], dim=1)
        best_d, best_i = class_top3_fold(best_d, best_i, dist, start)
    return best_d, best_i


def adc_topk_fused_ref(codes: Tensor, lut: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """Plain K8 → (dist [B, kk] f32, rows [B, kk] int32), kk = min(k, 2C)."""
    return _select(*adc_topk_candidates_ref(codes, lut), k)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_inputs(codes: Tensor, lut: Tensor, packed_u4: bool) -> None:
    if lut.dtype != torch.float32 or lut.dim() != 3:
        raise ValueError(f"lut must be float32 [B, m, ks], got {lut.dtype} {tuple(lut.shape)}")
    _, m, ks = lut.shape
    if packed_u4 and (m % 2 or ks > 16):
        raise ValueError(f"packed u4 codes need an even m and ks <= 16, got m={m}, ks={ks}")
    if ks > 256:
        raise ValueError(f"u8 codes index at most 256 entries, got ks={ks}")
    mb = m // 2 if packed_u4 else m
    if codes.dtype != torch.uint8 or codes.dim() != 2 or codes.shape[1] != mb:
        raise ValueError(f"codes must be uint8 [N, {mb}], got {codes.dtype} {tuple(codes.shape)}")
    if lut.device != codes.device:
        raise ValueError("codes and lut must be on one device")
    if not (lut.is_contiguous() and codes.is_contiguous()):
        raise ValueError("codes and lut must be contiguous")
    if 4 * m * ks > MAX_SMEM_BYTES:  # one query's LUT lives in shared memory
        raise ValueError(f"m·ks = {m * ks} exceeds the kernels' shared-memory limit")


def _grid(nq: int, qb: int, ntiles: int) -> Tuple[int, int]:
    """(splits, tiles of C rows per split) for a pass over ntiles tiles."""
    qblocks = -(-nq // qb)
    splits = max(1, min(ntiles, -(-TARGET_CTAS // qblocks)))
    per = -(-ntiles // splits)
    return -(-ntiles // per), per


_SCAN_PER_SM: dict = {}


def scan_per_sm(qb: int, ql: int, m: int, ks: int, packed_u4: bool, groups: int,
                rows: int) -> int:
    """K6/K7 CTAs one SM holds at once (the CUDA occupancy query, cached)."""
    from vectorindex_tpu_torch.kernels import _build

    key = (qb, ql, m, ks, packed_u4, groups, rows)
    if key not in _SCAN_PER_SM:
        per_sm = _build.load().vi_adc_scan_qlanes_per_sm(qb, ql, m, ks, int(packed_u4), groups,
                                                         rows)
        if per_sm < 1:
            raise RuntimeError(f"K6/K7 cannot run qb={qb}, m={m}, ks={ks}, {groups} groups of "
                               f"{rows}-row tiles")
        _SCAN_PER_SM[key] = per_sm
    return _SCAN_PER_SM[key]


def scan_launch(codes: Tensor, lut: Tensor, packed_u4: bool, *, qb: Optional[int] = None,
                ql: Optional[int] = None, groups: int = SCAN_GROUPS,
                tile_rows: Optional[int] = None, splits: Optional[int] = None,
                bulk: bool = True) -> Tensor:
    """Launch K6 (u8) or K7 (packed u4) on CUDA tensors → [B, n] f32. qb,
    ql (queries a lane), tile_rows and splits default to scan_query_block,
    scan_lane_queries, scan_tile_rows and scan_grid; bulk=False writes
    every tile with plain stores, which n % 4 != 0 always takes. The A/B
    (scripts/ab_adc_torch.py) sets them to other values the design allows."""
    from vectorindex_tpu_torch.kernels import _build

    name = "adc_scan_u4" if packed_u4 else "adc_scan_u8"
    b, m, ks = lut.shape
    n = codes.shape[0]
    out = torch.empty((b, n), dtype=torch.float32, device=codes.device)
    if b == 0 or n == 0:
        return out
    qb = qb or scan_query_block(m, ks)
    ql = ql or scan_lane_queries(qb)
    rows = tile_rows or scan_tile_rows(qb, groups, ql)
    if scan_smem(qb, m, ks, rows, groups, ql) > MAX_SMEM_BYTES:
        raise ValueError(f"K6/K7 at qb={qb}, m={m}, ks={ks}, {groups} groups of {rows}-row tiles "
                         "exceed shared memory")
    steps = -(-n // (groups * rows))
    if splits is None:
        resident = SMS * scan_per_sm(qb, ql, m, ks, packed_u4, groups, rows)
        splits, per = scan_grid(b, qb, steps, resident)
    else:
        splits, per = _splits(splits, steps)
    lib = _build.load()
    err = lib.vi_adc_scan_qlanes(
        lut_blocks(lut, qb, ql).data_ptr(), codes.data_ptr(), b, n, m, ks, codes.shape[1],
        int(packed_u4), qb, ql, groups, rows, splits, per, int(bulk), out.data_ptr(),
        torch.cuda.current_stream(codes.device).cuda_stream,
    )
    _build.check(lib, err, name)
    LAUNCHES[name] += 1
    return out


def _launch_scan_v1(name: str, codes: Tensor, lut: Tensor, packed_u4: bool) -> Tensor:
    from vectorindex_tpu_torch.kernels import _build

    b, m, ks = lut.shape
    n = codes.shape[0]
    out = torch.empty((b, n), dtype=torch.float32, device=codes.device)
    if b == 0 or n == 0:
        return out
    qb = query_block(m, ks)
    splits, per = _grid(b, qb, -(-n // C))
    lib = _build.load()
    err = lib.vi_adc_scan_v1(
        lut.data_ptr(), codes.data_ptr(), b, n, m, ks, codes.shape[1], int(packed_u4), qb,
        splits, per * C, out.data_ptr(), torch.cuda.current_stream(codes.device).cuda_stream,
    )
    _build.check(lib, err, name)
    LAUNCHES[name] += 1
    return out


def adc_scan_u8(codes: Tensor, lut: Tensor) -> Tensor:
    """K6: codes [N, m] uint8, lut [B, m, ks] f32 (ks ≤ 256) → [B, N] f32.
    CUDA tensors launch the kernel (or raise); CPU tensors take
    adc_scan_u8_ref."""
    _check_inputs(codes, lut, False)
    if codes.device.type == "cpu":
        return adc_scan_u8_ref(codes, lut)
    return scan_launch(codes, lut, False)


def adc_scan_u4(packed_codes: Tensor, lut: Tensor) -> Tensor:
    """K7: packed_codes [N, m/2] uint8 (pack_u4 layout), lut [B, m, ks] f32
    (ks ≤ 16) → [B, N] f32. CUDA tensors launch the kernel (or raise); CPU
    tensors take adc_scan_u4_ref."""
    _check_inputs(packed_codes, lut, True)
    if packed_codes.device.type == "cpu":
        return adc_scan_u4_ref(packed_codes, lut)
    return scan_launch(packed_codes, lut, True)


def adc_scan_u8_v1(codes: Tensor, lut: Tensor) -> Tensor:
    """K6 in its first design (rows on the lanes), the same function as
    adc_scan_u8, kept to time against it (scripts/ab_adc_torch.py). CUDA
    tensors only."""
    _check_inputs(codes, lut, False)
    if codes.device.type == "cpu":
        raise ValueError("adc_scan_u8_v1 times a CUDA kernel: pass CUDA tensors")
    return _launch_scan_v1("adc_scan_u8_v1", codes, lut, False)


def adc_scan_u4_v1(packed_codes: Tensor, lut: Tensor) -> Tensor:
    """K7 in its first design (rows on the lanes), kept to time against
    adc_scan_u4. CUDA tensors only."""
    _check_inputs(packed_codes, lut, True)
    if packed_codes.device.type == "cpu":
        raise ValueError("adc_scan_u4_v1 times a CUDA kernel: pass CUDA tensors")
    return _launch_scan_v1("adc_scan_u4_v1", packed_codes, lut, True)


def _k8_out(b: int, splits: int, device) -> Tuple[Tensor, ...]:
    """K8's scratch and output: part_* [splits, B, 3, C], out_* [B, 3, C]."""
    return (
        torch.empty((splits, b, TIERS, C), dtype=torch.float32, device=device),
        torch.empty((splits, b, TIERS, C), dtype=torch.int32, device=device),
        torch.empty((b, TIERS, C), dtype=torch.float32, device=device),
        torch.empty((b, TIERS, C), dtype=torch.int32, device=device),
    )


_K8_PER_SM: dict = {}


def k8_per_sm(qb: int, warps: int, m: int, ks: int) -> int:
    """CTAs of K8's second design one SM holds at once (the CUDA
    occupancy query, cached)."""
    from vectorindex_tpu_torch.kernels import _build

    key = (qb, warps, m, ks)
    if key not in _K8_PER_SM:
        per_sm = _build.load().vi_adc_topk_qlanes_per_sm(qb, warps, m, ks)
        if per_sm < 1:
            raise RuntimeError(f"K8's second design cannot run qb={qb}, {warps} warps, m={m}, "
                               f"ks={ks}")
        _K8_PER_SM[key] = per_sm
    return _K8_PER_SM[key]


def k8_ring_per_sm(plan: K8Plan, m: int, ks: int) -> int:
    """K8 CTAs one SM holds at once under this plan (the CUDA occupancy
    query, cached)."""
    from vectorindex_tpu_torch.kernels import _build

    key = (plan, m, ks)
    if key not in _K8_PER_SM:
        per_sm = _build.load().vi_adc_topk_ring_per_sm(m, ks, *plan)
        if per_sm < 1:
            raise RuntimeError(f"K8 cannot run {plan} at m={m}, ks={ks}")
        _K8_PER_SM[key] = per_sm
    return _K8_PER_SM[key]


def k8_ring_attributes() -> dict:
    """{(qb, ksp, ql, skew, cnt): (registers a thread, local bytes a
    thread)} of every kernel csrc/adc_topk.cu instantiates, from the CUDA
    runtime: local bytes above 0 mean ptxas spilled."""
    import ctypes

    from vectorindex_tpu_torch.kernels import _build

    lib, out = _build.load(), {}
    key, regs, local = (ctypes.c_int * 5)(), ctypes.c_int(), ctypes.c_int()
    while lib.vi_adc_topk_ring_attributes(len(out), key, ctypes.byref(regs),
                                          ctypes.byref(local)) == 0:
        out[tuple(key)] = (regs.value, local.value)
    return out


def k8_candidates(codes: Tensor, lut: Tensor, *, plan: Optional[K8Plan] = None,
                  ctas: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """Launch K8 on CUDA tensors -> per (query, class) the 3 smallest (dist,
    row), (dist [B, 3, C] f32, rows [B, 3, C] int32). plan and ctas default
    to k8_plan and k8_ctas; the A/B (scripts/ab_adc_torch.py) sets them to
    other values the design allows."""
    from vectorindex_tpu_torch.kernels import _build

    b, m, ks = lut.shape
    n = codes.shape[0]
    plan = plan or k8_plan(m, ks, b)
    if plan is None:
        raise ValueError(f"m={m} tables of {k8_ks_pad(ks)} entries and K8's code ring exceed "
                         "shared memory")
    ctas = ctas or k8_ctas(plan, b, n, SMS * k8_ring_per_sm(plan, m, ks))
    part_d, part_i, out_d, out_i = _k8_out(b, k8_part_slots(plan, b, n, ctas), codes.device)
    lib = _build.load()
    err = lib.vi_adc_topk_ring(
        lut_blocks(lut, plan.qb, plan.ql, plan.skew).data_ptr(), codes.data_ptr(), b, n, m, ks,
        *plan, ctas, part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
        torch.cuda.current_stream(codes.device).cuda_stream,
    )
    _build.check(lib, err, "adc_topk_fused")
    LAUNCHES["adc_topk_fused"] += 1
    return out_d, out_i


def k8_v2_candidates(codes: Tensor, lut: Tensor, *, qb: Optional[int] = None,
                     splits: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """Launch K8's second design on CUDA tensors -> (dist [B, 3, C] f32,
    rows [B, 3, C] int32); ValueError where even one query's padded tables
    do not fit in shared memory. qb and splits default to k8_query_block and
    k8_grid; the A/B (scripts/ab_adc_torch.py) sets them to other values
    the design allows."""
    from vectorindex_tpu_torch.kernels import _build

    b, m, ks = lut.shape
    n = codes.shape[0]
    if 4 * m * k8_ks_pad(ks) > MAX_SMEM_BYTES:
        raise ValueError(f"m={m} tables of {k8_ks_pad(ks)} entries exceed K8's shared memory")
    qb = qb or k8_query_block(m, ks)
    warps, groups = k8_warps(qb)
    ntiles = -(-n // C)
    if splits is None:
        splits, per = k8_grid(b, qb, groups, ntiles, SMS * k8_per_sm(qb, warps, m, ks))
    else:
        splits, per = _splits(splits, ntiles)
    part_d, part_i, out_d, out_i = _k8_out(b, splits, codes.device)
    lib = _build.load()
    err = lib.vi_adc_topk_qlanes(
        lut_by_entry(lut).data_ptr(), codes.data_ptr(), b, n, m, ks, qb, warps, groups, splits,
        per, part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
        torch.cuda.current_stream(codes.device).cuda_stream,
    )
    _build.check(lib, err, "adc_topk_fused_v2")
    LAUNCHES["adc_topk_fused_v2"] += 1
    return out_d, out_i


def k8_v1_candidates(codes: Tensor, lut: Tensor, *, splits: Optional[int] = None
                     ) -> Tuple[Tensor, Tensor]:
    """Launch K8's first design on CUDA tensors -> (dist [B, 3, C], rows [B,
    3, C]); splits defaults to its own grid (_grid)."""
    from vectorindex_tpu_torch.kernels import _build

    b, m, ks = lut.shape
    n = codes.shape[0]
    qb = query_block(m, ks)
    ntiles = -(-n // C)
    splits, per = _grid(b, qb, ntiles) if splits is None else _splits(splits, ntiles)
    part_d, part_i, out_d, out_i = _k8_out(b, splits, codes.device)
    lib = _build.load()
    err = lib.vi_adc_topk_candidates(
        lut.data_ptr(), codes.data_ptr(), b, n, m, ks, qb, splits, per,
        part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
        torch.cuda.current_stream(codes.device).cuda_stream,
    )
    _build.check(lib, err, "adc_topk_fused_v1")
    LAUNCHES["adc_topk_fused_v1"] += 1
    return out_d, out_i


def adc_topk_fused(codes: Tensor, lut: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """K8: full-corpus ADC top-k → (dist [B, kk] f32, rows [B, kk] int32),
    kk = min(k, 2C), strict (dist, row) order over the per-class
    candidates; (+inf, INVALID_ID) where fewer rows exist. CUDA tensors
    launch the kernel k8_route names (or raise); CPU tensors take
    adc_topk_fused_ref."""
    _check_inputs(codes, lut, False)
    if codes.device.type == "cpu":
        return adc_topk_fused_ref(codes, lut, k)
    b, m, ks = lut.shape
    if b == 0 or codes.shape[0] == 0:
        return _select(*class_top3_init(b, codes.device), k)
    if k8_route(m, ks, b) == "ring":
        return _select(*k8_candidates(codes, lut, plan=k8_plan(m, ks, b)), k)
    return _select(*k8_v2_candidates(codes, lut), k)


def _k8_design(name: str, launch, codes: Tensor, lut: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    _check_inputs(codes, lut, False)
    if codes.device.type == "cpu":
        raise ValueError(f"{name} times a CUDA kernel: pass CUDA tensors")
    if lut.shape[0] == 0 or codes.shape[0] == 0:
        return _select(*class_top3_init(lut.shape[0], codes.device), k)
    return _select(*launch(codes, lut), k)


def adc_topk_fused_v2(codes: Tensor, lut: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """K8 in its second design (queries on the lanes, one a lane, codes by
    the threads' own loads), the same function as adc_topk_fused, kept to
    time against it (scripts/ab_adc_torch.py, chip_smoke.py). CUDA tensors
    only."""
    return _k8_design("adc_topk_fused_v2", k8_v2_candidates, codes, lut, k)


def adc_topk_fused_v1(codes: Tensor, lut: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """K8 in its first design (rows on the lanes), the same function as
    adc_topk_fused, kept and held to the plain version. CUDA tensors
    only."""
    return _k8_design("adc_topk_fused_v1", k8_v1_candidates, codes, lut, k)
