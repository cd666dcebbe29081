"""IVF-PQ ADC probed search: kernels K9, K10 and the search wrapper.

Counterpart of vectorindex_tpu/kernels/adc_probe.py. The fused per-(query,
probe) residual LUT decomposes (ops/pq.pq_lut_q_l2) into

    dist = base(q, list) + Σ_j qlut[b, j, code_j] + t_row

so the kernels carry one LUT per query (f32 [B, m, ks]) and a per-row
correction t (ops/pq.pq_row_corrections; zeros for IP); base comes from the
coarse-select distances.

  K9  `adc_probe_scores` and K10 `adc_probe_scores_rankseg`: for every
      (query, probe, slot), Σ_j lut[b, j, code(row, j)] + tcorr[row] with
      row = start + slot for slot < live, +inf otherwise →
      [B, nprobe·probe_cap] f32. Given `base` [B, nprobe], each slot adds
      base[b, p] (one more rounded add, dead slots too); given `row_allow`
      [N_pad] bool, a live slot whose row is denied is +inf. Same output; on
      the TPU two grids (per pair for B > 16, rank-segment for B ≤ 16), here
      one CUDA kernel (csrc/adc_probe.cu) behind two wrappers, each with its
      own launch count. The search routes B ≤ 16 to K10 and larger batches
      to K9.

The kernel sums j = 0..m−1 in order from 0, every add rounded apart, then
adds tcorr, then base; the plain versions (`*_ref`) do exactly these adds
in this order (a Python loop over j), so kernel and plain version agree bit
for bit on any device. u4 codes are read in the pack_u4 layout: subspace 2i
is the low nibble of byte i. CPU tensors take the plain versions; CUDA
tensors always launch the kernel.

The kernel (`adc_probe_group_kernel`) gives a CTA one query and G of its
probes, loads the query's LUT once by a bulk async copy for all G, and keeps
the next chunk's code loads in flight while it sums the current one;
`probe_plan` picks G. `adc_probe_scores_v1` launches the first design (one
CTA per (pair, 1,024 slots), the LUT staged per pair) for timing only and
raises on CPU tensors.

`ivf_search_pq_probe` is the counterpart of `ivf_search_pq_pallas`: select
lists, query LUT, K9/K10 with base term and allow mask in, position top-C,
ids, dedup, exact f32 rerank, strict (score, id) top-k.
`pq_probe_candidates` is its candidate half, and the device half of the
host-memory rerank tier: `ivf_search_pq_hostrerank` (per call) and
`ivf_search_pq_hostrerank_stream` (pipelined) land only the [B, C] candidate
ids (or CSR rows) on the host and rerank them there from a VectorReader
(ops/rerank); the f32 corpus never reaches the card.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from vectorindex_tpu_torch.kernels.ivf_probe import BLK
from vectorindex_tpu_torch.kernels.scan_fused import MAX_SMEM_BYTES
from vectorindex_tpu_torch.ops import pq as pq_ops
from vectorindex_tpu_torch.ops.dedup import dedup_mask
from vectorindex_tpu_torch.ops.ivf import _gram_rows, ivf_select
from vectorindex_tpu_torch.ops.rerank import (
    load_hostops,
    native_rerank_available,
    rerank_gathered,
    rerank_gathered_host,
    rerank_ids_host,
)
from vectorindex_tpu_torch.ops.topk import INVALID_DIST, INVALID_ID, topk
from vectorindex_tpu_torch.utils.config import Metric

Tensor = torch.Tensor

#: kernel launches per wrapper since the last reset (plain versions do not count)
LAUNCHES = {"adc_probe_scores": 0, "adc_probe_scores_rankseg": 0, "adc_probe_scores_v1": 0}

#: the kernel's launch plan: CTAs it aims for (about one an SM where the
#: LUT outweighs a probe's code bytes, else two: the fewest LUT loads that
#: keep that many) and most probes a CTA (csrc/adc_probe.cu kMaxProbes)
PLAN_CTAS, MAX_PROBES = 128, 8


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def adc_rankseg_fits(b: int) -> bool:
    """Serving batches (1 ≤ B ≤ 16) take K10; larger batches take K9."""
    return 1 <= b <= 16


def probe_smem(m: int, ks: int) -> int:
    """Shared memory of a K9/K10 CTA (csrc/adc_probe.cu group_smem): the
    LUT's mbarrier, padded to 16 bytes, and the LUT."""
    return 16 + 4 * m * ks


def probe_plan(b: int, nprobe: int, probe_cap: int, m: int, ks: int, packed_u4: bool) -> int:
    """G, the probes of one query a K9/K10 CTA serves (measured on the H100
    by scripts/ab_adc_probe_torch.py): the largest power of two ≤
    MAX_PROBES and ≤ nprobe that leaves at least PLAN_CTAS CTAs — twice
    that where the LUT (4·m·ks bytes) is smaller than a probe's code bytes
    (probe_cap·mb), as pq32x4's 2 KB is — so each LUT is read once per G
    probes. A LUT that does not fit in shared memory is a ValueError."""
    if probe_smem(m, ks) > MAX_SMEM_BYTES:
        raise ValueError(f"m·ks = {m * ks}: the LUT exceeds the kernel's shared memory "
                         f"({MAX_SMEM_BYTES} bytes)")
    mb = m // 2 if packed_u4 else m
    aim = PLAN_CTAS if 4 * m * ks >= probe_cap * mb else 2 * PLAN_CTAS
    g = 1
    while 2 * g <= min(nprobe, MAX_PROBES) and b * -(-nprobe // (2 * g)) >= aim:
        g *= 2
    return g


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def adc_probe_scores_ref(
    lut_q, start_rows, live_rows, codes, tcorr, *, nprobe: int, probe_cap: int, m: int, ks: int,
    packed_u4: bool = False, base: Optional[Tensor] = None, row_allow: Optional[Tensor] = None,
) -> Tensor:
    """Plain K9 → [B, nprobe·probe_cap] f32: the partial sums, then
    + base[:, :, None] and the allow mask where given, as the search once
    applied them after the kernel."""
    del ks
    b = lut_q.shape[0]
    offs = torch.arange(probe_cap, device=lut_q.device)
    live = offs < live_rows[:, :, None]
    rows = torch.where(live, start_rows[:, :, None].long() + offs, 0).reshape(b, -1)
    acc = torch.zeros(rows.shape, dtype=torch.float32, device=lut_q.device)
    for j in range(m):  # one rounded add per subspace, in order
        if packed_u4:
            byte = codes[rows, j // 2]
            code = (byte >> 4) if j % 2 else (byte & 0xF)
        else:
            code = codes[rows, j]
        acc = acc + torch.gather(lut_q[:, j, :], 1, code.long())
    acc = acc + tcorr[rows]
    dist = torch.where(live.reshape(b, -1), acc, INVALID_DIST)
    if base is not None:
        dist = (dist.reshape(b, nprobe, probe_cap) + base[:, :, None]).reshape(b, -1)
    if row_allow is not None:
        # a dead slot clipped onto a row is already +inf
        slot_of = torch.clamp(start_rows.long()[:, :, None] + offs, 0, row_allow.shape[0] - 1)
        dist = torch.where(row_allow[slot_of].reshape(b, -1), dist, INVALID_DIST)
    return dist


#: plain K10: the same function as plain K9
adc_probe_scores_rankseg_ref = adc_probe_scores_ref


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_inputs(lut_q, start_rows, live_rows, codes, tcorr, nprobe, probe_cap, m, ks, packed_u4,
                  base=None, row_allow=None):
    b = lut_q.shape[0]
    if lut_q.dtype != torch.float32 or lut_q.shape != (b, m, ks):
        raise ValueError(f"lut_q must be float32 [{b}, {m}, {ks}], got {lut_q.dtype} {tuple(lut_q.shape)}")
    if packed_u4 and (m % 2 or ks > 16):
        raise ValueError(f"packed u4 codes need an even m and ks <= 16, got m={m}, ks={ks}")
    mb = m // 2 if packed_u4 else m
    if codes.dtype != torch.uint8 or codes.dim() != 2 or codes.shape[1] != mb:
        raise ValueError(f"codes must be uint8 [N, {mb}], got {codes.dtype} {tuple(codes.shape)}")
    if tcorr.dtype != torch.float32 or tcorr.shape != (codes.shape[0],):
        raise ValueError(f"tcorr must be float32 [{codes.shape[0]}]")
    if probe_cap <= 0 or probe_cap % BLK:
        raise ValueError(f"probe_cap must be a positive multiple of {BLK}")
    for name, t in (("start_rows", start_rows), ("live_rows", live_rows)):
        if t.dtype != torch.int32 or t.shape != (b, nprobe):
            raise ValueError(f"{name} must be int32 [{b}, {nprobe}]")
    if base is not None and (base.dtype != torch.float32 or base.shape != (b, nprobe)
                             or base.stride(1) != 1):
        raise ValueError(f"base must be float32 [{b}, {nprobe}] with unit stride along probes")
    if row_allow is not None and (row_allow.dtype != torch.bool
                                  or row_allow.shape != (codes.shape[0],)):
        raise ValueError(f"row_allow must be bool [{codes.shape[0]}]")
    tensors = [t for t in (lut_q, start_rows, live_rows, codes, tcorr, row_allow) if t is not None]
    if any(t.device != codes.device for t in tensors + [base] * (base is not None)):
        raise ValueError("all inputs must be on one device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("all inputs but base must be contiguous")
    if probe_smem(m, ks) > MAX_SMEM_BYTES:  # the query's LUT lives in shared memory
        raise ValueError(f"m·ks = {m * ks} exceeds the kernel's shared-memory limit")


def _launch(name, lut_q, start_rows, live_rows, codes, tcorr, probe_cap, m, ks, packed_u4,
            base=None, row_allow=None, probes: Optional[int] = None):
    from vectorindex_tpu_torch.kernels import _build

    b, nprobe = start_rows.shape
    out = torch.empty((b, nprobe * probe_cap), dtype=torch.float32, device=codes.device)
    if b == 0 or nprobe == 0:
        return out
    if probes is None:
        probes = probe_plan(b, nprobe, probe_cap, m, ks, packed_u4)
    lib = _build.load()
    err = lib.vi_adc_probe_scores(  # one kernel serves both names
        lut_q.data_ptr(), start_rows.data_ptr(), live_rows.data_ptr(), codes.data_ptr(),
        tcorr.data_ptr(), None if base is None else base.data_ptr(),
        None if row_allow is None else row_allow.data_ptr(), b, nprobe,
        0 if base is None else base.stride(0), probe_cap, m, ks,
        codes.shape[1], int(packed_u4), probes, out.data_ptr(),
        torch.cuda.current_stream(codes.device).cuda_stream,
    )
    _build.check(lib, err, name)
    LAUNCHES[name] += 1
    return out


def adc_probe_scores(
    lut_q: Tensor,  # [B, m, ks] f32 query LUT (pq_lut_q_l2 / pq_lut_ip)
    start_rows: Tensor,  # [B, nprobe] int32 CSR start row of each probed list
    live_rows: Tensor,  # [B, nprobe] int32 live length of each probed list
    codes: Tensor,  # [N_pad, m] uint8, or [N_pad, m//2] packed u4
    tcorr: Tensor,  # [N_pad] f32 per-row corrections (zeros for IP)
    *,
    nprobe: int,
    probe_cap: int,  # per-list slot budget, multiple of BLK, ≥ every live length
    m: int,
    ks: int,
    packed_u4: bool = False,
    base: Optional[Tensor] = None,  # [B, nprobe] f32 coarse term, added to every slot (rows
    #   may be strided, as a slice of ivf_select's sort is)
    row_allow: Optional[Tensor] = None,  # [N_pad] bool allow mask, CSR row order
) -> Tensor:
    """K9 → [B, nprobe·probe_cap] f32 ADC distances (with base, if given),
    +inf in dead and denied slots. CUDA tensors launch the kernel (or
    raise); CPU tensors take adc_probe_scores_ref."""
    _check_inputs(lut_q, start_rows, live_rows, codes, tcorr, nprobe, probe_cap, m, ks, packed_u4,
                  base, row_allow)
    args = (lut_q, start_rows, live_rows, codes, tcorr)
    if codes.device.type == "cpu":
        return adc_probe_scores_ref(*args, nprobe=nprobe, probe_cap=probe_cap, m=m, ks=ks,
                                    packed_u4=packed_u4, base=base, row_allow=row_allow)
    return _launch("adc_probe_scores", *args, probe_cap, m, ks, packed_u4, base, row_allow)


def adc_probe_scores_rankseg(
    lut_q: Tensor, start_rows: Tensor, live_rows: Tensor, codes: Tensor, tcorr: Tensor,
    *, nprobe: int, probe_cap: int, m: int, ks: int, packed_u4: bool = False,
    base: Optional[Tensor] = None, row_allow: Optional[Tensor] = None,
) -> Tensor:
    """K10 → K9's output, the serving-batch (B ≤ 16) kernel. CUDA tensors
    launch the kernel (or raise); CPU tensors take
    adc_probe_scores_rankseg_ref."""
    _check_inputs(lut_q, start_rows, live_rows, codes, tcorr, nprobe, probe_cap, m, ks, packed_u4,
                  base, row_allow)
    args = (lut_q, start_rows, live_rows, codes, tcorr)
    if codes.device.type == "cpu":
        return adc_probe_scores_rankseg_ref(*args, nprobe=nprobe, probe_cap=probe_cap, m=m, ks=ks,
                                            packed_u4=packed_u4, base=base, row_allow=row_allow)
    return _launch("adc_probe_scores_rankseg", *args, probe_cap, m, ks, packed_u4, base, row_allow)


def adc_probe_scores_v1(
    lut_q: Tensor, start_rows: Tensor, live_rows: Tensor, codes: Tensor, tcorr: Tensor,
    *, nprobe: int, probe_cap: int, m: int, ks: int, packed_u4: bool = False,
) -> Tensor:
    """K9/K10's first design (no base or allow inputs), for timing
    the redesign against it: CUDA tensors only."""
    _check_inputs(lut_q, start_rows, live_rows, codes, tcorr, nprobe, probe_cap, m, ks, packed_u4)
    if codes.device.type == "cpu":
        raise ValueError("adc_probe_scores_v1 times a CUDA kernel: pass CUDA tensors")
    from vectorindex_tpu_torch.kernels import _build

    b = lut_q.shape[0]
    out = torch.empty((b, nprobe * probe_cap), dtype=torch.float32, device=codes.device)
    if b == 0 or nprobe == 0:
        return out
    lib = _build.load()
    err = lib.vi_adc_probe_scores_v1(
        lut_q.data_ptr(), start_rows.data_ptr(), live_rows.data_ptr(), codes.data_ptr(),
        tcorr.data_ptr(), b, nprobe, probe_cap, m, ks, codes.shape[1], int(packed_u4),
        out.data_ptr(), torch.cuda.current_stream(codes.device).cuda_stream,
    )
    _build.check(lib, err, "adc_probe_scores_v1")
    LAUNCHES["adc_probe_scores_v1"] += 1
    return out


# ---------------------------------------------------------------------------
# the probed search
# ---------------------------------------------------------------------------


def _dedup_missing(iids: Tensor, missing: Tensor) -> Tensor:
    """Mark all-but-the-first occurrence of each candidate id as missing —
    needed under spill multi-assignment (ops.ivf.spill_assign), where a
    corpus row can reach the top-C from two lists (ops.dedup.dedup_mask)."""
    return dedup_mask(iids, missing)


def _probed_adc(q, centroids, arrays, codes, tcorr, books, nprobe, probe_cap, metric, packed_u4,
                row_allow, disabled_lists, what):
    """ADC distances of every probed slot, base term and allow mask in →
    (dist [B, nprobe·probe_cap], start_rows [B, nprobe] int32)."""
    if metric == Metric.L2:
        lut_q = pq_ops.pq_lut_q_l2(q, books)
    elif metric == Metric.INNER_PRODUCT:
        lut_q = pq_ops.pq_lut_ip(q, books)
    else:
        raise ValueError(f"{what} supports L2 and IP")
    b = q.shape[0]
    m, ks, _ = books.centroids.shape
    # base: ‖q−c_l‖² (L2) or −⟨q, c_l⟩ (IP), the coarse-select distances
    base, probe_lists = ivf_select(q, centroids, nprobe=nprobe, metric=metric,
                                   disabled=disabled_lists)
    probe_lists = probe_lists.long()
    start_rows = arrays.starts[probe_lists].to(torch.int32).contiguous()
    live_rows = arrays.lengths[probe_lists].to(torch.int32)
    if disabled_lists is not None:
        # a disabled list is still selected when nprobe spans every list
        # (its +inf routing distance only ranks it last): scan none of it
        live_rows = torch.where(torch.isfinite(base), live_rows, 0)
    scores = adc_probe_scores_rankseg if adc_rankseg_fits(b) else adc_probe_scores
    # the coarse term (read in place: a slice of ivf_select's sort) and the
    # allow mask go in, before the top-C; on the card the kernel's epilogue
    # applies them, so the search makes no pass of its own over dist
    dist = scores(lut_q.contiguous(), start_rows, live_rows.contiguous(), codes, tcorr,
                  nprobe=nprobe, probe_cap=probe_cap, m=m, ks=ks, packed_u4=packed_u4,
                  base=base.float(), row_allow=row_allow)
    return dist, start_rows


def candidate_count(rerank_c: int, k: int, nprobe: int, nlist: int, probe_cap: int) -> int:
    """C, the ADC candidates a query keeps for the rerank: max(rerank_c,
    4·min(k, P), 128), at most P = min(nprobe, nlist)·probe_cap."""
    p = min(nprobe, nlist) * probe_cap
    return min(max(rerank_c, 4 * min(k, p), 128), p)


def _top_c(dist, start_rows, c, probe_cap, row_ids, dedup):
    """Position top-c of the probed distances (lowest position first on
    ties) → (distances, CSR rows clipped, internal ids INVALID where
    missing, missing mask)."""
    cd, cp = topk(dist, c, strict_ties=False)
    cp = cp.long()
    rows = torch.gather(start_rows.long(), 1, cp // probe_cap) + cp % probe_cap
    rows = torch.clamp(rows, 0, row_ids.shape[0] - 1)
    iids = row_ids[rows]
    missing = ~torch.isfinite(cd)
    if dedup:
        missing = _dedup_missing(iids, missing)
        # a dedup'd duplicate must not keep its finite distance: ranked
        # without rerank it would put an INVALID_ID mid-row
        cd = torch.where(missing, INVALID_DIST, cd)
    return cd, rows, torch.where(missing, INVALID_ID, iids), missing


def ivf_search_pq_probe(
    q: Tensor,
    centroids: Tensor,
    arrays,  # ops.ivf.IVFListArrays
    codes: Tensor,  # [N_pad, m] uint8 / [N_pad, m//2] packed u4, CSR layout
    tcorr: Tensor,  # [N_pad] f32 (pq_row_corrections; zeros for IP)
    books: pq_ops.PQCodebooks,
    *,
    nprobe: int,
    probe_cap: int,
    k: int,
    metric: Metric = Metric.L2,
    packed_u4: bool = False,
    rerank_c: int = 0,
    rerank_vecs: Optional[Tensor] = None,  # [n, d] rerank source gathered by
    #   internal id (original row order) instead of by CSR row
    rerank_sqnorms: Optional[Tensor] = None,  # [n] f32 ‖x‖², with rerank_vecs
    row_allow: Optional[Tensor] = None,  # [N_pad] bool allow mask, CSR row order
    disabled_lists: Optional[Tensor] = None,  # [kc] bool
    dedup: bool = False,  # needed under spill: a row's copies share an id
) -> Tuple[Tensor, Tensor]:
    """IVF-PQ ADC probed search through K9/K10 → (dist [B, k], internal ids
    [B, k] int32), the counterpart of the JAX package's
    `ivf_search_pq_pallas`.

    The c = min(max(rerank_c, 4·kk, 128), P) best ADC slots by position
    (kk = min(k, P), P = nprobe·probe_cap) are kept; with rerank_c they are
    re-scored exactly at f32 from arrays.vecs/sqnorms (or rerank_vecs/
    rerank_sqnorms by id), then the strict (score, id) top-k, padded to k
    with (+inf, INVALID_ID)."""
    if rerank_c and rerank_vecs is not None and rerank_sqnorms is None:
        raise ValueError("rerank_vecs needs rerank_sqnorms (‖x‖² of the same rows)")
    b = q.shape[0]
    q = q.float()
    # ivf_select clamps nprobe to nlist; the kernels' tables must agree
    nprobe = min(nprobe, centroids.shape[0])
    dist, start_rows = _probed_adc(q, centroids, arrays, codes, tcorr, books, nprobe, probe_cap,
                                   metric, packed_u4, row_allow, disabled_lists,
                                   "ivf_search_pq_probe")
    kk = min(k, dist.shape[1])
    c = candidate_count(rerank_c, k, nprobe, centroids.shape[0], probe_cap)
    cd, rows, iids, missing = _top_c(dist, start_rows, c, probe_cap, arrays.row_ids, dedup)
    if rerank_c:
        # exact rerank of the ADC top-C against the stored vectors
        # (reference IVFPostADC.rerankTopKFlat + #40)
        if rerank_vecs is not None:
            gidx = torch.clamp(torch.where(missing, 0, iids), 0, rerank_vecs.shape[0] - 1).long()
            xg, sg = rerank_vecs[gidx].float(), rerank_sqnorms[gidx].float()
        else:
            rrows = torch.where(missing, 0, rows)
            xg, sg = arrays.vecs[rrows].float(), arrays.sqnorms[rrows].float()
        g = _gram_rows(q, xg)
        if metric == Metric.L2:
            ex = torch.clamp_min((q * q).sum(dim=-1)[:, None] + sg - 2.0 * g, 0.0)
        else:
            ex = -g
        sd, si = topk(torch.where(missing, INVALID_DIST, ex), kk, ids=iids, strict_ties=True)
    else:
        sd, si = topk(cd, kk, ids=iids, strict_ties=True)
        if metric == Metric.L2:
            sd = torch.where(torch.isfinite(sd), torch.clamp_min(sd, 0.0), sd)
    if kk < k:  # degenerate: fewer probed slots than k
        sd = torch.cat([sd, sd.new_full((b, k - kk), INVALID_DIST)], dim=1)
        si = torch.cat([si, si.new_full((b, k - kk), INVALID_ID)], dim=1)
    return sd, si


def pq_probe_candidates(
    q: Tensor,
    centroids: Tensor,
    arrays,  # ops.ivf.IVFListArrays (vecs/sqnorms unused, may be None)
    codes: Tensor,
    tcorr: Tensor,
    books: pq_ops.PQCodebooks,
    *,
    nprobe: int,
    probe_cap: int,
    c: int,
    metric: Metric = Metric.L2,
    packed_u4: bool = False,
    row_allow: Optional[Tensor] = None,
    disabled_lists: Optional[Tensor] = None,
    dedup: bool = False,
) -> Tuple[Tensor, Tensor, Tensor]:
    """ADC probe → top-C candidates only: (adc_dist [B, c] f32, CSR rows
    [B, c] (0 where missing), internal ids [B, c] int32 (INVALID_ID where
    missing)). The device half of a rerank whose source is elsewhere:
    nothing here reads the stored vectors."""
    q = q.float()
    nprobe = min(nprobe, centroids.shape[0])
    dist, start_rows = _probed_adc(q, centroids, arrays, codes, tcorr, books, nprobe, probe_cap,
                                   metric, packed_u4, row_allow, disabled_lists,
                                   "pq_probe_candidates")
    cd, rows, iids, missing = _top_c(dist, start_rows, min(c, dist.shape[1]), probe_cap,
                                     arrays.row_ids, dedup)
    return cd, torch.where(missing, 0, rows), iids


# ---------------------------------------------------------------------------
# the host-memory rerank tier (VectorReader seam)
# ---------------------------------------------------------------------------


def _host_queries(q) -> np.ndarray:
    if isinstance(q, torch.Tensor):
        q = q.detach().cpu().numpy()
    return np.ascontiguousarray(q, dtype=np.float32)


def _upload(qnp: np.ndarray, device: torch.device) -> Tensor:
    """Queries to the device without waiting for its queue: from pinned
    memory (the caching host allocator keeps the block until the copy is
    done), where a pageable upload would synchronise the stream."""
    q = torch.from_numpy(qnp)
    if device.type != "cuda":
        return q.to(device)
    return q.pin_memory().to(device, non_blocking=True)


def _rows_of(g: np.ndarray, d: int, b: int, c: int) -> np.ndarray:
    """Gathered [B·C, d'] rows → [B, C, d], without the columns past d a
    padded reader serves."""
    if g.shape[-1] > d:
        g = np.ascontiguousarray(g[:, :d])
    return g.reshape(b, c, g.shape[-1])


def rerank_by_ids(reader, iids: np.ndarray, qnp: np.ndarray, *, k: int, metric: Metric):
    """The host rerank of candidate ids [B, C] from an id-keyed reader
    (`gather_ids`): the native fused rerank where the reader's `vecs` is
    id-indexed and its layout admits it, else gather_ids +
    rerank_gathered_host."""
    if getattr(reader, "vecs_id_indexed", False):
        out = rerank_ids_host(reader.vecs, iids, qnp, k=k, metric=metric)
        if out is not None:
            return out
    xg = _rows_of(reader.gather_ids(iids.reshape(-1)), qnp.shape[1], *iids.shape)
    return rerank_gathered_host(qnp, xg, iids, k=k, metric=metric)


def ivf_search_pq_hostrerank(
    q,  # [B, d] queries (numpy or tensor)
    centroids: Tensor,
    arrays,  # ops.ivf.IVFListArrays; vecs/sqnorms may be None
    codes: Tensor,
    tcorr: Tensor,
    books: pq_ops.PQCodebooks,
    reader,  # ops.rerank.VectorReader: the full-precision source
    *,
    nprobe: int,
    probe_cap: int,
    k: int,
    rerank_c: int = 128,
    metric: Metric = Metric.L2,
    packed_u4: bool = False,
    row_allow: Optional[Tensor] = None,
    disabled_lists: Optional[Tensor] = None,
    dedup: bool = False,  # needed under spill, as on the device tier
    host_rerank: bool = True,
):
    """IVF-PQ search with the exact-rerank source outside device memory
    (reference VectorReader seam, ExactRerank.swift:81-96) → (dist [B, k],
    internal ids [B, k] int32).

    (1) pq_probe_candidates on the card (K9/K10): the C best ADC
    candidates, C = candidate_count(...); (2) their ids (an id-keyed reader,
    `gather_ids`) or CSR rows (a rows-keyed one) to the host; (3) the exact
    f32 rerank and strict (score, id) top-k on the host, numpy arrays out:
    the native fused rerank where the reader's `vecs` is id-indexed and its
    layout admits it, else the reader's gather + rerank_gathered_host.
    host_rerank=False ships the gathered rows back and reranks on the
    device (rerank_gathered), tensors out."""
    qnp = _host_queries(q)
    dev = centroids.device
    qd = _upload(qnp, dev)
    b, d = qnp.shape
    c = candidate_count(rerank_c, k, nprobe, centroids.shape[0], probe_cap)
    cd, rows, iids = pq_probe_candidates(
        qd, centroids, arrays, codes, tcorr, books, nprobe=nprobe, probe_cap=probe_cap, c=c,
        metric=metric, packed_u4=packed_u4, row_allow=row_allow,
        disabled_lists=disabled_lists, dedup=dedup)
    if host_rerank and hasattr(reader, "gather_ids"):
        # the ids are both the gather key and the missing / dedup sentinel:
        # one [B, C] int32 array crosses the link
        return rerank_by_ids(reader, iids.cpu().numpy(), qnp, k=k, metric=metric)
    xg = _rows_of(reader.gather(rows.cpu().numpy().reshape(-1)), d, b, iids.shape[1])
    if host_rerank:
        return rerank_gathered_host(qnp, xg, iids.cpu().numpy(), k=k, metric=metric)
    return rerank_gathered(qd, torch.from_numpy(xg).to(dev), cd, iids, k=k, metric=metric)


class _Landed(NamedTuple):
    views: tuple  # host tensors the device tensors were copied into
    event: Optional[torch.cuda.Event]  # recorded after the copies (CUDA only)
    buf: Optional[Tensor]  # the pinned buffer holding the views


class PinnedLanding:
    """A pool of pinned host buffers that candidate tensors land in.

    `land` enqueues non-blocking copies of int32 device tensors into a free
    buffer on the current stream and records an event after them; `wait`
    blocks on that event only and gives numpy views; `release` returns the
    buffer once the host is done with the views. A buffer is never reused
    before its batch has been released. CPU tensors land as themselves, with
    no copy and no event."""

    def __init__(self, slots: int):
        self._free = deque([None] * slots)

    def land(self, tensors) -> _Landed:
        if tensors[0].device.type != "cuda":
            return _Landed(tuple(tensors), None, None)
        if not self._free:
            raise RuntimeError("every pinned buffer is in flight: release a batch first")
        n = sum(t.numel() for t in tensors)
        buf = self._free.popleft()
        if buf is None or buf.numel() < n:
            buf = torch.empty(n, dtype=torch.int32, pin_memory=True)
        views, off = [], 0
        for t in tensors:
            v = buf[off : off + t.numel()].view(t.shape)
            v.copy_(t, non_blocking=True)
            views.append(v)
            off += t.numel()
        event = torch.cuda.Event()
        event.record()
        return _Landed(tuple(views), event, buf)

    @staticmethod
    def wait(landed: _Landed) -> tuple:
        if landed.event is not None:
            landed.event.synchronize()
        return tuple(v.numpy() for v in landed.views)

    def release(self, landed: _Landed) -> None:
        if landed.buf is not None:
            self._free.append(landed.buf)


def ivf_search_pq_hostrerank_stream(
    q_batches,  # iterable of [B, d] query batches (numpy or tensors)
    centroids: Tensor,
    arrays,
    codes: Tensor,
    tcorr: Tensor,
    books: pq_ops.PQCodebooks,
    reader,
    *,
    nprobe: int,
    probe_cap: int,
    k: int,
    rerank_c: int = 128,
    metric: Metric = Metric.L2,
    packed_u4: bool = False,
    row_allow: Optional[Tensor] = None,
    disabled_lists: Optional[Tensor] = None,
    dedup: bool = False,
    host_rerank: bool = True,
    lookahead: int = 3,
):
    """Pipelined host-rerank serving: yields ivf_search_pq_hostrerank's
    (dist, ids) per batch, in order, with up to `lookahead` batches in
    flight (reference gather tiles pipelined against scoring,
    ExactRerank.swift:21-64).

    dispatch(batch) enqueues the candidate stage on the current stream and
    the copy of its ids (and, for a rows-keyed reader or the device rerank,
    its CSR rows) into a pinned buffer (PinnedLanding, lookahead + 1 of
    them), with an event after the copy; finish(batch) waits on that event
    only, then reranks. Batches drain before the next dispatch, so at most
    `lookahead` are in flight. The native rerank reads the corpus in
    finish(); for the numpy paths one worker thread lands the ids or rows
    and gathers, so the gather of one batch overlaps the rerank of the one
    before. On CPU tensors the same code runs synchronously."""
    use_ids = host_rerank and hasattr(reader, "gather_ids")
    native = (use_ids and getattr(reader, "vecs_id_indexed", False)
              and native_rerank_available(reader.vecs))
    if native:
        load_hostops()  # built now, not inside the first batch; a failed build raises
    depth = max(lookahead, 1)
    landing = PinnedLanding(depth + 1)
    fetcher = None if native else ThreadPoolExecutor(max_workers=1)
    dev = centroids.device

    def gather(landed, b, c, d):  # the worker: the first landed array keys the gather
        keys = landing.wait(landed)[0].reshape(-1)
        return _rows_of(reader.gather_ids(keys) if use_ids else reader.gather(keys), d, b, c)

    def dispatch(qb):
        qnp = _host_queries(qb)
        qd = _upload(qnp, dev)
        b, d = qnp.shape
        c = candidate_count(rerank_c, k, nprobe, centroids.shape[0], probe_cap)
        cd, rows, iids = pq_probe_candidates(
            qd, centroids, arrays, codes, tcorr, books, nprobe=nprobe, probe_cap=probe_cap,
            c=c, metric=metric, packed_u4=packed_u4, row_allow=row_allow,
            disabled_lists=disabled_lists, dedup=dedup)
        c = iids.shape[1]
        # a rows-keyed host rerank lands its ids beside the rows
        keys = (iids,) if use_ids else (rows.to(torch.int32),) + ((iids,) if host_rerank else ())
        landed = landing.land(keys)
        fut = None if native else fetcher.submit(gather, landed, b, c, d)
        return qnp, qd, cd, iids, landed, fut

    def finish(pend):
        qnp, qd, cd, iids, landed, fut = pend
        try:
            if native:
                return rerank_by_ids(reader, landing.wait(landed)[0], qnp, k=k, metric=metric)
            xg = fut.result()
            if host_rerank:
                return rerank_gathered_host(qnp, xg, landing.wait(landed)[-1], k=k, metric=metric)
            return rerank_gathered(qd, torch.from_numpy(xg).to(dev), cd, iids, k=k, metric=metric)
        finally:
            landing.release(landed)

    pending = deque()
    try:
        for qb in q_batches:
            if len(pending) >= depth:  # drain first: at most `lookahead` in flight
                yield finish(pending.popleft())
            pending.append(dispatch(qb))
        while pending:
            yield finish(pending.popleft())
    finally:
        if fetcher is not None:
            fetcher.shutdown(wait=True, cancel_futures=True)
