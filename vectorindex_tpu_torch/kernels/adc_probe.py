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
`pq_probe_candidates` is its candidate half. The host-memory rerank tier
(`ivf_search_pq_hostrerank`, `_stream`) is not ported yet (ROADMAP.md
Queue 1 item 6).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vectorindex_tpu_torch.kernels.ivf_probe import BLK
from vectorindex_tpu_torch.kernels.scan_fused import MAX_SMEM_BYTES
from vectorindex_tpu_torch.ops import pq as pq_ops
from vectorindex_tpu_torch.ops.dedup import dedup_mask
from vectorindex_tpu_torch.ops.ivf import _gram_rows, ivf_select
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
    p = dist.shape[1]
    kk = min(k, p)
    c = min(max(rerank_c, 4 * kk, 128), p)
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
