"""IVF-Flat probed search: kernels K3, K4, K5 and the search wrapper.

Counterpart of vectorindex_tpu/kernels/ivf_probe.py. The three kernels score
the live rows of each query's probed lists (CSR rows start + o, o < live)
and never read a dead row:

  K4 `ivf_probe_scores`: every (query, probe, slot) distance →
      [B, nprobe·probe_cap] f32, +inf where slot ≥ live.
  K5 `ivf_probe_scores_rankmajor`: K4's output, plus the deny sentinel — a
      non-finite ‖x‖² gives +inf for IP and cosine too (L2 gets it from the
      arithmetic). On the TPU it is K4 through a rank-major grid; here one
      CUDA kernel serves both, with the sentinel as a template flag.
  K3 `ivf_probe_topc_rankmajor`: per query, over the live probed rows, with
      class = CSR row mod CBINS: the 3 smallest finite (dist, row) pairs of
      each class in (dist, row) order, tier-major → cand [B, 3·CBINS]
      (unfilled: +inf, row 0), and drop_min [B, CBINS], the class's 4th
      smallest finite distance (+inf if none). A function of the set of
      rows, not of the TPU's step order: it keeps at least what the TPU
      kernel keeps, and its drop_min is ≥ the TPU's, so every query the TPU
      proves complete (min(drop_min) > tau) is proven complete here too.
      It honours the deny sentinel like K5.

Distances, shared by all three (one __device__ function in
csrc/ivf_probe.cu, one plain version here), with q rounded to the storage
dtype and ‖q‖² taken from f32 q:

  L2:     (‖q‖² + ‖x‖²) − 2g
  IP:     −g
  cosine: 1 − (g · 1/‖q‖) · (‖x‖² > 0 ? 1/√max(‖x‖², 1e-30) : 0)

where g = Σ_k q[k]·x[k] is summed in order k = 0..d−1 with every product
and every sum rounded to f32 (no fused multiply-add), and 1/√ is a
correctly rounded square root and division. The plain versions
(`*_ref`) do exactly these operations in this order, so on a given input
the kernels and their plain versions agree bit for bit, on any device.
CPU tensors take the plain versions; CUDA tensors always launch the kernels.

Schedules on the card (csrc/ivf_probe.cu):

  K4/K5 are list-major: `probe_groups` sorts the B·nprobe pairs stably by
      start row on the device (no host sync) and cuts each run of one start
      into groups of at most PROBE_GROUP pairs; a CTA per (group leader,
      chunk of rows) stages its chunk of the list through a cp.async ring in
      shared memory once and runs every pair's chain on it, so a list that
      several queries probe is read once a group, not once a pair. Each pair
      keeps its own live length. Serving batches (≤ SCORES_SMALL_PAIRS
      pairs), whose lists are rarely probed twice, skip the grouping: each
      pair is its own group.
  K3 is one launch: CTAs over (pair, chunk of `_topc_chunk_rows` rows) keep
      their per-class top-4 in registers, fed through a cp.async ring, and
      write it as a partial; the last CTA of a query to arrive (a per-query
      counter in a workspace that the folding CTA resets to 0) folds the
      query's partials. The insert is lexicographic, so neither the chunking
      nor the order of arrival changes a bit of the result.
  All three are bound by bytes (each live row of the distinct probed lists
  read once); grouped K4 comes within 1% of that count on the IVF main path,
  and at serving batches, where a list is rarely probed twice, the pairs'
  rows are ~15% more. The first designs (one CTA per pair; K3 as scan +
  merge launches) stay as `ivf_probe_scores_v1` and `ivf_probe_topc_v1` for
  timing in turns and are never called by the search.

`ivf_search_flat_probe` is the counterpart of `ivf_search_flat_pallas`:
select lists, route (K3 for B ≤ 16 and k ≤ 2·CBINS; else the pair path),
prove K3's selection complete or re-run the batch through the pair path
(K4), f32 exact rerank of the candidates, strict (score, id) top-k.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vectorindex_tpu_torch.kernels.scan_fused import _DTYPE_CODE, _METRIC_CODE, MAX_SMEM_BYTES
from vectorindex_tpu_torch.ops.ivf import _gram_rows, ivf_select
from vectorindex_tpu_torch.ops.topk import INVALID_DIST, INVALID_ID, topk
from vectorindex_tpu_torch.utils.config import Metric

Tensor = torch.Tensor

BLK = 256  # rows per block == the CSR packer's minimum list capacity
CBINS = 256  # K3 classes per query (a CSR row's class is row mod CBINS)
TIERS = 3  # K3 candidates kept per class
GUARD_BLOCKS = 16  # trailing dead blocks of the CSR layout (ops/ivf._repack)

#: K4/K5: most (query, probe) pairs one CTA serves (the kernel's kGroup)
PROBE_GROUP = 16
#: K4/K5 rows per CTA; batches of at most SCORES_SMALL_PAIRS pairs (serving
#: batches, whose groups hold about one pair) take the smaller chunk so that
#: their few lists still spread over every SM, and skip the grouping: each
#: pair is its own group
SCORES_CHUNK_ROWS, SCORES_CHUNK_ROWS_SMALL, SCORES_SMALL_PAIRS = 1024, 512, 1024
#: K3: rows per CTA at least (a whole list at the IVF main path's probe_cap:
#: smaller chunks cost more in per-CTA start-up and fold than they gain in
#: balance), and the CTAs a launch aims at (two fit an SM); each CTA's
#: partial is 4 x CBINS x 8 bytes
TOPC_CHUNK_MIN = 2048
TOPC_GRID = 2048
#: K3's first design: rows per CTA at least, chunks per pair at most
TOPC_V1_CHUNK_MIN, TOPC_V1_MAX_CHUNKS = 2048, 4

#: kernel launches per wrapper since the last reset (plain versions do not
#: count); the *_v1 entries count the first designs, which only timing calls
LAUNCHES = {"ivf_probe_topc": 0, "ivf_probe_scores": 0, "ivf_probe_scores_rankmajor": 0,
            "ivf_probe_topc_v1": 0, "ivf_probe_scores_v1": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def rank_major_fits(b: int, probe_cap: int = 0, d: int = 0, itemsize: int = 0) -> bool:
    """Serving batches (1 ≤ B ≤ 16) take K3 (and K5 where they need the
    full distance matrix); larger batches take K4."""
    del probe_cap, d, itemsize
    return 1 <= b <= 16


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _query_terms(q: Tensor, storage_dtype: torch.dtype, metric: Metric) -> Tuple[Tensor, Tensor]:
    """(q rounded to the storage dtype as f32 [B, d], the per-query term
    [B]: ‖q‖² for L2, 1/‖q‖ for cosine, 0 for IP), from f32 q."""
    qr = q.to(storage_dtype).float().contiguous()
    qn = (q * q).sum(dim=1)
    if metric == Metric.L2:
        qterm = qn
    elif metric == Metric.COSINE:
        qterm = 1.0 / torch.sqrt(torch.clamp_min(qn, 1e-30))
    else:
        qterm = torch.zeros_like(qn)
    return qr, qterm.contiguous()


def _probe_dist_ref(
    q: Tensor,
    start_rows: Tensor,
    live_rows: Tensor,
    vecs: Tensor,
    sqnorms: Tensor,
    *,
    probe_cap: int,
    metric: Metric,
    deny_sentinel: bool,
) -> Tuple[Tensor, Tensor]:
    """Distances of every (query, probe, slot) in the kernels' arithmetic →
    (dist [B, nprobe·probe_cap] f32, +inf in dead slots; CSR row of each
    slot [B, nprobe·probe_cap] int64, 0 in dead slots)."""
    qr, qterm = _query_terms(q, vecs.dtype, metric)
    b = q.shape[0]
    offs = torch.arange(probe_cap, device=q.device)
    live = offs < live_rows[:, :, None]
    rows = torch.where(live, start_rows[:, :, None].long() + offs, 0).reshape(b, -1)
    live = live.reshape(b, -1)
    g = torch.zeros(rows.shape, dtype=torch.float32, device=q.device)
    for k in range(q.shape[1]):  # one rounded product and one rounded sum per k
        g = g + qr[:, k : k + 1] * vecs[:, k][rows].float()
    dist = _probe_epilogue(g, qterm[:, None], sqnorms[rows], metric, deny_sentinel)
    return torch.where(live, dist, INVALID_DIST), rows


def _probe_epilogue(g: Tensor, qterm: Tensor, sq: Tensor, metric: Metric,
                    deny_sentinel: bool) -> Tensor:
    """Distances from the chain's g, the query term and ‖x‖² (broadcast),
    in the kernels' epilogue arithmetic (probe_epilogue in the CUDA file)."""
    if metric == Metric.L2:
        dist = (qterm + sq) - 2.0 * g
    elif metric == Metric.INNER_PRODUCT:
        dist = -g
    else:
        xinv = torch.where(sq > 0, 1.0 / torch.sqrt(torch.clamp_min(sq, 1e-30)), 0.0)
        dist = 1.0 - g * qterm * xinv
    if deny_sentinel and metric != Metric.L2:
        dist = torch.where(sq < INVALID_DIST, dist, INVALID_DIST)
    return dist


def ivf_probe_scores_ref(
    q, start_rows, live_rows, vecs, sqnorms, *, nprobe: int, probe_cap: int,
    metric: Metric = Metric.L2,
) -> Tensor:
    """Plain K4 → [B, nprobe·probe_cap] f32."""
    del nprobe
    return _probe_dist_ref(q, start_rows, live_rows, vecs, sqnorms, probe_cap=probe_cap,
                           metric=metric, deny_sentinel=False)[0]


def ivf_probe_scores_rankmajor_ref(
    q, start_rows, live_rows, vecs, sqnorms, *, nprobe: int, probe_cap: int,
    metric: Metric = Metric.L2,
) -> Tensor:
    """Plain K5 → [B, nprobe·probe_cap] f32 (K4 plus the deny sentinel)."""
    del nprobe
    return _probe_dist_ref(q, start_rows, live_rows, vecs, sqnorms, probe_cap=probe_cap,
                           metric=metric, deny_sentinel=True)[0]


def ivf_probe_topc_rankmajor_ref(
    q, start_rows, live_rows, vecs, sqnorms, *, nprobe: int, probe_cap: int,
    metric: Metric = Metric.L2,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain K3 → (cand_dist [B, 3·CBINS] f32, cand_rows [B, 3·CBINS] int32,
    drop_min [B, CBINS] f32), by stable sorts on (class, dist, row)."""
    del nprobe
    dist, rows = _probe_dist_ref(q, start_rows, live_rows, vecs, sqnorms,
                                 probe_cap=probe_cap, metric=metric, deny_sentinel=True)
    b = q.shape[0]
    bi, pi = torch.isfinite(dist).nonzero(as_tuple=True)
    dv, rv = dist[bi, pi], rows[bi, pi]
    group = bi * CBINS + rv % CBINS
    order = torch.argsort(rv, stable=True)
    order = order[torch.argsort(dv[order], stable=True)]
    order = order[torch.argsort(group[order], stable=True)]
    group, dv, rv = group[order], dv[order], rv[order]
    counts = torch.bincount(group, minlength=b * CBINS)
    rank = torch.arange(group.shape[0], device=q.device) - (torch.cumsum(counts, 0) - counts)[group]
    keep = rank <= TIERS
    best_d = torch.full((b * CBINS, TIERS + 1), INVALID_DIST, device=q.device)
    best_r = torch.zeros((b * CBINS, TIERS + 1), dtype=torch.int32, device=q.device)
    best_d[group[keep], rank[keep]] = dv[keep]
    best_r[group[keep], rank[keep]] = rv[keep].to(torch.int32)

    def tier_major(a: Tensor) -> Tensor:
        return a[:, :TIERS].reshape(b, CBINS, TIERS).transpose(1, 2).reshape(b, TIERS * CBINS)

    return tier_major(best_d), tier_major(best_r), best_d[:, TIERS].reshape(b, CBINS).contiguous()


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_inputs(q, start_rows, live_rows, vecs, sqnorms, nprobe, probe_cap, metric) -> None:
    if metric not in _METRIC_CODE:
        raise ValueError(f"IVF probe kernels support L2/IP/cosine, got {metric}")
    if q.dim() != 2 or vecs.dim() != 2 or q.shape[1] != vecs.shape[1]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, vecs {tuple(vecs.shape)}")
    if q.dtype != torch.float32:
        raise TypeError(f"q must be float32, got {q.dtype}")
    if vecs.dtype not in _DTYPE_CODE:
        raise TypeError(f"vecs must be float32 or bfloat16, got {vecs.dtype}")
    if vecs.shape[0] % BLK or probe_cap <= 0 or probe_cap % BLK:
        raise ValueError(f"rows and probe_cap must be positive multiples of {BLK}")
    if sqnorms.dtype != torch.float32 or sqnorms.shape != (vecs.shape[0],):
        raise ValueError(f"sqnorms must be float32 [{vecs.shape[0]}]")
    for name, t in (("start_rows", start_rows), ("live_rows", live_rows)):
        if t.dtype != torch.int32 or t.shape != (q.shape[0], nprobe):
            raise ValueError(f"{name} must be int32 [{q.shape[0]}, {nprobe}]")
    tensors = (q, start_rows, live_rows, vecs, sqnorms)
    if any(t.device != vecs.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")
    if 4 * (q.shape[1] + 8) > MAX_SMEM_BYTES:  # one query row, d f32, in shared memory
        raise ValueError(f"d={q.shape[1]} exceeds the kernels' shared-memory limit")


def _stream(t: Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def probe_groups(start_rows: Tensor, group: int = PROBE_GROUP) -> Tuple[Tensor, Tensor]:
    """K4/K5's list-major schedule → (order [P] int32: the P = B·nprobe pair
    ids, pair = query·nprobe + probe, sorted stably by start row; glen [P]
    int32: at a group leader the pairs its CTA serves, order[pos : pos +
    glen[pos]], else 0). A leader starts each run of one start row and
    every `group` pairs within a longer run. Device ops only, no host sync."""
    flat = start_rows.reshape(-1)
    srt, order = torch.sort(flat, stable=True)
    pos = torch.arange(flat.numel(), device=flat.device)
    run0 = torch.searchsorted(srt, srt)  # first position of each pair's run
    run1 = torch.searchsorted(srt, srt, right=True)  # one past its last
    lead = (pos - run0) % group == 0
    glen = torch.where(lead, torch.clamp(run1 - pos, max=group), 0)
    return order.to(torch.int32), glen.to(torch.int32)


def _scores_chunk_rows(pairs: int) -> int:
    return SCORES_CHUNK_ROWS_SMALL if pairs <= SCORES_SMALL_PAIRS else SCORES_CHUNK_ROWS


def _launch_scores(q, start_rows, live_rows, vecs, sqnorms, probe_cap, metric, deny_sentinel,
                   chunk_rows=None, grouped=None):
    from vectorindex_tpu_torch.kernels import _build

    b, nprobe = start_rows.shape
    out = torch.empty((b, nprobe * probe_cap), dtype=torch.float32, device=vecs.device)
    if b == 0 or nprobe == 0:
        return out
    qr, qterm = _query_terms(q, vecs.dtype, metric)
    small = b * nprobe <= SCORES_SMALL_PAIRS
    if grouped is None:
        grouped = not small
    order, glen = probe_groups(start_rows) if grouped else (None, None)
    chunk = chunk_rows or _scores_chunk_rows(b * nprobe)
    lib = _build.load()
    err = lib.vi_ivf_probe_scores(
        qr.data_ptr(), qterm.data_ptr(), start_rows.data_ptr(), live_rows.data_ptr(),
        0 if order is None else order.data_ptr(), 0 if glen is None else glen.data_ptr(),
        vecs.data_ptr(), sqnorms.data_ptr(), b, nprobe, q.shape[1], probe_cap, chunk,
        _DTYPE_CODE[vecs.dtype], _METRIC_CODE[metric], int(deny_sentinel), out.data_ptr(),
        _stream(vecs),
    )
    name = "ivf_probe_scores_rankmajor" if deny_sentinel else "ivf_probe_scores"
    _build.check(lib, err, name)
    LAUNCHES[name] += 1
    return out


def ivf_probe_scores(
    q: Tensor,  # [B, d] f32
    start_rows: Tensor,  # [B, nprobe] int32, CSR start row of each probed list
    live_rows: Tensor,  # [B, nprobe] int32, live length of each probed list
    vecs: Tensor,  # [N_pad, d] f32/bf16, N_pad % BLK == 0
    sqnorms: Tensor,  # [N_pad] f32
    *,
    nprobe: int,
    probe_cap: int,  # per-list slot budget, multiple of BLK, ≥ every live length
    metric: Metric = Metric.L2,
) -> Tensor:
    """K4 → [B, nprobe·probe_cap] f32, +inf in dead slots. Slot p maps to
    CSR row start_rows[b, p // probe_cap] + p % probe_cap. CUDA tensors
    launch the kernel (or raise); CPU tensors take ivf_probe_scores_ref."""
    _check_inputs(q, start_rows, live_rows, vecs, sqnorms, nprobe, probe_cap, metric)
    if vecs.device.type == "cpu":
        return ivf_probe_scores_ref(q, start_rows, live_rows, vecs, sqnorms,
                                    nprobe=nprobe, probe_cap=probe_cap, metric=metric)
    return _launch_scores(q, start_rows, live_rows, vecs, sqnorms, probe_cap, metric, False)


def ivf_probe_scores_rankmajor(
    q: Tensor, start_rows: Tensor, live_rows: Tensor, vecs: Tensor, sqnorms: Tensor,
    *, nprobe: int, probe_cap: int, metric: Metric = Metric.L2,
) -> Tensor:
    """K5 → K4's output, where a non-finite sqnorm (the deny sentinel) also
    gives +inf for IP and cosine. CUDA tensors launch the kernel (or raise);
    CPU tensors take ivf_probe_scores_rankmajor_ref."""
    _check_inputs(q, start_rows, live_rows, vecs, sqnorms, nprobe, probe_cap, metric)
    if vecs.device.type == "cpu":
        return ivf_probe_scores_rankmajor_ref(q, start_rows, live_rows, vecs, sqnorms,
                                              nprobe=nprobe, probe_cap=probe_cap, metric=metric)
    return _launch_scores(q, start_rows, live_rows, vecs, sqnorms, probe_cap, metric, True)


def ivf_probe_scores_v1(
    q: Tensor, start_rows: Tensor, live_rows: Tensor, vecs: Tensor, sqnorms: Tensor,
    *, nprobe: int, probe_cap: int, metric: Metric = Metric.L2, deny_sentinel: bool = False,
) -> Tensor:
    """K4 (K5 with deny_sentinel) in its first design, one CTA per (pair,
    1024-row chunk), each thread loading its own row: for timing in turns
    with the list-major kernel. CUDA tensors only."""
    _check_inputs(q, start_rows, live_rows, vecs, sqnorms, nprobe, probe_cap, metric)
    if vecs.device.type == "cpu":
        raise ValueError("ivf_probe_scores_v1 times a CUDA kernel: pass CUDA tensors")
    from vectorindex_tpu_torch.kernels import _build

    b = q.shape[0]
    out = torch.empty((b, nprobe * probe_cap), dtype=torch.float32, device=vecs.device)
    if b == 0 or nprobe == 0:
        return out
    qr, qterm = _query_terms(q, vecs.dtype, metric)
    lib = _build.load()
    err = lib.vi_ivf_probe_scores_v1(
        qr.data_ptr(), qterm.data_ptr(), start_rows.data_ptr(), live_rows.data_ptr(),
        vecs.data_ptr(), sqnorms.data_ptr(), b, nprobe, q.shape[1], probe_cap,
        _DTYPE_CODE[vecs.dtype], _METRIC_CODE[metric], int(deny_sentinel),
        out.data_ptr(), _stream(vecs),
    )
    _build.check(lib, err, "ivf_probe_scores_v1")
    LAUNCHES["ivf_probe_scores_v1"] += 1
    return out


def _topc_chunk_rows(probe_cap: int, pairs: int) -> int:
    """Rows one K3 CTA covers: a multiple of BLK, at least TOPC_CHUNK_MIN
    (or probe_cap), as few as keep the grid (pairs × chunks) at about
    TOPC_GRID CTAs or fewer."""
    chunks = max(1, min(probe_cap // TOPC_CHUNK_MIN, TOPC_GRID // max(pairs, 1)))
    return -(-probe_cap // chunks // BLK) * BLK


def _topc_chunk_rows_v1(probe_cap: int) -> int:
    """Rows one first-design K3 scan CTA covers: ≥ TOPC_V1_CHUNK_MIN, and at
    most TOPC_V1_MAX_CHUNKS chunks per (query, probe)."""
    per = -(-probe_cap // TOPC_V1_MAX_CHUNKS)
    return max(TOPC_V1_CHUNK_MIN, -(-per // BLK) * BLK)


#: K3's per-query arrival counters, one workspace per device; the folding
#: CTA of each query resets its counter, so they are all 0 between launches
#: (K3 launches that overlap on two streams of one device would share them)
_ARRIVALS: dict = {}


def _arrivals(dev: torch.device, n: int) -> Tensor:
    ws = _ARRIVALS.get(dev)
    if ws is None or ws.numel() < n:
        ws = torch.zeros(max(n, 64), dtype=torch.int32, device=dev)
        _ARRIVALS[dev] = ws
    return ws


def _empty_topc(b: int, dev) -> Tuple[Tensor, Tensor, Tensor]:
    return (torch.full((b, TIERS * CBINS), INVALID_DIST, device=dev),
            torch.zeros((b, TIERS * CBINS), dtype=torch.int32, device=dev),
            torch.full((b, CBINS), INVALID_DIST, device=dev))


def ivf_probe_topc_rankmajor(
    q: Tensor, start_rows: Tensor, live_rows: Tensor, vecs: Tensor, sqnorms: Tensor,
    *, nprobe: int, probe_cap: int, metric: Metric = Metric.L2,
) -> Tuple[Tensor, Tensor, Tensor]:
    """K3 → (cand_dist [B, 3·CBINS] f32, cand_rows [B, 3·CBINS] int32 CSR
    rows, drop_min [B, CBINS] f32). Selection is provably complete for a
    query iff min(drop_min) > its k-th candidate distance. CUDA tensors
    launch the kernel (one launch, or raise); CPU tensors take
    ivf_probe_topc_rankmajor_ref."""
    _check_inputs(q, start_rows, live_rows, vecs, sqnorms, nprobe, probe_cap, metric)
    if vecs.device.type == "cpu":
        return ivf_probe_topc_rankmajor_ref(q, start_rows, live_rows, vecs, sqnorms,
                                            nprobe=nprobe, probe_cap=probe_cap, metric=metric)
    return _launch_topc(q, start_rows, live_rows, vecs, sqnorms, nprobe, probe_cap, metric)


def _launch_topc(q, start_rows, live_rows, vecs, sqnorms, nprobe, probe_cap, metric,
                 chunk_rows=None):
    from vectorindex_tpu_torch.kernels import _build

    b = q.shape[0]
    dev = vecs.device
    if b == 0 or nprobe == 0:
        return _empty_topc(b, dev)
    # the merging CTAs write every element of the outputs
    cand_d = torch.empty((b, TIERS * CBINS), dtype=torch.float32, device=dev)
    cand_r = torch.empty((b, TIERS * CBINS), dtype=torch.int32, device=dev)
    drop = torch.empty((b, CBINS), dtype=torch.float32, device=dev)
    chunk = chunk_rows or _topc_chunk_rows(probe_cap, b * nprobe)
    nchunks = -(-probe_cap // chunk)
    # per (query, probe, chunk) top-4 of each class; only live chunks are
    # written and read
    part_d = torch.empty((b * nprobe * nchunks, TIERS + 1, CBINS), dtype=torch.float32, device=dev)
    part_r = torch.empty((b * nprobe * nchunks, TIERS + 1, CBINS), dtype=torch.int32, device=dev)
    qr, qterm = _query_terms(q, vecs.dtype, metric)
    lib = _build.load()
    err = lib.vi_ivf_probe_topc(
        qr.data_ptr(), qterm.data_ptr(), start_rows.data_ptr(), live_rows.data_ptr(),
        vecs.data_ptr(), sqnorms.data_ptr(), b, nprobe, q.shape[1], chunk, nchunks,
        _DTYPE_CODE[vecs.dtype], _METRIC_CODE[metric], part_d.data_ptr(), part_r.data_ptr(),
        _arrivals(dev, b).data_ptr(), cand_d.data_ptr(), cand_r.data_ptr(), drop.data_ptr(),
        _stream(vecs),
    )
    _build.check(lib, err, "ivf_probe_topc")
    LAUNCHES["ivf_probe_topc"] += 1
    return cand_d, cand_r, drop


def ivf_probe_topc_v1(
    q: Tensor, start_rows: Tensor, live_rows: Tensor, vecs: Tensor, sqnorms: Tensor,
    *, nprobe: int, probe_cap: int, metric: Metric = Metric.L2,
) -> Tuple[Tensor, Tensor, Tensor]:
    """K3 in its first design (a scan launch over (pair, chunk) and a merge
    launch), for timing in turns with the one-launch kernel. CUDA tensors
    only."""
    _check_inputs(q, start_rows, live_rows, vecs, sqnorms, nprobe, probe_cap, metric)
    if vecs.device.type == "cpu":
        raise ValueError("ivf_probe_topc_v1 times a CUDA kernel: pass CUDA tensors")
    from vectorindex_tpu_torch.kernels import _build

    b = q.shape[0]
    dev = vecs.device
    if b == 0 or nprobe == 0:
        return _empty_topc(b, dev)
    cand_d = torch.empty((b, TIERS * CBINS), dtype=torch.float32, device=dev)
    cand_r = torch.empty((b, TIERS * CBINS), dtype=torch.int32, device=dev)
    drop = torch.empty((b, CBINS), dtype=torch.float32, device=dev)
    chunk = _topc_chunk_rows_v1(probe_cap)
    nchunks = -(-probe_cap // chunk)
    part_d = torch.empty((b * nprobe * nchunks, TIERS + 1, CBINS), dtype=torch.float32, device=dev)
    part_r = torch.empty((b * nprobe * nchunks, TIERS + 1, CBINS), dtype=torch.int32, device=dev)
    qr, qterm = _query_terms(q, vecs.dtype, metric)
    lib = _build.load()
    err = lib.vi_ivf_probe_topc_v1(
        qr.data_ptr(), qterm.data_ptr(), start_rows.data_ptr(), live_rows.data_ptr(),
        vecs.data_ptr(), sqnorms.data_ptr(), b, nprobe, q.shape[1], chunk, nchunks,
        _DTYPE_CODE[vecs.dtype], _METRIC_CODE[metric], part_d.data_ptr(), part_r.data_ptr(),
        cand_d.data_ptr(), cand_r.data_ptr(), drop.data_ptr(), _stream(vecs),
    )
    _build.check(lib, err, "ivf_probe_topc_v1")
    LAUNCHES["ivf_probe_topc_v1"] += 1
    return cand_d, cand_r, drop


# ---------------------------------------------------------------------------
# the probed search
# ---------------------------------------------------------------------------


def _exact_rerank(q: Tensor, src: Tensor, rows: Tensor, metric: Metric) -> Tensor:
    """f32 distances of q [B, d] to src[rows] [B, c, d] (src in CSR row
    order), at full f32."""
    xg = src[rows].float()
    g = _gram_rows(q, xg)
    if metric == Metric.L2:
        qn = (q * q).sum(dim=-1)
        return torch.clamp_min(qn[:, None] + (xg * xg).sum(dim=-1) - 2.0 * g, 0.0)
    if metric == Metric.INNER_PRODUCT:
        return -g
    qn = torch.sqrt(torch.clamp_min((q * q).sum(dim=-1), 1e-30))
    xn = torch.sqrt(torch.clamp_min((xg * xg).sum(dim=-1), 1e-30))
    return 1.0 - g / (qn[:, None] * xn)


def ivf_search_flat_probe(
    q: Tensor,
    centroids: Tensor,
    arrays,  # ops.ivf.IVFListArrays
    rerank_vecs: Optional[Tensor] = None,  # f32 rerank source in CSR row order
    row_allow: Optional[Tensor] = None,  # [N_pad] bool allow mask, CSR row order
    disabled_lists: Optional[Tensor] = None,  # [kc] bool
    *,
    nprobe: int,
    probe_cap: int,
    k: int,
    metric: Metric = Metric.L2,
    exact_rerank: bool = True,
) -> Tuple[Tensor, Tensor]:
    """IVF-Flat probed search through K3/K4/K5 → (dist [B, k], internal
    ids [B, k] int32), the counterpart of the JAX package's
    `ivf_search_flat_pallas` (kernels/ivf_probe.py:224). Same result
    contract as ops.ivf.ivf_search_flat: exact within the probed lists,
    strict (score, id) order.

    Routes: B ≤ 16 and k ≤ 2·CBINS take K3; the allow mask is folded into
    the sqnorms as the +inf deny sentinel; if any query fails K3's
    completeness proof the whole batch re-runs through the pair path (K4
    with the mask applied to its [B, nprobe·probe_cap] output). B ≤ 16 with
    larger k takes K5 with the folded sentinel, B > 16 takes K4. Then an f32
    rerank of the c = max(4·kk, 128) best candidates (from rerank_vecs when
    the scan storage is bf16)."""
    b = q.shape[0]
    q = q.float()
    # ivf_select clamps nprobe to nlist; the kernels' tables must agree
    nprobe = min(nprobe, centroids.shape[0])
    sel_d, probe_lists = ivf_select(
        q, centroids, nprobe=nprobe, metric=metric, disabled=disabled_lists
    )
    probe_lists = probe_lists.long()
    vecs, sqn = arrays.vecs, arrays.sqnorms
    pad = (-vecs.shape[0]) % BLK
    if pad:  # only a store that skipped the packer: pad to the CSR layout
        pad += GUARD_BLOCKS * BLK
        vecs = torch.cat([vecs, vecs.new_zeros((pad, vecs.shape[1]))])
        sqn = torch.cat([sqn, sqn.new_zeros(pad)])
    start_rows = arrays.starts[probe_lists].to(torch.int32).contiguous()
    live_rows = arrays.lengths[probe_lists].to(torch.int32)
    if disabled_lists is not None:
        # a disabled list is still selected when nprobe spans every list
        # (its +inf routing distance only ranks it last): read none of it
        live_rows = torch.where(torch.isfinite(sel_d), live_rows, 0)
    live_rows = live_rows.contiguous()
    p_total = nprobe * probe_cap
    n_rows = arrays.row_ids.shape[0]
    args = dict(nprobe=nprobe, probe_cap=probe_cap, metric=metric)

    def sqn_deny() -> Tensor:
        """sqnorms with denied rows at +inf (the deny sentinel)."""
        if row_allow is None:
            return sqn
        allow = row_allow
        if allow.shape[0] < sqn.shape[0]:  # degenerate-store padding
            allow = torch.cat([allow, allow.new_zeros(sqn.shape[0] - allow.shape[0])])
        return torch.where(allow, sqn, INVALID_DIST).contiguous()

    def select(dist: Tensor, c: int) -> Tuple[Tensor, Tensor]:
        """Position top-c of [B, nprobe·probe_cap] (lowest-position ties)
        → (distances, CSR rows)."""
        cdp, cpp = topk(dist, c, strict_ties=False)
        cpp = cpp.long()
        rws = torch.gather(start_rows.long(), 1, cpp // probe_cap) + cpp % probe_cap
        return cdp, torch.clamp(rws, 0, n_rows - 1)

    def pair_path(c: int) -> Tuple[Tensor, Tensor]:
        """K4 over every probed slot, the allow mask applied to its output
        before selection (always complete)."""
        dist = ivf_probe_scores(q, start_rows, live_rows, vecs, sqn, **args)
        if row_allow is not None:
            # slot (p, o) is CSR row start_rows[b, p] + o; a dead slot
            # clipped onto a row is already +inf
            slot_rows = torch.clamp(
                start_rows.long()[:, :, None] + torch.arange(probe_cap, device=q.device),
                0, row_allow.shape[0] - 1,
            )
            dist = torch.where(row_allow[slot_rows].reshape(b, -1), dist, INVALID_DIST)
        return select(dist, c)

    serving = rank_major_fits(b, probe_cap, vecs.shape[1], vecs.element_size())
    if serving and k <= 2 * CBINS:
        cand_d, cand_rows, drop_min = ivf_probe_topc_rankmajor(
            q, start_rows, live_rows, vecs, sqn_deny(), **args
        )
        c_total = min(cand_d.shape[1], p_total)
        kk = min(k, c_total)
        c = min(max(4 * kk, 128), c_total)
        cd, rows = topk(cand_d, c, ids=cand_rows, strict_ties=False)
        rows = torch.clamp(rows.long(), 0, n_rows - 1)
        # exactness proof: no dropped value may reach the kk-th candidate
        # distance (== tau would still break the strict tie contract)
        tau = cd[:, kk - 1]
        dmin = drop_min.min(dim=1).values
        complete = torch.where(torch.isfinite(tau), dmin > tau, ~torch.isfinite(dmin))
        if not bool(complete.all()):
            cd, rows = pair_path(c)
    else:
        kk = min(k, p_total)
        c = min(max(4 * kk, 128), p_total)
        if serving:
            # serving batch with k beyond K3's candidates: K5, with the
            # allow mask riding the sqnorms as the deny sentinel
            dist = ivf_probe_scores_rankmajor(q, start_rows, live_rows, vecs, sqn_deny(), **args)
            cd, rows = select(dist, c)
        else:
            cd, rows = pair_path(c)
    missing = ~torch.isfinite(cd)
    iids = torch.where(missing, INVALID_ID, arrays.row_ids[rows])
    if exact_rerank:
        src = vecs if rerank_vecs is None else rerank_vecs
        ex = _exact_rerank(q, src, torch.where(missing, 0, rows), metric)
        cd = torch.where(missing, INVALID_DIST, ex)
    sd, si = topk(cd, kk, ids=iids, strict_ties=True)
    if metric == Metric.L2:
        sd = torch.where(torch.isfinite(sd), torch.clamp_min(sd, 0.0), sd)
    if kk < k:  # degenerate: fewer candidate slots than k
        sd = torch.cat([sd, sd.new_full((b, k - kk), INVALID_DIST)], dim=1)
        si = torch.cat([si, si.new_full((b, k - kk), INVALID_ID)], dim=1)
    return sd, si
