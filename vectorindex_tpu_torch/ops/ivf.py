"""IVF ops: coarse centroid selection, CSR list storage, probed search.

Counterpart of vectorindex_tpu.ops.ivf (parity targets: the reference's
IVFSelect.swift:78, IVFAppend.swift:220-712, ExactRerank.swift:655).

  - `ivf_select`: one f32 distance block against the centroids + strict
    top-nprobe.
  - `IVFListStore`: host-managed CSR lists. Rows are sorted by list; each
    list reserves a power-of-two capacity ≥ RESERVE_MIN (256) rows starting
    at a multiple of 256, and GUARD_BLOCKS·256 dead rows trail the last
    list — the JAX package's row layout, so a CSR row means the same in both
    packages. Only its 128-lane padding of d is left out. Appends within a
    list's capacity patch the host mirror in place and, at the next sync,
    the device tensors in place with `index_copy_`.
  - `ivf_search_flat`: the gather path (select → gather probed rows →
    score → strict top-k). It is the plain reference for the probed search
    of kernels/ivf_probe.ivf_search_flat_probe.
  - `spill_assign`: boundary multi-assignment for IVF-PQ, on a stable
    top-2 (`nearest_two`).
  - `build_centroid_graph` and `ivf_select_beam`: beam-search selection
    over a kNN graph of the centroids (reference ivf_select_beam_f32,
    IVFSelect.swift:166), for very many lists.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from vectorindex_tpu_torch.ops import scoring
from vectorindex_tpu_torch.ops.topk import INVALID_DIST, INVALID_ID, topk, topk_padded
from vectorindex_tpu_torch.utils.config import Metric

Tensor = torch.Tensor

RESERVE_FACTOR = 2.0  # reference IVFAppendOpts.reserve_factor
RESERVE_MIN = 256  # reference IVFAppendOpts.reserve_min


# ---------------------------------------------------------------------------
# #29 — coarse selection
# ---------------------------------------------------------------------------


def ivf_select(
    q: Tensor,
    centroids: Tensor,
    *,
    nprobe: int,
    metric: Metric = Metric.L2,
    centroid_sqnorms: Optional[Tensor] = None,
    centroid_invnorms: Optional[Tensor] = None,
    disabled: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Top-nprobe centroids per query → (dist [B, nprobe], list ids
    [B, nprobe] int32), ties by lowest list id. `disabled` [kc] bool lists
    get +inf (reference IVFSelectOpts.disabledLists)."""
    norms = scoring.NormCache(sq=centroid_sqnorms, inv=centroid_invnorms)
    dist = scoring.distance_block(q.float(), centroids, metric, norms=norms)
    if disabled is not None:
        dist = torch.where(disabled[None, :], INVALID_DIST, dist)
    return topk(dist, min(nprobe, centroids.shape[0]), strict_ties=True)


def nearest_two(x: Tensor, centroids: Tensor) -> Tuple[Tensor, Tensor]:
    """The two nearest centroids of each row by squared L2 → (d [n, 2],
    ids [n, 2] int64), the lower index first on ties (jax.lax.top_k's order):
    a first-index argmin, then another with that column masked out."""
    d = scoring.l2sqr_block(x.float(), centroids.float())
    d1, i1 = torch.min(d, dim=1)
    d.scatter_(1, i1[:, None], INVALID_DIST)
    d2, i2 = torch.min(d, dim=1)
    return torch.stack([d1, d2], dim=1), torch.stack([i1, i2], dim=1)


def spill_assign(
    x,
    centroids,
    *,
    eps: float = 0.2,
    chunk: int = 131072,
    max_spill: int = 2,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Boundary multi-assignment ("list spill"): rows whose second-nearest
    centroid is nearly as close as their first are placed in BOTH lists.

    Returns (src [n_exp] int32, assign [n_exp] int32, spill_frac): row j of
    the expanded corpus is x[src[j]] assigned to list assign[j]; the first n
    entries are the primary assignment in corpus order, spilled copies
    follow. A row spills when d2 <= (1+eps)·d1 (squared L2). Search paths
    must dedup candidate ids (spilled copies share their internal id).
    x and centroids are numpy arrays or tensors; the top-2 runs on the
    centroids' device (a numpy array: the CPU) in row chunks."""
    if max_spill != 2:
        raise ValueError("only primary + one spill copy is supported")
    cent = torch.as_tensor(centroids, dtype=torch.float32)
    n = x.shape[0]
    a = np.empty((n, 2), np.int32)
    dd = np.empty((n, 2), np.float32)
    for s in range(0, n, chunk):
        xc = torch.as_tensor(x[s : s + chunk], dtype=torch.float32).to(cent.device)
        d, i = nearest_two(xc, cent)
        dd[s : s + chunk] = d.cpu().numpy()
        a[s : s + chunk] = i.cpu().numpy()
    spill = dd[:, 1] <= (1.0 + eps) * np.maximum(dd[:, 0], 1e-30)
    idx = np.flatnonzero(spill).astype(np.int32)
    src = np.concatenate([np.arange(n, dtype=np.int32), idx])
    assign = np.concatenate([a[:, 0], a[idx, 1]])
    return src, assign, float(idx.size) / max(n, 1)


# ---------------------------------------------------------------------------
# #30 — CSR list storage (host control plane / device data plane)
# ---------------------------------------------------------------------------


class IVFListArrays(NamedTuple):
    """Device-side view of the CSR list storage."""

    vecs: Optional[Tensor]  # [N_pad, d] sorted by list, storage dtype
    row_ids: Tensor  # [N_pad] int32 internal id per row (-1 for dead rows)
    sqnorms: Optional[Tensor]  # [N_pad] f32
    starts: Tensor  # [kc] int32 list start rows
    lengths: Tensor  # [kc] int32 live lengths
    timestamps: Optional[Tensor] = None  # [N_pad] int64, when enabled


class IVFListStore:
    """Host-managed per-list growable storage (reference IVFListHandle,
    IVFAppend.swift:220). Appending within a list's reserved capacity is
    O(1); overflow marks the store for a repack of the flat arrays at the
    next sync (the reference grows one list with a copy, :633-712)."""

    def __init__(self, n_lists: int, dim: int, timestamps: bool = False, device="cuda"):
        self.n_lists = n_lists
        self.dim = dim
        self.timestamps = timestamps  # reference IVFAppendOpts.timestamps
        self.device = torch.device(device)
        self.version = 0  # bumped on every mutation (cache invalidation key)
        # bumped only when packed rows MOVE (repack); in-place appends keep
        # the layout so device tensors are patched instead of rebuilt
        self.layout_version = 0
        self._lists_ids: list[list[int]] = [[] for _ in range(n_lists)]
        self._lists_vecs: list[list[np.ndarray]] = [[] for _ in range(n_lists)]
        self._lists_ts: list[list[int]] = [[] for _ in range(n_lists)]
        self._caps = np.zeros(n_lists, dtype=np.int64)
        self._dirty = True  # needs repack
        self._packed = None  # host CSR mirror
        self._dev: Optional[IVFListArrays] = None
        # in-place appends since the last repack: (version, packed_row, list)
        self._patch_log: list[tuple[int, int, int]] = []
        # packed rows not yet patched into the device tensors
        self._dev_pending: list[int] = []
        # CSR metadata without vecs/sqnorms (the IVF-PQ host-rerank tier's
        # view); its own pending list, since the two views sync separately
        self._dev_meta: Optional[IVFListArrays] = None
        self._dev_meta_pending: list[int] = []

    # -- mutation --

    def append(self, list_id: int, internal_id: int, vec: np.ndarray, ts: int = 0) -> None:
        self.version += 1
        self._lists_ids[list_id].append(internal_id)
        self._lists_vecs[list_id].append(np.asarray(vec, dtype=np.float32))
        if self.timestamps:
            self._lists_ts[list_id].append(int(ts))
        if len(self._lists_ids[list_id]) > self._caps[list_id]:
            self._dirty = True  # overflow → repack on next sync
        elif self._packed is not None and not self._dirty:
            # in place into the packed mirror; the device tensors are
            # patched at the next sync
            p = self._packed
            row = int(p["starts"][list_id] + p["lengths"][list_id])
            v = self._lists_vecs[list_id][-1]
            p["vecs"][row] = v
            p["row_ids"][row] = internal_id
            p["sqnorms"][row] = float(np.dot(v, v))
            p["lengths"][list_id] += 1
            if self.timestamps:
                p["timestamps"][row] = int(ts)
            self._patch_log.append((self.version, row, list_id))
            self._dev_pending.append(row)
            self._dev_meta_pending.append(row)

    def append_batch(self, list_ids, internal_ids, vecs, ts=None) -> None:
        self.version += 1
        vecs = np.asarray(vecs, dtype=np.float32)
        ts_arr = None if ts is None else np.asarray(ts)
        for n_, (l, i, v) in enumerate(zip(np.asarray(list_ids), np.asarray(internal_ids), vecs)):
            self._lists_ids[int(l)].append(int(i))
            self._lists_vecs[int(l)].append(v)
            if self.timestamps:
                self._lists_ts[int(l)].append(0 if ts_arr is None else int(ts_arr[n_]))
        self._dirty = True

    def remove(self, list_id: int, internal_id: int) -> bool:
        try:
            pos = self._lists_ids[list_id].index(internal_id)
        except ValueError:
            return False
        self.version += 1
        self._lists_ids[list_id].pop(pos)
        self._lists_vecs[list_id].pop(pos)
        if self.timestamps and pos < len(self._lists_ts[list_id]):
            self._lists_ts[list_id].pop(pos)
        self._dirty = True
        return True

    def clear(self) -> None:
        self.version += 1
        self._lists_ids = [[] for _ in range(self.n_lists)]
        self._lists_vecs = [[] for _ in range(self.n_lists)]
        self._lists_ts = [[] for _ in range(self.n_lists)]
        self._caps[:] = 0
        self._dirty = True
        self._dev = None
        self._dev_meta = None

    # -- packing --

    @staticmethod
    def _cap_for(n: int) -> int:
        want = max(int(n * RESERVE_FACTOR), RESERVE_MIN)
        return 1 << (want - 1).bit_length()

    def _repack(self) -> None:
        from vectorindex_tpu_torch.kernels.ivf_probe import BLK, GUARD_BLOCKS

        lengths = np.array([len(l) for l in self._lists_ids], dtype=np.int32)
        self._caps = np.array([self._cap_for(int(n)) for n in lengths], dtype=np.int64)
        starts = np.zeros(self.n_lists, dtype=np.int32)
        starts[1:] = np.cumsum(self._caps)[:-1]
        # trailing guard blocks: the JAX package's row layout (its DMAs run
        # up to GUARD_BLOCKS blocks past a list start); kept so CSR rows
        # mean the same in both packages
        total = int(self._caps.sum()) + GUARD_BLOCKS * BLK
        vecs = np.zeros((total, self.dim), dtype=np.float32)
        row_ids = np.full(total, -1, dtype=np.int32)
        tsarr = np.zeros(total, dtype=np.int64) if self.timestamps else None
        for i in range(self.n_lists):
            n = int(lengths[i])
            if n:
                s = int(starts[i])
                vecs[s : s + n] = np.stack(self._lists_vecs[i])
                row_ids[s : s + n] = self._lists_ids[i]
                if tsarr is not None:
                    tsarr[s : s + n] = self._lists_ts[i]
        sqnorms = np.einsum("nd,nd->n", vecs, vecs, dtype=np.float32)
        self._packed = {
            "vecs": vecs,
            "row_ids": row_ids,
            "sqnorms": sqnorms,
            "starts": starts,
            "lengths": lengths,
            "timestamps": tsarr,
        }
        self._dirty = False
        self._dev = None
        self.layout_version += 1  # rows moved — downstream caches rebuild
        self._patch_log.clear()
        self._dev_pending.clear()
        self._dev_meta = None
        self._dev_meta_pending.clear()

    def _upload(self, a: Optional[np.ndarray], dtype=None) -> Optional[Tensor]:
        if a is None:
            return None
        # copy=True: on the CPU a tensor must not alias the host mirror
        return torch.from_numpy(a).to(self.device, dtype, copy=True)

    def _patch(self, view: IVFListArrays, pending: list[int], names, dtype) -> IVFListArrays:
        """Copy the pending packed rows of each named array into the device
        tensors in place (index_copy_), then refresh the lengths."""
        rows_np = np.asarray(sorted(set(pending)), dtype=np.int64)
        pending.clear()
        rows = torch.from_numpy(rows_np).to(self.device)
        for name in names:
            dst = getattr(view, name)
            if dst is not None:
                src = self._packed[name][rows_np]
                dst.index_copy_(0, rows, self._upload(src, dtype if name == "vecs" else None))
        return view._replace(lengths=self._upload(self._packed["lengths"]))

    def packed(self) -> dict:
        """The host packed mirror (CSR arrays by name), repacked first if a
        change left it stale. Uploads nothing."""
        if self._dirty or self._packed is None:
            self._repack()
        return self._packed

    def sync_device(self, storage_dtype=torch.float32, with_vecs: bool = True) -> IVFListArrays:
        """Device view of the packed lists. After in-place appends the
        existing tensors are patched in place with index_copy_ (one call per
        array for all pending rows) instead of re-uploaded."""
        p = self.packed()
        if not with_vecs:
            if self._dev_meta is None:
                self._dev_meta = IVFListArrays(
                    vecs=None,
                    row_ids=self._upload(p["row_ids"]),
                    sqnorms=None,
                    starts=self._upload(p["starts"]),
                    lengths=self._upload(p["lengths"]),
                    timestamps=self._upload(p["timestamps"]),
                )
                self._dev_meta_pending.clear()
            elif self._dev_meta_pending:
                self._dev_meta = self._patch(
                    self._dev_meta, self._dev_meta_pending, ("row_ids", "timestamps"), None
                )
            return self._dev_meta
        if self._dev is not None and self._dev.vecs.dtype != storage_dtype:
            self._dev = None  # dtype switch — full re-upload
        if self._dev is None:
            self._dev = IVFListArrays(
                vecs=self._upload(p["vecs"], storage_dtype),
                row_ids=self._upload(p["row_ids"]),
                sqnorms=self._upload(p["sqnorms"]),
                starts=self._upload(p["starts"]),
                lengths=self._upload(p["lengths"]),
                timestamps=self._upload(p["timestamps"]),
            )
            self._dev_pending.clear()
        elif self._dev_pending:
            self._dev = self._patch(
                self._dev, self._dev_pending,
                ("vecs", "row_ids", "sqnorms", "timestamps"), storage_dtype,
            )
        return self._dev

    @property
    def max_length(self) -> int:
        return max((len(l) for l in self._lists_ids), default=0)

    def list_stats(self) -> dict:
        """Reference getListStats (IVFAppend.swift:317)."""
        lengths = np.array([len(l) for l in self._lists_ids])
        return {
            "n_lists": self.n_lists,
            "total": int(lengths.sum()),
            "max_len": int(lengths.max()) if len(lengths) else 0,
            "min_len": int(lengths.min()) if len(lengths) else 0,
            "mean_len": float(lengths.mean()) if len(lengths) else 0.0,
            "empty_lists": int((lengths == 0).sum()),
            "reserved_rows": int(self._caps.sum()),
        }

    def read_list(self, list_id: int) -> Tuple[np.ndarray, np.ndarray]:
        """Host view of one list (reference readList, IVFAppend.swift:366)."""
        ids = np.asarray(self._lists_ids[list_id], dtype=np.int32)
        vecs = (
            np.stack(self._lists_vecs[list_id])
            if self._lists_ids[list_id]
            else np.zeros((0, self.dim), np.float32)
        )
        return ids, vecs


# ---------------------------------------------------------------------------
# #29 variant — beam selection over a centroid kNN graph
# ---------------------------------------------------------------------------


def build_centroid_graph(centroids: Tensor, degree: int = 16) -> Tensor:
    """kNN graph over the centroids → [kc, min(degree, kc − 1)] int32
    neighbour ids, nearest first by (L2², id), self excluded (the routing
    structure of ivf_select_beam)."""
    d2 = scoring.l2sqr_block(centroids, centroids)
    d2.fill_diagonal_(INVALID_DIST)
    _, nbrs = topk(d2, min(degree, centroids.shape[0] - 1), strict_ties=True)
    return nbrs


def _dist_rows(q: Tensor, rows: Tensor, vecs: Tensor, sqn: Tensor) -> Tensor:
    """L2²(q_b, vecs[rows[b, j]]) → [B, W]; rows < 0 read row 0 (the caller
    masks them)."""
    safe = rows.clamp_min(0).long()
    g = _gram_rows(q, vecs[safe])
    return torch.clamp_min((q.float() ** 2).sum(dim=-1)[:, None] + sqn[safe] - 2.0 * g, 0.0)


def _graph_beam(q, vecs, sqn, nbrs, entry, *, ef: int, iters: int) -> Tuple[Tensor, Tensor]:
    """Batched bounded best-first search over a fixed-degree graph (the JAX
    package's ops/graph.beam_search with one expansion an iteration;
    reference efSearch_core, HNSWTraversal.swift:221-280) → (L2² [B, ef]
    ascending, ids [B, ef], INVALID_ID padded). Each iteration expands the
    best unexpanded beam slot, scores its neighbours not yet visited, in the
    beam or repeated, and keeps the top-ef of beam ∪ neighbours by
    (distance, id)."""
    b, m = q.shape[0], nbrs.shape[1]
    dev = q.device
    beam_d = torch.full((b, ef), INVALID_DIST, device=dev)
    beam_i = torch.full((b, ef), INVALID_ID, dtype=torch.int32, device=dev)
    beam_x = torch.zeros((b, ef), dtype=torch.int32, device=dev)  # expanded flags
    beam_d[:, 0] = _dist_rows(q, entry[:, None], vecs, sqn)[:, 0]
    beam_i[:, 0] = entry
    visited = torch.full((b, iters), INVALID_ID, dtype=torch.int32, device=dev)
    earlier = torch.ones((m, m), dtype=torch.bool, device=dev).tril(-1)
    for t in range(iters):
        unexp = (beam_x == 0) & (beam_i != INVALID_ID)
        slot = torch.argsort((~unexp).to(torch.int8), dim=1, stable=True)[:, :1]
        has = unexp.any(dim=1, keepdim=True)
        cur = torch.where(has, torch.gather(beam_i, 1, slot), 0)
        beam_x.scatter_(1, slot, torch.where(has, 1, torch.gather(beam_x, 1, slot)))
        visited[:, t] = torch.where(has, cur, INVALID_ID)[:, 0]
        nb = nbrs[cur[:, 0].long()]  # [B, M]
        valid = (nb >= 0) & has
        valid &= ~(nb[:, :, None] == visited[:, None, :]).any(dim=-1)
        valid &= ~(nb[:, :, None] == beam_i[:, None, :]).any(dim=-1)
        valid &= ~((nb[:, :, None] == nb[:, None, :]) & earlier).any(dim=-1)
        nd = torch.where(valid, _dist_rows(q, nb, vecs, sqn), INVALID_DIST)
        all_i = torch.cat([beam_i, torch.where(valid, nb, INVALID_ID)], dim=1)
        all_d = torch.cat([beam_d, nd], dim=1)
        all_x = torch.cat([beam_x, torch.zeros_like(nb)], dim=1)
        # two-key (distance, id) order: by id, then stably by distance
        order = torch.argsort(all_i, dim=1, stable=True)
        order = torch.gather(order, 1, torch.argsort(torch.gather(all_d, 1, order), dim=1,
                                                     stable=True))[:, :ef]
        beam_d, beam_i, beam_x = (torch.gather(a, 1, order) for a in (all_d, all_i, all_x))
    return beam_d, beam_i


def ivf_select_beam(
    q: Tensor,
    centroids: Tensor,
    centroid_graph: Tensor,  # [kc, degree] from build_centroid_graph
    *,
    nprobe: int,
    beam_width: int = 32,
    iters: int = 4,
    metric: Metric = Metric.L2,
) -> Tuple[Tensor, Tensor]:
    """Beam-search centroid selection (reference ivf_select_beam_f32,
    IVFSelect.swift:166) → (L2² [B, nprobe], list ids [B, nprobe] int32):
    instead of scoring all kc centroids, walk the centroid graph from the
    best of a strided sample of 4·beam_width seeds (scored by `metric`).
    Approaches the exhaustive ivf_select as beam_width·iters·degree
    approaches kc."""
    kc = centroids.shape[0]
    stride = max(kc // (beam_width * 4), 1)
    seeds = torch.arange(0, kc, stride, device=centroids.device)[: beam_width * 4]
    _, best = topk(scoring.distance_block(q, centroids[seeds], metric), 1, strict_ties=True)
    entry = seeds[best[:, 0].long()].to(torch.int32)
    bd, bi = _graph_beam(q.float(), centroids.float(), scoring.squared_norms(centroids),
                         centroid_graph, entry, ef=max(beam_width, nprobe),
                         iters=iters * beam_width)
    return bd[:, :nprobe], bi[:, :nprobe]


# ---------------------------------------------------------------------------
# probed search (#29 + #40 fused): select lists → gather rows → score → topk
# ---------------------------------------------------------------------------


def _gram_rows(q: Tensor, xg: Tensor) -> Tensor:
    """g[b, p] = q[b] · xg[b, p] at full f32 (a batched product; refuses
    TF32, as scoring._gram does)."""
    if q.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "f32 Gram products need torch.backends.cuda.matmul.allow_tf32 = False"
        )
    return torch.bmm(xg.float(), q.float()[:, :, None])[:, :, 0]


def ivf_search_flat(
    q: Tensor,
    centroids: Tensor,
    arrays: IVFListArrays,
    *,
    nprobe: int,
    probe_cap: int,
    k: int,
    metric: Metric = Metric.L2,
    query_chunk: int = 16,
    row_allow: Optional[Tensor] = None,
    disabled_lists: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """IVF-Flat probed search by gathering → (dist [B, k], internal ids
    [B, k] int32), strict (score, id) order. probe_cap ≥ the longest list;
    row_allow [N_pad] bool (CSR row order) is masked in before top-k;
    disabled_lists [kc] bool are never scanned. Queries run in chunks of
    `query_chunk` to bound the [chunk, nprobe·probe_cap, d] gather."""
    q = q.float()
    b = q.shape[0]
    nprobe = min(nprobe, centroids.shape[0])
    sel_d, probe_lists = ivf_select(
        q, centroids, nprobe=nprobe, metric=metric, disabled=disabled_lists
    )
    probe_lists = probe_lists.long()
    lens_all = arrays.lengths[probe_lists]
    if disabled_lists is not None:
        # a disabled list ranks last but is still selected when nprobe
        # spans every list: its rows must not be scanned
        lens_all = torch.where(torch.isfinite(sel_d), lens_all, 0)
    starts_all = arrays.starts[probe_lists].long()
    offs = torch.arange(probe_cap, device=q.device)
    out_d, out_i = [], []
    for s in range(0, b, query_chunk):
        qc = q[s : s + query_chunk]
        c = qc.shape[0]
        valid = offs[None, None, :] < lens_all[s : s + c, :, None]
        rows = torch.where(valid, starts_all[s : s + c, :, None] + offs, 0)
        if row_allow is not None:
            valid = valid & row_allow[rows]
        cand = rows.reshape(c, -1)
        vmask = valid.reshape(c, -1)
        xg = arrays.vecs[cand]  # [C, P, d] storage dtype
        sg = arrays.sqnorms[cand]
        ig = arrays.row_ids[cand]
        # q rounded to the storage dtype, as the JAX package's einsum does
        g = _gram_rows(qc.to(xg.dtype), xg)
        if metric == Metric.L2:
            qn = (qc * qc).sum(dim=1)
            dist = torch.clamp_min(qn[:, None] + sg - 2.0 * g, 0.0)
        elif metric == Metric.INNER_PRODUCT:
            dist = -g
        elif metric == Metric.COSINE:
            qinv = scoring.inv_norms(qc)
            xinv = torch.where(sg > 0, torch.rsqrt(torch.clamp_min(sg, 1e-30)), 0.0)
            dist = 1.0 - g * qinv[:, None] * xinv
        else:
            raise ValueError(f"ivf_search_flat unsupported metric {metric}")
        d, i = topk_padded(dist, vmask, k, ids=ig)
        out_d.append(d)
        out_i.append(i)
    if not out_d:
        return (torch.empty((0, k), device=q.device),
                torch.empty((0, k), dtype=torch.int32, device=q.device))
    return torch.cat(out_d), torch.cat(out_i)


def probe_cap_for(max_len: int) -> int:
    """Bucketed probe capacity (pow2, ≥ RESERVE_MIN)."""
    return 1 << max(max_len - 1, RESERVE_MIN - 1).bit_length()


# ---------------------------------------------------------------------------
# #40 — standalone exact rerank
# ---------------------------------------------------------------------------


def rerank_exact_topk(
    q: Tensor,
    candidates: Tensor,
    vecs: Tensor,
    sqnorms: Tensor,
    *,
    k: int,
    metric: Metric = Metric.L2,
    cand_ids: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Re-score candidate rows [B, C] (INVALID_ID = missing) exactly and
    select top-k in strict (score, id) order (reference rerank_exact_topk,
    ExactRerank.swift:655); missing rows get +inf (:76-78)."""
    missing = candidates == INVALID_ID
    rows = torch.where(missing, 0, candidates).long()
    xg = vecs[rows]  # [B, C, d]
    sg = sqnorms[rows].float()
    g = _gram_rows(q, xg)
    if metric == Metric.L2:
        qn = (q.float() ** 2).sum(dim=-1)
        dist = torch.clamp_min(qn[:, None] + sg - 2.0 * g, 0.0)
    elif metric == Metric.INNER_PRODUCT:
        dist = -g
    elif metric == Metric.COSINE:
        qinv = scoring.inv_norms(q)
        xinv = torch.where(sg > 0, torch.rsqrt(torch.clamp_min(sg, 1e-30)), 0.0)
        dist = 1.0 - g * qinv[:, None] * xinv
    else:
        raise ValueError(f"rerank unsupported metric {metric}")
    ids = candidates if cand_ids is None else cand_ids
    return topk_padded(dist, ~missing, k, ids=ids)
