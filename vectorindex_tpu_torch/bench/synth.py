"""Bulk builders for benchmark-scale index state, and exact truth.

The model classes build storage through per-row host paths (insert_batch),
which is the durability-friendly route but slow for constructing
multi-million-row benchmark corpora. These helpers produce the same device
structures (ops.ivf.IVFListArrays CSR layout; PQ code and correction arrays
in packed row order) with vectorized numpy and torch, so a benchmark can
stand up a 1M-10M index in seconds.

Layout contract matches ops.ivf.IVFListStore._repack and the JAX package's
`bench/synth.pack_ivf`: rows sorted by list, per-list reserved regions
whole multiples of kernels/ivf_probe.BLK rows, GUARD_BLOCKS dead blocks
after the last list, dead rows row_id=-1. The JAX function pads d to 128
lanes for Mosaic; the port stores d columns.

The corpus generators (`clustered_corpus`, `lowdim_corpus`,
`lowdim_queries`) are numpy, copies of the JAX package's: the same seed
gives the same bytes. Training draws its samples from numpy
`default_rng(seed)` as the JAX functions do, and trains with the port's
k-means and PQ on `device` (their generators are the port's
ops/rng.make_generator streams, not JAX's threefry keys). Every function
runs on `device` ("cuda" unless the caller asks for "cpu"); a CUDA device
with no card visible raises.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from vectorindex_tpu_torch.bench.timing import resolve_device
from vectorindex_tpu_torch.kernels.ivf_probe import BLK, GUARD_BLOCKS
from vectorindex_tpu_torch.ops.ivf import IVFListArrays
from vectorindex_tpu_torch.ops.topk import topk


def _host(a) -> np.ndarray:
    """numpy view of an array or a tensor on any device."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rows(x, idx, dev: torch.device) -> torch.Tensor:
    """x[idx] as an f32 tensor on dev, x numpy (host rows gathered, then
    uploaded) or a tensor (gathered where it lives)."""
    if isinstance(x, torch.Tensor):
        return x[torch.as_tensor(idx, device=x.device).long()].to(dev, torch.float32)
    return torch.from_numpy(np.ascontiguousarray(x[idx], dtype=np.float32)).to(dev)


def clustered_corpus(
    n: int,
    d: int,
    nlist: int,
    seed: int = 42,
    spread: float = 0.15,
    normalized: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Clustered corpus with its true structure exposed:
    (x [n,d], centers [nlist,d], assign [n] i32). Centers are recomputed as
    member means after normalization, i.e. the k-means-optimal centroids for
    the returned data — the 'trained quantizer' operating point without
    paying a k-means run per bench invocation (bench/datagen.generate_clustered
    keeps the single-array API for callers that don't need the structure)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((nlist, d), dtype=np.float32)
    assign = rng.integers(0, nlist, n).astype(np.int32)
    # float32 end-to-end and in-place ops: float64 temps + np.add.at made
    # 10M-row generation take ~12 min on one host core
    x = rng.standard_normal((n, d), dtype=np.float32)
    x *= spread
    x += centers[assign]
    if normalized:
        norms = np.sqrt(np.einsum("nd,nd->n", x, x))
        x /= np.maximum(norms, 1e-30)[:, None]
    # member means via per-column weighted bincount (C-speed; np.add.at is
    # a scalar-buffered ufunc loop at this size)
    counts = np.maximum(np.bincount(assign, minlength=nlist), 1)
    sums = np.empty((nlist, d), np.float64)
    for j in range(d):
        sums[:, j] = np.bincount(assign, weights=x[:, j], minlength=nlist)
    centers = (sums / counts[:, None]).astype(np.float32)
    return x, centers, assign


def trained_quantizer(
    x,
    nlist: int,
    *,
    seed: int = 42,
    train_sample: int = 524288,
    iters: int = 40,
    batch_size: int = 65536,
    assign_chunk: int = 131072,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Production coarse quantizer: minibatch k-means (ops/kmeans, seeded
    by `seed` on `device`) on a `default_rng(seed)` sample, then the
    full-corpus assignment in row chunks of `assign_chunk` → (centers
    [nlist,d] f32, assign [n] i32), numpy.

    The reference always trains its coarse stage (IVFIndex.swift:265-284,
    k-means++ seed + minibatch); benchmarks routed with generator-aligned
    cluster labels never stress routing. Assignment is chunked so the
    [chunk, nlist] distance block stays bounded at 10M-row scale. x is a
    numpy array or a tensor on any device; chunks move to `device`."""
    from vectorindex_tpu_torch.ops import kmeans as km

    dev = resolve_device(device)
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    samp = rng.choice(n, min(train_sample, n), replace=False)
    res = km.kmeans(
        _rows(x, samp, dev),
        km.KMeansConfig(
            k=nlist, iters=iters, algo="minibatch",
            batch_size=batch_size, seed=seed,
        ),
    )
    centers = res.centroids
    assign = np.empty(n, np.int32)
    for s in range(0, n, assign_chunk):
        e = min(s + assign_chunk, n)
        a, _ = km.assign_clusters_chunked(_rows(x, np.arange(s, e), dev), centers,
                                          chunk=assign_chunk)
        assign[s:e] = _host(a)
    return _host(centers).astype(np.float32), assign


def pack_ivf(
    x,
    assign,
    nlist: int,
    storage_dtype=torch.bfloat16,
    with_vecs: bool = True,
    src=None,
    device="cuda",
) -> Tuple[IVFListArrays, np.ndarray, int]:
    """Pack (x, assignments) into the CSR device layout.

    Returns (arrays, order, probe_cap): `arrays` on `device`; `order`
    (numpy i32) maps packed row -> original index (row_ids[row] ==
    order[row]); probe_cap is the static per-list row budget for the probe
    kernels (BLK-multiple >= the longest list). The layout is computed on
    the host in numpy, as the JAX function does, and uploaded once.

    with_vecs=False builds the codes-only/host-rerank tier: vecs and
    sqnorms stay None (never reach the card; x may be None) — only the CSR
    metadata (starts, lengths, row_ids) is device-resident. Valid for the
    PQ search paths, which score from code arrays (kernels/adc_probe).

    src (optional, [n_assign] i32): multi-assignment expansion from
    ops.ivf.spill_assign — assign[j] places row x[src[j]], so a corpus row
    may occupy several CSR slots (one per list it spilled into). row_ids
    then carry ORIGINAL corpus indices (duplicated for spilled rows);
    search epilogues dedup by id."""
    dev = resolve_device(device)
    assign = _host(assign)
    n = assign.shape[0]
    lengths = np.bincount(assign, minlength=nlist).astype(np.int32)
    caps = (np.ceil(np.maximum(lengths, 1) / BLK).astype(np.int64)) * BLK
    starts = np.concatenate([[0], np.cumsum(caps)[:-1]]).astype(np.int32)
    # trailing guard blocks: the JAX package's row layout
    total = int(caps.sum()) + GUARD_BLOCKS * BLK
    order = np.argsort(assign, kind="stable").astype(np.int32)
    rows = starts[assign[order]] + (
        np.arange(n, dtype=np.int32)
        - np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int32)[
            assign[order]
        ]
    )
    if src is not None:
        order = _host(src)[order].astype(np.int32)  # packed row -> ORIGINAL corpus index
    row_ids = np.full(total, -1, np.int32)
    row_ids[rows] = order
    vecs_dev = sqn_dev = None
    if with_vecs:
        x = _host(x)
        vecs = np.zeros((total, x.shape[1]), np.float32)
        vecs[rows] = x[order]
        sqn = np.einsum("nd,nd->n", vecs, vecs, dtype=np.float32)
        vecs_dev = torch.from_numpy(vecs).to(dev, storage_dtype)
        sqn_dev = torch.from_numpy(sqn).to(dev)
    arrays = IVFListArrays(
        vecs=vecs_dev,
        row_ids=torch.from_numpy(row_ids).to(dev),
        sqnorms=sqn_dev,
        starts=torch.from_numpy(starts).to(dev),
        lengths=torch.from_numpy(lengths).to(dev),
    )
    probe_cap = int(np.ceil(max(int(lengths.max(initial=0)), 1) / BLK)) * BLK
    return arrays, order, probe_cap


def pq_csr_state(
    x,
    assign,
    centers,
    arrays: IVFListArrays,
    order: np.ndarray,
    *,
    m: int,
    ks: int = 256,
    u4: bool = False,
    iters: int = 12,
    train_sample: int = 131072,
    seed: int = 7,
    encode_chunk: int = 4_000_000,
    device="cuda",
):
    """Residual-PQ state in packed row order:
    (books, codes [N_pad, m] u8 — or [N_pad, m//2] nibble-packed when
    u4=True (ks forced to 16) — and tcorr [N_pad] f32), on `device`. Dead
    rows are zeros (masked by list lengths in the probe kernels).

    The codebooks train (ops/pq.pq_train_residual, generator
    make_generator(seed, 0) on `device`) on a `default_rng(seed)` sample of
    the primary assignments. Encoding streams `encode_chunk`-row chunks of
    x to the card, so device residency stays ~2·chunk·d·4 bytes whatever
    n (the host tier's whole point).

    Residuals are taken against the list each PACKED slot belongs to
    (derived from the CSR metadata), not assign[order]: under spill
    multi-assignment (ops.ivf.spill_assign) a corpus row's second copy
    lives in — and must be encoded against — its second-nearest list.
    assign is only used to pick the codebook training sample (primary
    assignments; the first n entries under spill)."""
    from vectorindex_tpu_torch.ops import pq as pq_ops
    from vectorindex_tpu_torch.ops import rng as vrng
    from vectorindex_tpu_torch.ops.dtypes import pack_u4

    dev = resolve_device(device)
    if u4:
        ks = 16
    n = order.shape[0]  # live packed rows (exceeds x rows under spill)
    rng = np.random.default_rng(seed)
    n_x = x.shape[0]
    samp = rng.choice(n_x, min(train_sample, n_x), replace=False)
    cent = torch.as_tensor(centers, device=dev).float()
    books = pq_ops.pq_train_residual(
        vrng.make_generator(seed, 0, device=dev),
        _rows(x, samp, dev),
        cent,
        torch.from_numpy(_host(assign)[samp]).to(dev),
        m=m,
        ks=ks,
        iters=iters,
    )
    # encode in packed row order
    nlist = arrays.starts.shape[0]
    row_list = torch.repeat_interleave(
        torch.arange(nlist, dtype=torch.int32, device=dev), arrays.lengths.to(dev).long()
    )
    live_rows = torch.nonzero(arrays.row_ids.to(dev) >= 0).squeeze(1)
    total = arrays.row_ids.shape[0]
    codes = torch.zeros((total, m), dtype=torch.uint8, device=dev)
    tcorr = torch.zeros(total, dtype=torch.float32, device=dev)
    for s in range(0, n, encode_chunk):
        e = min(s + encode_chunk, n)
        lst = row_list[s:e]
        cchunk = pq_ops.pq_encode_residual(_rows(x, order[s:e], dev), cent, lst, books)
        codes[live_rows[s:e]] = cchunk
        tcorr[live_rows[s:e]] = pq_ops.pq_row_corrections(cchunk, lst, cent, books)
        del cchunk
    if u4:
        # nibble-pack AFTER tcorr (pq_row_corrections reads class ids);
        # probe kernels take packed_u4=True and unpack lo|hi in-kernel
        codes = pack_u4(codes)
    return books, codes, tcorr


def _l2(qd: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    """Squared L2 [B, rows] at full f32: ‖q‖² + ‖x‖² − 2⟨q, x⟩, unclamped."""
    from vectorindex_tpu_torch.ops import scoring

    return scoring.l2sqr_block(qd, xc, clamp=False)


def topk_chunked(q, x, k: int, dist_fn=_l2, row_chunk: int = 2_000_000, device="cuda"):
    """The k smallest dist_fn(q, rows) over x streamed to `device` in row
    chunks, with a running top-k merge there → (dist [Q, k], ids [Q, k]
    int64) on `device`, in the strict (score, id) order across chunks.
    Memory is bounded by the chunk, not by Q·n·d; x is a numpy array or a
    tensor on any device."""
    dev = resolve_device(device)
    qd = torch.as_tensor(_host(q), device=dev).float()
    best_d = torch.empty((qd.shape[0], 0), dtype=torch.float32, device=dev)
    best_i = torch.empty((qd.shape[0], 0), dtype=torch.int64, device=dev)
    for s in range(0, x.shape[0], row_chunk):
        xc = _rows(x, np.arange(s, min(s + row_chunk, x.shape[0])), dev)
        cd, ci = topk(dist_fn(qd, xc), k)
        md = torch.cat([best_d, cd], dim=1)
        mi = torch.cat([best_i, ci.long() + s], dim=1)
        best_d, sel = torch.sort(md, dim=1, stable=True)  # earlier chunks first: ties by id
        best_d = best_d[:, :k]
        best_i = torch.gather(mi, 1, sel[:, :k])
        del xc
    return best_d, best_i


def exact_truth(q, x, k: int, batch: int = 64, device="cuda") -> np.ndarray:
    """Full-f32 brute-force top-k ids [Q, k] (ground truth for recall), in
    the strict (score, id) order; the corpus on `device` whole, queries in
    batches of `batch`."""
    dev = resolve_device(device)
    xd = torch.as_tensor(x, device=dev).float()
    q = _host(q)
    out = []
    for s in range(0, q.shape[0], batch):
        qb = torch.from_numpy(np.ascontiguousarray(q[s : s + batch])).to(dev).float()
        out.append(_host(topk(_l2(qb, xd), k)[1]))
    return np.concatenate(out, axis=0)


def exact_truth_chunked(
    q, x, k: int, row_chunk: int = 2_000_000, device="cuda"
) -> np.ndarray:
    """exact_truth for corpora too large for device residency: stream the
    corpus to `device` in row chunks and keep a running top-k merge there
    ((score, id) order across chunks) → ids [Q, k] int64, numpy."""
    return _host(topk_chunked(q, x, k, row_chunk=row_chunk, device=device)[1])


def recall_at_k(found_ids: np.ndarray, truth_ids: np.ndarray) -> float:
    """Mean |found ∩ truth| / k over queries; found may contain -1/INVALID."""
    k = truth_ids.shape[1]
    return float(
        np.mean(
            [
                len(set(found_ids[i].tolist()) & set(truth_ids[i].tolist())) / k
                for i in range(truth_ids.shape[0])
            ]
        )
    )


def lowdim_corpus(
    n: int, d: int, dz: int = 16, noise: float = 0.05, seed: int = 42
) -> Tuple[np.ndarray, np.ndarray]:
    """(x [n,d], W [dz,d]): unit-norm corpus with intrinsic dimension dz —
    the SIFT-like regime (real descriptor sets have intrinsic dim ~12-16,
    which is what makes 8-byte PQ recall meaningful; i.i.d. gaussian 128-d
    data is maximally hard for ANY 8-byte code and reads as a broken
    benchmark). Queries: draw fresh z, map through the returned W."""
    rng = np.random.default_rng(seed)
    W = (rng.standard_normal((dz, d), dtype=np.float32) / np.sqrt(dz)).astype(
        np.float32
    )
    z = rng.standard_normal((n, dz), dtype=np.float32)
    x = rng.standard_normal((n, d), dtype=np.float32)  # f32 draws: the f64
    x *= noise  # path costs 3-4x on single-core hosts at bench scale
    x += z @ W
    norms = np.sqrt(np.einsum("nd,nd->n", x, x))
    x /= np.maximum(norms, 1e-30)[:, None]
    return x, W


def lowdim_queries(
    W: np.ndarray, nq: int, noise: float = 0.05, seed: int = 9
) -> np.ndarray:
    rng = np.random.default_rng(seed)
    dz, d = W.shape
    q = rng.standard_normal((nq, dz), dtype=np.float32) @ W
    q += noise * rng.standard_normal((nq, d), dtype=np.float32)
    q /= np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-30)
    return q.astype(np.float32)
