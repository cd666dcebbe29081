"""K-means: k-means++ / k-means‖ seeding, mini-batch and Lloyd training,
streaming chunk API.

Counterpart of vectorindex_tpu.ops.kmeans (parity targets: the reference's
KMeansSeeding.swift:167 and KMeansMiniBatchKernel.swift:424,771-886).
Plain torch on tensors of any device; the JAX package has no kernel here.

  - Assignment is one f32 Gram product + argmin per row chunk, so the
    [n, k] distance matrix is never materialised beyond [chunk, k].
  - Segment sums add each cluster's rows in ascending row order, so a seed
    gives the same centroids bit for bit in every run. On the CPU that is
    `index_add_`; on CUDA (where `index_add_` adds floats by atomics in no
    fixed order) the rows are stably sorted by assignment and each segment
    is summed by `torch.segment_reduce`. The JAX package's one-hot matmul
    would materialise [n, k] (scripts/ab_kmeans_segment_torch.py times both
    CUDA designs).
  - The JAX package's `lax.scan`s are Python loops; Lloyd stops at the same
    rule as its masked scan (stop once an iteration does not improve the
    inertia by more than tol·|previous|, keeping the previous centroids).
  - Randomness comes from `torch.Generator`s made by ops/rng from
    (seed, stream); the draws are not the JAX package's (see ops/rng).
  - k-means‖ reduces over the corpus at full f32 (the JAX package rounds to
    bf16 there, which only perturbs the sampling weights).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch

from vectorindex_tpu_torch.ops import rng as vrng
from vectorindex_tpu_torch.ops import scoring

Tensor = torch.Tensor

#: rows per distance chunk in assign_clusters_chunked
ASSIGN_CHUNK = 131072


# ---------------------------------------------------------------------------
# assignment / inertia helpers
# ---------------------------------------------------------------------------


def assign_clusters(x: Tensor, centroids: Tensor) -> Tuple[Tensor, Tensor]:
    """Nearest centroid per row → (assignments [n] int32, sq distances [n]).
    argmin returns the first index of a tie, as jnp.argmin does."""
    d2 = scoring.l2sqr_block(x, centroids)
    d2min, assign = torch.min(d2, dim=1)
    return assign.to(torch.int32), d2min


def assign_clusters_chunked(
    x: Tensor, centroids: Tensor, chunk: int = ASSIGN_CHUNK
) -> Tuple[Tensor, Tensor]:
    """assign_clusters over row chunks: the live intermediate is [chunk, k]."""
    n = x.shape[0]
    if n <= chunk:
        return assign_clusters(x, centroids)
    csq = scoring.squared_norms(centroids)
    assign = torch.empty(n, dtype=torch.int32, device=x.device)
    d2min = torch.empty(n, dtype=torch.float32, device=x.device)
    for s in range(0, n, chunk):
        d2 = scoring.l2sqr_block(x[s : s + chunk], centroids, x_sqnorms=csq)
        d, a = torch.min(d2, dim=1)
        assign[s : s + chunk] = a.to(torch.int32)
        d2min[s : s + chunk] = d
    return assign, d2min


def _segment_mean(x: Tensor, assign: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """Per-cluster (sums [k, d] f32, counts [k] f32), each cluster's rows
    added in ascending row order: index_add_ on the CPU; on CUDA a stable
    sort by assignment, then a sum per segment, with no float atomics."""
    idx = assign.long()
    counts = torch.bincount(idx, minlength=k)
    if x.is_cuda:
        rows = x.float()[torch.argsort(idx, stable=True)]
        sums = torch.segment_reduce(rows, "sum", lengths=counts, axis=0, unsafe=True)
        return sums, counts.float()
    sums = torch.zeros((k, x.shape[1]), dtype=torch.float32, device=x.device)
    sums.index_add_(0, idx, x.float())
    return sums, counts.float()


def inertia(x: Tensor, centroids: Tensor) -> Tensor:
    _, d2 = assign_clusters_chunked(x, centroids)
    return d2.sum()


# ---------------------------------------------------------------------------
# seeding (#11)
# ---------------------------------------------------------------------------


def _first_index(gen: torch.Generator, n: int) -> Tensor:
    return torch.randint(0, n, (1,), generator=gen, device=gen.device)


def kmeans_pp_seed(gen: torch.Generator, x: Tensor, k: int) -> Tensor:
    """Exact sequential k-means++ D² seeding (reference kmeansPlusPlusSeed,
    KMeansSeeding.swift:167). O(k·n·d); subsample x first for large n.
    `gen` must live on x's device."""
    sqn = scoring.squared_norms(x)

    def d2_to(c: Tensor) -> Tensor:  # c [1, d]
        return torch.clamp_min(sqn + (c * c).sum() - 2.0 * (x @ c[0]), 0.0)

    idxs = [_first_index(gen, x.shape[0])]
    min_d2 = d2_to(x[idxs[0]])
    for _ in range(k - 1):
        idx = vrng.weighted_pick(gen, min_d2, (1,))
        min_d2 = torch.minimum(min_d2, d2_to(x[idx]))
        idxs.append(idx)
    return x[torch.cat(idxs)]


def kmeans_parallel_seed(
    gen: torch.Generator, x: Tensor, k: int, rounds: int = 5, oversample: int = 2
) -> Tensor:
    """k-means‖ (Bahmani et al.): `rounds` rounds of D²-proportional
    oversampling (l = oversample·k per round), then weighted k-means++ over
    the ≈rounds·l candidate pool. Corpus-wide reductions run over row
    chunks (live intermediate ≈256 MB)."""
    n = x.shape[0]
    l = oversample * k
    sqn = scoring.squared_norms(x)

    def chunked(cands: Tensor, reduce_fn):
        csq = scoring.squared_norms(cands)
        chunk = min(n, max(1024, (256 << 20) // max(cands.shape[0] * 4, 1)))
        return torch.cat([
            reduce_fn(scoring.l2sqr_block(
                x[s : s + chunk], cands, x_sqnorms=csq, q_sqnorms=sqn[s : s + chunk]))
            for s in range(0, n, chunk)
        ])

    first = _first_index(gen, n)
    min_d2 = chunked(x[first], lambda d2: d2.min(dim=1).values)
    cand_idxs = [first]
    for _ in range(rounds):
        idxs = vrng.weighted_pick(gen, min_d2, (l,))
        min_d2 = torch.minimum(min_d2, chunked(x[idxs], lambda d2: d2.min(dim=1).values))
        cand_idxs.append(idxs)
    pool = x[torch.cat(cand_idxs)]  # [1 + rounds*l, d]
    # weights: how many points each candidate attracts
    attract = chunked(pool, lambda d2: d2.argmin(dim=1))
    weights = torch.bincount(attract, minlength=pool.shape[0]).float()

    # weighted k-means++ over the small pool
    pool_sqn = scoring.squared_norms(pool)

    def d2_to(c: Tensor) -> Tensor:
        return torch.clamp_min(pool_sqn + (c * c).sum() - 2.0 * (pool @ c[0]), 0.0)

    picks = [vrng.weighted_pick(gen, weights, (1,))]
    min_d2 = d2_to(pool[picks[0]])
    for _ in range(k - 1):
        idx = vrng.weighted_pick(gen, min_d2 * weights, (1,))
        min_d2 = torch.minimum(min_d2, d2_to(pool[idx]))
        picks.append(idx)
    return pool[torch.cat(picks)]


# ---------------------------------------------------------------------------
# training (#12)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class KMeansConfig:
    """Reference KMeansMBConfig (KMeansMiniBatchKernel.swift:46)."""

    k: int
    iters: int = 20  # epochs (minibatch) or iterations (lloyd)
    batch_size: int = 4096  # minibatch only
    tol: float = 1e-4  # relative inertia improvement early-stop
    algo: str = "lloyd"  # "lloyd" | "minibatch"
    seed: int = 42
    stream: int = 0
    # seeding runs on a bounded sample of the corpus (reference
    # KMeansSeedConfig.sampleSize, KMeansSeeding.swift:40)
    seed_sample: int = 262144


class KMeansResult(NamedTuple):
    centroids: Tensor
    assignments: Tensor
    inertia: Tensor
    iterations: int  # iterations actually run (early stop)


def _repair_empty(gen: torch.Generator, centroids: Tensor, counts: Tensor, x: Tensor) -> Tensor:
    """Empty-cluster repair: reseed empties to random data points (reference
    emptyPolicy reseed, PQTrain.swift:20-43)."""
    k = centroids.shape[0]
    idxs = torch.randint(0, x.shape[0], (k,), generator=gen, device=gen.device)
    return torch.where((counts > 0)[:, None], centroids, x[idxs])


def kmeans_lloyd(
    gen: torch.Generator, x: Tensor, init: Tensor, *, k: int, iters: int, tol: float = 1e-4
) -> KMeansResult:
    """Full-batch Lloyd with the inertia early stop of the JAX package's
    masked scan: iteration i > 0 that does not improve the inertia by more
    than tol·|previous| ends training and keeps the centroids it started
    from. One host synchronisation per iteration (the stop test)."""
    cent = init.float()
    prev = float("inf")
    done_iters = 0
    for i in range(iters):
        assign, d2 = assign_clusters_chunked(x, cent)
        cur = float(d2.sum())
        if i > 0 and not (prev - cur > tol * abs(prev)):
            break
        sums, counts = _segment_mean(x, assign, k)
        new = torch.where(
            counts[:, None] > 0, sums / torch.clamp_min(counts, 1.0)[:, None], cent
        )
        cent = _repair_empty(gen, new, counts, x)
        prev = cur
        done_iters += 1
    assign, d2 = assign_clusters_chunked(x, cent)
    return KMeansResult(cent, assign, d2.sum(), done_iters)


def kmeans_minibatch(
    gen: torch.Generator, x: Tensor, init: Tensor, *, k: int, iters: int, batch_size: int
) -> KMeansResult:
    """Sculley-style mini-batch k-means: per-batch assignment + running
    per-cluster counts with 1/count learning rates (reference lloydMiniBatch,
    KMeansMiniBatchKernel.swift:424)."""
    n = x.shape[0]
    bs = min(batch_size, n)
    cent = init.float()
    counts = torch.zeros(k, device=x.device)
    for _ in range(iters):
        idx = torch.randint(0, n, (bs,), generator=gen, device=gen.device)
        xb = x[idx]
        assign, _ = assign_clusters(xb, cent)
        sums, bcounts = _segment_mean(xb, assign, k)
        counts = counts + bcounts
        lr = torch.where(counts > 0, 1.0 / torch.clamp_min(counts, 1.0), 0.0)
        target = torch.where(
            bcounts[:, None] > 0, sums / torch.clamp_min(bcounts, 1.0)[:, None], cent
        )
        cent = cent + (lr * bcounts)[:, None] * (target - cent)
    assign, d2 = assign_clusters_chunked(x, cent)
    return KMeansResult(cent, assign, d2.sum(), iters)


def kmeans(
    x: Tensor,
    cfg: KMeansConfig,
    init: Optional[Tensor] = None,
    gen: Optional[torch.Generator] = None,
) -> KMeansResult:
    """Seed (k-means++ for k ≤ 256, k-means‖ above) + train: the seed→train
    flow of IVFIndex.optimize() (reference IVFIndex.swift:265-284). The
    generator defaults to (cfg.seed, cfg.stream) on x's device."""
    x = x.float()
    if gen is None:
        gen = vrng.make_generator(cfg.seed, cfg.stream, device=x.device)
    gseed, gtrain = vrng.split_stream(gen, 0), vrng.split_stream(gen, 1)
    if init is None:
        xs = x
        if cfg.seed_sample and x.shape[0] > cfg.seed_sample:
            xs = x[vrng.sample_without_replacement(gseed, x.shape[0], cfg.seed_sample)]
        if cfg.k <= 256:
            init = kmeans_pp_seed(gseed, xs, cfg.k)
        else:
            init = kmeans_parallel_seed(gseed, xs, cfg.k)
    if cfg.algo == "minibatch":
        return kmeans_minibatch(
            gtrain, x, init, k=cfg.k, iters=cfg.iters, batch_size=cfg.batch_size
        )
    return kmeans_lloyd(gtrain, x, init, k=cfg.k, iters=cfg.iters, tol=cfg.tol)


# ---------------------------------------------------------------------------
# streaming API (reference kmeans_state_init/update_chunk/finalize,
# KMeansMiniBatchKernel.swift:771-886)
# ---------------------------------------------------------------------------


class KMeansStreamState(NamedTuple):
    centroids: Tensor
    counts: Tensor  # running per-cluster counts


def kmeans_stream_init(init_centroids: Tensor) -> KMeansStreamState:
    k = init_centroids.shape[0]
    return KMeansStreamState(init_centroids.float(), torch.zeros(k, device=init_centroids.device))


def kmeans_stream_update(state: KMeansStreamState, chunk: Tensor) -> KMeansStreamState:
    """Consume one chunk (reference kmeans_state_update_chunk :785):
    mini-batch 1/count update rule."""
    k = state.centroids.shape[0]
    assign, _ = assign_clusters(chunk, state.centroids)
    sums, bcounts = _segment_mean(chunk, assign, k)
    counts = state.counts + bcounts
    lr = torch.where(counts > 0, bcounts / torch.clamp_min(counts, 1.0), 0.0)
    target = torch.where(
        bcounts[:, None] > 0, sums / torch.clamp_min(bcounts, 1.0)[:, None], state.centroids
    )
    cent = state.centroids + lr[:, None] * (target - state.centroids)
    return KMeansStreamState(cent, counts)


def kmeans_stream_finalize(state: KMeansStreamState) -> Tensor:
    return state.centroids
