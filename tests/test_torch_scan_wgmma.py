"""The wgmma design of K1, K2 and K11 (kernels/scan_fused.wgmma_plan and
csrc scan_wgmma_kernel's thread map) on the CPU: no JAX, no card.

The kernel itself runs only on the card (tests/test_torch_cuda.py and
chip_smoke.py hold it to its plain versions there); these tests check what
sizes and maps it: every plan over the route's widths and batches fits the
H100's shared memory and the consumers' register budget, K1 and K2 take one
tile for one (B, d) and K11 the narrow tile's (every plan gives the same floats, so K2
recomputes K1's and K11's bit for bit; the cuda tests hold them to it),
K11's splits hold whole blocks, the thread map owns every (query, class)
pair of a CTA once, and a replay of the wide tile K1's threshold-and-queue
fold keeps the plain version's per-class tiers.
"""

import pytest
import torch

from vectorindex_tpu_torch.kernels import scan_fused as sf
from vectorindex_tpu_torch.utils.config import Metric

torch.set_num_threads(1)

KERNELS = ("bin_candidates", "bin_candidates_tree", "count_below")
#: widths across the route: each side of the slab edges (64), of the
#: register-resident query block (d <= 128), of the shared-memory one, of
#: the first tensor-core design's last width (2,400) and of the first FMA
#: design's (7,264), and the embedding widths past them (3,072, 4,096,
#: 8,192), some not a multiple of 8 (rows the producer copies)
ROUTE_D = [1, 8, 16, 63, 64, 65, 100, 127, 128, 129, 192, 256, 257, 320, 384, 448, 449, 512,
           768, 1024, 1536, 2048, 2399, 2400, 2401, 3072, 3073, 4096, 7265, 8192, 16383, 16384]
BATCHES = [1, 8, 9, 64, 65, 129, 256, 300]
N = 1 << 20


def _geometry(p: sf.WgmmaPlan) -> tuple:
    return p.qt, p.g, p.qblocks, p.a_regs, p.chunked, p.cs, p.tps, p.stages, p.smem


@pytest.mark.parametrize("d", ROUTE_D)
@pytest.mark.parametrize("nq", BATCHES)
def test_wgmma_plan_fits_shared_memory_and_registers(d, nq):
    p = sf.wgmma_plan(nq, N, d)
    slabs = -(-d // sf.WG_SLAB)
    assert p.smem <= sf.MAX_SMEM_BYTES
    assert p.smem == sf.wgmma_smem(d, p.qt, p.a_regs, p.chunked, p.cs, p.tps, p.stages, False,
                                   p.units, p.queue)[1]
    # setmaxnreg: two consumer warpgroups and the producer's share an SM's
    # 65,536 registers
    assert 128 * (2 * sf.WG_CONSUMER_REGS + sf.WG_PRODUCER_REGS) <= 65_536
    assert sf.WG_THREADS == 3 * 128
    for kernel in KERNELS:
        for metric in (Metric.L2, Metric.COSINE):
            placed = sf.wgmma_plan(nq, N, d, a_mode=sf.wgmma_placement(kernel, metric, d, nq),
                                   kernel=kernel)
            assert placed.smem <= sf.MAX_SMEM_BYTES
            assert placed.smem == sf.wgmma_smem(d, placed.qt, placed.a_regs, placed.chunked,
                                                placed.cs, placed.tps, placed.stages,
                                                kernel == "bin_candidates_tree", placed.units,
                                                placed.queue)[1]
            tps = placed.tps if placed.chunked else 1  # accumulators a warpgroup holds
            assert (sf.wgmma_registers(placed.a_regs, kernel, tps, placed.units)
                    <= sf.WG_REG_BUDGET < sf.WG_CONSUMER_REGS)
            queued = kernel == "bin_candidates" and sf.wg_queued(placed.units, tps)
            assert (placed.queue >= sf.WG_QUEUE_MIN) if queued else placed.queue == 0
            if sf.wg_queued(placed.units, tps):  # a tier's row: its tile's index in the split
                assert placed.tiles_per_split <= sf.WG_MAX_SPLIT_TILES
    assert 2 <= p.stages <= sf.WG_MAX_STAGES
    assert p.qt in (1, 2, 4) and p.units == (2 if p.qt == 4 else 1)
    assert p.g * p.qt == 64 * p.units and sf.C % p.g == 0
    assert p.qblocks * 64 * p.qt >= nq > (p.qblocks - 1) * 64 * p.qt
    if nq <= 128 and d <= 256 or nq <= 256 and d <= 128:
        assert p.qblocks == 1  # every query in one CTA: the corpus read once a pass
    if not p.chunked:
        assert (p.a_regs > 0) == (slabs <= 2) and p.a_regs in (0, 4 * slabs)
    else:  # the wide tile reads a stage's query chunk into registers
        assert p.a_regs == (4 * p.cs if p.tps == sf.WG_WIDE_TILES else 0)
    if p.chunked:
        wide = nq > 64
        assert p.tps == (sf.WG_WIDE_TILES if wide else sf.WG_CHUNK_TILES)
        assert p.qt == (2 if wide else 1) and p.cs <= slabs
        assert p.tiles_per_split % p.tps == 0  # only the last split ends mid-stage
    else:
        assert p.cs == slabs
    if p.a_regs == 0 and not p.chunked:
        assert p.stages >= 3
    ntiles = N // sf.C
    assert (p.splits - 1) * p.tiles_per_split < ntiles <= p.splits * p.tiles_per_split
    ctas = p.qblocks * (sf.C // p.g) * p.splits
    assert ctas <= max(sf.SMS, p.qblocks * (sf.C // p.g))  # one wave


@pytest.mark.parametrize("d", [16, 100, 128, 256, 384, 1024, 2400])
@pytest.mark.parametrize("nq", [1, 13, 64, 256, 300])
@pytest.mark.parametrize("block_tiles", [16, 32])
@pytest.mark.parametrize("metric", [Metric.L2, Metric.INNER_PRODUCT, Metric.COSINE],
                         ids=lambda m: m.value)
def test_k1_k2_k11_share_one_tile_geometry(d, nq, block_tiles, metric):
    """One tile for one (B, d): the same query tiles, units, class groups,
    query blocks, tiles a stage and splits for K1 and K2, and the same
    placement of the query block but where wgmma_placement moves cosine
    K1's into shared memory (the placement does not change the floats);
    where K1's tiers leave the registers (the wide tile) they and its queue
    take shared memory, so K1 may hold fewer stages or slabs a stage than
    K2. K11 keeps the narrow tile (one unit a warpgroup, at most two query
    tiles) and, outside the wide tile, K1's geometry; its tiers take shared
    memory beside the same ring geometry where it fits; K11's splits start
    on block boundaries (block_tiles = tile / 256 for tiles 4096 and 8192)
    and still cover the corpus."""
    plans = {k: sf.wgmma_plan(nq, N, d, block_tiles=block_tiles if k == "bin_candidates_tree" else 1,
                              a_mode=sf.wgmma_placement(k, metric, d, nq), kernel=k) for k in KERNELS}
    k1, k11, k2 = (plans[k] for k in KERNELS)
    tile = ("qt", "units", "g", "qblocks", "chunked", "tps", "splits", "tiles_per_split")
    assert [getattr(k1, f) for f in tile] == [getattr(k2, f) for f in tile]
    wide = k1.units == 2 or k1.chunked and k1.tps == sf.WG_WIDE_TILES
    assert wide == (nq > 64 and (d <= 128 and nq > 128 or k1.chunked))
    assert k11.units == 1 and k11.qt <= 2 and k11.tps == 1 if k11.chunked else k11.units == 1
    if not wide:
        assert (k1.qt, k1.g, k1.qblocks) == (k11.qt, k11.g, k11.qblocks)
        if metric != Metric.COSINE:
            assert _geometry(k1) == _geometry(k2)
            assert _geometry(k1) == _geometry(sf.wgmma_plan(nq, N, d, block_tiles=block_tiles))
    elif metric != Metric.COSINE or d > 128:
        assert (k1.a_regs, k2.a_regs) == ((4 * k1.cs, 4 * k2.cs) if k1.chunked else (k2.a_regs,) * 2)
        assert k1.queue > 0 and k2.queue == 0 and k1.smem > k2.smem
    assert _geometry(k2) == _geometry(sf.wgmma_plan(nq, N, d, kernel="count_below"))
    assert sf.wgmma_placement("bin_candidates_tree", metric, d) is None
    assert k11.a_regs == k2.a_regs or k2.units == 2 or k2.tps == sf.WG_WIDE_TILES
    if k11.chunked and not k2.chunked:  # the tiers leave no room for the resident query block
        assert sf._wgmma_ring(d, k11.qt, 0, False, True)[2] < 3
    assert k11.smem == sf.wgmma_smem(d, k11.qt, k11.a_regs, k11.chunked, k11.cs, k11.tps,
                                     k11.stages, True)[1]
    assert k11.tiles_per_split % block_tiles == 0
    ntiles = N // sf.C
    assert (k11.splits - 1) * k11.tiles_per_split < ntiles <= k11.splits * k11.tiles_per_split


@pytest.mark.parametrize("nq", [1, 64, 65, 128, 129, 256])
@pytest.mark.parametrize("d", [128, 384, 4096])
def test_wgmma_thread_map_owns_each_pair_once(nq, d):
    """The consumers' 256 threads x 16 units pairs cover the CTA's 64 qt
    queries x 64 units / qt classes once each (four query tiles at two
    units a warpgroup: 256 queries x 32 classes); a thread's pairs are 2
    query rows of each unit against 8 classes."""
    p = sf.wgmma_plan(nq, N, d)
    queries, classes = sf.wgmma_thread_map(p)
    assert queries.shape == classes.shape == (256, 16 * p.units)
    key = queries * 1000 + classes
    assert key.unique().numel() == 256 * 16 * p.units == 64 * p.qt * p.g
    assert queries.min() == 0 and queries.max() == 64 * p.qt - 1
    assert classes.min() == 0 and classes.max() == p.g - 1
    assert all(len(set(r.tolist())) == 2 * p.units for r in queries)
    assert all(len(set(r.tolist())) == 8 for r in classes)


@pytest.mark.parametrize(
    "kwargs, match",
    [(dict(d=-1), "wgmma route"), (dict(d=0), "wgmma route"),
     (dict(d=129, a_mode="regs"), "registers"), (dict(d=128, a_mode="tma"), "a_mode"),
     (dict(d=128, qt=3), "qt"), (dict(d=128, kernel="bin_candidates_fma"), "plans"),
     (dict(d=256, qt=4), "registers"), (dict(d=4096, qt=4), "registers"),
     (dict(d=128, qt=4, kernel="bin_candidates_tree"), "qt"),
     (dict(d=4096, chunk_tiles=3), "chunk_tiles"), (dict(d=4096, chunk_tiles=8), "chunk_tiles"),
     (dict(d=4096, kernel="bin_candidates_tree", chunk_tiles=2), "chunk_tiles")],
)
def test_wgmma_plan_refuses_what_the_kernel_does_not_take(kwargs, match):
    d = kwargs.pop("d")
    with pytest.raises(ValueError, match=match):
        sf.wgmma_plan(256, N, d, **kwargs)


@pytest.mark.parametrize("a_mode", ["regs", "smem", "chunked"])
def test_wgmma_plan_overrides(a_mode):
    """Each placement of the query block (the A/B sweep's variants) gives a
    plan that fits at the main path's shape."""
    p = sf.wgmma_plan(256, N, 128, a_mode=a_mode)
    assert p.smem <= sf.MAX_SMEM_BYTES
    # past one query tile a chunked stage's query chunk is read into registers
    assert (p.a_regs, p.chunked) == {"regs": (8, False), "smem": (0, False),
                                     "chunked": (4 * p.cs, True)}[a_mode]


@pytest.mark.parametrize("nq", [1, 70, 300])
def test_chunked_query_block_is_q_rounded_once_and_zero_padded(nq):
    """A chunked plan's query block (brought in by TMA with each stage's k
    chunk): q rounded to bf16 once, rows past the batch and k past d zero."""
    q = torch.randn(nq, 1000)
    p = sf.wgmma_plan(nq, N, 1000, a_mode="chunked")
    assert p.chunked
    qp = sf._query_block(q, p)
    assert qp.dtype == torch.bfloat16 and qp.shape == (p.qblocks * 64 * p.qt, 1024)
    assert torch.equal(qp[:nq, :1000], q.bfloat16())
    assert not qp[nq:].any() and not qp[:, 1000:].any()


@pytest.mark.parametrize("d", [449, 768, 1024, 1536, 2048, 2400, 2401, 3072, 3073, 4096, 8192,
                               16384])
@pytest.mark.parametrize("nq", [8, 256])
def test_wide_rows_stream_the_query_block(d, nq):
    """Past the widths whose resident query block leaves 3 stages of whole
    rows (d > 448), the query block's k chunk rides in each stage, at one
    query tile beside WG_CHUNK_TILES tiles' k chunk (B <= 64: 4 slabs in 2
    stages), or past one query tile at two beside WG_WIDE_TILES tiles' (the
    wide tile: K2 3 slabs in 2 stages, K1, whose tiers and queue take 80 KiB,
    2 slabs), in stages of at most WG_CHUNK_RING's bytes, as many as its
    fewest; the query block is made at any width."""
    wide = nq > 64
    for kernel, want in (("bin_candidates", (2, 2) if wide else (4, 2)),
                         ("count_below", (3, 2) if wide else (4, 2))):
        p = sf.wgmma_plan(nq, N, d, kernel=kernel)
        assert p.chunked and p.a_regs == (4 * p.cs if wide else 0) and p.units == 1
        assert (p.qt, p.tps) == ((2, sf.WG_WIDE_TILES) if wide else (1, sf.WG_CHUNK_TILES))
        assert sf._wgmma_ring(d, 1, 0, False, False)[2] < 3
        most, fewest = sf.WG_CHUNK_RING[p.tps]
        assert p.cs * (p.tps * p.g + 64 * p.qt) * 128 <= most and p.stages >= fewest
        assert (p.cs, p.stages) == want
        qp = sf._query_block(torch.zeros(nq, d), p)
        assert qp.shape == (p.qblocks * 64 * p.qt, -(-d // 64) * 64)
        # the default placement past d = 448
        assert sf.wgmma_plan(nq, N, d, a_mode="smem", kernel=kernel) == p


@pytest.mark.parametrize("qt", [1, 2])
@pytest.mark.parametrize("d", [256, 768])
def test_wgmma_plan_takes_query_tiles_by_hand(qt, d):
    """qt (the A/B sweep's override) sets the CTA's query tiles and its
    class group; the batch's query blocks follow."""
    a_mode = "smem" if d <= 448 else "chunked"
    p = sf.wgmma_plan(256, N, d, a_mode=a_mode, qt=qt)
    assert (p.qt, p.g, p.qblocks) == (qt, 64 // qt, 4 // qt)
    assert p.chunked == (a_mode == "chunked")


def test_first_designs_raise_on_cpu_tensors():
    x = torch.randn(512, 16).bfloat16()
    q = torch.randn(2, 16)
    bias = torch.zeros(512)
    tau = torch.zeros(2)
    with pytest.raises(ValueError, match="CUDA"):
        sf.bin_candidates_mma_v1(q, x, bias, None, metric=Metric.L2)
    with pytest.raises(ValueError, match="CUDA"):
        sf.count_below_mma_v1(q, x, bias, None, tau, metric=Metric.L2)
    with pytest.raises(ValueError, match="CUDA"):
        sf.bin_candidates_tree_v1(q, x, bias, metric=Metric.L2, tile=512)
    assert sf.LAUNCHES["bin_candidates_mma_v1"] == sf.LAUNCHES["count_below_mma_v1"] == 0
    assert sf.LAUNCHES["bin_candidates_tree_v1"] == 0


@pytest.mark.parametrize("d", [768, 3073, 4096, 16384])
@pytest.mark.parametrize("chunk_tiles", [1, 2, 4])
def test_chunked_stages_hold_one_or_two_tiles(d, chunk_tiles):
    """A chunked plan's stage holds chunk_tiles tiles' k chunk beside the
    query block's (the A/B sweep's variants: 1 or 2 at one query tile, 4 at
    two, the wide tile); its accumulators fit the register budget (K1's
    tiers out of registers past two), and K11 keeps one tile."""
    for kernel in ("bin_candidates", "count_below"):
        p = sf.wgmma_plan(256, N, d, a_mode="chunked", kernel=kernel, chunk_tiles=chunk_tiles)
        assert p.chunked and p.tps == chunk_tiles and p.stages >= sf.WG_CHUNK_RING[chunk_tiles][1]
        assert p.qt == (2 if chunk_tiles == sf.WG_WIDE_TILES else 1)
        assert p.smem == sf.wgmma_smem(d, p.qt, 0, True, p.cs, p.tps, p.stages, False, p.units,
                                       p.queue)[1] <= sf.MAX_SMEM_BYTES
        assert sf.wgmma_registers(p.a_regs, kernel, p.tps) <= sf.WG_REG_BUDGET
        assert (p.queue > 0) == (kernel == "bin_candidates" and sf.wg_queued(1, p.tps))
    tree = sf.wgmma_plan(256, N, d, a_mode="chunked", kernel="bin_candidates_tree", block_tiles=16)
    assert tree.tps == 1 and tree.tiles_per_split % 16 == 0


#: the wide tile's batches (past one query tile, one not a multiple of 64)
#: and widths (registers, the producer's copies, resident, streamed)
WIDE_BATCHES = [65, 128, 200, 256]
WIDE_D = [100, 128, 256, 300, 384, 768, 3072, 4096, 8192]


@pytest.mark.parametrize("d", WIDE_D)
@pytest.mark.parametrize("nq", WIDE_BATCHES)
@pytest.mark.parametrize("kernel", ["bin_candidates", "count_below"])
def test_wide_tile_plan_fits_and_states_its_queries(kernel, d, nq):
    """Past one query tile K1 and K2 take the wide tile where it applies:
    every query of a batch up to 256 in one CTA at d <= 128 (four query
    tiles, two units a warpgroup, A from registers), 128 queries x 128 rows
    a stage on streamed rows and on the band's rows that band_chunked gives
    it (two query tiles, WG_WIDE_TILES tiles); the narrow tile's two query
    tiles on the band's other rows (d % 8 != 0: d = 100 is below the band)
    or at B <= 128 at d <= 128. Each fits the shared memory and the
    register budget, and K1's tiers, queue and tile indices fit beside it."""
    p = sf.wgmma_plan(nq, N, d, kernel=kernel)
    tps = p.tps if p.chunked else 1
    assert p.smem <= sf.MAX_SMEM_BYTES
    assert p.smem == sf.wgmma_smem(d, p.qt, p.a_regs, p.chunked, p.cs, p.tps, p.stages, False,
                                   p.units, p.queue)[1]
    assert sf.wgmma_registers(p.a_regs, kernel, tps, p.units) <= sf.WG_REG_BUDGET
    queries = 64 * p.qt  # a CTA's
    if d <= 128:
        assert queries == (256 if nq > 128 else 128) and p.qblocks == 1
        assert p.units == (2 if nq > 128 else 1) and p.a_regs == 4 * (-(-d // 64))
    elif d <= 448 and not sf.band_chunked(d):
        assert queries == 128 and not p.chunked and p.qblocks == -(-nq // 128)
    else:
        assert queries == 128 and p.chunked and p.tps == sf.WG_WIDE_TILES
    queued = kernel == "bin_candidates" and sf.wg_queued(p.units, tps)
    assert queued == (kernel == "bin_candidates" and (p.units == 2 or p.chunked))
    if queued:
        assert p.queue >= sf.WG_QUEUE_MIN and p.tiles_per_split <= sf.WG_MAX_SPLIT_TILES
        own = sf.wgmma_plan(nq, N, d, kernel="count_below")
        assert (p.qt, p.units, p.tps, p.splits) == (own.qt, own.units, own.tps, own.splits)


def test_wide_tile_splits_hold_at_most_1023_tiles():
    """A corpus whose splits would pass WG_MAX_SPLIT_TILES tiles takes more
    splits (K1 keeps a tier's row as its tile's index, 10 bits), K2 the
    same; the narrow tile's plan does not."""
    n = 1 << 26
    for d in (128, 384, 4096):
        k1 = sf.wgmma_plan(256, n, d)
        k2 = sf.wgmma_plan(256, n, d, kernel="count_below")
        assert k1.tiles_per_split <= sf.WG_MAX_SPLIT_TILES
        assert (k1.splits, k1.tiles_per_split) == (k2.splits, k2.tiles_per_split)
        assert k1.splits * k1.tiles_per_split >= n // sf.C
    assert sf.wgmma_plan(64, n, 128).tiles_per_split > sf.WG_MAX_SPLIT_TILES


def _queue_fold_replay(dist: torch.Tensor, units: int, cap: int):
    """K1's wide-tile epilogue, replayed in plain torch: dist [T, threads,
    16 units] (tile j's distance of each thread's pair k, rows growing with
    j). Each thread tests a pair's distance against its threshold (its third
    tier's distance as of its last fold: stale between folds) and queues the
    hits; after each half of a unit (8 pairs) a warp whose threads might not
    fit 8 more (any queue > cap - 8) folds every thread's queue, in order,
    into its tiers by push3 (strict <: a later row never passes an equal
    distance), and reloads the thresholds; a last fold at the end. ->
    (dist [threads, pairs, 3], tile index [threads, pairs, 3], none = -1)."""
    tiles, threads, pairs = dist.shape
    td = torch.full((threads, pairs, 3), float("inf"))
    ti = torch.full((threads, pairs, 3), -1, dtype=torch.int64)
    thr = torch.full((threads, pairs), float("inf"))
    queues = [[] for _ in range(threads)]
    folds = [0]

    def fold():
        for t, entries in enumerate(queues):
            for v, j, k in entries:
                d0, d1, d2 = td[t, k].tolist()
                if not v < d2:
                    continue  # a stale threshold let it in: a no-op
                c1, c0 = v < d1, v < d0
                i0, i1, _ = ti[t, k].tolist()
                td[t, k] = torch.tensor([v if c0 else d0, d0 if c0 else (v if c1 else d1),
                                         d1 if c1 else v])
                ti[t, k] = torch.tensor([j if c0 else i0, i0 if c0 else (j if c1 else i1),
                                         i1 if c1 else j])
            entries.clear()
        thr.copy_(td[:, :, 2])
        folds[0] += 1

    for j in range(tiles):
        for u in range(units):
            for h in range(2):
                ks = [16 * u + 4 * jj + 2 * h + e for jj in range(4) for e in range(2)]
                for t in range(threads):
                    for k in ks:
                        v = float(dist[j, t, k])
                        if v < float(thr[t, k]):
                            queues[t].append((v, j, k))
                if any(len(q) > cap - 8 for q in queues):
                    fold()
    if any(queues):
        fold()
    return td, ti, folds[0]


@pytest.mark.parametrize("units", [1, 2])
@pytest.mark.parametrize("cap", [16, 23, 30, 64])
@pytest.mark.parametrize("data", ["ties", "gauss"])
def test_k1_queue_fold_equals_class_top3_fold(units, cap, data):
    """The wide tile K1's threshold-and-queue fold keeps, per (query,
    class), the tiers class_top3_fold (the plain version's selection) keeps:
    the same 3 smallest finite (dist, row) in (dist, row) order, whatever
    the queue's capacity (a small one folds every few tiles, a large one
    rarely: thresholds go stale between folds and queue rows that no longer
    qualify), with ties at a class's third tier (integer distances in 0..5)
    and dead rows (+inf)."""
    gen = torch.Generator().manual_seed(units * 100 + cap)
    tiles, threads = 24, 8
    pairs = 16 * units
    if data == "ties":
        dist = torch.randint(0, 6, (tiles, threads, pairs), generator=gen).float()
    else:
        dist = torch.randn(tiles, threads, pairs, generator=gen)
    dist[torch.rand(tiles, threads, pairs, generator=gen) < 0.1] = float("inf")
    td, ti, folds = _queue_fold_replay(dist, units, cap)
    assert folds >= 1
    # the plain selection: each (thread, pair) a (query, class) whose rows are
    # j * C + its class, its distances dist[:, thread, pair]
    b, cls = threads, pairs
    rows = dist.permute(1, 0, 2)  # [thread = query, tile, pair = class]
    plain = torch.full((b, tiles, sf.C), float("inf"))
    plain[:, :, :cls] = rows
    best_d, best_i = sf.class_top3_init(b, "cpu")
    best_d, best_i = sf.class_top3_fold(best_d, best_i, plain.reshape(b, -1), 0)
    want_d = best_d[:, :, :cls].permute(0, 2, 1)  # [query, class, tier]
    want_i = best_i[:, :, :cls].permute(0, 2, 1)
    got_i = torch.where(ti >= 0, ti * sf.C + torch.arange(cls).view(1, -1, 1),
                        torch.full_like(ti, sf.INVALID_ID))
    assert torch.equal(td, want_d)
    assert torch.equal(got_i.to(want_i.dtype), want_i)


#: the band between the register-resident and the streamed query block,
#: each side of its slab edges, rows the producer copies (d % 8 != 0) and
#: the sentence-embedding widths 256 and 384
BAND_D = [129, 136, 160, 191, 192, 255, 256, 300, 320, 384, 447, 448]


@pytest.mark.parametrize("d", BAND_D)
@pytest.mark.parametrize("nq", [65, 128, 129, 200, 256, 300])
def test_band_batches_past_one_query_tile_take_the_wide_chunked_tile(d, nq):
    """At 128 < d <= 448 and B > 64, on the rows band_chunked gives it (the
    rows TMA can address, d % 8 == 0), K1 and K2 stream the query
    block's k chunk beside WG_WIDE_TILES ring tiles a stage at two query
    tiles, every stage holding the fewest slabs that keep its k chunks (so
    a row pads fewer zero slabs than it has chunks); the other rows keep the
    narrow tile's resident query block at two query tiles. Each plan fits
    the shared memory and the register budget, K1's queue and tile indices
    fit beside it, and K1 and K2 share the query tiles and splits; the
    narrow tile stays reachable by hand (qt=2, chunk_tiles=2)."""
    slabs = -(-d // 64)
    narrow = sf.wgmma_plan(nq, N, d, qt=2, chunk_tiles=sf.WG_CHUNK_TILES)
    assert (narrow.qt, narrow.units, narrow.chunked, narrow.a_regs, narrow.cs) == (2, 1, False, 0, slabs)
    plans = {}
    for kernel in ("bin_candidates", "count_below"):
        p = plans[kernel] = sf.wgmma_plan(nq, N, d, kernel=kernel)
        tps = p.tps if p.chunked else 1
        assert p.smem <= sf.MAX_SMEM_BYTES
        assert sf.wgmma_registers(p.a_regs, kernel, tps, p.units) <= sf.WG_REG_BUDGET
        if not sf.band_chunked(d):
            assert d % 8
            assert p == sf.wgmma_plan(nq, N, d, kernel=kernel, qt=2, chunk_tiles=sf.WG_CHUNK_TILES)
            continue
        assert p.chunked and p.tps == sf.WG_WIDE_TILES and p.a_regs == 4 * p.cs
        assert (p.qt, p.units, p.qblocks) == (2, 1, -(-nq // 128))
        chunks = -(-slabs // p.cs)
        assert chunks * p.cs - slabs < chunks  # padding: under a slab a chunk
        assert p.cs in (2, 3)  # the kernel's instances (KS = 4 cs)
        if kernel == "bin_candidates":
            assert p.queue >= sf.WG_QUEUE_MIN and p.tiles_per_split <= sf.WG_MAX_SPLIT_TILES
    k1, k2 = plans.values()
    assert (k1.qt, k1.g, k1.qblocks, k1.chunked, k1.tps, k1.splits, k1.tiles_per_split) == (
        k2.qt, k2.g, k2.qblocks, k2.chunked, k2.tps, k2.splits, k2.tiles_per_split)


#: plans the route gives batches of at most one query tile (K1, K2) and K11,
#: which the band's wide tile leaves as they were: (qt, g, qblocks,
#: a_regs, chunked, cs, tps, stages, splits, tiles_per_split, smem, units,
#: queue) over 2^20 rows
SMALL_BATCH_PLANS = {
    16: (1, 64, 1, 4, False, 1, 2, 8, 33, 125, 141312, 1, 0),
    100: (1, 64, 1, 8, False, 2, 1, 8, 33, 125, 141312, 1, 0),
    128: (1, 64, 1, 8, False, 2, 1, 8, 33, 125, 141312, 1, 0),
    136: (1, 64, 1, 0, False, 3, 1, 8, 33, 125, 231424, 1, 0),
    192: (1, 64, 1, 0, False, 3, 1, 8, 33, 125, 231424, 1, 0),
    256: (1, 64, 1, 0, False, 4, 1, 5, 33, 125, 203776, 1, 0),
    300: (1, 64, 1, 0, False, 5, 1, 4, 33, 125, 210944, 1, 0),
    384: (1, 64, 1, 0, False, 6, 1, 3, 33, 125, 201728, 1, 0),
    448: (1, 64, 1, 0, True, 4, 2, 2, 33, 126, 200704, 1, 0),
    768: (1, 64, 1, 0, True, 4, 2, 2, 33, 126, 200704, 1, 0),
    3073: (1, 64, 1, 0, True, 4, 2, 2, 33, 126, 200704, 1, 0),
    4096: (1, 64, 1, 0, True, 4, 2, 2, 33, 126, 200704, 1, 0),
}
#: K11's at block_tiles = 16 (tile 4096), B = 8 and 256
TREE_PLANS = {
    (128, 8): (1, 64, 1, 8, False, 2, 1, 7, 32, 128, 222208, 1, 0),
    (128, 256): (2, 32, 2, 8, False, 2, 2, 7, 8, 512, 222208, 1, 0),
    (256, 8): (1, 64, 1, 0, True, 2, 1, 3, 32, 128, 201728, 1, 0),
    (256, 256): (2, 32, 2, 0, False, 4, 1, 3, 8, 512, 218112, 1, 0),
    (384, 8): (1, 64, 1, 0, True, 2, 1, 3, 32, 128, 201728, 1, 0),
    (384, 256): (2, 32, 2, 0, True, 2, 1, 3, 8, 512, 226304, 1, 0),
    (768, 8): (1, 64, 1, 0, True, 2, 1, 3, 32, 128, 201728, 1, 0),
    (768, 256): (1, 64, 4, 0, True, 2, 1, 3, 8, 512, 201728, 1, 0),
    (4096, 256): (1, 64, 4, 0, True, 2, 1, 3, 8, 512, 201728, 1, 0),
}


@pytest.mark.parametrize("d", sorted(SMALL_BATCH_PLANS))
def test_small_batch_plans_do_not_move(d):
    """B <= 64 at every width: K1 and K2 keep the narrow tile's plans."""
    for nq in (1, 8, 64):
        for kernel in ("bin_candidates", "count_below"):
            assert tuple(sf.wgmma_plan(nq, N, d, kernel=kernel)) == SMALL_BATCH_PLANS[d]


@pytest.mark.parametrize("d, nq", sorted(TREE_PLANS))
def test_k11_plans_do_not_move(d, nq):
    """K11 keeps one unit a warpgroup and its plans at every width."""
    p = sf.wgmma_plan(nq, N, d, kernel="bin_candidates_tree", block_tiles=16)
    assert tuple(p) == TREE_PLANS[(d, nq)]
