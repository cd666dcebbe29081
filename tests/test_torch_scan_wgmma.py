"""The wgmma design of K1, K2 and K11 (kernels/scan_fused.wgmma_plan and
csrc scan_wgmma_kernel's thread map) on the CPU: no JAX, no card.

The kernel itself runs only on the card (tests/test_torch_cuda.py and
chip_smoke.py hold it to its plain versions there); these tests check what
sizes and maps it: every plan over the route's widths and batches fits the
H100's shared memory and the consumers' register budget, K1, K2 and K11
take one tile geometry for one (B, d) (the exactness proof needs K2 to
recompute K1's floats bit for bit), K11's splits hold whole blocks, and the
thread map owns every (query, class) pair of a CTA once.
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
    assert p.smem == sf.wgmma_smem(d, p.qt, p.a_regs, p.chunked, p.cs, p.tps, p.stages)[1]
    # setmaxnreg: two consumer warpgroups and the producer's share an SM's
    # 65,536 registers
    assert 128 * (2 * sf.WG_CONSUMER_REGS + sf.WG_PRODUCER_REGS) <= 65_536
    assert sf.WG_THREADS == 3 * 128
    for kernel in KERNELS:
        for metric in (Metric.L2, Metric.COSINE):
            placed = sf.wgmma_plan(nq, N, d, a_mode=sf.wgmma_placement(kernel, metric, d),
                                   kernel=kernel)
            assert placed.smem <= sf.MAX_SMEM_BYTES
            assert placed.smem == sf.wgmma_smem(d, placed.qt, placed.a_regs, placed.chunked,
                                                placed.cs, placed.tps, placed.stages,
                                                kernel == "bin_candidates_tree")[1]
            tps = placed.tps if placed.chunked else 1  # accumulators a warpgroup holds
            assert sf.wgmma_registers(placed.a_regs, kernel, tps) <= sf.WG_REG_BUDGET < sf.WG_CONSUMER_REGS
    assert 2 <= p.stages <= sf.WG_MAX_STAGES
    assert p.qt in (1, 2) and p.g * p.qt == 64 and sf.C % p.g == 0
    assert p.qblocks * 64 * p.qt >= nq > (p.qblocks - 1) * 64 * p.qt
    if nq <= 128 and d <= 256:
        assert p.qblocks == 1  # every query in one CTA: the corpus read once a pass
    assert (p.a_regs > 0) == (slabs <= 2) and p.a_regs in (0, 4 * slabs)
    if p.chunked:
        assert p.tps == sf.WG_CHUNK_TILES and p.qt == 1 and p.cs <= slabs
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
    """One tile geometry for one (B, d), whatever the kernel: the same query
    tiles, class groups and query blocks, and the same placement of the
    query block for K1, K2 and K11 but where wgmma_placement moves cosine
    K1's into shared memory (the placement does not change the floats);
    K11's tiers take shared memory beside the same ring geometry where it
    fits; K11's splits start on block boundaries (block_tiles = tile / 256
    for tiles 4096 and 8192) and still cover the corpus."""
    plans = {k: sf.wgmma_plan(nq, N, d, block_tiles=block_tiles if k == "bin_candidates_tree" else 1,
                              a_mode=sf.wgmma_placement(k, metric, d), kernel=k) for k in KERNELS}
    k1, k11, k2 = (plans[k] for k in KERNELS)
    assert (k1.qt, k1.g, k1.qblocks) == (k2.qt, k2.g, k2.qblocks) == (k11.qt, k11.g, k11.qblocks)
    if metric != Metric.COSINE:
        assert _geometry(k1) == _geometry(k2)
        assert _geometry(k1) == _geometry(sf.wgmma_plan(nq, N, d, block_tiles=block_tiles))
    assert _geometry(k2) == _geometry(sf.wgmma_plan(nq, N, d))  # K2 always the plan's own
    assert sf.wgmma_placement("bin_candidates_tree", metric, d) is None
    assert k11.a_regs == k2.a_regs
    if k11.chunked != k2.chunked:  # the tiers leave no room for the resident query block
        assert sf._wgmma_ring(d, k2.qt, 0, False, True)[2] < 3
    assert k11.smem == sf.wgmma_smem(d, k11.qt, k11.a_regs, k11.chunked, k11.cs, k11.tps,
                                     k11.stages, True)[1]
    assert k11.tiles_per_split % block_tiles == 0
    ntiles = N // sf.C
    assert (k11.splits - 1) * k11.tiles_per_split < ntiles <= k11.splits * k11.tiles_per_split


@pytest.mark.parametrize("nq", [1, 64, 65, 128, 129, 256])
def test_wgmma_thread_map_owns_each_pair_once(nq):
    """The consumers' 256 threads x 16 pairs cover the CTA's 64 qt queries x
    64 / qt classes once each; a thread's pairs are 2 query rows against 8
    classes."""
    p = sf.wgmma_plan(nq, N, 128)
    queries, classes = sf.wgmma_thread_map(p)
    assert queries.shape == classes.shape == (256, 16)
    key = queries * 1000 + classes
    assert key.unique().numel() == 256 * 16 == 64 * p.qt * p.g
    assert queries.min() == 0 and queries.max() == 64 * p.qt - 1
    assert classes.min() == 0 and classes.max() == p.g - 1
    assert all(len(set(r.tolist())) == 2 for r in queries)
    assert all(len(set(r.tolist())) == 8 for r in classes)


@pytest.mark.parametrize(
    "kwargs, match",
    [(dict(d=-1), "wgmma route"), (dict(d=0), "wgmma route"),
     (dict(d=129, a_mode="regs"), "registers"), (dict(d=128, a_mode="tma"), "a_mode"),
     (dict(d=128, qt=4), "qt"), (dict(d=128, kernel="bin_candidates_fma"), "plans"),
     (dict(d=4096, chunk_tiles=3), "chunk_tiles"),
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
    assert (p.a_regs, p.chunked) == {"regs": (8, False), "smem": (0, False),
                                     "chunked": (0, True)}[a_mode]


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
    rows (d > 448), the query block's k chunk rides in each stage at one
    query tile beside WG_CHUNK_TILES tiles' k chunk, in stages of at most
    WG_CHUNK_RING's bytes, as many as its fewest; the query block is made
    at any width."""
    p = sf.wgmma_plan(nq, N, d)
    assert p.chunked and p.qt == 1 and p.tps == sf.WG_CHUNK_TILES == 2 and p.a_regs == 0
    assert sf._wgmma_ring(d, 1, 0, False, False)[2] < 3
    most, fewest = sf.WG_CHUNK_RING[p.tps]
    assert p.cs * (p.tps * p.g + 64 * p.qt) * 128 <= most and p.stages >= fewest
    assert (p.cs, p.stages) == (4, 2)
    qp = sf._query_block(torch.zeros(nq, d), p)
    assert qp.shape == (p.qblocks * 64, -(-d // 64) * 64)
    assert sf.wgmma_plan(nq, N, d, a_mode="smem") == p  # the default placement past d = 448


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
@pytest.mark.parametrize("chunk_tiles", [1, 2])
def test_chunked_stages_hold_one_or_two_tiles(d, chunk_tiles):
    """A chunked plan's stage holds chunk_tiles tiles' k chunk beside the
    query block's (the A/B sweep's variants); two tiles hold two
    accumulators within the register budget, and K11 keeps one tile."""
    for kernel in ("bin_candidates", "count_below"):
        p = sf.wgmma_plan(256, N, d, a_mode="chunked", kernel=kernel, chunk_tiles=chunk_tiles)
        assert p.chunked and p.tps == chunk_tiles and p.stages >= sf.WG_CHUNK_RING[chunk_tiles][1]
        assert p.smem == sf.wgmma_smem(d, p.qt, 0, True, p.cs, p.tps, p.stages)[1] <= sf.MAX_SMEM_BYTES
        assert sf.wgmma_registers(0, kernel, p.tps) <= sf.WG_REG_BUDGET
    tree = sf.wgmma_plan(256, N, d, a_mode="chunked", kernel="bin_candidates_tree", block_tiles=16)
    assert tree.tps == 1 and tree.tiles_per_split % 16 == 0
