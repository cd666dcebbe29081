"""The FMA design's launch plans (vectorindex_tpu_torch.kernels.scan_fused
fma_plan) on the CPU: every plan fits the card's shared memory and the
register budget, and a replay of the kernel's thread mapping over a CTA and
the grid owns every (query, class) pair once and covers every tile once.

The kernels themselves run only on the card (tests/test_torch_cuda.py holds
them to their first design and their plain versions); these tests need no
JAX and no card.
"""

import numpy as np
import pytest
import torch

from vectorindex_tpu_torch.kernels import scan_fused as sf
from vectorindex_tpu_torch.utils.config import Metric

KERNELS = ("bin_candidates", "count_below")
DTYPES = [torch.float32, torch.bfloat16]
N = 1 << 20


@pytest.mark.parametrize("b", [1, 7, 8, 9, 16, 17, 64, 256, 300])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", [1, 8, 100, 128, 129, 768, 2401, 3072, 7264, 7265, 8192, 16384])
def test_plan_fits_shared_memory_and_registers(d, dtype, b):
    """Both kernels' plans fit 227 KB and the register budget, and fill one
    wave of the card with splits of whole stages; small batches put every
    query in one block."""
    for kernel in KERNELS:
        p = sf.fma_plan(b, N, d, dtype, kernel)
        itemsize = 2 if dtype == torch.bfloat16 else 4
        assert p.smem == sf.fma_smem(d, itemsize, p.tm, p.qb, p.g, p.kc, p.stages)
        assert p.smem <= sf.MAX_SMEM_BYTES
        assert sf.fma_registers(p.tm, kernel) <= sf.FMA_REG_BUDGET
        assert p.qb in sf.FMA_QUERY_BLOCKS[p.tm] and p.qb * p.g == sf.FMA_THREADS * p.tm
        assert sf.C % p.g == 0 and p.kc % 16 == 0 and 2 <= p.stages <= sf.FMA_MAX_STAGES
        assert p.tiles_per_split % p.tm == 0
        assert (p.splits - 1) * p.tiles_per_split < N // sf.C <= p.splits * p.tiles_per_split
        ctas = -(-b // p.qb) * (sf.C // p.g) * p.splits
        assert sf.SMS // 2 < ctas <= sf.SMS
        if b <= sf.FMA_SMALL_BATCH:
            # a byte-bound pass: every query in one block, the 4 x 4 tile
            assert (p.tm, p.qb, p.g) == (4, 16, 64)
        else:
            assert p.tm == 8 and (p.qb >= b or p.qb == sf.FMA_BALANCED_QB[8])


@pytest.mark.parametrize("tm", [4, 8])
@pytest.mark.parametrize("kernel", KERNELS)
def test_a_thread_owns_tm_pairs_within_the_register_budget(kernel, tm):
    """A thread owns one class and tm queries: K1's tiers are 6 tm
    registers beside the tm x tm accumulators and one k step's fragments."""
    own = 2 * sf.TIERS * tm if kernel == "bin_candidates" else 3 * tm
    assert sf.fma_registers(tm, kernel) == tm * tm + 8 * tm + own <= sf.FMA_REG_BUDGET


def _replay(p, nq, n):
    """Owners of each (query, class) pair over the grid, and of each tile
    over the splits, from fma_thread_map and the grid's (query block, class
    group, split) order."""
    cls, queries = (t.numpy() for t in sf.fma_thread_map(p))
    qblocks, groups = -(-nq // p.qb), sf.C // p.g
    pairs = np.zeros((qblocks * p.qb, sf.C), dtype=np.int64)
    tiles = np.zeros(n // sf.C, dtype=np.int64)
    for bx in range(qblocks):
        for by in range(groups):
            q0, c0 = bx * p.qb, by * p.g
            for t in range(sf.FMA_THREADS):
                pairs[q0 + queries[t], c0 + cls[t]] += 1
    for bz in range(p.splits):
        t0 = bz * p.tiles_per_split
        tiles[t0:min(t0 + p.tiles_per_split, n // sf.C)] += 1
    return cls, pairs, tiles


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("b, n, d, dtype", [
    (256, N, 128, torch.float32), (8, N, 128, torch.float32), (64, 1 << 17, 3072, torch.bfloat16),
    (300, 66_304, 129, torch.float32), (17, 66_304, 768, torch.float32), (1, 256, 2401, torch.bfloat16),
])
def test_thread_map_owns_every_pair_once(kernel, b, n, d, dtype):
    p = sf.fma_plan(b, n, d, dtype, kernel)
    cls, pairs, tiles = _replay(p, b, n)
    # every (query, class) pair of the grid, padded queries included, once
    assert (pairs == 1).all()
    assert (tiles == 1).all()
    # a thread's micro-tile rows are its class's row in each of a stage's tm
    # tiles: the same class (row mod C) in every tile of its split
    assert cls.shape == (sf.FMA_THREADS,) and cls.max() < p.g
    t0 = p.tiles_per_split  # the second split's first stage
    for c0 in range(0, sf.C, p.g):
        rows = [(t0 + i) * sf.C + c0 + cls for i in range(p.tm)]
        assert all((r % sf.C == c0 + cls).all() for r in rows)
        assert all((b - a == sf.C).all() for a, b in zip(rows, rows[1:]))  # rows grow


@pytest.mark.parametrize("override, match", [
    (dict(tm=6), "micro-tile"), (dict(qb=48), "qb=48"), (dict(kc=24), "multiple of 16"),
    (dict(stages=5), "stages"), (dict(tm=8, qb=32, kc=512), "no FMA"),
])
def test_plans_that_cannot_launch_raise(override, match):
    with pytest.raises(ValueError, match=match):
        sf.fma_plan(64, N, 768, torch.float32, "bin_candidates", **override)


@pytest.mark.parametrize("fn", ["bin_candidates_fma_v1", "count_below_fma_v1", "bin_candidates_fma",
                                "count_below_fma"])
def test_timing_only_wrappers_raise_on_cpu_tensors(fn):
    """The first design (and the FMA design's timing entries) run only on the
    card: a CPU tensor raises instead of taking a plain version."""
    q, x = torch.randn(3, 16), torch.randn(sf.C, 16)
    bias = (x * x).sum(dim=1)
    args = (q, x, bias, None) + ((torch.zeros(3),) if fn.startswith("count") else ())
    sf.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        getattr(sf, fn)(*args, metric=Metric.L2)
    assert not any(sf.LAUNCHES.values())
