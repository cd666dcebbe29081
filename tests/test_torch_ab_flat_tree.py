"""The port's K11 (`kernels/scan_fused.bin_candidates_tree`, the round-5 A/B
kernel of scripts/ab_flat_tree.py, mode "tree") against the JAX kernel body.

scripts/ab_flat_tree.py cannot be imported: it builds a 1M-row corpus and
times TPU kernels when it loads. So its kernel body `_kernel_param` is read
from the source with `ast` and run through `pl.pallas_call(...,
interpret=True)` with the script's grid (query block `_query_block(B)`, one
grid step per `tile` rows); the script stays as it is.

On the CPU the port's wrapper runs its plain version. Tolerance: finite
tiers at the same places, distances within rtol=1e-5 (bf16 products are
exact; f32 sums in another order), rows equal. Unfilled tiers: the port
returns (+inf, INVALID_ID), the JAX body (+inf, 0) — the reference's id-0
fill (ROADMAP Queue 3), pinned here. The CUDA kernel is held against the
plain version on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import ast
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from vectorindex_tpu.kernels import scan_fused as jfused
from vectorindex_tpu.ops.topk import INVALID_DIST as JINVALID_DIST
from vectorindex_tpu.utils.config import Metric as JMetric
from vectorindex_tpu_torch.kernels import scan_fused as sf
from vectorindex_tpu_torch.ops.topk import INVALID_ID, topk
from vectorindex_tpu_torch.utils.config import Metric
from vectorindex_tpu_torch.utils.parity import ids_match_up_to_ties

torch.set_num_threads(1)

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "ab_flat_tree.py"
N, D, B = 2048, 32, 8


def _kernel_param():
    """scripts/ab_flat_tree.py's `_kernel_param`, compiled alone in a
    namespace holding the names it reads."""
    tree = ast.parse(SCRIPT.read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "_kernel_param")
    ns = {"jax": jax, "jnp": jnp, "pl": pl, "C": jfused.C, "INVALID_DIST": JINVALID_DIST,
          "_dist_tile": jfused._dist_tile}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(SCRIPT), "exec"), ns)
    return ns["_kernel_param"]


def _jax_tree(q, x, bias, metric, tile):
    """The script's `_bin_candidates_param(mode="tree")` in interpret mode
    -> (dist [B, 3, C], row [B, 3, C])."""
    nq, dd = q.shape
    tb = jfused._query_block(nq)
    c = jfused.C
    grid_spec = pl.GridSpec(
        grid=(nq // tb, x.shape[0] // tile),
        in_specs=[pl.BlockSpec((tb, dd), lambda qb, i: (qb, 0)),
                  pl.BlockSpec((tile, dd), lambda qb, i: (i, 0)),
                  pl.BlockSpec((1, tile), lambda qb, i: (0, i))],
        out_specs=(pl.BlockSpec((tb, c), lambda qb, i: (qb, 0)),) * 6,
    )
    outs = pl.pallas_call(
        partial(_kernel_param(), metric=JMetric(metric.value), tb=tb, tile=tile, mode="tree"),
        out_shape=(jax.ShapeDtypeStruct((nq, c), jnp.float32),
                   jax.ShapeDtypeStruct((nq, c), jnp.int32)) * 3,
        grid_spec=grid_spec,
        interpret=True,
    )(q, x, bias)
    outs = [np.asarray(o) for o in outs]
    return np.stack(outs[0::2], axis=1), np.stack(outs[1::2], axis=1)


def _bf16(a):
    return torch.from_numpy(a).bfloat16().float().numpy()


def _case(seed):
    """Seeded bf16 corpus with dead rows: class 7 dead everywhere (3 unfilled
    tiers), class 9 live only in rows < 512 (one or two filled tiers), 10% of
    the rest dead -> (q f32, x as bf16-exact f32, sqnorms, live mask)."""
    rng = np.random.default_rng(seed)
    x = _bf16(rng.standard_normal((N, D), dtype=np.float32))
    q = _bf16(rng.standard_normal((B, D), dtype=np.float32))
    live = rng.random(N) >= 0.1
    rows = np.arange(N)
    live[rows % sf.C == 7] = False
    live[(rows % sf.C == 9) & (rows >= 512)] = False
    return q, x, (x.astype(np.float64) ** 2).sum(1).astype(np.float32), live


def _bias(sq, live, metric):
    return np.where(live, sq if metric == Metric.L2 else 0.0, np.inf).astype(np.float32)


@pytest.mark.parametrize("tile", [512, 1024])
@pytest.mark.parametrize("metric", [Metric.L2, Metric.INNER_PRODUCT], ids=lambda m: m.value)
def test_tree_candidates_match_jax_body(metric, tile):
    q, x, sq, live = _case(31)
    bias = _bias(sq, live, metric)
    jd, ji = _jax_tree(jnp.asarray(q), jnp.asarray(x).astype(jnp.bfloat16),
                       jnp.asarray(bias)[None, :], metric, tile)
    sf.reset_launches()
    pd, pi = sf.bin_candidates_tree(torch.from_numpy(q), torch.from_numpy(x).bfloat16(),
                                    torch.from_numpy(bias), metric=metric, tile=tile)
    assert sf.LAUNCHES["bin_candidates_tree"] == 0  # a CPU tensor takes the plain version
    pd, pi = pd.numpy(), pi.numpy()
    finite = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(pd), finite)
    np.testing.assert_allclose(pd[finite], jd[finite], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(pi[finite], ji[finite])
    # unfilled tiers: INVALID_ID in the port, id 0 in the JAX body
    assert (~finite).any() and (~finite[:, :, 7]).all()
    assert (pi[~finite] == INVALID_ID).all() and (ji[~finite] == 0).all()
    # one candidate per block: a class's tiers come from distinct blocks
    blocks = np.where(finite, pi // tile, -np.arange(3)[None, :, None] - 1)
    assert (blocks[:, 0] != blocks[:, 1]).all() and (blocks[:, 1] != blocks[:, 2]).all()


def test_tree_ref_matches_numpy_oracle():
    """Integer-valued data (exact distances, real ties): per (query, class,
    block) the smallest (dist, row), then the 3 smallest of those."""
    rng = np.random.default_rng(32)
    n, tile, b = 4 * 512, 512, 3
    x = rng.integers(-3, 4, size=(n, 8)).astype(np.float32)
    q = rng.integers(-3, 4, size=(b, 8)).astype(np.float32)
    x[[5, 5 + sf.C, 5 + 3 * sf.C, 5 + 4 * sf.C]] = q[0]  # ties in one class and block
    sq = (x.astype(np.float64) ** 2).sum(1)
    dist = sq[None, :] - 2.0 * (q.astype(np.float64) @ x.T.astype(np.float64))
    got_d, got_i = sf.bin_candidates_tree_ref(
        torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(sq.astype(np.float32)),
        metric=Metric.L2, tile=tile)
    for qi in range(b):
        for c in range(sf.C):
            cands = []
            for start in range(0, n, tile):
                rows = np.arange(start + c, start + tile, sf.C)
                best = rows[np.lexsort((rows, dist[qi, rows]))[0]]
                cands.append((dist[qi, best], best))
            want = sorted(cands)[: sf.TIERS]
            np.testing.assert_array_equal(got_d[qi, :, c].numpy(), [w[0] for w in want])
            np.testing.assert_array_equal(got_i[qi, :, c].numpy(), [w[1] for w in want])
    # rows 5 and 5 + C tie in block 0: the first row stands for the block
    assert list(got_i[0, :, 5].numpy()) == [5, 5 + 3 * sf.C, 5 + 4 * sf.C]


def test_tree_candidates_flag_what_they_miss():
    """The A/B's exactness check: tree candidates -> tau -> count_below ->
    flags; on rows exact in both, the ids equal scan_topk_fused's."""
    q, x, sq, live = _case(33)
    # query 1's two nearest rows share class 40 and block 0: the tree keeps one
    x[[40, 40 + sf.C]] = q[1]
    live[[40, 40 + sf.C]] = True
    sq = (x.astype(np.float64) ** 2).sum(1).astype(np.float32)
    k = 10
    xt, sqt, vt = torch.from_numpy(x).bfloat16(), torch.from_numpy(sq), torch.from_numpy(live)
    qt = torch.from_numpy(q)
    bias = torch.from_numpy(_bias(sq, live, Metric.L2))
    cd, ci = sf.bin_candidates_tree(qt, xt, bias, metric=Metric.L2, tile=512)
    sd, si = topk(cd.view(B, -1), k, ids=ci.view(B, -1), strict_ties=True)
    tau = sd[:, k - 1].contiguous()
    lt, le = sf.count_below_ref(qt, xt, bias, None, tau, metric=Metric.L2)
    exact = (lt == (sd < tau[:, None]).sum(1)) & (le == k)
    fd, fi, fex = sf.scan_topk_fused(qt, xt, sqt, vt, metric=Metric.L2, k=k)
    both = exact & fex
    assert both.any()
    assert ids_match_up_to_ties(si[both].numpy(), fi[both].numpy(), fd[both].numpy(), k)
    # 8 rows a class: 4 blocks keep 4 candidates a class, a query is flagged
    # exactly when a class holds 2 of its top-k within one block
    d64 = sq[None, :].astype(np.float64) - 2.0 * q.astype(np.float64) @ x.T.astype(np.float64)
    d64[:, ~live] = np.inf
    top = np.argsort(d64, axis=1, kind="stable")[:, :k]
    crowded = np.array([len({(r % sf.C, r // 512) for r in row}) < k for row in top])
    assert crowded[1]
    np.testing.assert_array_equal(~exact.numpy(), crowded)


def test_tree_wrapper_rejects_what_the_kernel_does_not_take():
    q, x, sq, live = _case(34)
    qt, xt, bias = torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(sq)
    with pytest.raises(ValueError, match="L2/IP"):
        sf.bin_candidates_tree(qt, xt.bfloat16(), bias, metric=Metric.COSINE, tile=512)
    with pytest.raises(TypeError, match="bf16"):
        sf.bin_candidates_tree(qt, xt, bias, metric=Metric.L2, tile=512)
    for tile in (300, 4096):  # not a multiple of C; does not divide n
        with pytest.raises(ValueError, match="tile"):
            sf.bin_candidates_tree(qt, xt.bfloat16(), bias, metric=Metric.L2, tile=tile)
    with pytest.raises(ValueError, match="CUDA"):
        sf.bin_candidates_fma(qt, xt.bfloat16(), bias, None, metric=Metric.L2)


@pytest.mark.parametrize(
    "nq, d, want",
    [(256, 128, (8, 1, 8)), (8, 128, (1, 8, 1)), (13, 100, (1, 8, 1)), (40, 64, (4, 2, 4)),
     (256, 1024, (4, 1, 1))],
)
def test_tensor_core_geometry(nq, d, want):
    """Query warps cover the batch (up to 8 warps of 16), the other warps
    take classes, a stage holds about 128 rows; wide rows shrink the
    stages, then the warps, to fit 227 KB."""
    qw, cw, tps = sf._mma_config(nq, d)
    assert (qw, cw, tps) == want
    assert sf._mma_smem(d, qw, cw, tps) <= sf.MAX_SMEM_BYTES
    # K11's splits start on block boundaries; K1 and K2 share one geometry
    n = 1 << 20
    g1, g11 = sf._grid(nq, n, d, mma=True), sf._grid(nq, n, d, mma=True, block_tiles=16)
    assert g1[:3] == g11[:3] == (qw, cw, tps)
    splits, per = g11[3:]
    assert per % 16 == 0 and per % tps == 0 and (splits - 1) * per < n // sf.C <= splits * per
    with pytest.raises(ValueError, match="shared-memory"):
        sf._mma_config(8, 8000)
