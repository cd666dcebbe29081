"""The port's graph ops (vectorindex_tpu_torch.ops.graph) against the JAX
package's (vectorindex_tpu.ops.graph), on the CPU.

The same seeded numpy graphs and vectors go through both packages. On
integer-valued vectors every f32 product and sum is exact and every sort is
two-key, so the outputs must be equal. On gaussian vectors the two packages
round their dot products differently: beam ids must be equal except at a
rank whose JAX distance lies within rtol=2e-4, atol=2e-5 of a neighbouring
rank's (utils/parity), distances within that tolerance, and the discrete
outputs (descent ends, selections) equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vectorindex_tpu.ops import graph as jgraph
from vectorindex_tpu_torch.ops import graph
from vectorindex_tpu_torch.ops import rng as vrng
from vectorindex_tpu_torch.ops.topk import INVALID_ID
from vectorindex_tpu_torch.utils.parity import ATOL, RTOL, ids_match_up_to_ties

torch.set_num_threads(1)

N, D, B, M0, M1, N1 = 240, 16, 6, 8, 4, 48
DATA = ["integer", "gaussian"]


def _case(data: str, seed: int = 0):
    """(vecs [N, D], sqn [N], q [B, D], level-0 table [N, M0], upper level:
    node ids [N1], its table [64, M1] (rows past N1 empty), lookup [N])."""
    rng = np.random.default_rng(seed)
    if data == "integer":
        x = rng.integers(-8, 9, (N, D)).astype(np.float32)
        q = rng.integers(-8, 9, (B, D)).astype(np.float32)
    else:
        x = rng.standard_normal((N, D)).astype(np.float32)
        q = rng.standard_normal((B, D)).astype(np.float32)
    sqn = np.einsum("nd,nd->n", x, x, dtype=np.float32)
    nbrs0 = np.stack([rng.choice(np.delete(np.arange(N), i), M0, replace=False) for i in range(N)])
    nbrs0 = np.where(rng.random((N, M0)) < 0.15, -1, nbrs0).astype(np.int32)
    node_ids = np.sort(rng.choice(N, N1, replace=False))
    nbrs1 = np.full((64, M1), -1, dtype=np.int32)
    for r in range(N1):
        nbrs1[r] = rng.choice(np.delete(node_ids, r), M1, replace=False)
    lookup = np.full(N, -1, dtype=np.int32)
    lookup[node_ids] = np.arange(N1, dtype=np.int32)
    return x, sqn, q, nbrs0, node_ids, nbrs1, lookup


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("data", DATA)
def test_greedy_descent_matches_jax(data):
    x, sqn, q, _, node_ids, nbrs1, lookup = _case(data, seed=1)
    entry = np.full(B, node_ids[0], dtype=np.int32)
    (jq, jx, js, jn, jl, je), (tq, tx, ts, tn, tl, te) = _both(q, x, sqn, nbrs1, lookup, entry)
    want = np.asarray(jgraph.greedy_descent(jq, jx, js, jn, jl, je, steps=8))
    got = graph.greedy_descent(tq, tx, ts, tn, tl, te, steps=8).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isin(got, node_ids).all()  # the walk stays on its level


@pytest.mark.parametrize("data", DATA)
@pytest.mark.parametrize("expand", [1, 4])
@pytest.mark.parametrize("level", ["level0", "upper"])
def test_beam_search_matches_jax(data, expand, level):
    x, sqn, q, nbrs0, node_ids, nbrs1, lookup = _case(data, seed=2)
    if level == "level0":
        nbrs, lk, entry = nbrs0, None, np.full(B, 7, dtype=np.int32)
    else:
        nbrs, lk, entry = nbrs1, lookup, np.full(B, node_ids[3], dtype=np.int32)
    ef = 24
    iters = -(-ef // expand)
    (jq, jx, js, jn, je), (tq, tx, ts, tn, te) = _both(q, x, sqn, nbrs, entry)
    jl = None if lk is None else jnp.asarray(lk)
    tl = None if lk is None else torch.from_numpy(lk)
    want = jgraph.beam_search(jq, jx, js, jn, jl, je, ef=ef, iters=iters, expand=expand)
    got = graph.beam_search(tq, tx, ts, tn, tl, te, ef=ef, iters=iters, expand=expand)
    wd, wi = np.asarray(want.dists), np.asarray(want.ids)
    gd, gi = got.dists.numpy(), got.ids.numpy()
    if data == "integer":
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gd, wd)
    else:
        assert ids_match_up_to_ties(gi, wi, wd, ef)
        np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=ATOL)
    live = gi != INVALID_ID
    assert live[:, 0].all() and (np.diff(gd, axis=1)[live[:, 1:]] >= 0).all()
    if level == "upper":
        assert np.isin(gi[live], node_ids).all()
    for row in gi:  # no id twice in a beam
        ids = row[row != INVALID_ID]
        assert len(set(ids.tolist())) == len(ids)


def _candidates(x, sqn, seed, c=12, ef=20, invalid_tail=5):
    """Sorted (dist, id) candidate lists of c new points (rows 0..c-1 of x)
    over distinct other ids, the last `invalid_tail` slots INVALID."""
    rng = np.random.default_rng(seed)
    cand_i = np.stack([rng.choice(np.arange(c, N), ef, replace=False) for _ in range(c)])
    cand_i = cand_i.astype(np.int32)
    g = np.einsum("cd,ced->ce", x[:c], x[cand_i])
    d = np.maximum(sqn[:c, None] + sqn[cand_i] - 2.0 * g, 0.0).astype(np.float32)
    cand_i[:, ef - invalid_tail :] = INVALID_ID
    d[:, ef - invalid_tail :] = np.inf
    order = np.lexsort((cand_i, d), axis=1)
    return np.take_along_axis(d, order, axis=1), np.take_along_axis(cand_i, order, axis=1)


@pytest.mark.parametrize("data", DATA)
@pytest.mark.parametrize("m", [4, 8, 20])
def test_select_neighbors_diverse_matches_jax(data, m):
    x, sqn, *_ = _case(data, seed=3)
    cd, ci = _candidates(x, sqn, seed=4)
    (jd, ji, jx, js), (td, ti, tx, ts) = _both(cd, ci, x, sqn)
    want = np.asarray(jgraph.select_neighbors_diverse(jd, ji, jx, js, m=m))
    got = graph.select_neighbors_diverse(td, ti, tx, ts, m=m).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (12, min(m, 20))
    # selections first, then the nearest pruned, INVALID only at the end
    for row in got:
        live = row != INVALID_ID
        assert not (live[1:] & ~live[:-1]).any()


@pytest.mark.parametrize("data", DATA)
def test_prune_neighbors_matches_jax(data):
    x, sqn, *_ = _case(data, seed=5)
    rng = np.random.default_rng(6)
    node_ids = rng.choice(N, 10, replace=False).astype(np.int32)
    lists = np.stack([rng.choice(np.delete(np.arange(N), n), 2 * M1, replace=False) for n in node_ids])
    lists = lists.astype(np.int32)
    lists[:3, -3:] = INVALID_ID  # short lists, INVALID padded
    (jn, jl, jx, js), (tn, tl, tx, ts) = _both(node_ids, lists, x, sqn)
    want = np.asarray(jgraph.prune_neighbors(jn, jl, jx, js, m=M1))
    got = graph.prune_neighbors(tn, tl, tx, ts, m=M1).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (10, M1)
    for n, row, lst in zip(node_ids, got, lists):
        assert n not in row and np.isin(row[row != INVALID_ID], lst).all()


def test_sample_levels_geometric_and_capped():
    """The JAX law (⌊−ln u / ln M⌋, capped) from a torch generator: the
    draws are the generator's (threefry is not replayed), so the law is
    checked, as tests/test_hnsw.py checks the JAX draws."""
    levels = graph.sample_levels(vrng.make_generator(0), 20000, 16).numpy()
    assert levels.dtype == np.int32 and levels.min() == 0 and levels.max() <= graph.LEVEL_CAP
    assert abs((levels == 0).mean() - 0.9375) < 0.01  # P(level 0) = 1 - 1/M
    assert abs((levels >= 1).mean() - 1 / 16) < 0.01
    again = graph.sample_levels(vrng.make_generator(0), 20000, 16).numpy()
    np.testing.assert_array_equal(levels, again)
    other = graph.sample_levels(vrng.make_generator(1), 20000, 16).numpy()
    assert not np.array_equal(levels, other)
    capped = graph.sample_levels(vrng.make_generator(0), 20000, 2, cap=1).numpy()
    assert capped.max() == 1
    jlv = np.asarray(jgraph.sample_levels(jax.random.PRNGKey(0), 20000, 16))
    assert abs((jlv == 0).mean() - (levels == 0).mean()) < 0.01
