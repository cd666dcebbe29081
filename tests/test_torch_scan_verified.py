"""The port's verified two-phase scan (ops/scan.scan_topk_verified) against
the JAX package's, against the port's strict path, and FlatIndex's routing
to it. Everything runs on the CPU.

  - The same seeded numpy inputs go through both packages' functions:
    distances within rtol=2e-4, atol=2e-5 on the ascending distance (f32
    sums in another order), ids equal except at a rank whose JAX distance
    lies within that tolerance of a neighbouring rank's (utils/parity),
    the exact flags equal.
  - On tie-free gaussian data the verified scan equals the port's strict
    path bit for bit: both score the same block and the candidates are the
    exact smallest.
  - FlatIndex at capacity 2^17 (LARGE_SCAN_THRESHOLD, not lowered) takes
    the fused kernels for L2/IP/cosine at k <= 2C, the verified scan for
    manhattan/chebyshev and larger k once B x capacity reaches
    VERIFIED_MIN_BLOCK (B = 32 here), and the strict path below either;
    telemetry names the path that ran.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorindex_tpu_torch.models.flat as tflat
from vectorindex_tpu.models.flat import FlatIndex as JFlatIndex
from vectorindex_tpu.ops import scan as jscan
from vectorindex_tpu.utils.config import Metric as JMetric
from vectorindex_tpu_torch.kernels import scan_fused as sf
from vectorindex_tpu_torch.ops import scan
from vectorindex_tpu_torch.ops.topk import INVALID_ID
from vectorindex_tpu_torch.utils.config import Metric
from vectorindex_tpu_torch.utils.parity import ATOL, RTOL, ids_match_up_to_ties
from vectorindex_tpu_torch.utils.telemetry import TELEM

torch.set_num_threads(1)

N, D, B, K = 4096, 32, 16, 10


def _data(n=N, d=D, b=B, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, d)).astype(np.float32),
            rng.standard_normal((n, d)).astype(np.float32))


def _norms(x):
    sq = np.einsum("nd,nd->n", x, x).astype(np.float32)
    inv = np.where(sq > 0, 1.0 / np.sqrt(np.maximum(sq, 1e-30)), 0.0).astype(np.float32)
    return sq, inv


def _both(q, x, metric, k, valid=None):
    """(port dist, ids, exact), (JAX dist, ids, exact) as numpy."""
    sq, inv = _norms(x)
    t = scan.scan_topk_verified(
        torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(sq), torch.from_numpy(inv),
        None if valid is None else torch.from_numpy(valid), metric=metric, k=k,
    )
    j = jscan.scan_topk_verified(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(sq), jnp.asarray(inv),
        None if valid is None else jnp.asarray(valid), metric=JMetric(metric.value), k=k,
    )
    return tuple(a.numpy() for a in t), tuple(np.asarray(a) for a in j)


def _assert_matches_jax(got, want, k):
    (gd, gi, ge), (wd, wi, we) = got, want
    np.testing.assert_array_equal(ge, we)
    finite = np.isfinite(wd)
    np.testing.assert_array_equal(np.isfinite(gd), finite)
    np.testing.assert_allclose(gd[finite], wd[finite], rtol=RTOL, atol=ATOL)
    assert ids_match_up_to_ties(np.where(finite, gi, -1), np.where(finite, wi, -1), wd, k)


def _strict(q, x, metric, k, valid=None):
    sq, inv = _norms(x)
    d, i = scan.scan_topk_strict(
        torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(sq), torch.from_numpy(inv),
        None if valid is None else torch.from_numpy(valid), metric=metric, k=k,
    )
    return d.numpy(), i.numpy()


def test_candidate_count_matches_the_reference():
    for k in (1, 10, 32, 64, 65, 100, 600):
        assert scan.candidate_count(k) == jscan.candidate_count(k)
    assert scan.DEFAULT_CANDIDATES == jscan.DEFAULT_CANDIDATES


@pytest.mark.parametrize(
    "metric", [Metric.L2, Metric.INNER_PRODUCT, Metric.COSINE, Metric.MANHATTAN],
    ids=lambda m: m.value,
)
def test_verified_matches_jax_and_strict(metric):
    q, x = _data()
    got, want = _both(q, x, metric, K)
    assert got[2].all()
    _assert_matches_jax(got, want, K)
    sd, si = _strict(q, x, metric, K)
    np.testing.assert_array_equal(got[1], si)
    np.testing.assert_array_equal(got[0], sd)


def test_filtered_verified_matches_jax_and_strict():
    q, x = _data(seed=1)
    valid = np.random.default_rng(2).random(N) < 0.3
    got, want = _both(q, x, Metric.L2, K, valid)
    _assert_matches_jax(got, want, K)
    sd, si = _strict(q, x, Metric.L2, K, valid)
    np.testing.assert_array_equal(got[1], si)
    np.testing.assert_array_equal(got[0], sd)
    assert valid[got[1]].all()


def test_candidates_cover_the_corpus_returns_the_strict_top_k():
    """c = candidate_count(k) >= n: the strict top-k, every query exact."""
    q, x = _data(n=200, seed=3)
    got, want = _both(q, x, Metric.L2, K)
    assert got[2].all()
    _assert_matches_jax(got, want, K)
    sd, si = _strict(q, x, Metric.L2, K)
    np.testing.assert_array_equal(got[1], si)


def test_k_above_the_fused_candidate_cap():
    """k > 2C (the fused kernels' cap): c = candidate_count(k) = 2,432."""
    k = 2 * sf.C + 88
    q, x = _data(b=4, seed=4)
    assert scan.candidate_count(k) < N
    got, want = _both(q, x, Metric.L2, k)
    assert got[2].all()
    _assert_matches_jax(got, want, k)
    np.testing.assert_array_equal(got[1], _strict(q, x, Metric.L2, k)[1])


def test_few_live_rows_non_finite_tau():
    """4 live rows in one residue class (slots 0, C, 2C, 3C) and k=10: tau
    is +inf, and the query is exact because its finite candidates are every
    live row; the other ranks are (+inf, any id)."""
    q, x = _data(seed=5)
    valid = np.zeros(N, dtype=bool)
    live = [0, sf.C, 2 * sf.C, 3 * sf.C]
    valid[live] = True
    got, want = _both(q, x, Metric.L2, K, valid)
    _assert_matches_jax(got, want, K)
    gd, gi, ge = got
    assert ge.all() and np.isfinite(gd[:, :4]).all() and not np.isfinite(gd[:, 4:]).any()
    d = ((q[:, None, :] - x[live][None]) ** 2).sum(-1)
    np.testing.assert_array_equal(gi[:, :4], np.asarray(live)[np.argsort(d, axis=1)])


def test_verification_counts_a_missed_row():
    """The verification flags the one selection torch.topk may get wrong:
    a tie group straddling the c-th candidate (c = 256 here), which may
    leave out the group's lowest ids. 300 copies of one row tie at the
    query's k-th distance (integer-valued, so every order of the sums gives
    the same value), so that query is flagged; a tie-free query over the
    same corpus is not."""
    q, x = _data(b=2, seed=6)
    copies = np.random.default_rng(7).choice(N, 300, replace=False)
    x[copies] = 2.0
    q[0] = 2.5
    sq, inv = _norms(x)
    d, i, exact = scan.scan_topk_verified(
        torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(sq), torch.from_numpy(inv),
        None, metric=Metric.L2, k=K,
    )
    assert scan.candidate_count(K) < len(copies)
    assert exact.tolist() == [False, True]
    sd, si = _strict(q, x, Metric.L2, K)
    np.testing.assert_array_equal(i[1].numpy(), si[1])
    np.testing.assert_array_equal(np.sort(si[0]), np.sort(copies)[:K])


# ---------------------------------------------------------------------------
# FlatIndex routing
# ---------------------------------------------------------------------------

CAP = 1 << 17  # LARGE_SCAN_THRESHOLD
ROUTED_B = (1 << 22) // CAP  # VERIFIED_MIN_BLOCK at capacity CAP


def _routed(metric, k, capacity, d=16, rows=300, seed=7, b=ROUTED_B):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    t = tflat.FlatIndex(d, metric, capacity=capacity, device="cpu")
    t.insert_batch(list(range(rows)), x)
    TELEM.reset()
    TELEM.enable()
    try:
        res = t.batch_search(q, k)
    finally:
        TELEM.disable()
    calls = {key.split(".")[1] for key, v in TELEM.snapshot()["counters"].items()
             if key.startswith("kernel.") and v}
    return x, q, res, calls


@pytest.mark.parametrize("metric, k, capacity, path", [
    (Metric.L2, K, CAP, "scan_fused"),
    (Metric.COSINE, K, CAP, "scan_fused"),
    (Metric.MANHATTAN, K, CAP, "scan_verified"),
    (Metric.CHEBYSHEV, K, CAP, "scan_verified"),
    (Metric.L2, 2 * sf.C + 1, CAP, "scan_verified"),
    (Metric.L2, K, CAP // 2, "scan_strict"),
    (Metric.MANHATTAN, K, CAP // 2, "scan_strict"),
], ids=lambda v: getattr(v, "value", str(v)))
def test_flat_index_routes_by_metric_k_and_capacity(metric, k, capacity, path):
    x, q, res, calls = _routed(metric, k, capacity)
    assert calls == {path}
    assert tflat.LARGE_SCAN_THRESHOLD == CAP and tflat.VERIFIED_MIN_BLOCK == ROUTED_B * CAP
    assert all(len(row) == min(k, len(x)) for row in res)


def test_wide_bf16_index_at_large_k_takes_the_verified_scan(monkeypatch):
    """k = 2C + 1 on a wide bf16 index (d = 8,192, which K1/K2 take at
    k <= 2C) routes by k alone, as in the JAX package: the verified scan,
    no fused call, and the exact top-k against f64 brute force over the
    bf16 rows, up to ties."""
    monkeypatch.setattr(tflat, "LARGE_SCAN_THRESHOLD", 1024)
    monkeypatch.setattr(tflat, "VERIFIED_MIN_BLOCK", 1024)
    d, rows, k = 8192, 600, 2 * sf.C + 1
    rng = np.random.default_rng(12)
    x = rng.standard_normal((rows, d)).astype(np.float32)
    q = rng.standard_normal((2, d)).astype(np.float32)
    t = tflat.FlatIndex(d, Metric.L2, capacity=1024, storage_dtype=torch.bfloat16, device="cpu")
    t.insert_batch(list(range(rows)), x)
    TELEM.reset()
    TELEM.enable()
    try:
        res = t.batch_search(q, k)
    finally:
        TELEM.disable()
    calls = {key.split(".")[1] for key, v in TELEM.snapshot()["counters"].items()
             if key.startswith("kernel.") and v}
    assert calls == {"scan_verified"}
    xb = torch.from_numpy(x).bfloat16().double()
    dist = torch.cdist(torch.from_numpy(q).double(), xb).square().numpy()
    want = np.argsort(dist, axis=1, kind="stable")[:, : k + 1]
    want_d = np.take_along_axis(dist, want, axis=1)
    np.testing.assert_allclose([[r.score**2 for r in row] for row in res], want_d[:, :k],
                               rtol=RTOL, atol=ATOL)
    assert ids_match_up_to_ties([[r.id for r in row] for row in res], want, want_d, k)


@pytest.mark.parametrize("metric, k", [(Metric.MANHATTAN, K), (Metric.L2, 2 * sf.C + 1)],
                         ids=["manhattan", "l2_large_k"])
def test_small_blocks_at_capacity_take_the_strict_path(metric, k):
    """One query short of VERIFIED_MIN_BLOCK the strict path runs (the
    verified scan's fixed cost outweighs the sort it saves there), with the
    same results as the verified scan gives one query later."""
    x, q, res, calls = _routed(metric, k, CAP, b=ROUTED_B - 1)
    assert calls == {"scan_strict"}
    _, _, want, calls = _routed(metric, k, CAP)
    assert calls == {"scan_verified"}
    assert [[(r.id, r.score) for r in row] for row in res] == \
        [[(r.id, r.score) for r in row] for row in want[: ROUTED_B - 1]]


def test_flat_index_manhattan_at_capacity_matches_jax():
    """The verified route end to end: the port's FlatIndex at capacity 2^17
    against the JAX FlatIndex (which takes its own verified scan there)."""
    x, q, res, calls = _routed(Metric.MANHATTAN, K, CAP)
    assert calls == {"scan_verified"}
    j = JFlatIndex(x.shape[1], JMetric.MANHATTAN, capacity=CAP)
    j.insert_batch(list(range(len(x))), x)
    want = j.batch_search(q, K + 1)
    wd = np.array([[r.score for r in row] for row in want])
    gd = np.array([[r.score for r in row] for row in res])
    np.testing.assert_allclose(gd, wd[:, :K], rtol=RTOL, atol=ATOL)
    assert ids_match_up_to_ties([[r.id for r in row] for row in res],
                                [[r.id for r in row] for row in want], wd, K)


def test_tied_rows_at_capacity_take_the_strict_order():
    """Every live row a copy of one vector: each query's tie group spans
    more than the c candidates, so the verified scan flags it and the
    strict splice returns the lowest ids, the (score, id) order."""
    rng = np.random.default_rng(8)
    x = np.repeat(rng.standard_normal((1, 16)).astype(np.float32), 300, axis=0)
    q = rng.standard_normal((ROUTED_B, 16)).astype(np.float32)
    t = tflat.FlatIndex(16, Metric.MANHATTAN, capacity=CAP, device="cpu")
    t.insert_batch(list(range(300)), x)
    TELEM.reset()
    TELEM.enable()
    try:
        res = t.batch_search(q, K)
    finally:
        TELEM.disable()
    counters = TELEM.snapshot()["counters"]
    assert counters["kernel.scan_verified.calls"] == 1
    assert counters["flat.verify_fallback"] == ROUTED_B
    assert [[r.id for r in row] for row in res] == [list(range(K))] * ROUTED_B


def test_flagged_queries_are_spliced_from_the_strict_path(monkeypatch):
    """A query the verified scan cannot prove exact is re-run through the
    strict path and counted as a fallback."""
    real = tflat.scan_topk_verified

    def flag_first(*a, **kw):
        d, i, exact = real(*a, **kw)
        exact = exact.clone()
        exact[0] = False
        return d, i.masked_fill(torch.arange(i.shape[0])[:, None] == 0, INVALID_ID), exact

    monkeypatch.setattr(tflat, "scan_topk_verified", flag_first)
    x, q, res, calls = _routed(Metric.MANHATTAN, K, CAP)
    counters = TELEM.snapshot()["counters"]
    assert calls == {"scan_verified", "scan_strict"} and counters["flat.verify_fallback"] == 1
    d = np.abs(q[:, None, :] - x[None]).sum(-1)
    want = np.argsort(d, axis=1, kind="stable")[:, :K]
    assert [[r.id for r in row] for row in res] == want.tolist()
