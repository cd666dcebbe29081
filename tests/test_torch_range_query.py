"""The port's range queries (vectorindex_tpu_torch.ops.range_query), candidate
reservoir (ops.reservoir) and FlatIndex.range_search against the JAX
package's, on the same seeded numpy inputs (the shapes of
tests/test_support_ops.py), on the CPU.

Tolerances:
  - masks, counts and ids: equal (the data keeps every distance far from
    the radius and from its neighbours, relative to f32 rounding).
  - distances: rtol=atol=1e-5 (f32 sums in another order); FlatIndex
    scores compared as internal distances with the index tests' rtol=2e-4,
    atol=2e-5 (bf16 rows widened to f32 in both).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorindex_tpu.models.flat as jflat
import vectorindex_tpu_torch.models.flat as tflat
from vectorindex_tpu.ops import pq as jpq
from vectorindex_tpu.ops import range_query as jrq
from vectorindex_tpu.ops import reservoir as jres
from vectorindex_tpu.ops.dtypes import pack_u4 as jpack_u4
from vectorindex_tpu.utils.config import Metric as JMetric
from vectorindex_tpu_torch.ops import range_query as rq
from vectorindex_tpu_torch.ops import reservoir as res
from vectorindex_tpu_torch.ops.topk import INVALID_ID
from vectorindex_tpu_torch.utils.config import Metric
from vectorindex_tpu_torch.utils.errors import IndexError, IndexErrorKind
from vectorindex_tpu_torch.utils.parity import ATOL, RTOL

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
METRICS = [Metric.L2, Metric.INNER_PRODUCT, Metric.COSINE]
#: radius per metric: an L2 distance, an inner product, a cosine similarity
RADIUS = {Metric.L2: 5.0, Metric.INNER_PRODUCT: 2.0, Metric.COSINE: 0.2}


def _data(n=200, d=16, b=4, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, d)).astype(np.float32),
        rng.standard_normal((n, d)).astype(np.float32),
    )


def T(a):
    return torch.from_numpy(np.array(a))


def _same_result(got, want):
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    wd = np.asarray(want.dists)
    np.testing.assert_array_equal(np.isinf(got.dists.numpy()), np.isinf(wd))
    fin = np.isfinite(wd)
    np.testing.assert_allclose(got.dists.numpy()[fin], wd[fin], **TOL)
    assert got.ids.dtype == torch.int32 and got.counts.dtype == torch.int32


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.value)
def test_range_mask_and_count_match_jax(metric):
    q, x = _data()
    valid = np.random.default_rng(1).random(len(x)) < 0.8
    jm = JMetric(metric.value)
    for v in (None, valid):
        jv = None if v is None else jnp.asarray(v)
        tv = None if v is None else T(v)
        want = np.asarray(jrq.range_mask(jnp.asarray(q), jnp.asarray(x), RADIUS[metric], metric=jm,
                                         valid=jv))
        got = rq.range_mask(T(q), T(x), RADIUS[metric], metric=metric, valid=tv)
        assert 0 < want.sum() < want.size
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            rq.range_count(T(q), T(x), RADIUS[metric], metric=metric, valid=tv).numpy(),
            np.asarray(jrq.range_count(jnp.asarray(q), jnp.asarray(x), RADIUS[metric], metric=jm,
                                       valid=jv)))


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.value)
def test_range_scan_matches_jax(metric):
    """Compacted output, with room for every match and overflowing
    (max_results below the counts), with a validity mask and cached norms."""
    q, x = _data()
    valid = np.random.default_rng(2).random(len(x)) < 0.8
    sq = (x * x).sum(1)
    inv = 1.0 / np.sqrt(sq)
    jm = JMetric(metric.value)
    for max_results in (300, 10):
        for v in (None, valid):
            kw = {} if v is None else dict(valid=jnp.asarray(v))
            want = jrq.range_scan(jnp.asarray(q), jnp.asarray(x), RADIUS[metric], metric=jm,
                                  max_results=max_results, x_sqnorms=jnp.asarray(sq),
                                  x_invnorms=jnp.asarray(inv), **kw)
            got = rq.range_scan(T(q), T(x), RADIUS[metric], metric=metric,
                                max_results=max_results, x_sqnorms=T(sq), x_invnorms=T(inv),
                                **({} if v is None else dict(valid=T(v))))
            assert got.ids.shape == (len(q), min(max_results, len(x)))
            _same_result(got, want)
    assert (got.counts > 10).all()  # the last case overflowed its buffers


def test_range_scan_adc_matches_jax():
    """u8 and packed u4 codes, gather and one-hot strategies ('auto' takes
    'gather' on the CPU), with and without a validity mask."""
    q, x = _data(n=300, d=16, b=2, seed=3)
    cents = np.random.default_rng(4).standard_normal((4, 16, 4)).astype(np.float32)
    jb = jpq.PQCodebooks(jnp.asarray(cents), jnp.sum(jnp.square(jnp.asarray(cents)), axis=-1))
    codes = np.asarray(jpq.pq_encode(jnp.asarray(x), jb))
    lut = np.asarray(jpq.pq_lut_l2(jnp.asarray(q), jb))
    valid = np.random.default_rng(5).random(len(x)) < 0.7
    r = 5.5
    for strategy in ("gather", "onehot", "auto"):
        for v in (None, valid):
            want = jrq.range_scan_adc(jnp.asarray(codes), jnp.asarray(lut), r, max_results=64,
                                      strategy="gather",
                                      valid=None if v is None else jnp.asarray(v))
            got = rq.range_scan_adc(T(codes), T(lut), r, max_results=64, strategy=strategy,
                                    valid=None if v is None else T(v))
            _same_result(got, want)
    assert (np.asarray(want.counts) > 0).all()
    packed = np.asarray(jpack_u4(jnp.asarray(codes)))
    _same_result(rq.range_scan_adc_u4(T(packed), T(lut), r, max_results=64),
                 jrq.range_scan_adc_u4(jnp.asarray(packed), jnp.asarray(lut), r, max_results=64))


def test_compaction_orders_ties_by_id_and_pads():
    """Equal distances come out by ascending id; non-matches become
    (+inf, INVALID_ID) after every match, a match at +inf included."""
    dist = torch.tensor([[3.0, 1.0, 1.0, float("inf"), 0.5, 1.0, 9.0]])
    mask = torch.tensor([[True, True, False, True, True, True, False]])
    out = rq._compact(dist, mask, 6)
    assert out.ids.tolist() == [[4, 1, 5, 0, 3, INVALID_ID]]
    assert out.dists.tolist() == [[0.5, 1.0, 1.0, 3.0, float("inf"), float("inf")]]
    assert out.counts.tolist() == [5]
    assert rq._compact(dist, mask, 100).ids.shape == (1, 7)


def test_reservoir_matches_jax():
    rng = np.random.default_rng(6)
    d_all = rng.standard_normal((2, 300)).astype(np.float32)
    d_all[:, 150:160] = d_all[:, 10:20]  # ties across blocks: the lower id stays
    valid = rng.random((2, 300)) < 0.6
    jr, tr = jres.reservoir_init(2, 16), res.reservoir_init(2, 16)
    for c in range(0, 300, 50):
        ids = np.arange(c, c + 50, dtype=np.int32)[None].repeat(2, 0)
        if c < 150:
            jr = jres.reservoir_push(jr, jnp.asarray(d_all[:, c : c + 50]), jnp.asarray(ids))
            tr = res.reservoir_push(tr, T(d_all[:, c : c + 50]), T(ids))
        else:
            jr = jres.reservoir_push_masked(jr, jnp.asarray(d_all[:, c : c + 50]), jnp.asarray(ids),
                                            jnp.asarray(valid[:, c : c + 50]))
            tr = res.reservoir_push_masked(tr, T(d_all[:, c : c + 50]), T(ids),
                                           T(valid[:, c : c + 50]))
        np.testing.assert_array_equal(tr.ids.numpy(), np.asarray(jr.ids))
        np.testing.assert_array_equal(tr.dists.numpy(), np.asarray(jr.dists))
    assert tr.capacity == 16
    np.testing.assert_array_equal(res.reservoir_tau(tr).numpy(), np.asarray(jres.reservoir_tau(jr)))
    np.testing.assert_array_equal(res.reservoir_count(tr).numpy(),
                                  np.asarray(jres.reservoir_count(jr)))
    for k in (5, 16):
        gd, gi = res.reservoir_extract_topk(tr, k)
        wd, wi = jres.reservoir_extract_topk(jr, k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    # a partial fill: tau stays +inf, the count is the live entries
    part = res.reservoir_push_masked(res.reservoir_init(1, 8), torch.tensor([[1.0, 2.0, 3.0]]),
                                     torch.tensor([[10, 11, 12]]), torch.tensor([[True, False, True]]))
    assert res.reservoir_count(part).tolist() == [2] and torch.isinf(res.reservoir_tau(part)).all()
    assert part.ids[0, :3].tolist() == [10, 12, INVALID_ID]


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.value)
def test_range_scan_reservoir_matches_jax(metric):
    q, x = _data(n=500, d=8, b=2, seed=11)
    radius = {Metric.L2: 4.0, Metric.INNER_PRODUCT: 1.0, Metric.COSINE: 0.3}[metric]
    valid = np.random.default_rng(12).random(len(x)) < 0.75
    jm = JMetric(metric.value)
    for v in (None, valid):
        want = jrq.range_scan_reservoir(jnp.asarray(q), jnp.asarray(x), radius, capacity=32,
                                        metric=jm, chunk=128,
                                        valid=None if v is None else jnp.asarray(v))
        got = rq.range_scan_reservoir(T(q), T(x), radius, capacity=32, metric=metric, chunk=128,
                                      valid=None if v is None else T(v))
        np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
        np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists), **TOL)
    assert (res.reservoir_count(got) == 32).all()


# ---------------------------------------------------------------------------
# FlatIndex.range_search
# ---------------------------------------------------------------------------

D = 16
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _populated(metric: Metric, dtype: str):
    """The same inserts, removes and updates in a JAX and a port index."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal((600, D)).astype(np.float32)
    jd, td = DTYPES[dtype]
    j = jflat.FlatIndex(D, JMetric(metric.value), storage_dtype=jd)
    t = tflat.FlatIndex(D, metric, storage_dtype=td, device="cpu")
    meta = [{"tag": "even" if i % 2 == 0 else "odd"} for i in range(len(x))]
    for idx in (j, t):
        idx.insert_batch([f"v{i}" for i in range(len(x))], x, meta)
        for i in range(0, len(x), 9):
            idx.remove(f"v{i}")
        idx.update("v1", vector=x[1] + 0.5)
    return j, t, x[rng.choice(len(x), 3, replace=False)] + 0.2 * rng.standard_normal((3, D)).astype(np.float32)


def _ascending(hits, metric):
    s = np.array([h.score for h in hits], dtype=np.float64)
    return {Metric.L2: s * s, Metric.INNER_PRODUCT: -s, Metric.COSINE: 1.0 - s}[metric]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.value)
def test_flat_range_search_matches_jax(metric, dtype):
    j, t, qs = _populated(metric, dtype)
    radius = {Metric.L2: 5.0, Metric.INNER_PRODUCT: 4.0, Metric.COSINE: 0.4}[metric]
    even = lambda m: m is not None and m["tag"] == "even"  # noqa: E731
    for q in qs:
        for kw in ({}, dict(filter=even), dict(max_results=7)):
            want = j.range_search(q, radius, **kw)
            got = t.range_search(q, radius, **kw)
            assert 0 < len(want) and [h.id for h in got] == [h.id for h in want]
            np.testing.assert_allclose(_ascending(got, metric), _ascending(want, metric),
                                       rtol=RTOL, atol=ATOL)
            assert [h.metadata for h in got] == [h.metadata for h in want]
            if "filter" in kw:
                assert all(even(h.metadata) for h in got)
    assert len(t.range_search(qs[0], radius, max_results=7)) == 7
    assert {h.id for h in t.range_search(qs[0], 1e6 if metric == Metric.L2 else -1e6, 10_000)} \
        == {f"v{i}" for i in range(600) if i % 9}  # capped at the capacity, deleted rows gone


def test_flat_range_search_edges():
    t = tflat.FlatIndex(4, device="cpu")
    assert t.range_search(np.ones(4), 1.0) == []  # empty index
    j = jflat.FlatIndex(4)
    assert j.range_search(np.ones(4), 1.0) == []
    t.insert("a", np.ones(4))
    t.insert("b", 2 * np.ones(4))
    with pytest.raises(IndexError) as info:
        t.range_search(np.ones(3), 1.0)
    assert info.value.kind == IndexErrorKind.DIMENSION_MISMATCH
    hits = t.range_search(np.ones(4), 2.0)  # inclusive: "b" lies at exactly 2
    assert [h.id for h in hits] == ["a", "b"] and [h.score for h in hits] == [0.0, 2.0]
    t.remove("a")
    assert [h.id for h in t.range_search(np.ones(4), 2.0)] == ["b"]
