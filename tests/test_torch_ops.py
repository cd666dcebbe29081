"""The port's ops (vectorindex_tpu_torch.ops) against the JAX package's.

The same seeded numpy inputs go through both packages. Tolerance for
distances: rtol=2e-4, atol=2e-5 (f32 sums in another order; products of
bf16 values are exact in f32, so bf16 storage gets the same bound). Ids must
be equal, except at a rank whose JAX distance lies within that tolerance of
a neighbouring rank's (vectorindex_tpu_torch.utils.parity).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vectorindex_tpu.ops import filtering as jfilt
from vectorindex_tpu.ops import scan as jscan
from vectorindex_tpu.ops import scoring as jscoring
from vectorindex_tpu.ops import topk as jtopk
from vectorindex_tpu.ops.idmap import IDMap as JIDMap
from vectorindex_tpu.utils.config import Metric as JMetric
from vectorindex_tpu_torch.ops import filtering, scan, scoring, topk
from vectorindex_tpu_torch.ops.idmap import IDMap
from vectorindex_tpu_torch.utils.config import Metric
from vectorindex_tpu_torch.utils.parity import ATOL, RTOL, ids_match_up_to_ties

torch.set_num_threads(1)

METRICS = list(Metric)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _jm(metric: Metric) -> JMetric:
    return JMetric(metric.value)


def _data(seed, n=600, d=24, b=7, dtype="float32"):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    if dtype == "bfloat16":  # values bf16 holds exactly, for both packages
        x = torch.from_numpy(x).bfloat16().float().numpy()
    return q, x


def _both(q, x, dtype):
    jd, td = DTYPES[dtype]
    return (jnp.asarray(q), jnp.asarray(x, dtype=jd)), (
        torch.from_numpy(q),
        torch.from_numpy(x).to(td),
    )


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.value)
def test_distance_block_matches_jax(metric, dtype):
    q, x = _data(1, dtype=dtype)
    (jq, jx), (tq, tx) = _both(q, x, dtype)
    want = np.asarray(jscoring.distance_block(jq, jx, _jm(metric)))
    got = scoring.distance_block(tq, tx, metric).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.value)
def test_from_distance_and_pairwise_distance_match_jax(metric):
    """As tests/test_scoring.py:83: from_distance inverts as_distance, and
    distances rank as the scores do; pairwise_distance is distance_block."""
    q, x = _data(4, n=16, d=24, b=4)
    (jq, jx), (tq, tx) = _both(q, x, "float32")
    s = scoring.score_block(tq, tx, metric)
    d = scoring.as_distance(s, metric)
    back = scoring.from_distance(d, metric)
    np.testing.assert_allclose(back.numpy(), s.numpy(), rtol=1e-6, atol=1e-6)
    want = np.asarray(jscoring.from_distance(jscoring.as_distance(
        jscoring.score_block(jq, jx, _jm(metric)), _jm(metric)), _jm(metric)))
    np.testing.assert_allclose(back.numpy(), want, rtol=RTOL, atol=ATOL)
    if metric.is_similarity:
        assert np.all(np.argsort(d.numpy(), axis=-1) == np.argsort(-s.numpy(), axis=-1))
    want = np.asarray(jscoring.pairwise_distance(jq, jx, _jm(metric)))
    got = scoring.pairwise_distance(tq, tx, metric).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got, scoring.distance_block(tq, tx, metric).numpy())


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_norm_cache_and_direct_l2(dtype):
    q, x = _data(2, dtype=dtype)
    x[3] = 0.0  # zero row: inverse norm 0, not inf
    (jq, jx), (tq, tx) = _both(q, x, dtype)
    jn = jscoring.NormCache.build(jx)
    tn = scoring.NormCache.build(tx)
    np.testing.assert_allclose(tn.sq.numpy(), np.asarray(jn.sq), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tn.inv.numpy(), np.asarray(jn.inv), rtol=RTOL, atol=ATOL)
    assert tn.inv[3] == 0.0
    want = np.asarray(jscoring.l2sqr_block_direct(jq, jx))
    np.testing.assert_allclose(scoring.l2sqr_block_direct(tq, tx).numpy(), want, rtol=RTOL, atol=ATOL)
    # the cached norms feed the dot-trick and cosine epilogues
    jd = jscoring.distance_block(jq, jx, JMetric.COSINE, norms=jn)
    td = scoring.distance_block(tq, tx, Metric.COSINE, norms=tn)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL, atol=ATOL)


def _planted_dist(seed, b=5, n=300):
    """Distances with planted exact ties and +inf slots."""
    rng = np.random.default_rng(seed)
    dist = rng.integers(0, 40, size=(b, n)).astype(np.float32) / 4.0  # many ties
    dist[:, rng.choice(n, n // 5, replace=False)] = np.inf
    return dist


@pytest.mark.parametrize("strict", [True, False])
def test_topk_positional_ties_match_jax(strict):
    dist = _planted_dist(3)
    jd, ji = jtopk.topk(jnp.asarray(dist), 25, strict_ties=strict)
    td, ti = topk.topk(torch.from_numpy(dist), 25, strict_ties=strict)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("strict", [True, False])
def test_topk_with_ids_matches_jax(strict):
    rng = np.random.default_rng(4)
    dist = _planted_dist(4)
    ids = rng.permutation(dist.shape[1]).astype(np.int32)[None, :].repeat(dist.shape[0], 0)
    ids[:, -7:] = jtopk.INVALID_ID  # padding ids sort after every real id
    dist[:, -7:] = np.inf
    jd, ji = jtopk.topk(jnp.asarray(dist), 40, ids=jnp.asarray(ids), strict_ties=strict)
    td, ti = topk.topk(torch.from_numpy(dist), 40, ids=torch.from_numpy(ids), strict_ties=strict)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert topk.INVALID_ID == int(jtopk.INVALID_ID)


def test_merge_topk_and_topk_padded_match_jax():
    rng = np.random.default_rng(5)
    lists = np.sort(_planted_dist(5, b=3 * 4, n=16).reshape(3, 4, 16), axis=-1)
    ids = rng.choice(10_000, size=(3, 4, 16), replace=False).astype(np.int32)
    jd, ji = jtopk.merge_topk(jnp.asarray(lists), jnp.asarray(ids), 20)
    td, ti = topk.merge_topk(torch.from_numpy(lists), torch.from_numpy(ids), 20)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))

    dist = _planted_dist(6, b=4, n=50)
    valid = rng.random((4, 50)) > 0.3
    pid = rng.permutation(50).astype(np.int32)[None, :].repeat(4, 0)
    jd, ji = jtopk.topk_padded(jnp.asarray(dist), jnp.asarray(valid), 45, ids=jnp.asarray(pid))
    td, ti = topk.topk_padded(torch.from_numpy(dist), torch.from_numpy(valid), 45, ids=torch.from_numpy(pid))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert np.isinf(td.numpy()[ti.numpy() == topk.INVALID_ID]).all()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.value)
def test_scan_topk_strict_matches_jax(metric, dtype):
    q, x = _data(7, n=900, d=20, b=9, dtype=dtype)
    x[100] = x[400] = x[777] = x[5]  # duplicate rows: ties break by row
    q[0] = x[5]
    valid = np.random.default_rng(8).random(x.shape[0]) > 0.25
    valid[[5, 100, 400, 777]] = True
    (jq, jx), (tq, tx) = _both(q, x, dtype)
    jn = jscoring.NormCache.build(jx)
    tn = scoring.NormCache.build(tx)
    k = 12
    jd, ji = jscan.scan_topk_strict(
        jq, jx, jn.sq, jn.inv, jnp.asarray(valid), metric=_jm(metric), k=k + 1
    )
    td, ti = scan.scan_topk_strict(
        tq, tx, tn.sq, tn.inv, torch.from_numpy(valid), metric=metric, k=k + 1
    )
    jd, ji = np.asarray(jd), np.asarray(ji)
    np.testing.assert_allclose(td.numpy(), jd, rtol=RTOL, atol=ATOL)
    assert ids_match_up_to_ties(ti.numpy(), ji, jd, k)
    assert valid[ti.numpy()].all()
    if metric in (Metric.L2, Metric.MANHATTAN, Metric.CHEBYSHEV):
        assert list(ti.numpy()[0, :4]) == [5, 100, 400, 777]


def test_pad_queries_matches_jax():
    q = np.random.default_rng(9).standard_normal((5, 3)).astype(np.float32)
    jp, jn = jscan.pad_queries(jnp.asarray(q))
    tp, tn = scan.pad_queries(torch.from_numpy(q))
    assert tn == jn == 5
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    same, n = scan.pad_queries(torch.zeros(16, 3))
    assert same.shape[0] == 16 and n == 16


def test_bitsets_match_jax():
    n = 200
    a_ids, b_ids = [0, 3, 31, 32, 100, 199], [3, 4, 64, 100]
    ja, jb = jfilt.bitset_from_ids(a_ids, n), jfilt.bitset_from_ids(b_ids, n)
    ta = filtering.bitset_from_ids(a_ids, n, device="cpu")
    tb = filtering.bitset_from_ids(b_ids, n, device="cpu")
    for jw, tw in [
        (ja, ta),
        (jfilt.bitset_union(ja, jb), filtering.bitset_union(ta, tb)),
        (jfilt.bitset_intersect(ja, jb), filtering.bitset_intersect(ta, tb)),
        (jfilt.bitset_difference(ja, jb), filtering.bitset_difference(ta, tb)),
        # one id per word: the JAX scatter keeps one bit per word and call
        (jfilt.bitset_set(ja, jnp.asarray([5, 40, 150])),
         filtering.bitset_set(ta, torch.tensor([5, 40, 150]))),
    ]:
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).astype(np.int64))
    probe = np.arange(n)
    np.testing.assert_array_equal(
        filtering.bitset_test(ta, torch.from_numpy(probe)).numpy(),
        np.asarray(jfilt.bitset_test(ja, jnp.asarray(probe))),
    )
    np.testing.assert_array_equal(
        filtering.bitset_to_mask(ta, n).numpy(), np.asarray(jfilt.bitset_to_mask(ja, n))
    )
    for mode, jmode in [(filtering.FilterMode.ALLOW, jfilt.FilterMode.ALLOW),
                        (filtering.FilterMode.DENY, jfilt.FilterMode.DENY)]:
        to = filtering.IDFilterOverlay(ta, mode).add([7, 8], n).remove([0, 100], n)
        jo = jfilt.IDFilterOverlay(ja, jmode).add([7, 8], n).remove([0, 100], n)
        np.testing.assert_array_equal(to.allow_mask(n).numpy(), np.asarray(jo.allow_mask(n)))
    np.testing.assert_array_equal(
        filtering.filter_mask(n, allow_ids=a_ids, deny_ids=b_ids, device="cpu").numpy(),
        np.asarray(jfilt.filter_mask(n, allow_ids=a_ids, deny_ids=b_ids)),
    )


def test_slot_mask_matches_jax():
    jm, tm = JIDMap(), IDMap()
    for slot, ext in enumerate(["a", "b", "c", "d", "e"]):
        jm.append(ext, slot)
        tm.append(ext, slot)
    for allow, deny in [(None, None), (["a", "c", "zz"], None), (None, ["b"]), (["a", "b"], ["b"])]:
        want = jfilt.slot_mask_np(8, jm, allow, deny)
        got = filtering.slot_mask_np(8, tm, allow, deny)
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)
