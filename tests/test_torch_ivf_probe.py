"""The port's IVF probe kernels and probed search
(vectorindex_tpu_torch.kernels.ivf_probe) against the JAX package's.

On the CPU the port's wrappers run the plain PyTorch versions of K3/K4/K5;
the JAX side runs its Pallas kernels in interpret mode, as
tests/test_ivf_probe_kernel.py does. Both packages get the same seeded
numpy inputs and hold the same CSR rows.

Tolerances:
  - K4/K5 distances: finite entries within rtol=atol=1e-5 (f32 dot products
    summed in another order, on unit-norm data), +inf positions identical.
  - K3 is compared by property, since it keeps a superset of the TPU
    kernel's candidates: the port's drop_min >= JAX's element by element
    (less the same tolerance);
    every query JAX proves complete the port proves complete too; and the
    top-kk candidate distances agree within rtol=atol=1e-5 (rows equal
    except at near-ties).
  - ivf_search_flat_probe against ivf_search_flat_pallas: ids exactly
    equal; distances within rtol=atol=1e-4 (f32 storage) or 1e-3 (bf16
    storage with an f32 rerank source: the same f32 rerank, summed in
    another order).
The CUDA kernels are compared with these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorindex_tpu.kernels.ivf_probe as jkp
from vectorindex_tpu.bench.synth import clustered_corpus, pack_ivf
from vectorindex_tpu.ops import ivf as jivf
from vectorindex_tpu.utils.config import Metric as JMetric
from vectorindex_tpu_torch.kernels import ivf_probe as kp
from vectorindex_tpu_torch.ops import ivf as tivf
from vectorindex_tpu_torch.ops.topk import INVALID_ID
from vectorindex_tpu_torch.utils.config import Metric
from vectorindex_tpu_torch.utils.parity import ids_match_up_to_ties

torch.set_num_threads(1)

METRICS = [Metric.L2, Metric.INNER_PRODUCT, Metric.COSINE]


def T(a):
    """A torch tensor of a copy (JAX hands out read-only numpy views)."""
    return torch.from_numpy(np.array(a))


def _clustered(n=900, d=32, kc=13, seed=0, skew=1.5):
    rng = np.random.default_rng(seed)
    cent = rng.standard_normal((kc, d)).astype(np.float32)
    p = np.exp(rng.standard_normal(kc) * skew)
    p /= p.sum()
    assign = rng.choice(kc, size=n, p=p)
    x = (cent[assign] + 0.3 * rng.standard_normal((n, d))).astype(np.float32)
    return cent, x, assign


def _stores(assign, ids, x, kc, bf16=False):
    """The same lists in both packages → (jax arrays, port arrays, cap,
    jax rerank source, port rerank source)."""
    js = jivf.IVFListStore(kc, x.shape[1])
    ts = tivf.IVFListStore(kc, x.shape[1], device="cpu")
    js.append_batch(assign, ids, x)
    ts.append_batch(assign, ids, x)
    ja = js.sync_device(jnp.bfloat16 if bf16 else jnp.float32)
    ta = ts.sync_device(torch.bfloat16 if bf16 else torch.float32)
    np.testing.assert_array_equal(ta.row_ids.numpy(), np.asarray(ja.row_ids))
    np.testing.assert_array_equal(ta.starts.numpy(), np.asarray(ja.starts))
    cap = tivf.probe_cap_for(ts.max_length)
    return ja, ta, cap, jnp.asarray(js._packed["vecs"]), T(ts._packed["vecs"])


def _jax_search(q, cent, ja, *args, metric, **kw):
    d, i = jkp.ivf_search_flat_pallas(
        jnp.asarray(q), jnp.asarray(cent), ja, *args, metric=JMetric(metric.value),
        interpret=True, **kw,
    )
    return np.asarray(d), np.asarray(i)


def _port_search(q, cent, ta, *args, metric, **kw):
    d, i = kp.ivf_search_flat_probe(T(q), T(cent), ta, *args, metric=metric, **kw)
    return d.numpy(), i.numpy()


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.value)
def test_parity_vs_jax_and_gather_path(metric):
    cent, x, assign = _clustered()
    ja, ta, cap, _, _ = _stores(assign, np.arange(len(x)), x, 13)
    q = np.random.default_rng(1).standard_normal((7, x.shape[1])).astype(np.float32)
    jd, ji = _jax_search(q, cent, ja, metric=metric, nprobe=4, probe_cap=cap, k=10)
    td, ti = _port_search(q, cent, ta, metric=metric, nprobe=4, probe_cap=cap, k=10)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-4)
    for nprobe in (1, 4, 13):  # the port's gather path is exact within probed lists
        td, ti = _port_search(q, cent, ta, metric=metric, nprobe=nprobe, probe_cap=cap, k=10)
        gd, gi = tivf.ivf_search_flat(T(q), T(cent), ta, nprobe=nprobe, probe_cap=cap, k=10,
                                      metric=metric)
        np.testing.assert_array_equal(ti, gi.numpy())
        np.testing.assert_allclose(td, gd.numpy(), rtol=1e-4, atol=1e-4)


def test_skewed_lists_no_padding_leak():
    """Heavy skew: list tails must be masked — dead rows (zero vectors)
    would otherwise win IP queries."""
    cent, x, assign = _clustered(skew=3.0, seed=3)
    _, ta, cap, _, _ = _stores(assign, np.arange(len(x)), x, 13)
    q = np.random.default_rng(2).standard_normal((5, 32)).astype(np.float32)
    for b in (5, 20):  # K3 route and pair route
        qb = np.resize(q, (b, 32))
        _, ids = _port_search(qb, cent, ta, metric=Metric.INNER_PRODUCT, nprobe=13,
                              probe_cap=cap, k=10)
        assert (ids >= 0).all() and (ids != INVALID_ID).all()


def test_empty_lists_and_small_k():
    kc, d = 8, 16
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, d)).astype(np.float32)
    _, ta, cap, _, _ = _stores(np.array([0, 0, 3, 3, 3]), np.arange(5), x, kc)
    cent = rng.standard_normal((kc, d)).astype(np.float32)
    dist, ids = _port_search(x[:2], cent, ta, metric=Metric.L2, nprobe=kc, probe_cap=cap, k=10)
    for b in range(2):
        assert set(ids[b][np.isfinite(dist[b])].tolist()) == set(range(5))
    assert (ids[~np.isfinite(dist)] == INVALID_ID).all()


def test_bf16_storage_with_f32_rerank_matches_jax():
    cent, x, assign = _clustered(seed=5)
    ja, ta, cap, jsrc, tsrc = _stores(assign, np.arange(len(x)), x, 13, bf16=True)
    q = np.random.default_rng(4).standard_normal((4, 32)).astype(np.float32)
    jd, ji = _jax_search(q, cent, ja, jsrc, metric=Metric.L2, nprobe=6, probe_cap=cap, k=8)
    td, ti = _port_search(q, cent, ta, tsrc, metric=Metric.L2, nprobe=6, probe_cap=cap, k=8)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-3, atol=1e-3)


def test_strict_tie_contract():
    """Duplicate vectors: ties resolve by ascending internal id; 4 rows
    share class 0, so K3's proof fails and the pair path answers."""
    kc, d = 4, 16
    v = np.ones((12, d), np.float32)
    lists = np.array([2, 0, 1, 3, 2, 0, 1, 3, 2, 0, 1, 3])
    _, ta, cap, _, _ = _stores(lists, np.arange(12)[::-1], v, kc)
    cent = np.zeros((kc, d), np.float32)
    q = np.zeros((1, d), np.float32)
    cd, _, drop = kp.ivf_probe_topc_rankmajor(
        T(q), *_probe_tables(q, cent, ta, kc), ta.vecs, ta.sqnorms,
        nprobe=kc, probe_cap=cap, metric=Metric.L2,
    )
    assert float(drop.min()) == float(cd.min()) == 16.0  # the proof cannot hold
    _, ids = _port_search(q, cent, ta, metric=Metric.L2, nprobe=kc, probe_cap=cap, k=5)
    np.testing.assert_array_equal(ids[0], np.arange(5))


def _probe_tables(q, cent, arrays, nprobe, metric=Metric.L2):
    _, pl = tivf.ivf_select(T(q), T(cent), nprobe=nprobe, metric=metric)
    pl = pl.long()
    return arrays.starts[pl].contiguous(), arrays.lengths[pl].contiguous()


def _packed(n, d, nlist, seed, b, jitter=0.01):
    """bench.synth's packed layout in both packages (JAX arrays are
    lane-padded to 128 columns; the port's are not)."""
    x, centers, assign = clustered_corpus(n, d, nlist=nlist, seed=seed)
    arrays, _, cap = pack_ivf(x, assign, nlist, storage_dtype=jnp.float32)
    vecs = T(np.asarray(arrays.vecs)[:, :d])
    rng = np.random.default_rng(seed + 1)
    q = (x[rng.choice(n, b)] + jitter).astype(np.float32)
    return x, centers, arrays, vecs, T(arrays.sqnorms), cap, q


def _tables_both(q, centers, arrays, nprobe):
    _, pl = jivf.ivf_select(jnp.asarray(q), jnp.asarray(centers), nprobe=nprobe)
    starts, lens = arrays.starts[pl], arrays.lengths[pl]
    return (starts, lens), (T(starts), T(lens))


def _assert_scores_close(port, jax_out):
    rn, an = port.numpy(), np.asarray(jax_out)
    np.testing.assert_array_equal(np.isfinite(rn), np.isfinite(an))
    np.testing.assert_allclose(rn[np.isfinite(rn)], an[np.isfinite(an)], rtol=1e-5, atol=1e-5)


def test_k4_and_k5_plain_versions_match_jax():
    """Rank-major scores (K5) == per-pair scores (K4), in both packages."""
    x, centers, arrays, vecs, sqn, cap, q = _packed(4000, 32, 16, 3, 8)
    (js, jl), (ts, tl) = _tables_both(q, centers, arrays, 4)
    args = dict(nprobe=4, probe_cap=cap)
    a = jkp.ivf_probe_scores(jnp.asarray(q), js, jl, arrays.vecs, arrays.sqnorms,
                             interpret=True, **args)
    r = jkp.ivf_probe_scores_rankmajor(jnp.asarray(q), js, jl, arrays.vecs, arrays.sqnorms,
                                       interpret=True, **args)
    p4 = kp.ivf_probe_scores(T(q), ts, tl, vecs, sqn, **args)
    p5 = kp.ivf_probe_scores_rankmajor(T(q), ts, tl, vecs, sqn, **args)
    _assert_scores_close(p4, a)
    _assert_scores_close(p5, r)
    assert torch.equal(p4, p5)  # no sentinel in the sqnorms: the same floats


def test_rank_major_end_to_end_recall():
    """The K3 route stays exact within probed lists: self top-1 with every
    list probed."""
    x, centers, arrays, vecs, sqn, cap, _ = _packed(5000, 16, 8, 7, 8)
    ta = tivf.IVFListArrays(vecs, T(arrays.row_ids), sqn,
                            T(arrays.starts), T(arrays.lengths))
    assert kp.rank_major_fits(8, cap, 16, 4)
    _, si = _port_search(x[:8], centers, ta, metric=Metric.L2, nprobe=8, probe_cap=cap, k=5)
    assert (si[:, 0] == np.arange(8)).all()


def test_k3_plain_version_keeps_what_jax_keeps():
    """Property test of K3 against the JAX kernel, and the proof: on spread
    data every query's selection is complete in both packages."""
    k, nprobe = 10, 8
    x, centers, arrays, vecs, sqn, cap, q = _packed(4000, 32, 16, 11, 8)
    (js, jl), (ts, tl) = _tables_both(q, centers, arrays, nprobe)
    jd, ji, j4 = (np.asarray(a) for a in jkp.ivf_probe_topc_rankmajor(
        jnp.asarray(q), js, jl, arrays.vecs, arrays.sqnorms, nprobe=nprobe, probe_cap=cap,
        interpret=True))
    td, ti, t4 = (a.numpy() for a in kp.ivf_probe_topc_rankmajor(
        T(q), ts, tl, vecs, sqn, nprobe=nprobe, probe_cap=cap))
    assert td.shape == (8, kp.TIERS * kp.CBINS) and t4.shape == (8, kp.CBINS)
    # >= up to the distance tolerance (the packages sum in other orders)
    slack = np.where(np.isfinite(j4), 1e-5 * (1 + np.abs(j4)), 0.0)
    assert (t4 >= j4 - slack).all()
    # a candidate's class is its row mod CBINS; unfilled slots are (+inf, 0)
    cls = np.tile(np.arange(kp.CBINS), kp.TIERS)
    assert ((ti % kp.CBINS == cls) | ~np.isfinite(td)).all()
    assert (ti[~np.isfinite(td)] == 0).all()
    order_j = np.lexsort((ji, jd), axis=1)[:, :k]
    order_t = np.lexsort((ti, td), axis=1)[:, :k]
    jtop, ttop = np.take_along_axis(jd, order_j, 1), np.take_along_axis(td, order_t, 1)
    np.testing.assert_allclose(ttop, jtop, rtol=1e-5, atol=1e-5)
    assert ids_match_up_to_ties(np.take_along_axis(ti, order_t, 1),
                                np.take_along_axis(ji, order_j, 1), jtop, k)
    j_complete = j4.min(axis=1) > jtop[:, k - 1]
    t_complete = t4.min(axis=1) > ttop[:, k - 1]
    assert j_complete.all() and t_complete.all()
    # and the candidates hold the exact top-k of every probed distance
    full = np.sort(kp.ivf_probe_scores(T(q), ts, tl, vecs, sqn, nprobe=nprobe,
                                       probe_cap=cap).numpy(), axis=1)[:, :k]
    np.testing.assert_array_equal(ttop, full)


def test_k3_drop_detector_fires_on_class_crowding():
    """Five identical rows in one class (list offsets 0, 256, ..., 1024):
    min(drop_min) == 0.0, so the proof fails and the search returns the 5
    duplicates through the pair path."""
    d, nlist = 16, 2
    nfill = 4 * kp.CBINS - 4
    fill = 100.0 + np.arange(nfill * d, dtype=np.float32).reshape(nfill, d) / (nfill * d)
    slots = [0, 256, 512, 768, 1024]
    xx = np.empty((nfill + 5, d), np.float32)
    xx[slots] = 1.0
    xx[[i for i in range(len(xx)) if i not in slots]] = fill
    arrays, _, cap = pack_ivf(xx, np.zeros(len(xx), np.int32), nlist, storage_dtype=jnp.float32)
    ta = tivf.IVFListArrays(
        T(np.asarray(arrays.vecs)[:, :d]), T(arrays.row_ids),
        T(arrays.sqnorms), T(arrays.starts),
        T(arrays.lengths))
    q = np.ones((1, d), np.float32)
    cent = np.zeros((nlist, d), np.float32)
    starts, lens = _probe_tables(q, cent, ta, 1)
    _, _, drop = kp.ivf_probe_topc_rankmajor(T(q), starts, lens, ta.vecs, ta.sqnorms,
                                             nprobe=1, probe_cap=cap, metric=Metric.L2)
    assert float(drop[0].min()) == 0.0
    _, si = _port_search(q, cent, ta, metric=Metric.L2, nprobe=1, probe_cap=cap, k=5)
    assert set(si[0].tolist()) == set(np.asarray(arrays.row_ids)[slots].tolist())


@pytest.mark.parametrize("skew_case", ["one_giant", "pow2_edges", "empty_heavy"])
def test_k5_adversarial_skew_matches_jax(skew_case, monkeypatch):
    """K5 against the JAX rank-major kernel with its VMEM budget shrunk, so
    segments are 2 blocks and its 2-D grid really runs (nseg > 1)."""
    b, d, nlist, nprobe = 6, 48, 12, 7
    monkeypatch.setattr(jkp, "RANK_MAJOR_VMEM", 2 * (2 * b * 256 * d * 4))
    rng = np.random.default_rng({"one_giant": 1, "pow2_edges": 2, "empty_heavy": 3}[skew_case])
    lengths = {
        "one_giant": [1400] + [5] * (nlist - 1),
        "pow2_edges": [255, 256, 257, 512, 1, 0, 513, 2, 767, 768, 3, 100],
        "empty_heavy": [0] * (nlist - 2) + [900, 4],
    }[skew_case]
    assign = np.repeat(np.arange(nlist, dtype=np.int32), lengths)
    x = rng.standard_normal((len(assign), d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    arrays, _, cap = pack_ivf(x, assign, nlist, storage_dtype=jnp.float32)
    assert -(-(cap // jkp.BLK) // jkp._seg_blocks(b, cap // jkp.BLK, 128, 4)) > 1
    q = rng.standard_normal((b, d)).astype(np.float32)
    cent = np.stack([x[assign == i].mean(0) if (assign == i).any() else np.zeros(d)
                     for i in range(nlist)]).astype(np.float32)
    (js, jl), (ts, tl) = _tables_both(q, cent, arrays, nprobe)
    r = jkp.ivf_probe_scores_rankmajor(jnp.asarray(q), js, jl, arrays.vecs, arrays.sqnorms,
                                       nprobe=nprobe, probe_cap=cap, interpret=True)
    p = kp.ivf_probe_scores_rankmajor(
        T(q), ts, tl, T(np.asarray(arrays.vecs)[:, :d]),
        T(arrays.sqnorms), nprobe=nprobe, probe_cap=cap)
    _assert_scores_close(p, r)


def _row_allow(ta, allow_corpus):
    rid = ta.row_ids.numpy()
    ra = np.zeros(rid.shape[0], dtype=bool)
    ra[rid >= 0] = allow_corpus[rid[rid >= 0]]
    return ra


@pytest.mark.parametrize("b", [7, 20], ids=["k3-route", "pair-route"])
def test_filtered_search_matches_jax(b):
    """row_allow on both routes: the K3 route folds it into the sqnorms as
    the deny sentinel, the pair route masks K4's output. Ids equal JAX's,
    k results survive a 20%-selective filter, all allowed."""
    cent, x, assign = _clustered(n=1200, kc=11)
    ja, ta, cap, _, _ = _stores(assign, np.arange(len(x)), x, 11)
    rng = np.random.default_rng(7)
    q = rng.standard_normal((b, x.shape[1])).astype(np.float32)
    allow_corpus = rng.random(len(x)) < 0.2
    ra = _row_allow(ta, allow_corpus)
    jd, ji = _jax_search(q, cent, ja, None, jnp.asarray(ra), metric=Metric.L2, nprobe=11,
                         probe_cap=cap, k=10)
    td, ti = _port_search(q, cent, ta, None, T(ra), metric=Metric.L2, nprobe=11,
                          probe_cap=cap, k=10)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-4)
    assert (ti != INVALID_ID).all() and allow_corpus[ti].all()


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.value)
@pytest.mark.parametrize("b", [8, 17], ids=["k3-route", "pair-route"])
def test_filtered_search_all_metrics_equals_brute_force(metric, b):
    """The deny sentinel works for IP and cosine on the K3 route as for L2;
    with every list probed the allowed top-k is exact (brute force over the
    allowed rows), and no denied id appears."""
    rng = np.random.default_rng(3)
    n, d, nlist, k = 2000, 32, 16, 5
    x = rng.standard_normal((n, d)).astype(np.float32)
    cent = x[rng.choice(n, nlist, replace=False)]
    assign = ((x[:, None, :] - cent[None]) ** 2).sum(-1).argmin(1)
    _, ta, cap, _, _ = _stores(assign, np.arange(n), x, nlist)
    allow_corpus = rng.random(n) < 0.2
    q = x[rng.choice(n, b, replace=False)] + 0.05 * rng.standard_normal((b, d)).astype(np.float32)
    _, si = _port_search(q, cent, ta, None, T(_row_allow(ta, allow_corpus)), metric=metric,
                         nprobe=nlist, probe_cap=cap, k=k)
    allowed = np.nonzero(allow_corpus)[0]
    sub = x[allowed].astype(np.float64)
    qq = q.astype(np.float64)
    if metric == Metric.L2:
        ref = ((qq[:, None, :] - sub[None]) ** 2).sum(-1)
    elif metric == Metric.INNER_PRODUCT:
        ref = -(qq @ sub.T)
    else:
        ref = 1.0 - (qq / np.linalg.norm(qq, axis=1, keepdims=True)) @ (
            sub / np.linalg.norm(sub, axis=1, keepdims=True)).T
    truth = allowed[np.argsort(ref, axis=1, kind="stable")[:, :k]]
    np.testing.assert_array_equal(si, truth)


def test_disabled_lists_match_jax():
    cent, x, assign = _clustered(seed=9)
    ja, ta, cap, _, _ = _stores(assign, np.arange(len(x)), x, 13)
    q = np.random.default_rng(8).standard_normal((7, 32)).astype(np.float32)
    dis = np.zeros(13, bool)
    dis[[0, 4, 5]] = True
    jd, ji = _jax_search(q, cent, ja, None, None, jnp.asarray(dis), metric=Metric.L2,
                         nprobe=13, probe_cap=cap, k=10)
    td, ti = _port_search(q, cent, ta, None, None, T(dis), metric=Metric.L2, nprobe=13,
                          probe_cap=cap, k=10)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-4)
    assert not np.isin(ti, np.nonzero(np.isin(assign, [0, 4, 5]))[0]).any()


def test_cpu_tensors_take_the_plain_versions_and_k5_serves_large_k():
    cent, x, assign = _clustered(seed=2)
    _, ta, cap, _, _ = _stores(assign, np.arange(len(x)), x, 13)
    q = np.random.default_rng(3).standard_normal((3, 32)).astype(np.float32)
    kp.reset_launches()
    starts, lens = _probe_tables(q, cent, ta, 4)
    args = (T(q), starts, lens, ta.vecs, ta.sqnorms)
    kw = dict(nprobe=4, probe_cap=cap, metric=Metric.COSINE)
    assert torch.equal(kp.ivf_probe_scores(*args, **kw), kp.ivf_probe_scores_ref(*args, **kw))
    for a, r in zip(kp.ivf_probe_topc_rankmajor(*args, **kw),
                    kp.ivf_probe_topc_rankmajor_ref(*args, **kw)):
        assert torch.equal(a, r)
    # a serving batch with k above K3's candidates: K5's route, same answer
    # as the gather path
    td, ti = _port_search(q, cent, ta, metric=Metric.L2, nprobe=13, probe_cap=cap, k=600)
    gd, gi = tivf.ivf_search_flat(T(q), T(cent), ta, nprobe=13, probe_cap=cap, k=600)
    np.testing.assert_array_equal(ti, gi.numpy())
    assert set(kp.LAUNCHES.values()) == {0}


@pytest.mark.parametrize(
    "bad, err",
    [
        (lambda q, s, l, v, n: (q.double(), s, l, v, n), TypeError),
        (lambda q, s, l, v, n: (q, s, l, v.half(), n), TypeError),
        (lambda q, s, l, v, n: (q, s.long(), l, v, n), ValueError),
        (lambda q, s, l, v, n: (q, s, l, v[:-1], n[:-1]), ValueError),
        (lambda q, s, l, v, n: (q[:, :4], s, l, v, n), ValueError),
        (lambda q, s, l, v, n: (q, s, l, v.T.contiguous().T, n), ValueError),
    ],
    ids=["q-dtype", "vecs-dtype", "table-dtype", "rows", "dim", "strided"],
)
def test_wrappers_reject_what_the_kernels_do_not_take(bad, err):
    cent, x, assign = _clustered(n=300, seed=4)
    _, ta, cap, _, _ = _stores(assign, np.arange(len(x)), x, 13)
    q = x[:2].copy()
    starts, lens = _probe_tables(q, cent, ta, 3)
    for fn in (kp.ivf_probe_scores, kp.ivf_probe_scores_rankmajor, kp.ivf_probe_topc_rankmajor):
        with pytest.raises(err):
            fn(*bad(T(q), starts, lens, ta.vecs, ta.sqnorms), nprobe=3, probe_cap=cap)
    with pytest.raises(ValueError):
        kp.ivf_probe_scores(T(q), starts, lens, ta.vecs, ta.sqnorms, nprobe=3, probe_cap=100)


# ---------------------------------------------------------------------------
# replays of the CUDA schedules: K4/K5 list-major, K3 with merged partials
# ---------------------------------------------------------------------------


def _replay_k4(q, starts, lives, vecs, sqn, probe_cap, metric, *, group, chunk, slice_elems,
               deny_sentinel=False):
    """K4's list-major schedule in plain torch: probe_groups' groups, each
    group's chunks of rows read once, every pair's chain over k-slices of
    `slice_elems`, the scatter into [B, nprobe·probe_cap] (+inf past each
    pair's own live length). Checks that the groups cover every pair once."""
    b, nprobe = starts.shape
    qr, qterm = kp._query_terms(q, vecs.dtype, metric)
    order, glen = kp.probe_groups(starts, group)
    fs, fl = starts.reshape(-1).long(), lives.reshape(-1).long()
    out = torch.full((b * nprobe, probe_cap), float("nan"))
    seen = torch.zeros(b * nprobe, dtype=torch.int64)
    for pos in torch.nonzero(glen).flatten().tolist():
        pairs = order[pos : pos + int(glen[pos])].long()
        assert 1 <= len(pairs) <= group and (fs[pairs] == fs[pairs[0]]).all()
        seen[pairs] += 1
        start, maxlive = int(fs[pairs[0]]), int(fl[pairs].max())
        qb, qt = qr[pairs // nprobe], qterm[pairs // nprobe][:, None]
        for o0 in range(0, probe_cap, chunk):
            o1 = min(o0 + chunk, probe_cap)
            oend = max(o0, min(o1, maxlive))
            x = vecs[start + o0 : start + oend].float()
            g = torch.zeros((len(pairs), oend - o0))
            for k0 in range(0, q.shape[1], slice_elems):  # the chain runs on across slices
                for k in range(k0, min(k0 + slice_elems, q.shape[1])):
                    g = g + qb[:, k : k + 1] * x[None, :, k]
            dist = kp._probe_epilogue(g, qt, sqn[start + o0 : start + oend], metric, deny_sentinel)
            offs = torch.arange(o0, oend)
            out[pairs, o0:oend] = torch.where(offs < fl[pairs][:, None], dist, float("inf"))
            out[pairs, oend:o1] = float("inf")
    assert (seen == 1).all()
    return out.reshape(b, nprobe * probe_cap)


def _k4_case(case, arrays, starts, lens):
    """Probe tables [8, 4] for the schedule's edge cases over _packed's lists."""
    st, ln = starts.clone(), lens.clone()
    all_starts, all_lens = T(arrays.starts), T(arrays.lengths)
    big = int(torch.argmax(all_lens))
    if case == "one_list":  # every pair probes the longest list: a run of 32 > PROBE_GROUP
        st[:], ln[:] = all_starts[big], all_lens[big]
    elif case == "disabled":  # one start, live and disabled (live 0) pairs side by side
        st[:, :2], ln[:, 0] = all_starts[big], all_lens[big]
        ln[::2, 1] = 0
        ln[1::2, 1] = all_lens[big]
    elif case == "empty":  # probed lists with no live rows, and pairs with all live
        ln[:, ::2] = 0
    return st.contiguous(), ln.contiguous()


@pytest.mark.parametrize("case", ["selected", "one_list", "disabled", "empty"])
def test_k4_list_major_replay_matches_plain_and_jax(case):
    """The replay of K4's schedule equals the plain version bit for bit (and
    K5's with the deny sentinel), and JAX's interpret-mode kernel within
    rtol=atol=1e-5; groups of 4 and 16, chunks shorter than the longest
    list, one-element and 8-element k-slices."""
    x, centers, arrays, vecs, sqn, cap, q = _packed(4000, 32, 16, 3, 8)
    (js, jl), (ts, tl) = _tables_both(q, centers, arrays, 4)
    ts, tl = _k4_case(case, arrays, ts, tl)
    assert int(arrays.lengths.max()) > 128  # some list spans several chunks
    args = dict(nprobe=4, probe_cap=cap)
    ref = kp.ivf_probe_scores_ref(T(q), ts, tl, vecs, sqn, **args)
    for group, chunk, sl in ((kp.PROBE_GROUP, 128, 8), (4, 256, 1)):
        got = _replay_k4(T(q), ts, tl, vecs, sqn, cap, Metric.L2, group=group, chunk=chunk,
                         slice_elems=sl)
        assert torch.equal(got, ref), (group, chunk)
    deny = torch.where(torch.arange(sqn.shape[0]) % 7 == 0, float("inf"), sqn)
    got5 = _replay_k4(T(q), ts, tl, vecs, deny, cap, Metric.INNER_PRODUCT, group=kp.PROBE_GROUP,
                      chunk=128, slice_elems=8, deny_sentinel=True)
    assert torch.equal(got5, kp.ivf_probe_scores_rankmajor_ref(
        T(q), ts, tl, vecs, deny, metric=Metric.INNER_PRODUCT, **args))
    a = jkp.ivf_probe_scores(jnp.asarray(q), jnp.asarray(ts.numpy()), jnp.asarray(tl.numpy()),
                             arrays.vecs, arrays.sqnorms, interpret=True, **args)
    _assert_scores_close(got, a)


def test_probe_groups_cut_long_runs_and_keep_their_order():
    """A run of one start longer than the group cap splits into groups of
    at most `group` pairs, in pair order (the sort is stable)."""
    starts = torch.tensor([[512, 0, 512], [512, 256, 512], [0, 512, 512]], dtype=torch.int32)
    order, glen = kp.probe_groups(starts, 3)
    assert order.tolist() == [1, 6, 4, 0, 2, 3, 5, 7, 8]
    assert glen.tolist() == [2, 0, 1, 3, 0, 0, 3, 0, 0]


def _insert_keep(td, ti, v, r):
    """csrc/ivf_probe.cu's insert_keep over every class at once: keep the 4
    smallest finite (dist, row) pairs sorted; the new pair sinks to its
    place and the largest falls off."""
    for j in range(td.shape[1]):
        less = np.isfinite(v) & ((v < td[:, j]) | ((v == td[:, j]) & (r < ti[:, j])))
        sd, sr = td[:, j].copy(), ti[:, j].copy()
        td[:, j], ti[:, j] = np.where(less, v, sd), np.where(less, r, sr)
        v, r = np.where(less, sd, v), np.where(less, sr, r)


@pytest.mark.parametrize("chunk", [256, 512, "probe_cap"])
def test_k3_merge_of_chunk_partials_in_any_order_matches_plain(chunk):
    """K3's one-launch schedule replayed: per (pair, chunk) the per-class
    top-4 of the live rows (a partial), merged per query in a shuffled
    order by the kernel's insert, equals the plain version bit for bit —
    drop_min included — at every chunk size."""
    nprobe = 8
    x, centers, arrays, vecs, sqn, cap, q = _packed(4000, 32, 16, 11, 8)
    _, (ts, tl) = _tables_both(q, centers, arrays, nprobe)
    chunk = cap if chunk == "probe_cap" else chunk
    deny = torch.where(torch.arange(sqn.shape[0]) % 5 == 0, float("inf"), sqn)
    args = (T(q), ts, tl, vecs, deny)
    dist, rows = kp._probe_dist_ref(*args, probe_cap=cap, metric=Metric.COSINE, deny_sentinel=True)
    dist, rows = dist.numpy().reshape(8, nprobe, cap), rows.numpy().reshape(8, nprobe, cap)
    keep, rng = kp.TIERS + 1, np.random.default_rng(chunk)
    cand_d, cand_r = np.empty((8, kp.TIERS * kp.CBINS), np.float32), np.empty((8, 768), np.int64)
    drop = np.empty((8, kp.CBINS), np.float32)
    for b in range(8):
        parts = []
        for p in range(nprobe):
            for o0 in range(0, int(tl[b, p]), chunk):  # live chunks only
                td = np.full((kp.CBINS, keep), np.inf, np.float32)
                ti = np.full((kp.CBINS, keep), 0x7FFFFFFF, np.int64)
                for o in range(o0, min(o0 + chunk, int(tl[b, p])), kp.CBINS):
                    sl = slice(o, min(o + kp.CBINS, int(tl[b, p])))
                    v = np.full(kp.CBINS, np.inf, np.float32)
                    r = np.full(kp.CBINS, 0x7FFFFFFF, np.int64)
                    cls = rows[b, p, sl] % kp.CBINS
                    v[cls], r[cls] = dist[b, p, sl], rows[b, p, sl]
                    _insert_keep(td, ti, v, r)
                parts.append((td, ti))
        td = np.full((kp.CBINS, keep), np.inf, np.float32)
        ti = np.full((kp.CBINS, keep), 0x7FFFFFFF, np.int64)
        for i in rng.permutation(len(parts)):
            for t in range(keep):
                _insert_keep(td, ti, parts[i][0][:, t].copy(), parts[i][1][:, t].copy())
        cand_d[b] = td[:, : kp.TIERS].T.reshape(-1)
        cand_r[b] = np.where(np.isfinite(td[:, : kp.TIERS]), ti[:, : kp.TIERS], 0).T.reshape(-1)
        drop[b] = td[:, kp.TIERS]
    rd, rr, rdrop = kp.ivf_probe_topc_rankmajor_ref(*args, nprobe=nprobe, probe_cap=cap,
                                                     metric=Metric.COSINE)
    assert np.array_equal(cand_d, rd.numpy()) and np.array_equal(cand_r, rr.numpy())
    assert np.array_equal(drop, rdrop.numpy())


def test_k3_chunking_fills_the_grid():
    """K3's chunk rule: at B=8, nprobe=32, probe_cap 2,048 (the IVF main
    path) one chunk a pair, the whole list; a long probe_cap splits into
    TOPC_CHUNK_MIN-row chunks while the grid stays near TOPC_GRID CTAs; the
    chunk is a multiple of BLK and covers probe_cap."""
    assert kp._topc_chunk_rows(2048, 8 * 32) == 2048
    assert kp._topc_chunk_rows(16384, 8 * 16) == 2048
    assert kp._topc_chunk_rows(16384, 16 * 256) == 16384
    for cap, pairs in ((256, 1), (2048, 16 * 1024), (65536, 8), (4096, 3 * 8)):
        chunk = kp._topc_chunk_rows(cap, pairs)
        assert chunk % kp.BLK == 0 and 0 < chunk <= cap and -(-cap // chunk) <= max(1, kp.TOPC_GRID)
    assert kp._topc_chunk_rows_v1(2048) == 2048 and kp._topc_chunk_rows_v1(16384) == 4096
