"""The port's IVFIndex (vectorindex_tpu_torch.models.ivf) against the JAX
package's, and its own behaviour as tests/test_ivf.py, the IVF cases of
tests/test_id_filtering.py and tests/test_filters_advanced.py check it.

The slice as a whole: a JAX IVFIndex is built and trained, carried across
with IVFIndex.from_state, and both search on the CPU at f32 storage (the
port through its probe kernels' plain versions, the JAX package through its
gather path; both are exact within the probed lists). Ids must be equal
except at a rank whose JAX distance lies within RTOL/ATOL (rtol=2e-4,
atol=2e-5) of a neighbouring rank's; distances within the same tolerance.
The port's own optimize() cannot replay JAX's random draws, so its recall
must come within 0.05 of the JAX index's on the same data.
"""

import numpy as np
import pytest
import torch

from vectorindex_tpu.models.filters import JournalFilter as JJournalFilter
from vectorindex_tpu.models.ivf import IVFConfig as JConfig
from vectorindex_tpu.models.ivf import IVFIndex as JIndex
from vectorindex_tpu.utils.config import Metric as JMetric
from vectorindex_tpu_torch import IVFConfig, IVFIndex
from vectorindex_tpu_torch.kernels import ivf_probe as kp
from vectorindex_tpu_torch.models.filters import JournalFilter
from vectorindex_tpu_torch.utils.config import Metric
from vectorindex_tpu_torch.utils.errors import IndexError, IndexErrorKind
from vectorindex_tpu_torch.utils.parity import ATOL, RTOL, ids_match_up_to_ties

torch.set_num_threads(1)

K = 10


def _data(n=400, d=16, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _meta(i):
    return {"even": i % 2 == 0, "date": f"2024-01-{1 + i % 28:02d}",
            "tags": "a,b" if i % 3 == 0 else "c"}


def _index(x, metric=Metric.L2, nlist=16, nprobe=16, meta=False, optimize=True):
    idx = IVFIndex(x.shape[1], metric, IVFConfig(nlist=nlist, nprobe=nprobe), device="cpu")
    idx.insert_batch(list(range(len(x))), x, [_meta(i) for i in range(len(x))] if meta else None)
    if optimize:
        idx.optimize()
    return idx


def _ids(res):
    return [[r.id for r in row] for row in res]


def _ascending(row, metric):
    s = np.array([[r.score for r in row]], dtype=np.float64)
    return {Metric.L2: s * s, Metric.INNER_PRODUCT: -s, Metric.COSINE: 1.0 - s}[metric]


def _assert_same(got, want, metric, k=K):
    """got: port results for k; want: JAX results for k + 1, or for k where
    a metadata filter makes the oversampling depend on k. Row by row, since
    a filter may leave fewer than k results."""
    assert [len(r) for r in got] == [min(k, len(r)) for r in want]
    for g_row, w_row in zip(got, want):
        n = len(g_row)
        wd = _ascending(w_row, metric)
        np.testing.assert_allclose(_ascending(g_row, metric), wd[:, :n], rtol=RTOL, atol=ATOL)
        assert ids_match_up_to_ties([[r.id for r in g_row]], [[r.id for r in w_row]], wd, n)
        by_id = {r.id: r.metadata for r in w_row}
        assert all(r.metadata == by_id[r.id] for r in g_row if r.id in by_id)


def _jax_state(j):
    return {
        "dimension": j.dimension,
        "metric": j.metric.value,
        "config": {"nlist": j.config.nlist, "nprobe": j.config.nprobe,
                   "train_iters": j.config.train_iters, "seed": j.config.seed},
        "storage_dtype": "float32",
        "vectors": dict(j._vectors),
        "metadata": dict(j._metadata),
        "ids": list(j._idmap.items()),
        "free": list(j._free),
        "next_slot": j._next_slot,
        "centroids": j._centroids,
        "lists": [list(ids) for ids in j._store._lists_ids],
    }


def _trained_pair(metric, n=2000, d=32, nlist=16, nprobe=4, seed=3):
    """A trained JAX index with removes, updates and post-training inserts,
    and the port's index carried across from its state."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    j = JIndex(d, JMetric(metric.value), JConfig(nlist=nlist, nprobe=nprobe))
    j.insert_batch(list(range(n - 100)), x[: n - 100], [_meta(i) for i in range(n - 100)])
    j.optimize()
    j.insert_batch(list(range(n - 100, n)), x[n - 100 :], [_meta(i) for i in range(n - 100, n)])
    for i in range(0, n, 13):
        j.remove(i)
    for i in range(1, 60, 7):
        j.update(i, vector=x[i] + 0.5, metadata={"even": False, "tags": "z"})
    t = IVFIndex.from_state(_jax_state(j), device="cpu")
    return j, t, x, rng


@pytest.mark.parametrize(
    "metric, b",
    [(Metric.L2, 8), (Metric.INNER_PRODUCT, 8), (Metric.COSINE, 8), (Metric.L2, 20)],
    ids=["l2-k3", "ip-k3", "cos-k3", "l2-pair"],
)
def test_from_state_searches_like_jax(metric, b):
    j, t, x, rng = _trained_pair(metric)
    assert t.count == j.count and t.trained
    assert [len(l) for l in t._store._lists_ids] == [len(l) for l in j._store._lists_ids]
    ta, ja = t._store.sync_device(), j._store.sync_device()
    np.testing.assert_array_equal(ta.row_ids.numpy(), np.asarray(ja.row_ids))
    q = x[rng.choice(len(x), b, replace=False)] + 0.1 * rng.standard_normal((b, x.shape[1])).astype(np.float32)
    allow = list(range(0, len(x), 3))
    deny = list(range(0, len(x), 5))
    jf = JJournalFilter().date_between("2024-01-05", "2024-01-20").including_tags("a").compile()
    tf = JournalFilter().date_between("2024-01-05", "2024-01-20").including_tags("a").compile()
    cases = [
        ({}, {}),
        (dict(allow_ids=allow),) * 2,
        (dict(deny_ids=deny),) * 2,
        (dict(allow_ids=allow, deny_ids=deny),) * 2,
        (dict(filter=lambda m: m is not None and m["even"]),) * 2,
        (dict(filter=jf), dict(filter=tf)),
        (dict(disabled_lists=[0, 3, 7]),) * 2,
    ]
    for jkw, tkw in cases:
        kj = K if "filter" in jkw else K + 1
        _assert_same(t.batch_search(q, K, **tkw), j.batch_search(q, kj, **jkw), metric)
    _assert_same([t.search(q[0], K)], [j.search(q[0], K + 1)], metric)
    # both allocate the same slots afterwards
    j.insert("new", np.ones(x.shape[1]))
    t.insert("new", np.ones(x.shape[1]))
    assert t._idmap.lookup("new") == j._idmap.lookup("new")
    assert t._slot_list[t._idmap.lookup("new")] == j._slot_list[j._idmap.lookup("new")]


def test_own_optimize_recall_within_005_of_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2000, 16)).astype(np.float32)
    q = x[:200] + 0.1 * rng.standard_normal((200, 16)).astype(np.float32)
    truth = np.argsort(((q[:, None, :] - x[None]) ** 2).sum(-1), axis=1, kind="stable")[:, :K]

    def recall(res):
        return np.mean([len(set(r) & set(t.tolist())) / K for r, t in zip(_ids(res), truth)])

    j = JIndex(16, JMetric.L2, JConfig(nlist=16, nprobe=4))
    j.insert_batch(list(range(len(x))), x)
    j.optimize()
    t = _index(x, nlist=16, nprobe=4)
    rj, rt = recall(j.batch_search(q, K)), recall(t.batch_search(q, K))
    assert rj < 0.9  # nprobe < nlist on unclustered data: routing matters
    assert abs(rt - rj) <= 0.05


def test_json_snapshot_crosses_packages(tmp_path):
    x = _data(300, 8, seed=40)
    j = JIndex(8, JMetric.L2, JConfig(nlist=8, nprobe=8))
    j.insert_batch(list(range(300)), x, [_meta(i) for i in range(300)])
    t = _index(x, nlist=8, nprobe=8, meta=True, optimize=False)
    j.save(str(tmp_path / "jax.json"))
    t.save(str(tmp_path / "torch.json"))
    assert (tmp_path / "jax.json").read_bytes() == (tmp_path / "torch.json").read_bytes()
    t2 = IVFIndex.load(str(tmp_path / "jax.json"), device="cpu")
    j2 = JIndex.load(str(tmp_path / "torch.json"))
    assert t2.count == j2.count == 300 and t2.trained and j2.trained
    q = x[:6] + 0.01
    # nprobe == nlist: both searches are exact whatever the centroids
    _assert_same(t2.batch_search(q, K), j2.batch_search(q, K + 1), Metric.L2)


# -- the port's own behaviour (tests/test_ivf.py) --


def test_end_to_end_recall_and_monotone_nprobe():
    x = _data(400, 16, seed=11)
    res = _index(x).search(x[7], k=5)
    assert res[0].id == 7
    assert {r.id for r in res} == set(np.argsort(np.linalg.norm(x - x[7], axis=1))[:5].tolist())
    q = x[:40] + 0.01 * _data(40, 16, seed=12)
    truth = np.argsort(((q[:, None, :] - x[None]) ** 2).sum(-1), axis=1)[:, :5]
    recalls = []
    for nprobe in (1, 4, 16):
        rows = _index(x, nprobe=nprobe).batch_search(q, k=5)
        recalls.append(np.mean([len(set(r) & set(t.tolist())) / 5 for r, t in zip(_ids(rows), truth)]))
    assert recalls[0] <= recalls[1] + 0.05 <= recalls[2] + 0.1 and recalls[2] >= 0.99


def test_untrained_insert_after_train_update_and_remove():
    x = _data(200, 8)
    idx = _index(x[:150], nlist=8, nprobe=8, optimize=False)
    assert idx.search(x[3], k=3)[0].id == 3  # untrained: exact scan
    idx.optimize()
    idx.insert_batch(list(range(150, 200)), x[150:])  # assigned immediately
    assert idx.search(x[180], k=1)[0].id == 180
    idx.remove(180)
    assert idx.search(x[180], k=1)[0].id != 180
    assert idx.statistics().details["assigned"] == 199
    idx.update(5, vector=x[50] + 5.0)
    assert idx.search(x[50] + 5.0, k=1)[0].id == 5
    idx.insert("single", x[60] + 7.0)
    assert idx.search(x[60] + 7.0, k=1)[0].id == "single"
    st = idx.statistics()
    assert (st.count, st.details["nlist"], st.details["trained"]) == (200, 8, True)


@pytest.mark.parametrize("metric", [Metric.INNER_PRODUCT, Metric.COSINE], ids=lambda m: m.value)
def test_metrics_ip_cosine(metric):
    x = _data(200, 8, seed=20)
    res = _index(x, metric, nlist=8, nprobe=8).search(x[9], k=5)
    q = x[9]
    score = x @ q if metric == Metric.INNER_PRODUCT else (x @ q) / (np.linalg.norm(x, axis=1) * np.linalg.norm(q))
    assert {r.id for r in res} == set(np.argsort(-score)[:5].tolist())


def test_filter_oversampling_and_persistence(tmp_path):
    x = _data(300, 8, seed=30)
    idx = IVFIndex(8, config=IVFConfig(nlist=8, nprobe=8), device="cpu")
    idx.insert_batch(list(range(300)), x, [{"even": i % 2 == 0} for i in range(300)])
    idx.optimize()
    res = idx.search(x[0], k=10, filter=lambda m: m and m["even"])
    assert len(res) == 10 and all(r.metadata["even"] for r in res)
    idx.save(str(tmp_path / "ivf.json"))
    idx2 = IVFIndex.load(str(tmp_path / "ivf.json"), device="cpu")
    assert idx2.count == 300 and idx2.trained
    assert [r.id for r in idx.search(x[9], k=5)] == [r.id for r in idx2.search(x[9], k=5)]


def test_errors_and_unported_parts(tmp_path):
    with pytest.raises(IndexError) as info:
        IVFIndex(8, metric=Metric.MANHATTAN, device="cpu")
    assert info.value.kind == IndexErrorKind.UNSUPPORTED_METRIC
    with pytest.raises(IndexError) as info:
        IVFIndex(8, storage_dtype=torch.float16, device="cpu")
    assert info.value.kind == IndexErrorKind.INVALID_CONFIGURATION
    idx = _index(_data(50, 8), nlist=4, nprobe=4)
    for call, kind in [
        (lambda: idx.insert(0, np.ones(8)), IndexErrorKind.DUPLICATE_ID),
        (lambda: idx.insert("c", np.ones(5)), IndexErrorKind.DIMENSION_MISMATCH),
        (lambda: idx.insert("c", [0, np.nan] + [0] * 6), IndexErrorKind.INVALID_VECTOR),
        (lambda: idx.search(np.ones(3), 1), IndexErrorKind.DIMENSION_MISMATCH),
        (lambda: idx.ingest_flat([999], np.ones((1, 8)), [99]), IndexErrorKind.OUT_OF_RANGE),
    ]:
        with pytest.raises(IndexError) as info:
            call()
        assert info.value.kind == kind
    idx.checkpoint()  # not durable: nothing to do
    idx.close_durable()
    for call in (lambda: idx.enable_durable(str(tmp_path / "no_dir" / "i.vx")),
                 lambda: IVFIndex.load_durable(str(tmp_path / "missing.vx"), device="cpu")):
        with pytest.raises(IndexError) as info:
            call()
        assert info.value.kind == IndexErrorKind.IO_ERROR
    assert idx._durable is None
    assert idx.search(np.ones(8), 0) == []
    assert IVFIndex(8, device="cpu").search(np.ones(8), 3) == []


def test_ingest_flat_and_refresh_quantizer():
    rng = np.random.default_rng(21)
    n, d = 4000, 16
    x = rng.standard_normal((n, d)).astype(np.float32)
    idx = _index(x[:3000], nlist=32, nprobe=8)
    assigns = idx._assign_lists(x[3000:])
    idx.ingest_flat(list(range(3000, n)), x[3000:], assigns)
    assert idx.count == n and idx.search(x[3500], k=1)[0].id == 3500
    xnew = (rng.standard_normal((1000, d)) * 0.3 + 4.0).astype(np.float32)
    idx.insert_batch(list(range(n, n + 1000)), xnew)
    idx.batch_search(xnew[:1], 1)
    stale_max = idx._store.max_length
    out = idx.refresh_quantizer(iters=5)
    assert out["moved_frac"] > 0.0 and idx._store.max_length < stale_max
    res = idx.batch_search(xnew[:16] + 0.001, 5)
    assert sum(1 for i, row in enumerate(res) if row and row[0].id == n + i) >= 15
    res = idx.batch_search(x[:16] + 0.001, 5)
    assert sum(1 for i, row in enumerate(res) if row and row[0].id == i) >= 15


# -- id filters (tests/test_id_filtering.py, IVF cases) --


def _corpus(n=2000, d=32, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = x[rng.choice(n, 8, replace=False)] + 0.01 * rng.standard_normal((8, d)).astype(np.float32)
    return x, q.astype(np.float32)


def _brute_allowed(q, x, allowed, k, metric=Metric.L2):
    sub, qq = x[allowed].astype(np.float64), q.astype(np.float64)
    if metric == Metric.L2:
        d = ((qq[:, None, :] - sub[None]) ** 2).sum(-1)
    elif metric == Metric.INNER_PRODUCT:
        d = -(qq @ sub.T)
    else:
        d = 1.0 - (qq / np.linalg.norm(qq, axis=1, keepdims=True)) @ (
            sub / np.linalg.norm(sub, axis=1, keepdims=True)).T
    return np.asarray(allowed)[np.argsort(d, axis=1, kind="stable")[:, :k]]


@pytest.mark.parametrize("metric", [Metric.L2, Metric.INNER_PRODUCT, Metric.COSINE],
                         ids=lambda m: m.value)
def test_allow_selective_full_probe_exact(metric):
    """nprobe == nlist: filtered results equal brute force over the allowed
    rows (the mask lands before selection), through the K3 route with the
    deny sentinel for every metric."""
    x, q = _corpus()
    idx = _index(x, metric)
    allowed = np.sort(np.random.default_rng(11).choice(len(x), len(x) // 10, replace=False))
    res = idx.batch_search(q, K, allow_ids=[int(a) for a in allowed] + [99999])
    assert _ids(res) == _brute_allowed(q, x, allowed, K, metric).tolist()


def test_deny_and_disabled_lists_and_untrained_filters():
    x, q = _corpus()
    idx = _index(x)
    base = _ids(idx.batch_search(q, K))
    denied = set(base[0]) | set(base[1])
    got = _ids(idx.batch_search(q, K, deny_ids=list(denied)))
    assert all(len(r) == K and not set(r) & denied for r in got)
    nn_slot = idx._idmap.lookup(base[0][0])
    dead = idx._slot_list[nn_slot]
    members = {s for s, l in idx._slot_list.items() if l == dead}
    for row in idx.batch_search(q, K, disabled_lists=[dead]):
        assert row and not any(idx._idmap.lookup(r.id) in members for r in row)
    small = _index(x[:300], nlist=8, optimize=False)
    got = _ids(small.batch_search(q, K, allow_ids=list(range(30))))
    assert got == _brute_allowed(q, x[:300], np.arange(30), K).tolist()


def test_large_k_serving_batch_takes_k5_route_on_cpu():
    """B <= 16 with k above K3's 512 candidates: the K5 route returns what
    the gather path returns (CPU tensors: plain versions, no launches)."""
    x, q = _corpus(n=1200, d=16)
    idx = _index(x, nlist=8, nprobe=8)
    kp.reset_launches()
    res = idx.batch_search(q[:3], 600)
    want = np.argsort(((q[:3, None, :].astype(np.float64) - x[None]) ** 2).sum(-1), axis=1, kind="stable")[:, :600]
    assert _ids(res) == want.tolist()
    assert set(kp.LAUNCHES.values()) == {0}
