"""The port's IVFPQIndex (vectorindex_tpu_torch.models.ivf) against the JAX
package's, and its own behaviour as tests/test_ivfpq.py and
tests/test_ivf_spill.py check it.

The slice as a whole: a JAX IVFPQIndex is built and trained (coarse
quantizer, spill copies, PQ codebooks), carried across with
IVFPQIndex.from_state, and both search on the CPU — the port through
ivf_search_pq_probe with K9/K10's plain versions, the JAX package through
its XLA route. The two routes keep the same ADC candidates only where their
candidate counts agree (rerank_c >= max(4k, 128)), so the configs use
rerank_c=512 with k=10; both then rerank exactly at f32. Ids must be equal
except at a rank whose JAX distance lies within RTOL/ATOL (rtol=2e-4,
atol=2e-5) of a neighbouring rank's; distances within the same tolerance.
The port's own optimize() cannot replay JAX's random draws, so its recall
must come within 0.05 of the JAX index's on the same data.
"""

import json

import numpy as np
import pytest
import torch

from vectorindex_tpu.models.ivf import IVFPQConfig as JConfig
from vectorindex_tpu.models.ivf import IVFPQIndex as JIndex
from vectorindex_tpu.utils.config import Metric as JMetric
from vectorindex_tpu_torch import IVFPQConfig, IVFPQIndex
from vectorindex_tpu_torch.kernels import adc_probe as ap
from vectorindex_tpu_torch.utils.config import Metric
from vectorindex_tpu_torch.utils.errors import IndexError, IndexErrorKind
from vectorindex_tpu_torch.utils.parity import ATOL, RTOL, ids_match_up_to_ties

torch.set_num_threads(1)

K = 10
N, D = 2000, 16


def _meta(i):
    return {"even": i % 2 == 0}


def _ids(res):
    return [[r.id for r in row] for row in res]


def _ascending(row, metric):
    s = np.array([[r.score for r in row]], dtype=np.float64)
    return s * s if metric == Metric.L2 else -s


def _assert_same(got, want, metric, k=K):
    """got: port results for k; want: JAX results for k + 1 (or k under a
    metadata filter). Row by row, since a filter may leave fewer than k."""
    assert [len(r) for r in got] == [min(k, len(r)) for r in want]
    for g_row, w_row in zip(got, want):
        n = len(g_row)
        wd = _ascending(w_row, metric)
        np.testing.assert_allclose(_ascending(g_row, metric), wd[:, :n], rtol=RTOL, atol=ATOL)
        assert ids_match_up_to_ties([[r.id for r in g_row]], [[r.id for r in w_row]], wd, n)


def _jax_state(j):
    return {
        "dimension": j.dimension,
        "metric": j.metric.value,
        "config": {f: getattr(j.config, f) for f in j.config.__dataclass_fields__},
        "storage_dtype": "float32",
        "vectors": dict(j._vectors),
        "metadata": dict(j._metadata),
        "ids": list(j._idmap.items()),
        "free": list(j._free),
        "next_slot": j._next_slot,
        "centroids": j._centroids,
        "lists": [list(ids) for ids in j._store._lists_ids],
        "slot_list": dict(j._slot_list),
        "slot_spill": dict(j._slot_spill),
        "books": None if j._books is None else np.asarray(j._books.centroids),
    }


CONFIGS = {
    "l2-u8": (Metric.L2, dict(m=4, ks=256)),
    "l2-u4-spill": (Metric.L2, dict(m=8, ks=16, spill_eps=0.2)),
    "ip-u8-spill": (Metric.INNER_PRODUCT, dict(m=4, ks=256, spill_eps=0.2)),
    "ip-u4": (Metric.INNER_PRODUCT, dict(m=8, ks=16)),
}


def _cfg(**kw):
    return dict(nlist=8, nprobe=3, rerank_c=512, pq_iters=4, **kw)


def _data(seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D)).astype(np.float32)
    q = x[rng.choice(N, 20, replace=False)] + 0.1 * rng.standard_normal((20, D)).astype(np.float32)
    return x, q


@pytest.mark.parametrize("name", list(CONFIGS))
def test_from_state_searches_like_jax(name):
    metric, pqkw = CONFIGS[name]
    x, q = _data()
    j = JIndex(D, JMetric(metric.value), JConfig(**_cfg(**pqkw)))
    j.insert_batch(list(range(N - 100)), x[: N - 100], [_meta(i) for i in range(N - 100)])
    j.optimize()
    j.insert_batch(list(range(N - 100, N)), x[N - 100 :], [_meta(i) for i in range(N - 100, N)])
    for i in range(0, N, 17):
        j.remove(i)
    for i in range(1, 60, 7):
        j.update(i, vector=x[i] + 0.5)
    t = IVFPQIndex.from_state(_jax_state(j), device="cpu")
    assert t.count == j.count and t.trained and t.pq_trained
    assert t._store._lists_ids == j._store._lists_ids
    assert t._slot_spill == j._slot_spill and t._slot_list == j._slot_list
    if "spill" in name:
        assert len(t._slot_spill) > 0.05 * t.count
    allow = list(range(0, N, 3))
    ap.reset_launches()
    _assert_same(t.batch_search(q[:8], K), j.batch_search(q[:8], K + 1), metric)
    even = lambda m: m is not None and m["even"]  # noqa: E731
    _assert_same(t.batch_search(q, K, filter=even, allow_ids=allow),
                 j.batch_search(q, K, filter=even, allow_ids=allow), metric)
    _assert_same(t.batch_search(q[:8], K, disabled_lists=[1, 4]),
                 j.batch_search(q[:8], K + 1, disabled_lists=[1, 4]), metric)
    assert set(ap.LAUNCHES.values()) == {0}  # a CPU index takes the plain versions
    for row in t.batch_search(q, K, allow_ids=allow):
        assert len({r.id for r in row}) == K and all(r.id in set(allow) for r in row)


def test_own_optimize_recall_within_005_of_jax():
    x, _ = _data()
    rng = np.random.default_rng(1)
    q = x[:100] + 0.1 * rng.standard_normal((100, D)).astype(np.float32)
    truth = np.argsort(((q[:, None, :] - x[None]) ** 2).sum(-1), axis=1, kind="stable")[:, :K]

    def recall(res):
        return np.mean([len(set(r) & set(tr.tolist())) / K for r, tr in zip(_ids(res), truth)])

    j = JIndex(D, JMetric.L2, JConfig(**_cfg(m=4, ks=256)))
    j.insert_batch(list(range(N)), x)
    j.optimize()
    t = IVFPQIndex(D, Metric.L2, IVFPQConfig(**_cfg(m=4, ks=256)), device="cpu")
    t.insert_batch(list(range(N)), x)
    t.optimize()
    assert t._books.centroids.shape == (4, 256, 4)
    rj, rt = recall(j.batch_search(q, K)), recall(t.batch_search(q, K))
    assert rj < 0.95  # nprobe < nlist on unclustered data: routing matters
    assert abs(rt - rj) <= 0.05


@pytest.mark.parametrize("spill", [0.0, 0.2], ids=["plain", "spill"])
def test_incremental_sync_equals_full_rebuild(spill):
    x, _ = _data(5)
    idx = IVFPQIndex(D, Metric.L2, IVFPQConfig(**_cfg(m=8, ks=16, spill_eps=spill)), device="cpu")
    idx.insert_batch(list(range(1500)), x[:1500])
    idx.optimize()
    idx.batch_search(x[:2], K)  # packs and encodes
    layout = idx._store.layout_version
    for i in range(1500, 1520):  # in place: the lists have spare capacity
        idx.insert(i, x[i])
    got = idx.batch_search(x[1500:1508], K)
    assert idx._store.layout_version == layout and idx._store._patch_log
    codes, tcorr = idx._pq_cache["codes"].clone(), idx._pq_cache["tcorr"].clone()
    idx._pq_cache = None
    _, full_codes, full_tcorr = idx._sync_pq()
    assert torch.equal(codes, full_codes) and torch.equal(tcorr, full_tcorr)
    assert [row[0].id for row in got] == list(range(1500, 1508))


def test_json_snapshot_crosses_packages(tmp_path):
    x = np.random.default_rng(40).standard_normal((300, 8)).astype(np.float32)
    cfg = dict(nlist=4, nprobe=4, m=4, ks=16, rerank_c=512)
    j = JIndex(8, JMetric.L2, JConfig(**cfg))
    j.insert_batch(list(range(300)), x, [_meta(i) for i in range(300)])
    t = IVFPQIndex(8, Metric.L2, IVFPQConfig(**cfg, spill_eps=0.1), device="cpu")
    t.insert_batch(list(range(300)), x, [_meta(i) for i in range(300)])
    j.save(str(tmp_path / "jax.json"))
    t.save(str(tmp_path / "torch.json"))
    js = json.loads((tmp_path / "jax.json").read_text())
    ts = json.loads((tmp_path / "torch.json").read_text())
    # the port also writes spill_eps (the JAX package drops it); the rest is equal
    assert ts["config"].pop("spill_eps") == 0.1 and ts == js
    t2 = IVFPQIndex.load(str(tmp_path / "jax.json"), device="cpu")
    j2 = JIndex.load(str(tmp_path / "torch.json"))
    t3 = IVFPQIndex.load(str(tmp_path / "torch.json"), device="cpu")
    assert t2.config.spill_eps == 0.0 and t3.config.spill_eps == 0.1 and j2.config.spill_eps == 0.0
    assert t2.count == j2.count == 300 and t2.pq_trained and j2.pq_trained
    q = x[:6] + 0.01
    want = np.argsort(((q[:, None, :] - x[None]) ** 2).sum(-1), axis=1, kind="stable")[:, :K]
    # nprobe == nlist and rerank_c >= n: both searches are exact
    assert _ids(t2.batch_search(q, K)) == want.tolist() == _ids(j2.batch_search(q, K))
    assert _ids(t3.batch_search(q, K)) == want.tolist()
    assert t3.batch_search(q[:1], K)[0][0].metadata == _meta(int(want[0, 0]))


# -- the port's own behaviour (tests/test_ivfpq.py, tests/test_ivf_spill.py) --


def test_end_to_end_crud_and_statistics():
    x, _ = _data(7)
    idx = IVFPQIndex(D, config=IVFPQConfig(nlist=8, nprobe=8, m=8, ks=16, pq_iters=4), device="cpu")
    idx.insert_batch(list(range(1000)), x[:1000])
    assert not idx.pq_trained
    assert idx.search(x[3], K)[0].id == 3  # untrained: IVF-Flat's exact scan
    idx.optimize()
    assert idx.search(x[5] + 0.001, K)[0].id == 5
    idx.insert(5000, x[1500])  # trained insert: assigned and encoded
    assert idx.search(x[1500], 1)[0].id == 5000
    idx.remove(5000)
    assert all(r.id != 5000 for r in idx.search(x[1500], K))
    idx.update(7, vector=x[1600])
    assert idx.search(x[1600], 1)[0].id == 7
    st = idx.statistics()
    assert (st.count, st.details["pq_m"], st.details["pq_ks"], st.details["pq_trained"],
            st.details["code_bytes_per_vector"]) == (1000, 8, 16, True, 4)
    batches = [x[:4], x[4:9]]
    streamed = list(idx.batch_search_stream(batches, 3))
    assert [_ids(b) for b in streamed] == [_ids(idx.batch_search(b, 3)) for b in batches]
    no_rerank = IVFPQIndex(D, config=IVFPQConfig(nlist=8, nprobe=8, m=8, ks=16, rerank=False,
                                                 pq_iters=4), device="cpu")
    no_rerank.insert_batch(list(range(1000)), x[:1000])
    no_rerank.optimize()
    res = no_rerank.batch_search(x[:8] + 0.001, K)
    assert sum(row[0].id == i for i, row in enumerate(res)) >= 6  # ADC ranking alone
    assert all(len(row) == K for row in res)


def test_spill_copies_crud_and_dedup():
    x, q = _data(9)
    idx = IVFPQIndex(D, config=IVFPQConfig(**_cfg(m=8, ks=16, spill_eps=0.3, rerank=False)),
                     device="cpu")
    idx.insert_batch(list(range(N)), x)
    idx.optimize()
    spilled = dict(idx._slot_spill)
    assert len(spilled) > 0.1 * N
    copies = sum(len(ids) for ids in idx._store._lists_ids)
    assert copies == N + len(spilled)
    slot = next(iter(spilled))
    ext = idx._idmap.external_for(slot)
    idx.remove(ext)
    assert sum(len(ids) for ids in idx._store._lists_ids) == copies - 2
    idx.insert(ext, x[slot])
    for row in idx.batch_search(q, K):  # rerank off: ranked by ADC, dedup'd
        ids = [r.id for r in row]
        assert len(ids) == K and len(set(ids)) == K


def test_config_errors_and_host_tier_entry_points():
    with pytest.raises(IndexError) as info:
        IVFPQIndex(15, config=IVFPQConfig(m=4), device="cpu")
    assert info.value.kind == IndexErrorKind.INVALID_CONFIGURATION
    with pytest.raises(IndexError) as info:
        IVFPQIndex(16, config=IVFPQConfig(m=3, ks=16), device="cpu")
    assert info.value.kind == IndexErrorKind.INVALID_CONFIGURATION
    with pytest.raises(IndexError) as info:
        IVFPQIndex(16, Metric.COSINE, device="cpu")
    assert info.value.kind == IndexErrorKind.UNSUPPORTED_METRIC
    x, _ = _data(11)
    host = IVFPQIndex(D, config=IVFPQConfig(nlist=4, nprobe=4, m=4, ks=16, pq_iters=2,
                                            host_rerank=True), device="cpu")
    host.insert_batch(list(range(600)), x[:600])
    host.optimize()
    # the host-rerank tier searches, opens a session and streams
    res = host.batch_search(x[:2], 3)
    assert [row[0].id for row in res] == [0, 1]
    sess = host.serve_session()
    assert sess.arrays.vecs is None
    assert sess.search(x[:2], 3)[1][:, 0].tolist() == [host._idmap.lookup(i) for i in (0, 1)]
    streamed = list(host.batch_search_stream([x[:2]], 3))
    assert [[r.id for r in row] for row in streamed[0]] == [[r.id for r in row] for row in res]
    plain = IVFPQIndex(D, config=IVFPQConfig(nlist=4, m=4, ks=16), device="cpu")
    with pytest.raises(ValueError, match="host-rerank tier"):
        plain.serve_session()
    assert plain.search(x[0], 3) == [] and IVFPQConfig().__dict__ == JConfig().__dict__
