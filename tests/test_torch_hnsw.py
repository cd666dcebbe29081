"""The port's HNSWIndex (vectorindex_tpu_torch.models.hnsw) against the JAX
package's, and its own behaviour as tests/test_hnsw.py,
tests/test_hnsw_more.py and tests/test_churn.py's
test_hnsw_batch_and_error_edges check it. Everything runs on the CPU.

  - Both packages draw levels with numpy from (seed, counter), so an
    independent port build on integer-valued rows (every f32 product and
    sum exact, every sort two-key) must equal the JAX graph field by field:
    every level's nbrs and node_ids, _lookup0, _levels, _entry (L2 and IP).
  - A JAX-built gaussian index carried across by HNSWIndex.from_state
    searches the very same graph: ids equal except at a rank whose JAX
    score lies within rtol=2e-4, atol=2e-5 of a neighbouring rank's
    (utils/parity), scores within that tolerance; with a metadata filter,
    allow_ids in both regimes, deny_ids and after remove.
  - The port's own gaussian build has recall@10 within 0.02 of JAX's.

JAX indices are module fixtures at HNSWConfig(m=8, ef_construction=48,
build_chunk=64) (the default chunk pads every JAX chunk to 1,024 queries),
d = 24 and 600 rows, except the gaussian L2 index: 2,600 rows, because
allow_ids takes the beam regime only past 2,048 allowed rows.
"""

import copy
import dataclasses
import json

import numpy as np
import pytest
import torch

from vectorindex_tpu.models.hnsw import HNSWConfig as JConfig
from vectorindex_tpu.models.hnsw import HNSWIndex as JIndex
from vectorindex_tpu.utils.config import Metric as JMetric
from vectorindex_tpu_torch import HNSWConfig, HNSWIndex
from vectorindex_tpu_torch.utils.config import Metric
from vectorindex_tpu_torch.utils.errors import IndexError, IndexErrorKind
from vectorindex_tpu_torch.utils.parity import ATOL, RTOL, ids_match_up_to_ties

torch.set_num_threads(1)

D, K = 24, 10
SMALL = dict(m=8, ef_construction=48, build_chunk=64)
METRICS = [Metric.L2, Metric.INNER_PRODUCT, Metric.COSINE]
ROWS = {Metric.L2: 2600, Metric.INNER_PRODUCT: 600, Metric.COSINE: 600}


def _gauss(n, seed=0, d=D):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _ints(n, seed=0, d=D):
    return np.random.default_rng(seed).integers(-8, 9, (n, d)).astype(np.float32)


def _meta(i):
    return {"even": i % 2 == 0}


def _jbuild(x, metric, meta=False, **cfg):
    idx = JIndex(x.shape[1], JMetric(metric.value), JConfig(**{**SMALL, **cfg}))
    idx.insert_batch(list(range(len(x))), x, [_meta(i) for i in range(len(x))] if meta else None)
    idx.statistics()
    return idx


def _pbuild(x, metric, meta=False, **cfg):
    idx = HNSWIndex(x.shape[1], metric, HNSWConfig(**{**SMALL, **cfg}), device="cpu")
    idx.insert_batch(list(range(len(x))), x, [_meta(i) for i in range(len(x))] if meta else None)
    idx.statistics()
    return idx


def _state(j) -> dict:
    """A JAX index's host state as plain numpy/python values."""
    return {
        "dimension": j.dimension, "metric": j.metric.value,
        "config": dataclasses.asdict(j.config),
        "vectors": j._vectors, "graph_vecs": j._graph_vecs, "valid": j._valid,
        "levels": j._levels, "metadata": j._metadata, "ids": list(j._idmap.items()),
        "next_slot": j._next_slot, "pending": j._pending,
        "layers": [(layer.node_ids, layer.nbrs) for layer in j._layers],
        "lookup0": j._lookup0, "entry": j._entry, "r2": j._r2,
        "level_counter": j._level_counter,
    }


def _graph(idx):
    return (idx._entry, idx._levels, idx._lookup0,
            [(list(layer.node_ids), layer.nbrs[: layer.count]) for layer in idx._layers])


def _assert_same_graph(a, b):
    ea, la, ka, layers_a = _graph(a)
    eb, lb, kb, layers_b = _graph(b)
    assert ea == eb
    np.testing.assert_array_equal(la, lb)
    np.testing.assert_array_equal(ka, kb)
    assert len(layers_a) == len(layers_b)
    for (na, ta), (nb, tb) in zip(layers_a, layers_b):
        assert na == nb
        np.testing.assert_array_equal(ta, tb)


def _ids(rows):
    return [[r.id for r in row] for row in rows]


def _ascending(scores, metric):
    s = np.asarray(scores, dtype=np.float64)
    return s * s if metric == Metric.L2 else -s


def _assert_rows_match(got, want, metric):
    """Port rows against JAX rows: equal lengths, ids equal up to ties of
    the JAX scores, scores within RTOL/ATOL."""
    assert [len(r) for r in got] == [len(r) for r in want]
    for g, w in zip(got, want):
        if not w:
            continue
        gi = np.array([[r.id for r in g]])
        wi = np.array([[r.id for r in w]])
        ws = np.array([r.score for r in w])
        assert ids_match_up_to_ties(gi, wi, _ascending(ws, metric)[None], len(w)), (gi, wi)
        np.testing.assert_allclose([r.score for r in g], ws, rtol=RTOL, atol=ATOL)


def _recall(rows, x, q, metric, k=K):
    if metric == Metric.L2:
        score = -((q[:, None, :] - x[None]) ** 2).sum(-1)
    elif metric == Metric.INNER_PRODUCT:
        score = q @ x.T
    else:
        score = (q / np.linalg.norm(q, axis=1, keepdims=True)) @ (
            x / np.linalg.norm(x, axis=1, keepdims=True)).T
    truth = np.argsort(-score, axis=1, kind="stable")[:, :k]
    return float(np.mean([len(set(_ids([r])[0]) & set(t.tolist())) / k for r, t in zip(rows, truth)]))


@pytest.fixture(scope="module")
def jax_int():
    return {m: _jbuild(_ints(600, seed=1), m) for m in (Metric.L2, Metric.INNER_PRODUCT)}


@pytest.fixture(scope="module")
def jax_gauss():
    return {m: _jbuild(_gauss(ROWS[m], seed=2), m, meta=True) for m in METRICS}


def _queries(x, b=16, seed=3):
    rng = np.random.default_rng(seed)
    return (x[rng.choice(len(x), b, replace=False)]
            + 0.1 * rng.standard_normal((b, x.shape[1]))).astype(np.float32)


# ---------------------------------------------------------------------------
# the graph, built independently on integer-valued rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", [Metric.L2, Metric.INNER_PRODUCT], ids=lambda m: m.value)
def test_integer_build_equals_jax_graph(jax_int, metric):
    j = jax_int[metric]
    p = _pbuild(_ints(600, seed=1), metric)
    _assert_same_graph(p, j)
    assert p._level_counter == j._level_counter
    q = _ints(12, seed=9)
    assert _ids(p.batch_search(q, K)) == _ids(j.batch_search(q, K))


# ---------------------------------------------------------------------------
# a JAX graph carried across by from_state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.value)
def test_carried_graph_searches_like_jax(jax_gauss, metric):
    j = jax_gauss[metric]
    p = HNSWIndex.from_state(_state(j), device="cpu")
    _assert_same_graph(p, j)
    x = j._vectors[: ROWS[metric]]
    q = _queries(x)
    _assert_rows_match(p.batch_search(q, K), j.batch_search(q, K), metric)
    _assert_rows_match([p.search(q[0], 3)], [j.search(q[0], 3)], metric)
    # the fused search on device tensors, as batch_search's fast lane
    kslot, kscore, kok = p.device_search(torch.from_numpy(p._to_graph_space(q)), K)
    got = p.assemble_results(kslot.numpy(), kscore.numpy(), kok.numpy())
    assert _ids(got) == _ids(p.batch_search(q, K))


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.value)
def test_host_distance_and_rescore_match_jax(jax_gauss, metric):
    """The host-side graph distance (ops/graph._dist_rows' convention, the
    virtual R² under IP) and the public rescore of result slots."""
    j = jax_gauss[metric]
    p = HNSWIndex.from_state(_state(j), device="cpu")
    gv, q = j._graph_vecs, _queries(j._vectors[:64], b=1)[0]
    np.testing.assert_allclose(p._host_dist_from(gv[3], gv[:50]), j._host_dist_from(gv[3], gv[:50]),
                               rtol=RTOL, atol=ATOL)
    slots = np.arange(0, 40, 3)
    np.testing.assert_allclose(p._rescore(slots, q), j._rescore(slots, q), rtol=RTOL, atol=ATOL)


# allow_ids takes the beam regime past 2,048 allowed rows: the L2 index only
FILTER_CASES = [(m, how) for m in METRICS for how in ("metadata", "allow_few", "allow_many", "deny")
                if how != "allow_many" or ROWS[m] > 2048]


@pytest.mark.parametrize("metric, how", FILTER_CASES, ids=lambda c: getattr(c, "value", c))
def test_carried_graph_filters_like_jax(jax_gauss, metric, how):
    j = jax_gauss[metric]
    n = ROWS[metric]
    p = HNSWIndex.from_state(_state(j), device="cpu")
    q = _queries(j._vectors[:n], seed=4)
    kw = {
        "metadata": dict(filter=lambda m: m is not None and m["even"]),
        "allow_few": dict(allow_ids=set(range(0, n, 7))),  # the exact scan
        "allow_many": dict(allow_ids=set(range(n - 2100, n))),  # the ef-scaled beam
        "deny": dict(deny_ids=set(range(0, n, 3))),
    }[how]
    got = p.batch_search(q, K, **kw)
    _assert_rows_match(got, j.batch_search(q, K, **kw), metric)
    ok = {
        "metadata": lambda i: i % 2 == 0,
        "allow_few": lambda i: i % 7 == 0,
        "allow_many": lambda i: i >= n - 2100,
        "deny": lambda i: i % 3 != 0,
    }[how]
    assert all(ok(r.id) for row in got for r in row) and all(len(row) == K for row in got)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.value)
def test_carried_graph_after_remove_like_jax(jax_gauss, metric):
    j = copy.deepcopy(jax_gauss[metric])
    p = HNSWIndex.from_state(_state(j), device="cpu")
    gone = list(range(0, 200, 2)) + [j._entry]
    for i in set(gone):
        j.remove(i)
        p.remove(i)
    q = _queries(j._vectors[: ROWS[metric]], seed=5)
    got = p.batch_search(q, K)
    _assert_rows_match(got, j.batch_search(q, K), metric)
    assert not {r.id for row in got for r in row} & set(gone)


def test_own_build_recall_within_002_of_jax(jax_gauss):
    metric = Metric.L2
    x = _gauss(ROWS[metric], seed=2)
    p = _pbuild(x, metric, meta=True)
    q = _queries(x, b=48, seed=6)
    rp = _recall(p.batch_search(q, K), x, q, metric)
    rj = _recall(jax_gauss[metric].batch_search(q, K), x, q, metric)
    assert rp >= rj - 0.02, (rp, rj)
    assert rp >= 0.9


# ---------------------------------------------------------------------------
# behaviours (tests/test_hnsw.py, test_hnsw_more.py, test_churn.py)
# ---------------------------------------------------------------------------


def test_errors_match_jax_kinds():
    from vectorindex_tpu.utils.errors import IndexError as JError

    def kind(fn):
        try:
            fn()
        except (IndexError, JError) as e:
            return e.kind.name
        return None

    pairs = []
    for cls, mcls, kw in ((HNSWIndex, Metric, {"device": "cpu"}), (JIndex, JMetric, {})):
        idx = cls(4, **kw)
        idx.insert("a", np.ones(4))
        pairs.append([
            kind(lambda: idx.insert("a", np.ones(4))),
            kind(lambda: idx.insert("b", np.ones(5))),
            kind(lambda: idx.insert("c", np.array([1.0, np.nan, 0.0, 0.0]))),
            kind(lambda: idx.batch_search(np.ones((2, 5)), 3)),
            kind(lambda: idx.remove("zz")),
            kind(lambda: cls(4, metric=mcls.MANHATTAN, **kw)),
        ])
    assert pairs[0] == pairs[1]
    assert pairs[0][0] == IndexErrorKind.DUPLICATE_ID.name
    assert all(pairs[0])


def test_batch_and_error_edges():
    """test_churn.py::test_hnsw_batch_and_error_edges on the port."""
    rng = np.random.default_rng(1)
    idx = HNSWIndex(8, config=HNSWConfig(m=4, ef_construction=32, ef_search=32), device="cpu")
    x = rng.standard_normal((50, 8)).astype(np.float32)
    idx.insert_batch(list(range(40)), x[:40])
    # a duplicate mid-batch: the prefix is inserted, the error surfaces
    with pytest.raises(IndexError):
        idx.insert_batch([40, 5, 41], x[40:43])
    assert idx.contains(40) and not idx.contains(41)
    # re-position update: the query finds the new location
    idx.update(7, vector=x[49] * 3)
    assert idx.search(x[49] * 3, k=1)[0].id == 7
    # mass deletion: survivors still reachable through tombstones
    for i in range(30):
        if idx.contains(i):
            idx.remove(i)
    res = idx.search(x[35], k=5)
    assert res and all(r.id >= 30 for r in res)
    assert idx.search(x[35], k=0) == []
    assert len(idx.search(x[35], k=10_000)) == idx.count
    empty = HNSWIndex(8, device="cpu")
    assert empty.batch_search(x[:3], k=3) == [[], [], []]


def test_removed_entry_point_and_heavy_deletion():
    x = _gauss(600, seed=7)
    idx = _pbuild(x, Metric.L2)
    entry = idx._entry
    idx.remove(entry)
    res = idx.search(x[5], 3)
    assert res and all(r.id != entry for r in res)
    for i in range(0, 600, 2):
        if idx.contains(i):
            idx.remove(i)
    rows = idx.batch_search(x[1::2][:32], 5)
    assert all(row and all(r.id % 2 == 1 for r in row) for row in rows)
    assert rows[0][0].id == 1


def test_degree_bounds_no_self_edges_levels():
    x = _gauss(1000, seed=13)
    idx = _pbuild(x, Metric.L2)
    l0 = idx._layers[0]
    assert l0.max_degree == 2 * idx.config.m
    for layer in idx._layers:
        deg = (layer.nbrs[: layer.count] >= 0).sum(axis=1)
        assert deg.max() <= layer.max_degree
        rows = layer.nbrs[: layer.count]
        assert not (rows == np.asarray(layer.node_ids)[:, None]).any()
    counts = [layer.count for layer in idx._layers]
    assert counts[0] == 1000 and counts == sorted(counts, reverse=True)
    assert idx._levels[idx._entry] == idx._levels[:1000].max() == len(counts) - 1
    n1 = (idx._levels >= 1).sum()
    assert 50 <= n1 <= 250  # E = n / m = 125
    indeg = np.zeros(1000, int)
    np.add.at(indeg, l0.nbrs[:1000][l0.nbrs[:1000] >= 0], 1)
    assert (indeg[np.arange(1000) != idx._entry] > 0).all()  # orphans repaired


def test_trickle_insert_compact_statistics():
    x = _gauss(400, seed=19)
    idx = _pbuild(x, Metric.L2)
    y = _gauss(20, seed=23) + 3.0
    for i in range(20):
        idx.insert(1000 + i, y[i])
    assert idx.search(y[7], 3)[0].id == 1007
    idx.remove(5)
    st = idx.statistics()
    assert st.count == 419 and st.details["pending"] == 0 and st.details["avg_degree_l0"] > 1
    assert st.details["m"] == 8 and st.details["max_level"] == len(idx._layers) - 1
    idx.compact()
    assert idx.count == 419 and not idx.contains(5)
    assert idx.search(x[8], 1)[0].id == 8
    assert idx.statistics().details["entry_point"] == idx._entry


def test_cosine_scores_and_ip_rescore():
    rng = np.random.default_rng(31)
    x = _gauss(300, seed=31) * rng.uniform(0.1, 5.0, (300, 1)).astype(np.float32)
    idx = _pbuild(x, Metric.COSINE)
    res = idx.search(7.5 * x[5], 1)
    assert res[0].id == 5 and res[0].score == pytest.approx(1.0, abs=1e-5)
    ip = _pbuild(x, Metric.INNER_PRODUCT)
    q = x[3] + 0.1
    for r in ip.search(q, 5):
        assert r.score == pytest.approx(float(x[r.id] @ q), rel=1e-5, abs=1e-5)


def test_device_search_closure_matches_batch_search():
    x = _gauss(800, seed=3)
    idx = _pbuild(x, Metric.L2, ef_search=32)
    q = _queries(x, b=12)
    expect = idx.batch_search(q, 5)
    fn, fargs = idx.device_search_closure(5)
    kslot, kscore, kok = fn(torch.from_numpy(q), *fargs)
    got = idx.assemble_results(kslot.numpy(), kscore.numpy(), kok.numpy())
    assert _ids(got) == _ids(expect)
    assert [[r.score for r in row] for row in got] == [[r.score for r in row] for row in expect]


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.value)
def test_stream_matches_per_call(metric):
    x = _gauss(500, seed=23)
    idx = _pbuild(x, metric)
    rng = np.random.default_rng(23)
    batches = [_queries(x, b=6, seed=s) for s in range(4)] + [x[rng.choice(500)]]
    got = list(idx.batch_search_stream(batches, 5, lookahead=2))
    assert len(got) == len(batches)
    for qb, rows_s in zip(batches, got):
        rows_p = idx.batch_search(qb, 5)
        assert [[(r.id, r.score) for r in row] for row in rows_s] == [
            [(r.id, r.score) for r in row] for row in rows_p]
    with pytest.raises(IndexError):
        list(idx.batch_search_stream([np.ones((2, D + 1), np.float32)], 5))
    assert list(idx.batch_search_stream([x[:2]], 0)) == [[[], []]]


def test_json_snapshot_crosses_packages(tmp_path, jax_gauss):
    """A JAX save loads in the port and a port save in the JAX package; both
    rebuild the same graph from the same records where the config is the
    same (a JAX file carries no build_chunk: both read 1,024)."""
    x = _gauss(300, seed=8)
    p = _pbuild(x, Metric.L2, meta=True)
    path = tmp_path / "port.json"
    p.save(str(path))
    j = JIndex.load(str(path))
    assert j.count == 300 and j.config.m == 8 and j.config.ef_construction == 48
    back = HNSWIndex.load(str(path), device="cpu")
    assert back.config == p.config
    jpath = tmp_path / "jax.json"
    j.save(str(jpath))
    from_j = HNSWIndex.load(str(jpath), device="cpu")
    assert from_j.config.build_chunk == j.config.build_chunk == 1024
    _assert_same_graph(from_j, j)
    assert from_j._metadata[:300] == j._metadata[:300] == [_meta(i) for i in range(300)]
    q = _queries(x, b=4)
    _assert_rows_match(from_j.batch_search(q, K), j.batch_search(q, K), Metric.L2)


def test_save_load_keeps_every_config_field(tmp_path):
    """The JAX save writes five config fields, so a graph built at
    build_chunk=64 reloads at 1,024 there (another graph), and a missing
    ef_construction reads as 100. The port writes every field: its reload
    gives the same graph; a missing key still reads as the JAX load reads
    it."""
    x = _gauss(400, seed=9)
    p = _pbuild(x, Metric.L2, build_expand=4)
    path = tmp_path / "p.json"
    p.save(str(path))
    back = HNSWIndex.load(str(path), device="cpu")
    assert back.config == p.config
    _assert_same_graph(back, p)
    payload = json.loads(path.read_text())
    assert set(payload["config"]) == {f.name for f in dataclasses.fields(HNSWConfig)}
    for key in ("ef_construction", "build_chunk", "build_expand"):
        del payload["config"][key]
    path.write_text(json.dumps(payload))
    old = HNSWIndex.load(str(path), device="cpu")
    jold = JIndex.load(str(path))
    assert (old.config.ef_construction, old.config.build_chunk, old.config.build_expand) == (
        jold.config.ef_construction, jold.config.build_chunk, jold.config.build_expand
    ) == (100, 1024, 8)
    p.save_container(str(tmp_path / "c.vidx"))  # the container keeps them too, and the graph
    back = HNSWIndex.load_container(str(tmp_path / "c.vidx"), device="cpu")
    assert back.config == p.config
    _assert_same_graph(back, p)


def test_config_and_defaults_match_jax():
    assert dataclasses.asdict(HNSWConfig()) == dataclasses.asdict(JConfig())
    assert HNSWIndex(4).device.type == "cuda"  # the card unless the caller asks
