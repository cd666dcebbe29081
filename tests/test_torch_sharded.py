"""The port's sharding (vectorindex_tpu_torch.parallel, models/sharded)
against the JAX package's on its 8-device CPU mesh (tests/conftest.py).
Mirrors tests/test_sharded_search.py, test_sharded_ivfpq.py,
test_sharded_index.py and test_sharded_hnsw.py. Everything runs on the CPU:
the port's meshes repeat the CPU device (1, 2, 4 or 8 shards in one
process), as one card holds several shards.

Tolerance: distances within rtol=2e-4, atol=2e-5 on the ascending distance
(f32 sums in another order); ids equal except at a rank whose JAX distance
lies within that tolerance of a neighbouring rank's (utils/parity). Across
the port's own shard counts ids are equal. partition_store's tables are
equal field by field.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vectorindex_tpu.models.sharded import ShardedFlatIndex as JShardedFlat
from vectorindex_tpu.models.sharded import ShardedHNSWIndex as JShardedHNSW
from vectorindex_tpu.ops import ivf as jivf
from vectorindex_tpu.ops import pq as jpq
from vectorindex_tpu.ops.dtypes import pack_u4 as jpack_u4
from vectorindex_tpu.parallel import mesh as jmesh
from vectorindex_tpu.parallel import sharded_hnsw as jsh
from vectorindex_tpu.parallel import sharded_ivf as jsivf
from vectorindex_tpu.parallel import sharded_search as jss
from vectorindex_tpu.models.hnsw import HNSWConfig as JHNSWConfig
from vectorindex_tpu.utils.config import Metric as JMetric
from vectorindex_tpu_torch.models import FlatIndex, load_index
from vectorindex_tpu_torch.models.hnsw import HNSWConfig
from vectorindex_tpu_torch.models.sharded import ShardedFlatIndex, ShardedHNSWIndex
from vectorindex_tpu_torch.ops import ivf as tivf
from vectorindex_tpu_torch.ops import ivf_pq as tivf_pq
from vectorindex_tpu_torch.ops import pq as tpq
from vectorindex_tpu_torch.ops.topk import topk_padded
from vectorindex_tpu_torch.ops import scoring
from vectorindex_tpu_torch.parallel import (
    build_sharded_hnsw,
    corpus_sharding,
    make_mesh,
    make_mesh_2d,
    pad_rows,
    partition_store,
    replicated,
    shard_rows,
    sharded_flat_search,
    sharded_flat_search_2d,
    sharded_hnsw_search,
    sharded_ivf_pq_search,
    sharded_ivf_search,
)
from vectorindex_tpu_torch.parallel import sharded_hnsw as tsh
from vectorindex_tpu_torch.utils.config import Metric
from vectorindex_tpu_torch.utils.errors import IndexError
from vectorindex_tpu_torch.utils.parity import ATOL, RTOL, ids_match_up_to_ties

torch.set_num_threads(1)

CPU = torch.device("cpu")
SHARDS = (1, 2, 4, 8)
CFG = dict(m=8, ef_construction=64, build_chunk=64)


def _mesh(n):
    return make_mesh(n, devices=[CPU] * 8)


def _close(got_d, got_i, want_d, want_i, k):
    want_d = np.asarray(want_d)
    np.testing.assert_allclose(np.asarray(got_d), want_d, rtol=RTOL, atol=ATOL)
    assert ids_match_up_to_ties(np.asarray(got_i), np.asarray(want_i), want_d, k)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    n, d, b = 4096, 32, 16
    return rng.standard_normal((b, d)).astype(np.float32), rng.standard_normal((n, d)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# mesh and flat search
# ---------------------------------------------------------------------------


def test_meshes_repeat_a_device_and_name_their_axes():
    m = make_mesh_2d(4, 2, devices=[CPU] * 8)
    assert m.shape == {"replica": 4, "data": 2} == dict(jmesh.make_mesh_2d(4, 2).shape)
    assert _mesh(8).size == 8 and _mesh(8).first == CPU
    with pytest.raises(ValueError):
        make_mesh(9, devices=[CPU] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices="):
            make_mesh()
    xp, n = pad_rows(torch.ones(5, 3), 4)
    assert xp.shape == (8, 3) and n == 5 and (xp[5:] == 0).all()
    rows = shard_rows(_mesh(4), torch.arange(8.0))
    assert [t.tolist() for t in rows.shards] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert rows.shape == (8,) and torch.equal(rows.gather(CPU), torch.arange(8.0))


def test_placements_put_like_jax_device_put():
    """corpus_sharding(mesh).put splits rows as jax.device_put with the JAX
    package's corpus_sharding does (shard s holds rows s·N/S onward);
    replicated(mesh).put gives every device the whole array."""
    x = np.arange(32, dtype=np.float32).reshape(8, 4)
    got = corpus_sharding(_mesh(4)).put(x)
    jm = jmesh.make_mesh(4)
    want = jax.device_put(jnp.asarray(x), jmesh.corpus_sharding(jm))
    want = [np.asarray(s.data) for s in sorted(want.addressable_shards, key=lambda s: s.index)]
    assert [t.numpy().tolist() for t in got.shards] == [w.tolist() for w in want]
    assert [t.numpy().tolist() for t in shard_rows(_mesh(4), x).shards] == [w.tolist() for w in want]
    copies = replicated(_mesh(2)).put(x)
    assert len(copies) == 2 and all(np.array_equal(t.numpy(), x) for t in copies)
    with pytest.raises(ValueError, match="pad_rows"):
        corpus_sharding(_mesh(3)).put(x)


@pytest.mark.parametrize("metric", [Metric.L2, Metric.INNER_PRODUCT, Metric.COSINE],
                         ids=lambda m: m.value)
def test_sharded_flat_search_matches_jax_at_every_shard_count(data, metric):
    q, x = data
    jm = jmesh.make_mesh(8)
    wd, wi = jss.sharded_flat_search(jm, jnp.asarray(q), jmesh.shard_rows(jm, jnp.asarray(x)),
                                     jnp.ones((x.shape[0],), bool), 10, JMetric(metric.value))
    first = None
    for s in SHARDS:
        mesh = _mesh(s)
        d, i = sharded_flat_search(mesh, torch.from_numpy(q), shard_rows(mesh, x), None, 10,
                                   metric)
        _close(d, i, wd, wi, 10)
        if first is None:
            first = i
        assert torch.equal(i, first)


def test_sharded_flat_search_with_padding_mask_and_norms(data):
    q, x = data
    x_odd = torch.from_numpy(x[:4091])
    xp, n = pad_rows(x_odd, 8)
    valid = torch.arange(xp.shape[0]) < n
    rd, ri = topk_padded(scoring.distance_block(torch.from_numpy(q), x_odd, Metric.L2),
                         torch.ones((1, n), dtype=torch.bool), 7)
    mesh = _mesh(8)
    sd, si = sharded_flat_search(mesh, torch.from_numpy(q), shard_rows(mesh, xp), valid, 7)
    assert torch.equal(si, ri)
    xt = torch.from_numpy(x)
    _, full = topk_padded(scoring.distance_block(torch.from_numpy(q), xt, Metric.L2),
                          torch.ones((1, len(x)), dtype=torch.bool), 5)
    _, i5 = sharded_flat_search(mesh, torch.from_numpy(q), xt, None, 5, Metric.L2,
                                x_sqnorms=shard_rows(mesh, scoring.squared_norms(xt)))
    assert torch.equal(i5, full)


def test_2d_mesh_flat_search_matches_1d():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((512, 16)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
    d1, i1 = sharded_flat_search(_mesh(8), q, x, None, 5)
    d2, i2 = sharded_flat_search_2d(make_mesh_2d(2, 4, devices=[CPU] * 8), q, x, None, 5)
    assert torch.equal(i1, i2)
    torch.testing.assert_close(d1, d2, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# sharded IVF / IVF-PQ
# ---------------------------------------------------------------------------


def _stores(assign, x, kc):
    """The same lists in a JAX and a port IVFListStore."""
    js, ts = jivf.IVFListStore(kc, x.shape[1]), tivf.IVFListStore(kc, x.shape[1], device="cpu")
    for s in (js, ts):
        s.append_batch(assign, np.arange(len(x)), x)
    return js, ts


def _same_partition(got, want):
    np.testing.assert_array_equal(torch.cat(got.vecs).numpy(), np.asarray(want.vecs))
    np.testing.assert_array_equal(torch.cat(got.row_ids).numpy(), np.asarray(want.row_ids))
    np.testing.assert_array_equal(torch.cat(got.sqnorms).numpy(), np.asarray(want.sqnorms))
    np.testing.assert_array_equal(torch.stack(got.starts).numpy(), np.asarray(want.starts))
    np.testing.assert_array_equal(torch.stack(got.lengths).numpy(), np.asarray(want.lengths))
    assert got.rows_per_shard == want.rows_per_shard
    if want.codes is not None:
        np.testing.assert_array_equal(torch.cat(got.codes).numpy(), np.asarray(want.codes))


def test_partition_store_matches_jax_and_balances_lists():
    rng = np.random.default_rng(22)
    assign = np.repeat(np.arange(16), [(l + 1) * 10 for l in range(16)])
    x = rng.standard_normal((len(assign), 4)).astype(np.float32)
    js, ts = _stores(assign, x, 16)
    got = partition_store(ts, _mesh(4))
    _same_partition(got, jsivf.partition_store(js, jmesh.make_mesh(4)))
    per_shard = torch.stack(got.lengths).sum(dim=1)
    assert int(per_shard.sum()) == len(assign)
    assert per_shard.max() <= per_shard.min() * 2  # greedy balance


def test_sharded_ivf_matches_jax_and_the_single_device_search():
    rng = np.random.default_rng(21)
    x = rng.standard_normal((2000, 16)).astype(np.float32)
    cent = x[rng.choice(2000, 32, replace=False)]
    assign = np.argmin(((x[:, None, :] - cent[None]) ** 2).sum(-1), axis=1)
    js, ts = _stores(assign, x, 32)
    cap = tivf.probe_cap_for(ts.max_length)
    q = rng.standard_normal((12, 16)).astype(np.float32)
    wd, wi = jsivf.sharded_ivf_search(jmesh.make_mesh(8), jnp.asarray(q), jnp.asarray(cent),
                                      jsivf.partition_store(js, jmesh.make_mesh(8)),
                                      nprobe=8, probe_cap=cap, k=5)
    rd, ri = tivf.ivf_search_flat(torch.from_numpy(q), torch.from_numpy(cent),
                                  ts.sync_device(), nprobe=8, probe_cap=cap, k=5)
    for s in (2, 8):
        mesh = _mesh(s)
        sharded = partition_store(ts, mesh)
        d, i = sharded_ivf_search(mesh, torch.from_numpy(q), torch.from_numpy(cent), sharded,
                                  nprobe=8, probe_cap=cap, k=5)
        _close(d, i, wd, wi, 5)
        assert torch.equal(i, ri)
        torch.testing.assert_close(d, rd, rtol=RTOL, atol=ATOL)
    _same_partition(partition_store(ts, _mesh(8)), jsivf.partition_store(js, jmesh.make_mesh(8)))


@pytest.fixture(scope="module")
def pq_fixture():
    """test_sharded_ivfpq.py's corpus and lists with seeded residual books
    (rows of the residuals) and the port's CSR codes, fed to both packages
    as numpy arrays."""
    n, d, kc, m, ks = 600, 16, 8, 4, 16
    rng = np.random.default_rng(0)
    cent = rng.standard_normal((kc, d)).astype(np.float32)
    assign = rng.integers(0, kc, n)
    x = (cent[assign] + 0.25 * rng.standard_normal((n, d))).astype(np.float32)
    js, ts = _stores(assign, x, kc)
    resid = (x - cent[assign])[rng.choice(n, ks, replace=False)]
    tbooks = tpq.books_from_centroids(torch.from_numpy(
        np.ascontiguousarray(resid.reshape(ks, m, d // m).transpose(1, 0, 2))))
    books = jpq.PQCodebooks(jnp.asarray(tbooks.centroids.numpy()),
                            jnp.asarray(tbooks.sqnorms.numpy()))
    p = ts.packed()
    row_list = np.zeros(len(p["row_ids"]), dtype=np.int64)
    for l in range(kc):
        row_list[p["starts"][l] : p["starts"][l] + p["lengths"][l]] = l
    codes = tpq.pq_encode_residual(torch.from_numpy(p["vecs"]), torch.from_numpy(cent),
                                   torch.from_numpy(row_list), tbooks).numpy()
    return cent, js, ts, books, tbooks, codes


def _pq_search(mesh, fixture, q, codes, **kw):
    cent, _, ts, _, tbooks, _ = fixture
    sharded = partition_store(ts, mesh, codes=torch.from_numpy(codes))
    return sharded_ivf_pq_search(mesh, torch.from_numpy(q), torch.from_numpy(cent), sharded,
                                 tbooks, nprobe=8, probe_cap=tivf.probe_cap_for(ts.max_length),
                                 k=10, **kw)


def test_sharded_ivf_pq_matches_the_single_device_search(pq_fixture):
    """ADC over 2 and 8 shards, u8 and packed u4, equal to the port's
    single-device ivf_search_pq (itself held to the JAX package's in
    tests/test_torch_pq.py); the shards' codes equal JAX's partition."""
    cent, js, ts, books, tbooks, codes = pq_fixture
    q = np.random.default_rng(1).standard_normal((6, 16)).astype(np.float32)
    for packed in (False, True):
        c = np.asarray(jpack_u4(jnp.asarray(codes))) if packed else codes
        rd, ri = tivf_pq.ivf_search_pq(
            torch.from_numpy(q), torch.from_numpy(cent), ts.sync_device(), torch.from_numpy(c),
            tbooks, nprobe=8, probe_cap=tivf.probe_cap_for(ts.max_length), k=10,
            packed_u4=packed)
        for n_shards in (2, 8):
            d, i = _pq_search(_mesh(n_shards), pq_fixture, q, c, packed_u4=packed)
            assert torch.equal(i, ri)
            torch.testing.assert_close(d, rd, rtol=RTOL, atol=ATOL)
    _same_partition(partition_store(ts, _mesh(8), codes=torch.from_numpy(codes)),
                    jsivf.partition_store(js, jmesh.make_mesh(8), codes=codes))


def test_sharded_ivf_pq_rerank_matches_jax(pq_fixture):
    """Each of 4 shards exact-reranks its own ADC top-32, as the JAX
    package's sharded_ivf_pq_search does on its 4-device mesh."""
    cent, js, ts, books, tbooks, codes = pq_fixture
    q = np.random.default_rng(2).standard_normal((4, 16)).astype(np.float32)
    jm = jmesh.make_mesh(4)
    wd, wi = jsivf.sharded_ivf_pq_search(
        jm, jnp.asarray(q), jnp.asarray(cent), jsivf.partition_store(js, jm, codes=codes), books,
        nprobe=8, probe_cap=tivf.probe_cap_for(ts.max_length), k=10, rerank_c=32)
    d, i = _pq_search(_mesh(4), pq_fixture, q, codes, rerank_c=32)
    _close(d, i, wd, wi, 10)


# ---------------------------------------------------------------------------
# ShardedFlatIndex
# ---------------------------------------------------------------------------


def _data(n=500, d=16, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def test_sharded_flat_index_matches_flat_and_jax():
    x = _data()
    ids = [f"v{i}" for i in range(len(x))]
    flat = FlatIndex(16, device="cpu")
    jsh_idx = JShardedFlat(16, n_devices=8)
    for idx in (flat, jsh_idx):
        idx.insert_batch(ids, x)
    q = x[:10] + 0.01
    r1 = flat.batch_search(q, 7)
    want = jsh_idx.batch_search(q, 8)
    for s in SHARDS:
        sharded = ShardedFlatIndex(16, n_devices=s, device="cpu")
        sharded.insert_batch(ids, x)
        r2 = sharded.batch_search(q, 7)
        assert [[r.id for r in a] for a in r1] == [[r.id for r in b] for b in r2]
        wd = np.array([[r.score**2 for r in row] for row in want])
        np.testing.assert_allclose([[r.score**2 for r in row] for row in r2], wd[:, :7],
                                   rtol=RTOL, atol=ATOL)
        assert ids_match_up_to_ties([[r.id for r in row] for row in r2],
                                    [[r.id for r in row] for row in want], wd, 7)
        assert sharded.statistics().details["n_shards"] == s


def test_sharded_flat_crud_filters_growth_and_range():
    x = _data(300)
    idx = ShardedFlatIndex(16, n_devices=4, device="cpu")
    idx.insert_batch(list(range(300)), x, [{"i": i} for i in range(300)])
    idx.remove(5)
    assert idx.search(x[5], 1)[0].id != 5
    res = idx.search(x[0], 5, filter=lambda m: m and m["i"] % 2 == 0)
    assert all(r.metadata["i"] % 2 == 0 for r in res)
    allowed = set(range(0, 300, 7))
    res = idx.search(x[21], 5, allow_ids=allowed)
    assert len(res) == 5 and res[0].id == 21 and all(r.id in allowed for r in res)
    assert all(r.id != 21 for r in idx.search(x[21], 5, deny_ids={21}))
    ref = FlatIndex(16, device="cpu")
    ref.insert_batch(list(range(300)), x)
    ref.remove(5)
    assert [r.id for r in idx.range_search(x[1], 4.0)] == [r.id for r in ref.range_search(x[1], 4.0)]
    big = ShardedFlatIndex(8, n_devices=8, device="cpu")
    xb = _data(1500, 8, seed=3)
    big.insert_batch(list(range(1500)), xb)
    assert big.capacity % 8 == 0 and big.search(xb[1400], 1)[0].id == 1400
    with pytest.raises(IndexError):
        big.search(np.ones(9, np.float32), 1)


@pytest.mark.parametrize("metric", [Metric.INNER_PRODUCT, Metric.COSINE], ids=lambda m: m.value)
def test_sharded_flat_metrics(metric):
    x = _data(400, 8, seed=4)
    idx = ShardedFlatIndex(8, metric=metric, n_devices=8, device="cpu")
    idx.insert_batch(list(range(400)), x)
    q = x[9]
    if metric == Metric.INNER_PRODUCT:
        ref = np.argsort(-(x @ q))[:5]
    else:
        ref = np.argsort(-(x @ q) / (np.linalg.norm(x, axis=1) * np.linalg.norm(q)))[:5]
    assert [r.id for r in idx.search(q, 5)] == ref.tolist()


def test_sharded_flat_bf16_storage():
    x = _data(400, 16, seed=10)
    idx = ShardedFlatIndex(16, n_devices=8, storage_dtype=torch.bfloat16, device="cpu")
    idx.insert_batch(list(range(400)), x)
    res = idx.batch_search(x[:10], 1)
    assert np.mean([row[0].id == i for i, row in enumerate(res)]) >= 0.9


def test_sharded_flat_snapshots_cross_packages(tmp_path):
    x = _data(200, 8, seed=9)
    port = ShardedFlatIndex(8, n_devices=4, device="cpu")
    jax_idx = JShardedFlat(8, n_devices=8)
    for idx in (port, jax_idx):
        idx.insert_batch(list(range(200)), x)
    port.save(str(tmp_path / "port.json"))
    jax_idx.save(str(tmp_path / "jax.json"))
    assert json.load(open(tmp_path / "port.json"))["type"] == "sharded_flat"
    from_jax = load_index(str(tmp_path / "jax.json"), device="cpu")
    to_jax = JShardedFlat.load(str(tmp_path / "port.json"))
    assert type(from_jax) is ShardedFlatIndex and type(to_jax) is JShardedFlat
    want = [r.id for r in port.search(x[7], 5)]
    assert [r.id for r in from_jax.search(x[7], 5)] == want
    assert [r.id for r in to_jax.search(x[7], 5)] == want


# ---------------------------------------------------------------------------
# sharded HNSW
# ---------------------------------------------------------------------------


def _truth(q, x, k):
    d = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    return np.argsort(d, axis=1, kind="stable")[:, :k]


def _recall(ids, truth, k):
    return np.mean([len(set(ids[i]) & set(truth[i])) / k for i in range(len(truth))])


def test_sharded_hnsw_state_equals_jax_on_integer_rows():
    """Integer-valued rows: the port's per-shard graphs equal the JAX
    package's field by field, and so do the search results."""
    x = np.random.default_rng(5).integers(-8, 9, (300, 16)).astype(np.float32)
    gids = np.arange(300, dtype=np.int64) * 3 + 100
    metric = Metric.INNER_PRODUCT  # the routed norms are the shards' one R²
    st = build_sharded_hnsw(x, 4, metric, HNSWConfig(**CFG), global_ids=gids,
                            devices=[CPU] * 4)
    jst = jsh.build_sharded_hnsw(x, 4, JMetric(metric.value), JHNSWConfig(**CFG),
                                 global_ids=gids)
    for name in ("vecs", "sqn", "nbrs", "row_global"):
        np.testing.assert_array_equal(torch.stack(getattr(st, name)).numpy(),
                                      np.asarray(getattr(jst, name)), err_msg=name)
    assert list(st.entries) == np.asarray(jst.entries).tolist()
    q = x[:8] + 0.5
    d, i = sharded_hnsw_search(_mesh(4), torch.from_numpy(q), st, ef=32, iters=8, k=5)
    wd, wi = jsh.sharded_hnsw_search(jmesh.make_mesh(4), jnp.asarray(q), jst, ef=32, iters=8,
                                     k=5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
    np.testing.assert_allclose(d.numpy(), np.asarray(wd), rtol=RTOL, atol=ATOL)


def test_sharded_hnsw_recall_order_and_global_ids():
    n, d, k = 1200, 24, 10
    x = np.random.default_rng(3).standard_normal((n, d)).astype(np.float32)
    gids = np.arange(n, dtype=np.int64) * 3 + 100
    st = build_sharded_hnsw(x, 4, Metric.L2, HNSWConfig(**CFG), global_ids=gids,
                            devices=[CPU] * 4)
    q = x[:32] + 0.01 * np.random.default_rng(9).standard_normal((32, d)).astype(np.float32)
    dist, ids = sharded_hnsw_search(_mesh(4), torch.from_numpy(q), st, ef=64, iters=16, k=k)
    dist, ids = dist.numpy(), ids.numpy()
    assert (np.diff(dist, axis=1) >= 0).all()
    assert (ids[:, 0] == gids[:32]).all()
    assert _recall((ids - 100) // 3, _truth(q, x, k), k) >= 0.9


def test_sharded_hnsw_ip_uses_one_r2():
    n, d, k = 800, 16, 8
    rng = np.random.default_rng(11)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x *= rng.uniform(0.2, 3.0, (n, 1)).astype(np.float32)  # spread norms
    st = build_sharded_hnsw(x, 4, Metric.INNER_PRODUCT, HNSWConfig(**CFG), devices=[CPU] * 4)
    assert len({float(s[0]) for s in st.sqn}) == 1  # one R² on every shard
    q = rng.standard_normal((16, d)).astype(np.float32)
    _, ids = sharded_hnsw_search(_mesh(4), torch.from_numpy(q), st, ef=96, iters=24, k=k)
    truth = np.argsort(-(q @ x.T), axis=1, kind="stable")[:, :k]
    assert _recall(ids.numpy(), truth, k) >= 0.85


def test_sharded_hnsw_index_end_to_end_and_snapshots(tmp_path):
    x = np.random.default_rng(21).standard_normal((400, 24)).astype(np.float32)
    idx = ShardedHNSWIndex(24, Metric.L2, HNSWConfig(**CFG), n_devices=4, device="cpu")
    idx.insert_batch([f"v{i}" for i in range(400)], x, [{"par": i % 2} for i in range(400)])
    assert idx.search(x[5], 3)[0].id == "v5"
    idx.remove("v5")
    assert all(r.id != "v5" for r in idx.search(x[5], 3))
    for row in idx.batch_search(x[:4], 5, filter=lambda m: m and m["par"] == 1):
        assert all(r.metadata["par"] == 1 for r in row)
    assert idx.search(x[33], 3, deny_ids={"v33"})[0].id != "v33"
    assert all(r.id in {"v34", "v36"} for r in idx.search(x[34], 2, allow_ids={"v34", "v36"}))
    st = idx.statistics()
    assert st.details["n_shards"] == 4 and st.count == 399
    p = str(tmp_path / "sh.json")
    idx.save(p)
    snap = json.load(open(p))
    assert snap["type"] == "sharded_hnsw" and snap["config"]["build_chunk"] == 64
    loaded = load_index(p, device="cpu")
    assert type(loaded) is ShardedHNSWIndex and loaded.count == 399 and loaded.n_shards == 4
    assert dataclasses.asdict(loaded.config) == dataclasses.asdict(idx.config)
    assert loaded.search(x[6], 1)[0].id == "v6"
    # the JAX package reads the port's snapshot, and the port reads its
    jl = JShardedHNSW.load(p)
    assert jl._ids == loaded._ids and jl.config.m == 8
    np.testing.assert_array_equal(np.stack(jl._vectors), np.stack(loaded._vectors))
    jl.save(str(tmp_path / "jax.json"))
    back = load_index(str(tmp_path / "jax.json"), device="cpu")
    assert back._ids == loaded._ids and back.config.m == 8
    idx.compact()
    assert idx.count == 399 and idx.n_shards == 4


def test_tail_inserts_never_rebuild_and_overflow_rebuilds_once(monkeypatch):
    x = np.random.default_rng(3).standard_normal((350, 16)).astype(np.float32)
    idx = ShardedHNSWIndex(16, Metric.L2, HNSWConfig(**CFG), n_devices=2, device="cpu")
    idx.insert_batch([f"v{i}" for i in range(300)], x[:300])
    idx.search(x[0], 1)  # the bulk build
    built = idx._built_rows
    calls = {"n": 0}
    real = tsh.build_sharded_hnsw

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(tsh, "build_sharded_hnsw", counting)
    v_new = x[7] * 0.5 + 0.01
    idx.insert("tail0", v_new)
    assert idx.search(v_new, 3)[0].id == "tail0"  # the exact tail scan finds it
    idx.update("tail0", vector=v_new + 0.002)
    idx.search(v_new, 3)
    idx.remove("tail0")
    assert all(r.id != "tail0" for r in idx.search(v_new, 3))
    for i in range(300, 350):
        idx.insert(f"v{i}", x[i])
    idx.search(x[0], 1)
    assert calls["n"] == 0 and idx._built_rows == built
    monkeypatch.setattr(ShardedHNSWIndex, "_tail_count", lambda self: 2000)
    idx.search(x[0], 1)
    assert calls["n"] == 1  # exactly one rebuild
