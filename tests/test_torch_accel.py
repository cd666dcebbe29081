"""The port's acceleration seam (models/accel) against the JAX package's on
the same data, on the flat, IVF and HNSW indices. Mirrors
tests/test_accel_layout.py. Everything runs on the CPU.

  - Flat: the same inserts and removes in both packages; snapshots,
    candidates and structures equal; finalize_results equal.
  - IVF: the port's index carried across from a trained JAX index
    (IVFIndex.from_state), so both hold the same lists: the structure's
    centroids and CSR tables equal, the probed candidates equal.
  - HNSW: integer-valued rows (every f32 product and sum exact), which the
    two packages build into the same graph (tests/test_torch_hnsw.py), at
    that file's module-fixture config HNSWConfig(m=8, ef_construction=48,
    build_chunk=64): structures equal.
  - finalize_results over exactly rescored candidates equals batch_search
    on every index (flat: exactly; IVF: against the probed-list search;
    HNSW: against its own candidates), up to ties (utils/parity).
"""

import dataclasses

import numpy as np
import pytest
import torch

from vectorindex_tpu.models import accel as jaccel
from vectorindex_tpu.models.flat import FlatIndex as JFlat
from vectorindex_tpu.models.hnsw import HNSWConfig as JHNSWConfig
from vectorindex_tpu.models.hnsw import HNSWIndex as JHNSW
from vectorindex_tpu.models.ivf import IVFConfig as JIVFConfig
from vectorindex_tpu.models.ivf import IVFIndex as JIVF
from vectorindex_tpu.utils.config import Metric as JMetric
from vectorindex_tpu_torch.models import accel
from vectorindex_tpu_torch.models.flat import FlatIndex
from vectorindex_tpu_torch.models.hnsw import HNSWConfig, HNSWIndex
from vectorindex_tpu_torch.models.ivf import IVFIndex
from vectorindex_tpu_torch.utils.config import Metric
from vectorindex_tpu_torch.utils.parity import ATOL, RTOL, ids_match_up_to_ties

torch.set_num_threads(1)

D, K = 16, 5
SMALL = dict(m=8, ef_construction=48, build_chunk=64)


def _meta(i):
    return {"even": i % 2 == 0}


def _flat_pair(n=600, seed=0):
    x = np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32)
    j, t = JFlat(D), FlatIndex(D, device="cpu")
    for idx in (j, t):
        idx.insert_batch([f"v{i}" for i in range(n)], x, [_meta(i) for i in range(n)])
        idx.remove("v3")
        idx.remove("v17")
    return j, t, x


def _same_candidates(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.count == w.count
        np.testing.assert_array_equal(g.internal_ids, w.internal_ids)
        np.testing.assert_array_equal(g.vectors, w.vectors)


def _rows(res):
    return [(r.id, r.metadata) for r in res]


def test_flat_snapshot_structure_and_candidates_match_jax():
    j, t, x = _flat_pair()
    js, ts = jaccel.snapshot(j), accel.snapshot(t)
    np.testing.assert_array_equal(ts.vectors, js.vectors)
    np.testing.assert_array_equal(ts.internal_ids, js.internal_ids)
    assert ts.external_ids == js.external_ids and "v3" not in ts.external_ids
    ts.vectors[0] = 0  # a copy
    assert t.search(x[0], 1)[0].id == "v0"
    assert dataclasses.asdict(accel.get_index_structure(t)) == dataclasses.asdict(
        jaccel.get_index_structure(j))
    _same_candidates(accel.get_batch_candidates(t, x[:3]), jaccel.get_batch_candidates(j, x[:3]))
    assert accel.should_accelerate(t, 100, 10) == jaccel.should_accelerate(j, 100, 10)
    small = FlatIndex(4, device="cpu")
    small.insert("a", np.ones(4))
    assert not accel.should_accelerate(small, n_queries=1, k=1)


def test_flat_finalize_matches_jax_and_batch_search():
    j, t, x = _flat_pair(seed=1)
    q = x[:4] + 0.05
    for b in range(len(q)):
        cands = accel.get_candidates(t, q[b])
        d = ((cands.vectors - q[b]) ** 2).sum(-1)
        got = accel.finalize_results(t, cands.internal_ids, d, k=K)
        want = jaccel.finalize_results(j, cands.internal_ids, d, k=K)
        assert _rows(got) == _rows(want)
        np.testing.assert_allclose([r.score for r in got], [r.score for r in want])
        native = t.search(q[b], K + 1)
        wd = np.array([[r.score**2 for r in native]])
        np.testing.assert_allclose(wd[:, :K], [[r.score**2 for r in got]], rtol=RTOL, atol=ATOL)
        assert ids_match_up_to_ties([[r.id for r in got]], [[r.id for r in native]], wd, K)
        even = accel.finalize_results(t, cands.internal_ids, d, k=K,
                                      filter=lambda m: m and m["even"])
        assert _rows(even) == _rows(jaccel.finalize_results(
            j, cands.internal_ids, d, k=K, filter=lambda m: m and m["even"]))
        assert len(even) == K and all(r.metadata["even"] for r in even)


def _ivf_pair(n=800, seed=2):
    x = np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32)
    j = JIVF(D, JMetric.L2, JIVFConfig(nlist=8, nprobe=2))
    j.insert_batch(list(range(n)), x)
    j.optimize()
    state = {
        "dimension": D, "metric": "l2",
        "config": dataclasses.asdict(j.config), "storage_dtype": "float32",
        "vectors": dict(j._vectors), "metadata": dict(j._metadata),
        "ids": list(j._idmap.items()), "free": list(j._free), "next_slot": j._next_slot,
        "centroids": j._centroids, "lists": [list(ids) for ids in j._store._lists_ids],
    }
    return j, IVFIndex.from_state(state, device="cpu"), x


def test_ivf_structure_candidates_and_finalize_match_jax():
    j, t, x = _ivf_pair()
    st, jst = accel.get_index_structure(t), jaccel.get_index_structure(j)
    assert st.trained and (st.nlist, st.nprobe) == (jst.nlist, jst.nprobe)
    for name in ("centroids", "list_starts", "list_lengths", "row_ids"):
        np.testing.assert_array_equal(getattr(st, name), getattr(jst, name), err_msg=name)
    assert st.list_lengths.sum() == 800
    q = x[:6] + 0.01
    cands = accel.get_batch_candidates(t, q)
    _same_candidates(cands, jaccel.get_batch_candidates(j, q))
    assert 5 in cands[5].internal_ids  # its own list is probed
    limited = accel.get_batch_candidates(t, q, limit=7)
    assert all(c.count == 7 for c in limited)
    native = t.batch_search(q, K + 1)
    for b, c in enumerate(cands):
        d = ((c.vectors - q[b]) ** 2).sum(-1)
        got = accel.finalize_results(t, c.internal_ids, d, k=K)
        wd = np.array([[r.score**2 for r in native[b]]])
        assert ids_match_up_to_ties([[r.id for r in got]], [[r.id for r in native[b]]], wd, K)
    untrained = IVFIndex(D, device="cpu")
    assert not accel.get_index_structure(untrained).trained


@pytest.fixture(scope="module")
def hnsw_pair():
    x = np.random.default_rng(3).integers(-8, 9, (300, D)).astype(np.float32)
    j = JHNSW(D, JMetric.L2, JHNSWConfig(**SMALL))
    t = HNSWIndex(D, Metric.L2, HNSWConfig(**SMALL), device="cpu")
    for idx in (j, t):
        idx.insert_batch(list(range(len(x))), x)
    return j, t, x


def test_hnsw_structure_and_candidates_match_jax(hnsw_pair):
    j, t, x = hnsw_pair
    st, jst = accel.get_index_structure(t), jaccel.get_index_structure(j)
    assert (st.entry_point, st.max_level, st.m) == (jst.entry_point, jst.max_level, jst.m)
    assert len(st.levels) == len(jst.levels)
    for a, b in zip(st.levels, jst.levels):
        np.testing.assert_array_equal(a["node_ids"], b["node_ids"])
        np.testing.assert_array_equal(a["neighbors"], b["neighbors"])
    assert st.levels[0]["neighbors"].shape[0] == 300
    q = x[:4] + 0.25
    cands = accel.get_batch_candidates(t, q, limit=20)
    # the candidates are batch_search's own rows (held to the JAX search in
    # tests/test_torch_hnsw.py)
    assert [c.count for c in cands] == [20] * 4
    for b, c in enumerate(cands):
        d = ((c.vectors - q[b]) ** 2).sum(-1)
        got = accel.finalize_results(t, c.internal_ids, d, k=K)
        assert [r.id for r in got] == [r.id for r in t.search(q[b], K)]
