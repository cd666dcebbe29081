"""The port's IVF ops (vectorindex_tpu_torch.ops.ivf) against the JAX
package's, on the same seeded numpy inputs.

  - ivf_select: list ids equal, in strict (score, id) order; distances
    within rtol=atol=1e-5.
  - IVFListStore: after the same appends, in-place appends, batch appends
    and removes, both packages hold the same CSR layout — starts, lengths,
    row_ids and timestamps equal, vecs[:, :d] and sqnorms equal bit for
    bit (both are copies of the same f32 rows and numpy's einsum).
  - ivf_search_flat and rerank_exact_topk: ids equal; distances within
    rtol=atol=1e-4 (f32 dot products summed in another order).
  - build_centroid_graph: equal; ivf_select_beam: ids equal up to ties of
    the JAX distances (utils/parity), distances within rtol=atol=1e-4 (the
    JAX beam scores at XLA's default f32 matmul precision).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vectorindex_tpu.ops import ivf as jivf
from vectorindex_tpu.utils.config import Metric as JMetric
from vectorindex_tpu_torch.ops import ivf as tivf
from vectorindex_tpu_torch.ops.topk import INVALID_ID
from vectorindex_tpu_torch.utils.config import Metric
from vectorindex_tpu_torch.utils.parity import ids_match_up_to_ties

torch.set_num_threads(1)

METRICS = [Metric.L2, Metric.INNER_PRODUCT, Metric.COSINE]
T = torch.from_numpy


def _np(a):
    return np.array(a)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.value)
def test_ivf_select_matches_jax(metric):
    rng = np.random.default_rng(1)
    cents = rng.standard_normal((32, 8)).astype(np.float32)
    cents[5] = cents[3]  # a tie: the lower list id comes first
    q = rng.standard_normal((5, 8)).astype(np.float32)
    q[0] = cents[3]
    disabled = np.arange(32) % 7 == 0
    for dis in (None, disabled):
        jd, ji = jivf.ivf_select(jnp.asarray(q), jnp.asarray(cents), nprobe=6,
                                 metric=JMetric(metric.value),
                                 disabled=None if dis is None else jnp.asarray(dis))
        td, ti = tivf.ivf_select(T(q), T(cents), nprobe=6, metric=metric,
                                 disabled=None if dis is None else T(dis))
        np.testing.assert_array_equal(ti.numpy(), _np(ji))
        np.testing.assert_allclose(td.numpy(), _np(jd), rtol=1e-5, atol=1e-5)
    assert ti.dtype == torch.int32 and not np.isin(ti.numpy(), np.nonzero(disabled)[0]).any()


def _assert_same_layout(js, ts, dim, dtype=torch.float32):
    ja = js.sync_device()
    ta = ts.sync_device(dtype)
    for name in ("starts", "lengths", "row_ids"):
        np.testing.assert_array_equal(getattr(ta, name).numpy(), _np(getattr(ja, name)), name)
    np.testing.assert_array_equal(ta.sqnorms.numpy(), _np(ja.sqnorms))
    np.testing.assert_array_equal(ta.vecs.float().numpy(),
                                  torch.from_numpy(_np(ja.vecs)[:, :dim]).to(dtype).float().numpy())
    if ja.timestamps is not None:
        # the JAX store leaves the timestamp of a row appended in place at 0
        # until the next repack (ROADMAP Queue 3); the port writes it
        patched = [row for _, row, _ in ts._patch_log]
        keep = np.ones(ta.timestamps.shape[0], bool)
        keep[patched] = False
        np.testing.assert_array_equal(ta.timestamps.numpy()[keep], _np(ja.timestamps)[keep])
        want = {r for lst in range(ts.n_lists) for r in _rows_with_ts(ts, lst)}
        assert {(r, int(ta.timestamps[r])) for r in patched} <= want
    assert ts.list_stats() == js.list_stats()
    # the device view equals the host mirror, in-place patches included
    p = ts._packed
    np.testing.assert_array_equal(ta.row_ids.numpy(), p["row_ids"])
    np.testing.assert_array_equal(ta.lengths.numpy(), p["lengths"])


def _rows_with_ts(store, lst):
    """(packed row, timestamp) of every row of list `lst` per the host lists."""
    start = int(store._packed["starts"][lst])
    return {(start + i, t) for i, t in enumerate(store._lists_ts[lst])}


def test_in_place_append_keeps_its_timestamp():
    """Smallest input on which the JAX store loses a timestamp: a row
    appended in place after a sync reads 0 there; the port reads 200."""
    v = np.ones(4, np.float32)
    got = []
    for store in (jivf.IVFListStore(2, 4, timestamps=True),
                  tivf.IVFListStore(2, 4, timestamps=True, device="cpu")):
        store.append(0, 1, v, ts=100)
        store.sync_device()
        store.append(0, 2, v, ts=200)
        arrays = store.sync_device()
        start = int(_np(arrays.starts)[0])
        got.append(_np(arrays.timestamps)[start : start + 2].tolist())
    assert got == [[100, 0], [100, 200]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_list_store_matches_jax_under_mutation(dtype):
    """Randomised appends / in-place appends / batch appends / removes with
    syncs in between; the codes-only view tracks the full view."""
    rng = np.random.default_rng(99)
    dim, nl = 8, 6
    js = jivf.IVFListStore(nl, dim, timestamps=True)
    ts = tivf.IVFListStore(nl, dim, timestamps=True, device="cpu")
    live, next_id, patched = [], 0, 0
    for step in range(220):
        op = rng.random()
        if op < 0.55 or not live:
            lst, v = int(rng.integers(0, nl)), rng.standard_normal(dim).astype(np.float32)
            for s in (js, ts):
                s.append(lst, next_id, v, ts=step)
            live.append((lst, next_id))
            next_id += 1
        elif op < 0.62:
            lists = rng.integers(0, nl, 5)
            vecs = rng.standard_normal((5, dim)).astype(np.float32)
            ids = np.arange(next_id, next_id + 5)
            for s in (js, ts):
                s.append_batch(lists, ids, vecs, ts=ids * 10)
            live += list(zip(lists.tolist(), ids.tolist()))
            next_id += 5
        elif op < 0.75:
            lst, iid = live.pop(int(rng.integers(0, len(live))))
            assert js.remove(lst, iid) and ts.remove(lst, iid)
        if op >= 0.9 or step % 17 == 0:
            patched += len(ts._patch_log)
            _assert_same_layout(js, ts, dim, dtype)
            meta = ts.sync_device(with_vecs=False)
            full = ts.sync_device(dtype)
            assert meta.vecs is None and meta.sqnorms is None
            for name in ("row_ids", "starts", "lengths", "timestamps"):
                assert torch.equal(getattr(meta, name), getattr(full, name))
    _assert_same_layout(js, ts, dim, dtype)
    assert patched, "no append took the in-place path"
    assert not ts.remove(0, 10**6)
    ids, vecs = ts.read_list(2)
    jids, jvecs = js.read_list(2)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(vecs, jvecs)


def test_in_place_append_patches_the_device_tensors():
    store = tivf.IVFListStore(2, 4, device="cpu")
    v = np.ones(4, np.float32)
    store.append(0, 1, v)
    store.append(0, 2, 2 * v)
    before = store.sync_device()
    layout = store.layout_version
    store.append(0, 3, 3 * v)  # within capacity: no repack
    after = store.sync_device()
    assert store.layout_version == layout
    assert after.vecs is before.vecs  # patched in place
    row = int(after.starts[0]) + 2
    assert int(after.lengths[0]) == 3 and int(after.row_ids[row]) == 3
    assert torch.equal(after.vecs[row], torch.full((4,), 3.0)) and float(after.sqnorms[row]) == 36.0
    store.append(0, 4, v, ts=0)
    store.sync_device(torch.bfloat16)  # a dtype switch re-uploads
    assert store._dev.vecs.dtype == torch.bfloat16


def _clustered(n=900, d=32, kc=13, seed=0):
    rng = np.random.default_rng(seed)
    cent = rng.standard_normal((kc, d)).astype(np.float32)
    p = np.exp(rng.standard_normal(kc) * 1.5)
    assign = rng.choice(kc, size=n, p=p / p.sum())
    x = (cent[assign] + 0.3 * rng.standard_normal((n, d))).astype(np.float32)
    return cent, x, assign


@pytest.mark.parametrize("nprobe", [1, 4, 13])
@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.value)
def test_ivf_search_flat_matches_jax(metric, nprobe):
    cent, x, assign = _clustered()
    js, ts = jivf.IVFListStore(13, 32), tivf.IVFListStore(13, 32, device="cpu")
    for s in (js, ts):
        s.append_batch(assign, np.arange(len(x)), x)
    ja, ta = js.sync_device(), ts.sync_device()
    cap = tivf.probe_cap_for(ts.max_length)
    rng = np.random.default_rng(1)
    q = rng.standard_normal((7, 32)).astype(np.float32)
    allow = np.zeros(ta.row_ids.shape[0], bool)
    live = ta.row_ids.numpy() >= 0
    allow[live] = rng.random(int(live.sum())) < 0.3
    disabled = np.zeros(13, bool)
    disabled[[1, 2]] = True
    for extra in ({}, {"row_allow": allow}, {"disabled_lists": disabled}):
        jd, ji = jivf.ivf_search_flat(
            jnp.asarray(q), jnp.asarray(cent), ja, nprobe=nprobe, probe_cap=cap, k=10,
            metric=JMetric(metric.value), **{k: jnp.asarray(v) for k, v in extra.items()})
        td, ti = tivf.ivf_search_flat(
            T(q), T(cent), ta, nprobe=nprobe, probe_cap=cap, k=10, metric=metric,
            query_chunk=4, **{k: T(v) for k, v in extra.items()})
        np.testing.assert_array_equal(ti.numpy(), _np(ji))
        np.testing.assert_allclose(td.numpy(), _np(jd), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.value)
def test_rerank_exact_topk_matches_jax(metric):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((50, 8)).astype(np.float32)
    sqn = (x**2).sum(1)
    q = rng.standard_normal((3, 8)).astype(np.float32)
    cands = np.tile(np.arange(50, dtype=np.int32), (3, 1))
    cands[1, 40:] = INVALID_ID  # missing rows sort last
    cands[2, :] = INVALID_ID
    cands[2, :3] = [5, 7, 9]
    jd, ji = jivf.rerank_exact_topk(jnp.asarray(q), jnp.asarray(cands), jnp.asarray(x),
                                    jnp.asarray(sqn), k=6, metric=JMetric(metric.value))
    td, ti = tivf.rerank_exact_topk(T(q), T(cands), T(x), T(sqn), k=6, metric=metric)
    np.testing.assert_array_equal(ti.numpy(), _np(ji))
    fin = np.isfinite(_np(jd))
    np.testing.assert_array_equal(np.isfinite(td.numpy()), fin)
    np.testing.assert_allclose(td.numpy()[fin], _np(jd)[fin], rtol=1e-4, atol=1e-4)
    assert set(ti[2, :3].tolist()) == {5, 7, 9} and (ti[2, 3:] == INVALID_ID).all()


def test_probe_cap_and_reserve_constants():
    assert (tivf.RESERVE_FACTOR, tivf.RESERVE_MIN) == (jivf.RESERVE_FACTOR, jivf.RESERVE_MIN)
    for n in (0, 1, 255, 256, 257, 1000, 4097):
        assert tivf.probe_cap_for(n) == jivf.probe_cap_for(n)
        assert tivf.IVFListStore._cap_for(n) == jivf.IVFListStore._cap_for(n)


@pytest.mark.parametrize("metric", [Metric.L2, Metric.INNER_PRODUCT], ids=lambda m: m.value)
def test_ivf_select_beam_matches_jax_and_approximates_exhaustive(metric):
    """tests/test_ivf.py:248-260 on both packages: the centroid kNN graph
    and the beam selection over it equal the JAX package's, and the beam
    finds ≥ 85% of the exhaustive top-nprobe."""
    rng = np.random.default_rng(7)
    cents = rng.standard_normal((512, 32)).astype(np.float32)
    q = rng.standard_normal((8, 32)).astype(np.float32)
    jg = _np(jivf.build_centroid_graph(jnp.asarray(cents)))
    g = tivf.build_centroid_graph(T(cents))
    np.testing.assert_array_equal(g.numpy(), jg)
    assert g.shape == (512, 16) and g.dtype == torch.int32
    assert not (g.numpy() == np.arange(512)[:, None]).any()  # no self edges
    jd, ji = jivf.ivf_select_beam(jnp.asarray(q), jnp.asarray(cents), jnp.asarray(jg), nprobe=8,
                                  metric=JMetric(metric.value))
    bd, bi = tivf.ivf_select_beam(T(q), T(cents), g, nprobe=8, metric=metric)
    np.testing.assert_allclose(bd.numpy(), _np(jd), rtol=1e-4, atol=1e-4)
    assert ids_match_up_to_ties(bi.numpy(), _np(ji), _np(jd), 8)
    _, ei = tivf.ivf_select(T(q), T(cents), nprobe=8)
    bi, ei = bi.numpy(), ei.numpy()
    assert np.mean([len(set(bi[b]) & set(ei[b])) / 8 for b in range(8)]) >= 0.85
    small = tivf.build_centroid_graph(T(cents[:5]), degree=16)  # degree clamps to kc - 1
    np.testing.assert_array_equal(small.numpy(), _np(jivf.build_centroid_graph(jnp.asarray(cents[:5]))))
