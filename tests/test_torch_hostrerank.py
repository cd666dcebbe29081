"""The port's IVF-PQ host-memory rerank tier against the JAX package's:
ops/rerank (readers, the native and numpy host reranks, the device rerank),
kernels/adc_probe.ivf_search_pq_hostrerank and its stream,
models/serve.HostRerankSession and IVFPQIndex(host_rerank=True).

Both packages get the same seeded numpy inputs; the JAX side runs its Pallas
ADC kernels in interpret mode (as tests/test_adc_probe_kernel.py does), the
port's wrappers their plain versions on CPU tensors. The stores, codes and
shapes are tests/test_torch_adc_probe.py's (d = 16; u8 m=4 ks=256, u4 m=8
ks=16), so few new static shapes are compiled.

Tolerances:
  - the host reranks: ids exact (equal up to ties of the reference
    distances where the candidates come from the two packages' ADC
    stages, utils/parity), distances within host_rerank_dist_tol(d,
    scale), the two host backends' settled contract (ops/rerank); the
    native library against the JAX package's (the same source, built with
    the same flags on the same CPU) and against numpy on integer-valued
    rows, bit for bit;
  - the device rerank: ids exact, distances within host_rerank_dist_tol
    (an f32 batched product in another order than XLA's);
  - the index against the JAX index: as tests/test_torch_ivfpq_index.py
    (rerank_c=512, so both routes keep the same candidates; RTOL/ATOL of
    utils/parity).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorindex_tpu.kernels.adc_probe as jap
from vectorindex_tpu.models.ivf import IVFPQConfig as JConfig
from vectorindex_tpu.models.ivf import IVFPQIndex as JIndex
from vectorindex_tpu.models.serve import HostRerankSession as JSession
from vectorindex_tpu.ops import dtypes as jdtypes
from vectorindex_tpu.ops import ivf as jivf
from vectorindex_tpu.ops import pq as jpq
from vectorindex_tpu.ops import rerank as jrr
from vectorindex_tpu.utils.config import Metric as JMetric
from vectorindex_tpu_torch import IVFPQConfig, IVFPQIndex
from vectorindex_tpu_torch.kernels import adc_probe as ap
from vectorindex_tpu_torch.models.serve import HostRerankSession
from vectorindex_tpu_torch.ops import ivf as tivf
from vectorindex_tpu_torch.ops import pq
from vectorindex_tpu_torch.ops import rerank as rr
from vectorindex_tpu_torch.ops.topk import INVALID_ID
from vectorindex_tpu_torch.utils.config import Metric
from vectorindex_tpu_torch.utils.errors import IndexError
from vectorindex_tpu_torch.utils.parity import ATOL, RTOL, ids_match_up_to_ties
from vectorindex_tpu_torch.utils.telemetry import TELEM

torch.set_num_threads(1)

K = 10
METRICS = [Metric.L2, Metric.INNER_PRODUCT, Metric.COSINE]
CONFIGS = {"u8": (4, 256), "u4": (8, 16)}  # (m, ks) at d = 16


def T(a):
    return torch.from_numpy(np.array(a))


def _scale(q, x, metric):
    """The magnitude of the terms before cancellation (host_rerank_dist_tol)."""
    if metric == Metric.COSINE:
        return 1.0
    return float((q * q).sum(1).max() + (x * x).sum(1).max())


def _assert_ordered(d, i):
    """Each row ascends by strict (score, id); missing slots last."""
    for dr, ir in zip(d, i):
        keys = list(zip(dr.tolist(), ir.tolist()))
        assert keys == sorted(keys)
        assert all(v == INVALID_ID for s, v in keys if not np.isfinite(s))


# -- the host and device reranks ---------------------------------------------


def _gathered_case(seed):
    """Candidates over 60 real-valued rows (rows 30-39 copy rows 0-9, so
    scores tie across ids), with INVALID_ID and -1 missing and a query
    whose every candidate is missing."""
    rng = np.random.default_rng(seed)
    b, c, d = 5, 40, 24
    rows = rng.standard_normal((60, d)).astype(np.float32)
    rows[30:40] = rows[:10]
    iids = rng.integers(0, 60, (b, c)).astype(np.int32)
    iids[0, :10] = np.arange(10)
    iids[0, 10:20] = np.arange(30, 40)
    xg = rows[iids]
    iids[1, :5] = INVALID_ID
    iids[3, 3] = -1
    iids[2] = INVALID_ID
    q = rng.standard_normal((b, d)).astype(np.float32)
    return q, xg, iids, rows


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.value)
def test_rerank_gathered_host_matches_jax(metric):
    q, xg, iids, rows = _gathered_case(1)
    rr.reset_rerank_counts()
    for k in (K, 50):  # 50 > C: padded with (+inf, INVALID_ID)
        jd, ji = jrr.rerank_gathered_host(q, xg, iids, k=k, metric=JMetric(metric.value))
        td, ti = rr.rerank_gathered_host(q, xg, iids, k=k, metric=metric)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(td, jd, rtol=0,
                                   atol=rr.host_rerank_dist_tol(24, _scale(q, rows, metric)))
        _assert_ordered(td, ti)
        assert (ti[2] == INVALID_ID).all() and np.isinf(td[2]).all()
        assert -1 not in ti
    assert (ti[:, 40:] == INVALID_ID).all()
    # every copied row ties with its original (lower id first: _assert_ordered)
    assert ((td[0, 1:] == td[0, :-1]) & (ti[0, 1:] != ti[0, :-1])).sum() >= 10
    assert rr.RERANK_IMPL == {"native": 0, "numpy": 2, "device": 0}


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.value)
def test_rerank_ids_host_matches_jax_native_and_numpy(metric):
    rng = np.random.default_rng(3)
    n, d, b, c = 3000, 24, 7, 129
    jm = JMetric(metric.value)
    ids = rng.integers(0, n, (b, c)).astype(np.int32)
    ids[0] = INVALID_ID
    ids[1, ::2] = INVALID_ID
    ids[2, 5] = -1
    ids[3, :40] = ids[3, 40:80]  # repeated candidates
    for kind in ("int", "real"):
        if kind == "int":  # every f32 sum exact
            x = rng.integers(-8, 8, (n, d)).astype(np.float32)
            q = rng.integers(-8, 8, (b, d)).astype(np.float32)
        else:
            x = rng.standard_normal((n, d)).astype(np.float32)
            q = rng.standard_normal((b, d)).astype(np.float32)
        rr.reset_rerank_counts()
        td, ti = rr.rerank_ids_host(x, ids, q, k=K, metric=metric)
        assert rr.RERANK_IMPL["native"] == 1
        jd, ji = jrr.rerank_ids_host(x, ids, q, k=K, metric=jm)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(td, jd)  # the same source, flags and CPU
        xg = rr.CSRReader(x, np.arange(n)).gather_ids(ids.reshape(-1)).reshape(b, c, d)
        nd, ni = rr.rerank_gathered_host(q, xg, ids, k=K, metric=metric)
        np.testing.assert_array_equal(ti, ni)
        if kind == "int" and metric != Metric.COSINE:  # cosine's sqrt and divide round
            np.testing.assert_array_equal(td, nd)
        else:
            np.testing.assert_allclose(td, nd, rtol=0,
                                       atol=rr.host_rerank_dist_tol(d, _scale(q, x, metric)))
        _assert_ordered(td, ti)
        assert (ti[0] == INVALID_ID).all() and -1 not in ti
    # threads, a padded row stride, k past C, k <= 0
    d1, i1 = rr.rerank_ids_host(x, ids, q, k=K, metric=metric, n_threads=1)
    d4, i4 = rr.rerank_ids_host(x, ids, q, k=K, metric=metric, n_threads=4)
    np.testing.assert_array_equal(i1, i4)
    np.testing.assert_array_equal(d1, d4)
    wide = np.zeros((n, 32), np.float32)
    wide[:, :d] = x
    assert rr.native_rerank_available(wide[:, :d])
    dp, ip_ = rr.rerank_ids_host(wide[:, :d], ids, q, k=K, metric=metric)
    np.testing.assert_array_equal(ip_, i1)
    np.testing.assert_array_equal(dp, d1)
    dk, ik = rr.rerank_ids_host(x, ids[:, :6], q, k=K, metric=metric)
    assert dk.shape == (b, K) and (ik[:, 6:] == INVALID_ID).all()
    for k in (0, -1):
        e = rr.rerank_ids_host(x, ids, q, k=k, metric=metric)
        assert e[0].shape == (b, 0) and e[1].shape == (b, 0)


def test_rerank_ids_host_declines_only_by_layout():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((100, 8)).astype(np.float32)
    ids = rng.integers(0, 100, (2, 5)).astype(np.int32)
    q = x[:2]
    assert rr.rerank_ids_host(x, ids, q, k=3, metric=Metric.L2) is not None
    for src in (x.astype(np.float64), x[:, ::2], np.asfortranarray(x), list(x)):
        assert not rr.native_rerank_available(src)
        assert rr.rerank_ids_host(src, ids, q[:, : np.shape(src)[1]], k=3, metric=Metric.L2) is None
    assert rr.rerank_ids_host(x[:, :4], ids, q, k=3, metric=Metric.L2) is None  # d > width
    with pytest.raises(ValueError, match="L2, IP and cosine"):
        rr.rerank_ids_host(x, ids, q, k=3, metric=Metric.MANHATTAN)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.value)
def test_rerank_gathered_device_matches_jax(metric):
    q, xg, iids, rows = _gathered_case(2)
    cand = np.where((iids == INVALID_ID) | (iids < 0), np.inf, 1.0).astype(np.float32)
    iids = np.where(np.isfinite(cand), iids, INVALID_ID).astype(np.int32)
    jd, ji = jrr.rerank_gathered(jnp.asarray(q), jnp.asarray(xg), jnp.asarray(cand),
                                 jnp.asarray(iids), k=50, metric=JMetric(metric.value))
    rr.reset_rerank_counts()
    td, ti = rr.rerank_gathered(T(q), T(xg), T(cand), T(iids), k=50, metric=metric)
    assert rr.RERANK_IMPL == {"native": 0, "numpy": 0, "device": 1}
    jd, ji, td, ti = np.asarray(jd), np.asarray(ji), td.numpy(), ti.numpy()
    assert ids_match_up_to_ties(ti, ji, jd, 50)
    np.testing.assert_array_equal(np.isfinite(td), np.isfinite(jd))
    fin = np.isfinite(jd)
    np.testing.assert_allclose(td[fin], jd[fin], rtol=0,
                               atol=rr.host_rerank_dist_tol(24, _scale(q, rows, metric)))
    _assert_ordered(td, ti)


def test_readers_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((50, 6)).astype(np.float32)
    row_ids = rng.permutation(np.concatenate([np.arange(50), [-1, -1]])).astype(np.int32)
    rows = np.array([0, 3, 51, 7])
    ids = np.array([4, INVALID_ID, -1, 49, 50], np.int32)
    np.testing.assert_array_equal(rr.CSRReader(x, row_ids).gather(rows),
                                  jrr.CSRReader(x, row_ids).gather(rows))
    np.testing.assert_array_equal(rr.CSRReader(x, row_ids).gather_ids(ids),
                                  jrr.CSRReader(x, row_ids).gather_ids(ids))
    np.testing.assert_array_equal(rr.ArrayReader(x).gather(rows[:2]), x[rows[:2]])
    np.testing.assert_array_equal(rr.CallbackReader(lambda r: x[r] * 2).gather(rows[:2]),
                                  jrr.CallbackReader(lambda r: x[r] * 2).gather(rows[:2]))
    assert rr.CSRReader(x, row_ids).vecs is x  # no copy of an f32 corpus
    assert rr.CSRReader.vecs_id_indexed and not hasattr(rr.ArrayReader, "vecs_id_indexed")
    assert rr.host_rerank_dist_tol(96, 3.0) == jrr.host_rerank_dist_tol(96, 3.0)
    assert rr.host_rerank_dist_tol(96, 0.1) == jrr.host_rerank_dist_tol(96, 0.1)


# -- the host-rerank search and its stream -----------------------------------


def _store(x, assign, ids, kc):
    js = jivf.IVFListStore(kc, x.shape[1])
    ts = tivf.IVFListStore(kc, x.shape[1], device="cpu")
    js.append_batch(assign, ids, x)
    ts.append_batch(assign, ids, x)
    ja, ta = js.sync_device(), ts.sync_device(with_vecs=False)
    np.testing.assert_array_equal(ta.row_ids.numpy(), np.asarray(ja.row_ids))
    row_list = np.zeros(ja.row_ids.shape[0], np.int32)
    for l, (s, n) in enumerate(zip(np.asarray(ja.starts), np.asarray(ja.lengths))):
        row_list[s : s + n] = l
    return js, ts, ja, ta, row_list, tivf.probe_cap_for(ts.max_length)


def _pq_state(ja, coarse, row_list, m, ks, seed):
    cents = np.random.default_rng(seed).standard_normal((m, ks, 16 // m)).astype(np.float32)
    jb = jpq.PQCodebooks(jnp.asarray(cents), jnp.sum(jnp.square(jnp.asarray(cents)), axis=-1))
    codes = jpq.pq_encode_residual(ja.vecs, jnp.asarray(coarse), jnp.asarray(row_list), jb)
    tcorr = np.asarray(jpq.pq_row_corrections(codes, jnp.asarray(row_list), jnp.asarray(coarse), jb))
    if ks <= 16:
        codes = jdtypes.pack_u4(codes)
    return jb, pq.books_from_centroids(T(cents)), np.asarray(codes), tcorr


def _case(seed, n, kc, src=None, assign=None, x=None):
    rng = np.random.default_rng(seed)
    d = 16
    if x is None:
        coarse = rng.standard_normal((kc, d)).astype(np.float32)
        assign = rng.choice(kc, n, p=[0.35, 0.25, 0.15, 0.1, 0.1, 0.05])
        x = (coarse[assign] + 0.3 * rng.standard_normal((n, d))).astype(np.float32)
        src = np.arange(n)
    else:
        coarse = src
        src, assign, _ = jivf.spill_assign(x, coarse, eps=0.2)
    js, ts, ja, ta, row_list, cap = _store(x[src], assign, src, kc)
    out = dict(x=x, coarse=coarse, js=js, ts=ts, ja=ja, ta=ta, cap=cap, kc=kc, row_list=row_list)
    for name, (m, ks) in CONFIGS.items():
        out[name] = _pq_state(ja, coarse, row_list, m, ks, seed=m)
    out["q"] = rng.standard_normal((18, d)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def f():
    return _case(0, 1100, 6)


def _readers(f, kind):
    """(JAX reader, port reader) over the fixture's rows."""
    if kind == "csr":
        return (jrr.CSRReader(f["x"], np.asarray(f["ja"].row_ids)),
                rr.CSRReader(f["x"], f["ta"].row_ids.numpy()))
    if kind == "csr-f64":  # id-keyed, but no f32 rows: the numpy path
        return None, rr.CSRReader(f["x"].astype(np.float64), f["ta"].row_ids.numpy())
    # rows-keyed, each over its package's packed host mirror (the JAX
    # package's pads d to 128 lanes)
    return jrr.ArrayReader(f["js"]._packed["vecs"]), rr.ArrayReader(f["ts"].packed()["vecs"])


def _state(f, name, metric, **kw):
    """Both packages' candidate-stage arguments (tcorr zero for IP)."""
    jb, tb, codes, tcorr = f[name]
    if metric == Metric.INNER_PRODUCT:
        tcorr = np.zeros_like(tcorr)
    jkw, tkw = dict(kw), dict(kw)
    for key in ("row_allow", "disabled_lists"):
        if kw.get(key) is not None:
            jkw[key], tkw[key] = jnp.asarray(kw[key]), T(kw[key])
    packed = CONFIGS[name][1] <= 16
    jargs = (jnp.asarray(f["coarse"]), f["ja"], jnp.asarray(codes), jnp.asarray(tcorr), jb)
    targs = (T(f["coarse"]), f["ta"], T(codes), T(tcorr), tb)
    jkw.update(metric=JMetric(metric.value), packed_u4=packed, interpret=True)
    tkw.update(metric=metric, packed_u4=packed)
    return jargs, targs, jkw, tkw


def _np(out):
    return tuple(o.numpy() if isinstance(o, torch.Tensor) else np.asarray(o) for o in out)


def _assert_host_equal(got, want, q, x, metric, k=K):
    (td, ti), (jd, ji) = got, want
    fin = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(td), fin)
    np.testing.assert_allclose(td[fin], jd[fin], rtol=0,
                               atol=rr.host_rerank_dist_tol(q.shape[1], _scale(q, x, metric)))
    assert ids_match_up_to_ties(ti, ji, np.where(fin, jd, np.inf), k)
    _assert_ordered(td, ti)


SEARCH_CASES = {
    "u8-l2-k10-csr-native": ("u8", Metric.L2, 6, "csr", {}),
    "u8-l2-k10-array-numpy": ("u8", Metric.L2, 6, "array", {}),
    "u8-l2-k10-array-device": ("u8", Metric.L2, 6, "array", dict(host_rerank=False)),
    "u4-ip-k9-allow-csr": ("u4", Metric.INNER_PRODUCT, 18, "csr", dict(allow=True)),
    "u8-l2-k9-disabled-array": ("u8", Metric.L2, 18, "array", dict(disabled=True)),
}
IMPL = {"csr": "native", "array": "numpy"}


def _search_kw(f, kw):
    kw = dict(kw)
    if kw.pop("allow", False):
        kw["row_allow"] = np.random.default_rng(1).random(f["ja"].row_ids.shape[0]) < 0.3
    if kw.pop("disabled", False):
        dis = np.zeros(f["kc"], bool)
        dis[[0, 2]] = True
        kw["disabled_lists"] = dis
    nprobe = f["kc"] if "disabled_lists" in kw else 3
    return dict(kw, nprobe=nprobe, probe_cap=f["cap"], k=K, rerank_c=64)


@pytest.mark.parametrize("case", list(SEARCH_CASES))
def test_hostrerank_search_matches_jax(f, case):
    name, metric, b, kind, kw = SEARCH_CASES[case]
    kw = _search_kw(f, kw)
    q = f["q"][:b]
    jargs, targs, jkw, tkw = _state(f, name, metric, **kw)
    jreader, treader = _readers(f, kind)
    want = _np(jap.ivf_search_pq_hostrerank(jnp.asarray(q), *jargs, jreader, **jkw))
    rr.reset_rerank_counts()
    ap.reset_launches()
    got = ap.ivf_search_pq_hostrerank(q, *targs, treader, **tkw)
    impl = "device" if kw.get("host_rerank") is False else IMPL[kind]
    assert rr.RERANK_IMPL == {**dict.fromkeys(rr.RERANK_IMPL, 0), impl: 1}
    assert set(ap.LAUNCHES.values()) == {0}  # CPU tensors: the plain versions
    assert all(isinstance(o, torch.Tensor if impl == "device" else np.ndarray) for o in got)
    got = _np(got)
    _assert_host_equal(got, want, q, f["x"], metric)
    assert (got[1] != INVALID_ID).all()
    rid = f["ta"].row_ids.numpy()
    if "row_allow" in kw:
        assert set(got[1].ravel().tolist()) <= set(rid[kw["row_allow"] & (rid >= 0)].tolist())
    if "disabled_lists" in kw:
        members = rid[np.isin(f["row_list"], [0, 2]) & (rid >= 0)]
        assert not set(got[1].ravel().tolist()) & set(members.tolist())
    # the candidates are those of pq_probe_candidates at C = max(rerank_c, 4k, 128)
    c = ap.candidate_count(64, K, kw["nprobe"], f["kc"], f["cap"])
    assert c == min(max(64, 4 * K, 128), kw["nprobe"] * f["cap"]) == 128


def test_hostrerank_spill_dedup_matches_jax_and_fills_every_row():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((700, 16)).astype(np.float32)
    g = _case(2, 0, 6, src=0.5 * rng.standard_normal((6, 16)).astype(np.float32), x=x)
    q = g["q"]
    kw = dict(nprobe=3, probe_cap=g["cap"], k=K, rerank_c=64)
    jargs, targs, jkw, tkw = _state(g, "u4", Metric.L2, **kw)
    jreader, treader = _readers(g, "csr")
    want = _np(jap.ivf_search_pq_hostrerank(jnp.asarray(q), *jargs, jreader, dedup=True, **jkw))
    got = ap.ivf_search_pq_hostrerank(q, *targs, treader, dedup=True, **tkw)
    _assert_host_equal(got, want, q, x, Metric.L2)
    assert all(len(set(row)) == K and INVALID_ID not in row for row in got[1].tolist())
    dup = ap.ivf_search_pq_hostrerank(q, *targs, treader, **tkw)[1]  # copies crowd the top-k
    assert any(len(set(row)) < K for row in dup.tolist())


@pytest.mark.parametrize("kind", ["csr", "array", "csr-f64", "device"])
def test_stream_equals_per_call(f, kind):
    """Batch by batch and in order, at lookahead 1 and 3, with fewer batches
    than the lookahead, and batches of other sizes (K10 and K9)."""
    host = kind != "device"
    _, treader = _readers(f, "array" if kind == "device" else kind)
    _, targs, _, tkw = _state(f, "u8", Metric.L2, nprobe=3, probe_cap=f["cap"], k=K,
                              rerank_c=64, host_rerank=host)
    q = f["q"]
    batches = [q[:6], q[6:9], q[:18], T(q[9:15])]
    want = [_np(ap.ivf_search_pq_hostrerank(b, *targs, treader, **tkw)) for b in batches]
    for lookahead, n in ((1, 4), (3, 4), (3, 2)):
        rr.reset_rerank_counts()
        got = list(ap.ivf_search_pq_hostrerank_stream(batches[:n], *targs, treader,
                                                      lookahead=lookahead, **tkw))
        assert len(got) == n
        for (gd, gi), (wd, wi) in zip((_np(o) for o in got), want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gd, wd)
        impl = {"csr": "native", "device": "device"}.get(kind, "numpy")
        assert rr.RERANK_IMPL[impl] == n and sum(rr.RERANK_IMPL.values()) == n


def test_stream_matches_the_jax_stream(f):
    jargs, targs, jkw, tkw = _state(f, "u8", Metric.L2, nprobe=3, probe_cap=f["cap"], k=K,
                                    rerank_c=64)
    jreader, treader = _readers(f, "csr")
    q = f["q"]
    batches = [q[:6], q[6:12], q[12:18]]
    want = [_np(o) for o in jap.ivf_search_pq_hostrerank_stream(batches, *jargs, jreader,
                                                                lookahead=2, **jkw)]
    got = list(ap.ivf_search_pq_hostrerank_stream(batches, *targs, treader, lookahead=2, **tkw))
    for g, w, b in zip(got, want, batches):
        _assert_host_equal(g, w, b, f["x"], Metric.L2)


def test_pinned_landing_reuses_a_buffer_only_after_release():
    landing = ap.PinnedLanding(2)
    t = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    landed = landing.land((t,))  # a CPU tensor lands as itself
    assert landed.event is None and landed.views[0] is t
    np.testing.assert_array_equal(landing.wait(landed)[0], t.numpy())
    landing.release(landed)
    assert len(landing._free) == 2


# -- the serving session -----------------------------------------------------


def _sessions(f, kind, row_allow=None):
    jb, tb, codes, tcorr = f["u8"]
    jreader, treader = _readers(f, kind)
    common = dict(nprobe=3, probe_cap=f["cap"], rerank_c=64, lookahead=2)
    js = JSession(jnp.asarray(f["coarse"]), f["ja"], jnp.asarray(codes), jnp.asarray(tcorr), jb,
                  jreader, interpret=True, **common)
    ts = HostRerankSession(T(f["coarse"]), f["ta"], T(codes), T(tcorr), tb, treader,
                           row_allow=row_allow, device="cpu", **common)
    return js, ts


def test_session_methods_match_jax(f):
    js, ts = _sessions(f, "csr")
    q = f["q"][:6]
    got, want = ts.search(q, K), js.search(q, K)
    assert all(isinstance(o, np.ndarray) for o in got)
    _assert_host_equal(got, want, q, f["x"], Metric.L2)
    cd, rows, iids = ts.probe_candidates(q, K)
    jcd, _, jiids = js.probe_candidates(jnp.asarray(q), K)
    assert iids.shape == (6, 128) and isinstance(iids, torch.Tensor)
    np.testing.assert_allclose(cd.numpy(), np.asarray(jcd), rtol=1e-5, atol=1e-5)
    assert ids_match_up_to_ties(iids.numpy(), np.asarray(jiids), np.asarray(jcd), 128)
    fn, args = ts.candidates_closure(K)
    for a, b in zip(fn(T(q), *args), (cd, rows, iids)):
        assert torch.equal(a, b)
    rr.reset_rerank_counts()
    for a, b in zip(ts.rerank_host(iids, q, K), got):
        np.testing.assert_array_equal(a, b)
    assert rr.RERANK_IMPL["native"] == 1
    streamed = list(ts.stream([q, f["q"][6:12]], K))
    for a, b in zip(streamed[0], got):
        np.testing.assert_array_equal(a, b)
    _assert_host_equal(streamed[1], js.search(f["q"][6:12], K), f["q"][6:12], f["x"], Metric.L2)


def test_session_rows_keyed_reader_allow_mask_and_device_check(f):
    allow = np.random.default_rng(1).random(f["ja"].row_ids.shape[0]) < 0.3
    _, ts = _sessions(f, "array", row_allow=T(allow))
    q = f["q"][:6]
    got = ts.search(q, K)
    rid = f["ta"].row_ids.numpy()
    assert set(got[1].ravel().tolist()) <= set(rid[allow & (rid >= 0)].tolist())
    fn, args = ts.candidates_closure(K)
    assert len(args) == 5 and torch.equal(fn(T(q), *args)[2], ts.probe_candidates(q, K)[2])
    with pytest.raises(ValueError, match="id-keyed"):
        ts.rerank_host(ts.probe_candidates(q, K)[2], q, K)
    streamed = list(ts.stream([q], K))
    np.testing.assert_array_equal(streamed[0][1], got[1])
    with pytest.raises(ValueError, match="its device"):
        HostRerankSession(ts.centroids, ts.arrays, ts.codes, ts.tcorr, ts.books, ts.reader,
                          nprobe=3, probe_cap=f["cap"], device="cuda")


# -- IVFPQIndex(host_rerank=True) ---------------------------------------------

N, D = 2000, 16


def _meta(i):
    return {"even": i % 2 == 0}


def _ids(res):
    return [[r.id for r in row] for row in res]


def _ascending(row, metric):
    s = np.array([[r.score for r in row]], dtype=np.float64)
    return s * s if metric == Metric.L2 else -s


def _assert_same(got, want, metric, k=K):
    """got: the port's rows for k; want: the JAX index's for k + 1 (or k)."""
    assert [len(r) for r in got] == [min(k, len(r)) for r in want]
    for g_row, w_row in zip(got, want):
        n = len(g_row)
        wd = _ascending(w_row, metric)
        np.testing.assert_allclose(_ascending(g_row, metric), wd[:, :n], rtol=RTOL, atol=ATOL)
        assert ids_match_up_to_ties([[r.id for r in g_row]], [[r.id for r in w_row]], wd, n)


def _jax_state(j):
    return {
        "dimension": j.dimension, "metric": j.metric.value,
        "config": {f: getattr(j.config, f) for f in j.config.__dataclass_fields__},
        "storage_dtype": "float32", "vectors": dict(j._vectors), "metadata": dict(j._metadata),
        "ids": list(j._idmap.items()), "free": list(j._free), "next_slot": j._next_slot,
        "centroids": j._centroids, "lists": [list(ids) for ids in j._store._lists_ids],
        "slot_list": dict(j._slot_list), "slot_spill": dict(j._slot_spill),
        "books": None if j._books is None else np.asarray(j._books.centroids),
    }


def _host_index(name, metric=Metric.L2):
    m, ks = {"u8": (4, 256), "u4": (8, 16)}[name]
    rng = np.random.default_rng(13)
    x = rng.standard_normal((N, D)).astype(np.float32)
    q = x[rng.choice(N, 24, replace=False)] + 0.1 * rng.standard_normal((24, D)).astype(np.float32)
    cfg = dict(nlist=8, nprobe=3, rerank_c=512, pq_iters=4, m=m, ks=ks, host_rerank=True)
    j = JIndex(D, JMetric(metric.value), JConfig(**cfg))
    j.insert_batch(list(range(N)), x, [_meta(i) for i in range(N)])
    j.optimize()
    for i in range(0, N, 19):
        j.remove(i)
    t = IVFPQIndex.from_state(_jax_state(j), device="cpu")
    assert t.config.host_rerank and t.config == IVFPQConfig(**cfg)
    return j, t, x, q


@pytest.mark.parametrize("name", ["u8", "u4"])
def test_index_host_tier_matches_jax(name):
    j, t, x, q = _host_index(name)
    rr.reset_rerank_counts()
    _assert_same(t.batch_search(q[:8], K), j.batch_search(q[:8], K + 1), Metric.L2)
    allow = list(range(0, N, 3))
    even = lambda m: m is not None and m["even"]  # noqa: E731
    _assert_same(t.batch_search(q, K, filter=even, allow_ids=allow),
                 j.batch_search(q, K, filter=even, allow_ids=allow), Metric.L2)
    _assert_same(t.batch_search(q[:8], K, disabled_lists=[1, 4]),
                 j.batch_search(q[:8], K + 1, disabled_lists=[1, 4]), Metric.L2)
    # the index's reader is its packed host mirror, keyed by CSR row
    assert rr.RERANK_IMPL == {"native": 0, "numpy": 3, "device": 0}
    arrays, _, _ = t._sync_pq()
    assert arrays.vecs is None and arrays.sqnorms is None and t._store._dev is None
    assert all(r.id % 19 for row in t.batch_search(q, K) for r in row)  # removed ids stay out
    batches = [q[:8], q[8:16], q[16:24]]  # one static shape for the JAX stream
    streamed = list(t.batch_search_stream(batches, K, lookahead=2))
    assert [_ids(s) for s in streamed] == [_ids(t.batch_search(b, K)) for b in batches]
    if name == "u8":  # the JAX stream and session once (an interpret-mode compile each)
        for g, w in zip(streamed, j.batch_search_stream(batches, K, lookahead=2)):
            _assert_same(g, w, Metric.L2)
    sess = t.serve_session(lookahead=2)
    assert sess.arrays.vecs is None and sess.device == torch.device("cpu")
    assert sess.lookahead == 2 and sess.rerank_c == 512 and not sess.dedup
    sd, si = sess.search(q[:8], K)
    want = t.batch_search(q[:8], K)
    assert si.tolist() == [[t._idmap.lookup(r.id) for r in row] for row in want]
    with pytest.raises(IndexError):
        list(t.batch_search_stream([q[:2, :8]], K))


def test_index_host_tier_telemetry_and_session_filters():
    j, t, x, q = _host_index("u4")
    TELEM.reset()
    TELEM.enable()
    try:
        t.batch_search(q[:8], 5)
        rec = TELEM.recent(1)[0]
        snap = TELEM.snapshot()
    finally:
        TELEM.disable()
    c = ap.candidate_count(512, 5, 3, 8, tivf.probe_cap_for(t._store.max_length))
    assert "scan_adc" in rec.stage_ms and rec.lists_routed == 8 * 3
    assert "u4" in rec.flags and "host_rerank" in rec.flags
    assert rec.candidates_kept == 8 * c and snap["bytes"]["vecs"] == 8 * c * D * 4
    deny = [r.id for r in t.batch_search(q[:1], 3)[0]]
    sess = t.serve_session(deny_ids=deny)
    assert not set(deny) & {t._idmap.external_for(int(s)) for s in sess.search(q[:1], 3)[1][0]}
    with pytest.raises(ValueError, match="host-rerank tier"):
        IVFPQIndex(D, config=IVFPQConfig(nlist=4, m=4, ks=16), device="cpu").serve_session()
    untrained = IVFPQIndex(D, config=IVFPQConfig(nlist=4, m=4, ks=16, host_rerank=True),
                           device="cpu")
    untrained.insert_batch(list(range(50)), x[:50])
    with pytest.raises(ValueError, match="trained"):
        untrained.serve_session()
    assert [r[0].id for r in next(untrained.batch_search_stream([x[:2]], 1))] == [0, 1]


def test_saved_jax_host_tier_index_loads_and_searches(tmp_path):
    """A JAX IVFPQIndex(host_rerank=True) saved with save() loads into the
    port (which retrains on load, as the JAX package does) and searches to
    the same ids; nprobe == nlist and rerank_c >= n make both exact."""
    x = np.random.default_rng(41).standard_normal((300, 8)).astype(np.float32)
    cfg = dict(nlist=4, nprobe=4, m=4, ks=16, rerank_c=512, host_rerank=True)
    j = JIndex(8, JMetric.L2, JConfig(**cfg))
    j.insert_batch(list(range(300)), x, [_meta(i) for i in range(300)])
    j.optimize()
    j.save(str(tmp_path / "jax.json"))
    t = IVFPQIndex.load(str(tmp_path / "jax.json"), device="cpu")
    assert t.config.host_rerank and t.count == 300 and t.trained and t.pq_trained
    q = x[:6] + 0.01
    want = np.argsort(((q[:, None, :] - x[None]) ** 2).sum(-1), axis=1, kind="stable")[:, :K]
    rr.reset_rerank_counts()
    assert _ids(t.batch_search(q, K)) == want.tolist() == _ids(j.batch_search(q, K))
    assert rr.RERANK_IMPL["numpy"] == 1 and t._sync_pq()[0].vecs is None
    assert [_ids(b) for b in t.batch_search_stream([q[:2], q[2:]], K)] == [want[:2].tolist(),
                                                                          want[2:].tolist()]
    t.save(str(tmp_path / "torch.json"))
    assert json.loads((tmp_path / "torch.json").read_text())["config"]["host_rerank"] is True
    assert _ids(JIndex.load(str(tmp_path / "torch.json")).batch_search(q, K)) == want.tolist()
