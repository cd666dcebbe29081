"""The port's FlatIndex (vectorindex_tpu_torch.models.flat) against the JAX
package's, on the same seeded inserts, removes, updates and compaction.

Both routes are covered: the strict path below LARGE_SCAN_THRESHOLD, and the
fused path above it, with the threshold lowered to 1024 in both packages and
the JAX side forced onto its Pallas kernels (interpret mode), as
tests/test_scan_fused.py does, at any width; above it manhattan/chebyshev
take the verified two-phase scan in both packages. Tolerance for distances: rtol=2e-4,
atol=2e-5 on the internal ascending distance (squared L2, -IP, 1-cosine);
f32 sums in another order, and bf16 products are exact in f32. Ids must be
equal, except at a rank whose JAX distance lies within that tolerance of a
neighbouring rank's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorindex_tpu.models.flat as jflat
import vectorindex_tpu_torch.models.flat as tflat
from vectorindex_tpu.models.filters import JournalFilter as JJournalFilter
from vectorindex_tpu.utils.config import Metric as JMetric
from vectorindex_tpu_torch.kernels import scan_fused as sf
from vectorindex_tpu_torch.models.filters import JournalFilter
from vectorindex_tpu_torch.utils.config import Metric
from vectorindex_tpu_torch.utils.errors import IndexError, IndexErrorKind
from vectorindex_tpu_torch.utils.parity import ATOL, RTOL, ids_match_up_to_ties
from vectorindex_tpu_torch.utils.telemetry import TELEM

torch.set_num_threads(1)

D, N, B, K = 16, 1500, 6, 5
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(params=["strict", "fused"])
def route(request, monkeypatch):
    """strict: default threshold (the index stays below it); fused: both
    packages take the fused kernels at capacity >= 1024 (the port its
    verified scan from B x capacity >= 1024)."""
    if request.param == "fused":
        monkeypatch.setenv("VECTORINDEX_TPU_FORCE_PALLAS_SCAN", "1")
        monkeypatch.setattr(jflat, "LARGE_SCAN_THRESHOLD", 1024)
        monkeypatch.setattr(tflat, "LARGE_SCAN_THRESHOLD", 1024)
        monkeypatch.setattr(tflat, "VERIFIED_MIN_BLOCK", 1024)
    return request.param


def _meta(i):
    return {
        "tag": "even" if i % 2 == 0 else "odd",
        "date": f"2024-01-{1 + i % 28:02d}",
        "tags": "a,b" if i % 3 == 0 else "c",
    }


def _populate(idx, seed=0):
    """The same mutations on an index of either package; returns queries."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D)).astype(np.float32)
    idx.insert_batch([f"v{i}" for i in range(N - 10)], x[: N - 10], [_meta(i) for i in range(N - 10)])
    for i in range(N - 10, N):
        idx.insert(f"v{i}", x[i], _meta(i))
    for i in range(0, N, 9):
        idx.remove(f"v{i}")
    for i in [i for i in range(1, 80, 7) if i % 9]:
        idx.update(f"v{i}", vector=x[i] + 0.5, metadata={"tag": "updated"})
    extra = rng.standard_normal((30, D)).astype(np.float32)
    idx.insert_batch([f"w{i}" for i in range(30)], extra)  # reuses freed slots
    return x[rng.choice(N, B, replace=False)] + 0.3 * rng.standard_normal((B, D)).astype(np.float32)


def _pair(metric: Metric, dtype: str):
    jd, td = DTYPES[dtype]
    j = jflat.FlatIndex(D, JMetric(metric.value), storage_dtype=jd)
    t = tflat.FlatIndex(D, metric, storage_dtype=td, device="cpu")
    return j, t


def _ascending(res, metric: Metric):
    """Public scores -> internal ascending distances [B, len]."""
    s = np.array([[r.score for r in row] for row in res], dtype=np.float64)
    if metric == Metric.L2:
        return s * s
    if metric == Metric.INNER_PRODUCT:
        return -s
    if metric == Metric.COSINE:
        return 1.0 - s
    return s


def _assert_same(got, want, metric, k=K):
    """got: port results for k; want: JAX results for k + 1."""
    assert [len(r) for r in got] == [min(k, len(r)) for r in want]
    wd = _ascending(want, metric)
    np.testing.assert_allclose(_ascending(got, metric), wd[:, :k], rtol=RTOL, atol=ATOL)
    gi = np.array([[r.id for r in row] for row in got])
    wi = np.array([[r.id for r in row] for row in want])
    assert ids_match_up_to_ties(gi, wi, wd, k)
    for g_row, w_row in zip(got, want):
        by_id = {r.id: r.metadata for r in w_row}
        assert all(r.metadata == by_id[r.id] for r in g_row if r.id in by_id)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize(
    "metric", [Metric.L2, Metric.INNER_PRODUCT, Metric.COSINE], ids=lambda m: m.value
)
def test_search_matches_jax(metric, dtype, route):
    j, t = _pair(metric, dtype)
    q = _populate(j)
    _populate(t)
    assert t.count == j.count and t.capacity == j.capacity == 2048
    _assert_same(t.batch_search(q, K), j.batch_search(q, K + 1), metric)
    _assert_same([t.search(q[0], K)], [j.search(q[0], K + 1)], metric)


@pytest.mark.parametrize("metric", [Metric.MANHATTAN, Metric.CHEBYSHEV], ids=lambda m: m.value)
def test_broadcast_metrics_take_strict_at_any_size(metric, route):
    """manhattan/chebyshev never reach the fused kernels: the strict path
    below the threshold, the verified scan (ops/scan.scan_topk_verified)
    above it, as in the JAX package."""
    j, t = _pair(metric, "float32")
    q = _populate(j)
    _populate(t)
    TELEM.reset()
    TELEM.enable()
    try:
        got = t.batch_search(q, K)
    finally:
        TELEM.disable()
    _assert_same(got, j.batch_search(q, K + 1), metric)
    counters = TELEM.snapshot()["counters"]
    path = "scan_strict" if route == "strict" else "scan_verified"
    assert counters[f"kernel.{path}.calls"] == 1 and "kernel.scan_fused.calls" not in counters
    assert counters.get("flat.verify_fallback", 0) == 0


def test_filters_match_jax(route):
    j, t = _pair(Metric.COSINE, "float32")
    q = _populate(j)
    _populate(t)
    allow = [f"v{i}" for i in range(0, N, 4)] + ["missing"]
    deny = [f"v{i}" for i in range(0, N, 8)]
    jf = JJournalFilter().date_between("2024-01-05", "2024-01-20").including_tags("a").compile()
    tf = JournalFilter().date_between("2024-01-05", "2024-01-20").including_tags("a").compile()
    cases = [
        (dict(filter=lambda m: m is not None and m.get("tag") == "even"),) * 2,
        (dict(allow_ids=allow),) * 2,
        (dict(allow_ids=allow, deny_ids=deny),) * 2,
        (dict(filter=jf), dict(filter=tf)),
    ]
    for jkw, tkw in cases:
        got = t.batch_search(q, K, **tkw)
        _assert_same(got, j.batch_search(q, K + 1, **jkw), Metric.COSINE)
        assert all(len(row) == K for row in got)
    got = t.batch_search(q, K, allow_ids=allow, deny_ids=deny)
    assert {r.id for row in got for r in row} <= set(allow) - set(deny)


def test_crud_compact_and_statistics_match_jax():
    j, t = _pair(Metric.L2, "bfloat16")
    q = _populate(j)
    _populate(t)
    for idx in (j, t):
        idx.compact()
    np.testing.assert_array_equal(t._vectors, j._vectors)
    np.testing.assert_array_equal(t._valid, j._valid)
    assert dict(t._idmap.items()) == dict(j._idmap.items())
    assert t._metadata == j._metadata and t._next_slot == j._next_slot
    _assert_same(t.batch_search(q, K), j.batch_search(q, K + 1), Metric.L2)
    assert t.contains("v1") and not t.contains("v0")
    np.testing.assert_array_equal(t.get("v1")[0], j.get("v1")[0])
    assert t.get("v1")[1] == j.get("v1")[1] == {"tag": "updated"}
    js, ts = j.statistics(), t.statistics()
    assert (ts.count, ts.dimension, ts.metric, ts.memory_bytes) == (
        js.count, js.dimension, js.metric, js.memory_bytes)
    for key in ("capacity", "free_slots", "storage_dtype"):
        assert ts.details[key] == js.details[key]


def test_errors(tmp_path):
    t = tflat.FlatIndex(4, device="cpu")
    t.insert("a", np.ones(4))
    cases = [
        (lambda: t.insert("a", np.ones(4)), IndexErrorKind.DUPLICATE_ID),
        (lambda: t.insert_batch(["b", "a"], np.ones((2, 4))), IndexErrorKind.DUPLICATE_ID),
        (lambda: t.insert("c", np.ones(5)), IndexErrorKind.DIMENSION_MISMATCH),
        (lambda: t.insert_batch(["c"], np.ones((1, 3))), IndexErrorKind.DIMENSION_MISMATCH),
        (lambda: t.search(np.ones(3), 1), IndexErrorKind.DIMENSION_MISMATCH),
        (lambda: t.insert("c", [0, np.nan, 0, 0]), IndexErrorKind.INVALID_VECTOR),
        (lambda: t.remove("zz"), IndexErrorKind.NOT_FOUND),
        (lambda: tflat.FlatIndex(0, device="cpu"), IndexErrorKind.INVALID_CONFIGURATION),
        (lambda: tflat.FlatIndex(4, storage_dtype=torch.float16, device="cpu"),
         IndexErrorKind.INVALID_CONFIGURATION),
    ]
    for call, kind in cases:
        with pytest.raises(IndexError) as info:
            call()
        assert info.value.kind == kind
    t.save(str(tmp_path / "t.json"))
    for path, kind in ((tmp_path / "missing.vx", IndexErrorKind.IO_ERROR),
                       (tmp_path / "t.json", IndexErrorKind.CORRUPT_DATA)):  # no INDEXTPU magic
        with pytest.raises(IndexError) as info:
            tflat.FlatIndex.load_container(str(path), device="cpu")
        assert info.value.kind == kind
    assert t.search(np.ones(4), 0) == [] and tflat.FlatIndex(4, device="cpu").search(np.ones(4), 3) == []


def _jax_state(j):
    return {
        "vectors": j._vectors,
        "valid": j._valid,
        "metadata": list(j._metadata),
        "ids": list(j._idmap.items()),
        "free": list(j._free),
        "next_slot": j._next_slot,
        "dimension": j.dimension,
        "metric": j.metric.value,
        "storage_dtype": "bfloat16" if j.storage_dtype == jnp.bfloat16 else "float32",
    }


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_from_state_searches_the_same_slots(dtype, route):
    j = jflat.FlatIndex(D, JMetric.INNER_PRODUCT, storage_dtype=DTYPES[dtype][0])
    q = _populate(j)
    t = tflat.FlatIndex.from_state(_jax_state(j), device="cpu")
    assert t.storage_dtype == DTYPES[dtype][1] and t._free == j._free
    _assert_same(t.batch_search(q, K), j.batch_search(q, K + 1), Metric.INNER_PRODUCT)
    # both allocate the same slots afterwards
    j.insert("new", np.ones(D))
    t.insert("new", np.ones(D))
    assert t._idmap.lookup("new") == j._idmap.lookup("new")


def test_json_snapshot_crosses_packages(tmp_path):
    j, t = _pair(Metric.L2, "float32")
    q = _populate(j)
    _populate(t)
    j.save(tmp_path / "jax.json")
    t.save(tmp_path / "torch.json")
    assert (tmp_path / "jax.json").read_bytes() == (tmp_path / "torch.json").read_bytes()
    t2 = tflat.FlatIndex.load(tmp_path / "jax.json", device="cpu")
    j2 = jflat.FlatIndex.load(tmp_path / "torch.json")
    assert t2.count == j2.count == j.count
    _assert_same(t2.batch_search(q, K), j2.batch_search(q, K + 1), Metric.L2)
    _assert_same(t2.batch_search(q, K), j.batch_search(q, K + 1), Metric.L2)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_allow_ids_with_four_rows_in_one_class(dtype, route):
    """allow_ids lets through 4 rows of one residue class (slots 0, C, 2C,
    3C) and k=10: every route returns all 4, in brute-force order."""
    rng = np.random.default_rng(41)
    x = rng.standard_normal((2048, D)).astype(np.float32)
    q = rng.standard_normal((3, D)).astype(np.float32)
    t = tflat.FlatIndex(D, Metric.L2, storage_dtype=DTYPES[dtype][1], device="cpu")
    t.insert_batch(list(range(len(x))), x)
    allowed = [0, sf.C, 2 * sf.C, 3 * sf.C]
    res = t.batch_search(q, 10, allow_ids=set(allowed))
    xs = torch.from_numpy(x[allowed]).to(DTYPES[dtype][1]).double().numpy()
    want = np.array(allowed)[np.argsort(((q[:, None, :] - xs[None]) ** 2).sum(-1), axis=1)]
    assert [[r.id for r in row] for row in res] == want.tolist()


def test_fallback_splices_strict_results(monkeypatch):
    """Five copies of the best row in one residue class defeat K1's three
    tiers; the index re-runs that query through the strict path, whose ties
    break by row."""
    monkeypatch.setattr(tflat, "LARGE_SCAN_THRESHOLD", 1024)
    rng = np.random.default_rng(31)
    x = 10.0 * rng.standard_normal((2048, D)).astype(np.float32)
    q = 10.0 * rng.standard_normal((2, D)).astype(np.float32)
    for r in range(5):
        x[7 + r * sf.C] = q[0]
    t = tflat.FlatIndex(D, Metric.L2, device="cpu")
    t.insert_batch(list(range(len(x))), x)
    TELEM.reset()
    TELEM.enable()
    try:
        res = t.batch_search(q, 4)
    finally:
        TELEM.disable()
    counters = TELEM.snapshot()["counters"]
    assert counters["flat.verify_fallback"] == 1
    assert counters["kernel.scan_fused.calls"] == 1 and counters["kernel.scan_strict.calls"] == 1
    assert [r.id for r in res[0]] == [7 + r * sf.C for r in range(4)]



@pytest.mark.parametrize("dim, kernel", [(7264, "scan_fused"), (7265, "scan_fused")])
def test_rows_too_wide_for_the_kernels_take_the_strict_path(dim, kernel, monkeypatch):
    """Above the fused threshold a bf16 index runs K1+K2 at every width
    (scan_fused.scan_design names a kernel design for every d, as the JAX
    package routes by metric, k and capacity alone): past the first FMA
    design's d = 7,264 too, the top-k is exact and telemetry names the
    fused path alone."""
    monkeypatch.setattr(tflat, "LARGE_SCAN_THRESHOLD", 1024)
    monkeypatch.setattr(tflat, "VERIFIED_MIN_BLOCK", 1024)
    rng = np.random.default_rng(41)
    x = rng.standard_normal((300, dim)).astype(np.float32)
    q = rng.standard_normal((3, dim)).astype(np.float32)
    t = tflat.FlatIndex(dim, Metric.L2, storage_dtype=torch.bfloat16, device="cpu")
    t.insert_batch(list(range(len(x))), x)
    TELEM.reset()
    TELEM.enable()
    try:
        res = t.batch_search(q, 5)
    finally:
        TELEM.disable()
    counters = TELEM.snapshot()["counters"]
    assert counters[f"kernel.{kernel}.calls"] == 1
    assert sum(v for key, v in counters.items() if key.endswith(".calls")) == 1
    xb = torch.from_numpy(x).bfloat16().double().numpy()
    dist = ((q[:, None, :] - xb[None]) ** 2).sum(-1)
    want = np.argsort(dist, axis=1, kind="stable")[:, :6]  # rank 6 decides ties at rank 5
    want_d = np.take_along_axis(dist, want, axis=1)
    np.testing.assert_allclose([[r.score**2 for r in row] for row in res], want_d[:, :5],
                               rtol=RTOL, atol=ATOL)
    assert ids_match_up_to_ties([[r.id for r in row] for row in res], want, want_d, 5)


def test_wide_bf16_index_matches_jax_past_the_first_fma_limit(monkeypatch):
    """d = 7,265 bf16 (past the first FMA design's query block) above the
    fused threshold: the port's
    FlatIndex runs K1+K2 (their plain versions on the CPU) and the JAX
    FlatIndex its Pallas kernels (interpret mode) on the same numpy rows;
    distances within rtol=2e-4, atol=2e-5, ids equal up to ties."""
    monkeypatch.setenv("VECTORINDEX_TPU_FORCE_PALLAS_SCAN", "1")
    monkeypatch.setattr(jflat, "LARGE_SCAN_THRESHOLD", 1024)
    monkeypatch.setattr(tflat, "LARGE_SCAN_THRESHOLD", 1024)
    dim = 7265
    rng = np.random.default_rng(43)
    x = rng.standard_normal((300, dim)).astype(np.float32)
    q = x[:3] + 0.5 * rng.standard_normal((3, dim)).astype(np.float32)
    j = jflat.FlatIndex(dim, JMetric.L2, storage_dtype=jnp.bfloat16)
    t = tflat.FlatIndex(dim, Metric.L2, storage_dtype=torch.bfloat16, device="cpu")
    for idx in (j, t):
        idx.insert_batch(list(range(len(x))), x)
    assert t.capacity == j.capacity >= 1024
    TELEM.reset()
    TELEM.enable()
    try:
        got = t.batch_search(q, K)
    finally:
        TELEM.disable()
    counters = TELEM.snapshot()["counters"]
    assert counters["kernel.scan_fused.calls"] == 1
    assert sum(v for key, v in counters.items() if key.endswith(".calls")) == 1
    _assert_same(got, j.batch_search(q, K + 1), Metric.L2)
