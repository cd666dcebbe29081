"""The benchmark's parts on the CPU: seeding, the reference's top-k, the
metric arithmetic, the trace's reduction and the control."""

import statistics
import types

import numpy as np
import pytest
import torch

from conftest import TOY_CONFIGS

from portbench import compare, data, reference, roofline, trace
from portbench.control import control_numbers
from portbench.run import HERE, load_config, metric_reader

CPU = torch.device("cpu")


# --- data ---------------------------------------------------------------

def test_same_seed_same_bytes_other_seed_other_bytes():
    cfg = TOY_CONFIGS["toy-int-l2-bf16"]
    a_rows, a_q = data.make(cfg, 2**31 + 5, CPU)
    b_rows, b_q = data.make(cfg, 2**31 + 5, CPU)
    c_rows, _ = data.make(cfg, 2**31 + 6, CPU)
    assert np.array_equal(a_rows, b_rows) and np.array_equal(a_q, b_q)
    assert not np.array_equal(a_rows, c_rows)
    assert a_rows.shape == (cfg["rows"], cfg["dimension"]) and a_q.shape == (cfg["queries"], cfg["dimension"])


def test_integer_rows_are_uint8_valued_and_normalized_rows_unit():
    rows, q = data.make(TOY_CONFIGS["toy-int-l2-bf16"], 3, CPU)
    for x in (rows, q):
        assert np.array_equal(x, np.round(x)) and x.min() >= 0 and x.max() <= 255
        # exact in bf16, so bf16 storage keeps every row
        assert np.array_equal(torch.from_numpy(x).bfloat16().float().numpy(), x)
    rows, _ = data.make(TOY_CONFIGS["toy-f32-cos"], 3, CPU)
    np.testing.assert_allclose(np.linalg.norm(rows, axis=1), 1.0, rtol=1e-5)


def test_rows_do_not_depend_on_the_query_pool():
    cfg = dict(TOY_CONFIGS["toy-f32-cos"])
    rows_a, _ = data.make(cfg, 9, CPU)
    rows_b, _ = data.make(dict(cfg, queries=7), 9, CPU)
    assert np.array_equal(rows_a, rows_b)


def test_benchmark_configs_load():
    for name in ("bigann10m-flat-bf16", "cohere1m-flat-f32"):
        cfg = load_config(name, HERE)
        assert cfg["name"] == name and cfg["data"]["generator"] == "clustered"


# --- reference ------------------------------------------------------------

def _brute(rows, queries, metric, k):
    x, q = rows.astype(np.float64), queries.astype(np.float64)
    if metric == "l2":
        d = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    else:
        xn = x / np.linalg.norm(x, axis=1, keepdims=True)
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        d = 1.0 - qn @ xn.T
    ids = np.stack([np.lexsort((np.arange(len(x)), row))[:k] for row in d])
    return ids, np.take_along_axis(d, ids, 1)


def test_reference_breaks_ties_by_lowest_id(monkeypatch):
    monkeypatch.setattr(reference, "ROW_BLOCK", 7)  # ties straddle row blocks
    monkeypatch.setattr(reference, "QUERY_BLOCK", 2)
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 3, (50, 4)).astype(np.float32)  # many exact ties
    queries = rng.integers(0, 3, (5, 4)).astype(np.float32)
    ids, dist = reference.exact_topk(rows, queries, "l2", 10, CPU)
    want_ids, want_d = _brute(rows, queries, "l2", 10)
    assert np.array_equal(ids, want_ids) and np.array_equal(dist, want_d)


def test_reference_rounds_rows_to_bf16():
    rows = np.array([[1.0 + 2**-9, 0.0], [1.0 + 2**-7, 0.0]], dtype=np.float32)
    q = np.array([[1.0 + 2**-9, 0.0]], dtype=np.float32)
    ids, dist = reference.exact_topk(rows, q, "l2", 2, CPU)
    assert ids.tolist() == [[0, 1]] and dist[0, 0] == 0.0
    # stored in bf16, row 0 rounds to 1.0, and the query keeps its f32 value
    ids, dist = reference.exact_topk(rows, q, "l2", 2, CPU, row_precision="bfloat16")
    assert ids.tolist() == [[0, 1]] and dist[0, 0] == pytest.approx(2.0**-18)


def test_reference_cosine_matches_brute_force():
    rows, q = data.make(TOY_CONFIGS["toy-f32-cos"], 4, CPU)
    ids, dist = reference.exact_topk(rows, q[:6], "cosine", 10, CPU)
    want_ids, want_d = _brute(rows, q[:6], "cosine", 10)
    np.testing.assert_allclose(dist, want_d, rtol=0, atol=1e-12)
    assert (ids == want_ids).mean() > 0.99


def test_tf32_and_fp8_rounding():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-12, -(1.0 + 3 * 2**-11)])
    assert reference.round_to(x, "tf32").tolist() == [1.0, 1.0 + 2**-9, 1.0, -(1.0 + 2**-9)]
    assert reference.round_to(torch.tensor([17.0, 255.0]), "float8_e4m3").tolist() == [16.0, 256.0]


# --- the comparison ---------------------------------------------------------

def test_comparison_numbers():
    cfg = TOY_CONFIGS["toy-int-l2-bf16"]
    rows, queries = data.make(cfg, 1, CPU)
    ref = compare.reference_topk(rows, queries[:3], cfg, CPU)
    scores = reference.public_scores(ref[1], "l2")
    answers = [(i, list(zip(ref[0][i].tolist(), scores[i].tolist()))) for i in range(3)]
    qidx, ids, sc = compare.answer_arrays(answers, 10, cfg["rows"])
    found = compare.numbers(rows, queries, cfg, qidx, ids, sc, ref, CPU)
    assert found == {"missing": 0, "id_diff": 0, "rank_gap": 0.0, "score_err": 0.0}
    assert compare.numbers(rows, queries, cfg, qidx, ids, sc, ref, CPU, "recall") == {
        "missing": 0, "recall_loss": 0.0, "score_err": 0.0}
    # a repeated id, an id out of range and an answer that never came
    bad = list(answers[0][1])
    bad[3] = bad[2]
    bad[4] = (10**9, 1.0)
    answers = [(0, bad), (1, answers[1][1][::-1]), (2, None)]
    qidx, ids, sc = compare.answer_arrays(answers, 10, cfg["rows"])
    found = compare.numbers(rows, queries, cfg, qidx, ids, sc, ref, CPU)
    assert found["missing"] == 2 + 10
    assert found["id_diff"] >= 8 and found["rank_gap"] > 0
    ok, checks = compare.judge(found, cfg["limits"])
    assert not ok and checks["missing"] == {"value": 12, "limit": 0}


def test_recall_form_counts_places_within_the_kth_distance():
    """recall_loss counts a place as filled where its row lies within the
    reference's k-th distance, so a tied row at the k-th counts and a
    farther one does not; order within the k does not matter."""
    rows = np.array([[0.0], [1.0], [-1.0], [2.0], [3.0]], dtype=np.float32)
    q = np.array([[0.0]], dtype=np.float32)
    cfg = {"metric": "l2", "k": 3, "index": {"storage_dtype": "float32"}}
    ref = compare.reference_topk(rows, q, cfg, CPU)
    assert ref[0].tolist() == [[0, 1, 2]]

    def form(ids):
        sc = reference.public_scores(reference.distances_of(rows, q, np.array([ids]), "l2", CPU), "l2")
        answers = [(0, list(zip(ids, sc[0].tolist())))]
        qidx, a_ids, a_sc = compare.answer_arrays(answers, 3, len(rows))
        return compare.numbers(rows, q, cfg, qidx, a_ids, a_sc, ref, CPU, "recall")

    assert form([2, 0, 1])["recall_loss"] == 0.0
    assert form([0, 1, 3]) == {"missing": 0, "recall_loss": pytest.approx(1 / 3), "score_err": 0.0}


def test_reference_and_comparison_keep_to_the_allow_list(monkeypatch):
    """With an allow mask the reference answers from the allowed rows only,
    pads with -1 where fewer than k are allowed, and a result outside the
    mask counts as missing."""
    monkeypatch.setattr(reference, "ROW_BLOCK", 16)
    cfg = TOY_CONFIGS["toy-int-l2-bf16"]
    rows, queries = data.make(cfg, 8, CPU)
    allowed = np.random.default_rng(1).random(len(rows)) < 0.1
    ids, dist = reference.exact_topk(rows, queries[:4], "l2", 10, CPU, allowed=allowed)
    sub = np.flatnonzero(allowed)
    want_ids, want_d = _brute(rows[sub], queries[:4], "l2", 10)
    assert np.array_equal(ids, sub[want_ids]) and np.array_equal(dist, want_d)
    few = np.zeros(len(rows), dtype=bool)
    few[[3, 70]] = True
    ids, dist = reference.exact_topk(rows, queries[:2], "l2", 4, CPU, allowed=few)
    assert sorted(ids[0, :2].tolist()) == [3, 70] and ids[:, 2:].tolist() == [[-1, -1]] * 2
    assert np.isinf(dist[:, 2:]).all()
    # a program answer with both allowed rows is whole; one with a row
    # outside the list misses a place
    sc = reference.public_scores(dist, "l2")
    answers = [(0, list(zip(ids[0, :2].tolist(), sc[0, :2].tolist()))),
               (1, [(int(ids[1, 0]), float(sc[1, 0])), (5, 1.0)])]
    qidx, a_ids, a_sc = compare.answer_arrays(answers, 4, len(rows), few)
    found = compare.numbers(rows, queries, dict(cfg, k=4), qidx, a_ids, a_sc, (ids, dist), CPU)
    assert found["missing"] == 1 and found["id_diff"] == 0


@pytest.mark.parametrize("name", ["toy-int-l2-bf16", "toy-f32-cos"])
def test_control_fails_the_limits(name):
    """The reference in the next precision down, in the program's place,
    is not correct under the configuration's limits."""
    cfg = TOY_CONFIGS[name]
    found = control_numbers(cfg, 2**31 + 3, 200, CPU)
    ok, _ = compare.judge(found, cfg["limits"])
    assert not ok and found["missing"] == 0


# --- metric arithmetic --------------------------------------------------------

def _run(**kw):
    base = dict(cfg=load_config("bigann10m-flat-bf16", HERE), kind="NVIDIA H100 80GB HBM3", batch=256,
                k=10, setup_s=40.0, insert_s=30.0, calls=0, queries=0, wall_s=0.0, call_s=[],
                sizes=[], latency_s=[], stage_ms=[], flags=[], counters={}, trace=None)
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_rates_are_over_the_whole_window():
    # four calls of 256 in 2.0 s: a slow call counts with the rest
    r = _run(calls=4, queries=1024, wall_s=2.0, call_s=[0.1, 0.1, 0.1, 1.7])
    assert metric_reader("qps", HERE)(r) == 512.0
    assert metric_reader("setup_s", HERE)(r) == 40.0
    assert metric_reader("insert_s", HERE)(r) == 30.0


def test_latency_tail_is_over_every_request():
    """The p95 takes every request of the window: 100 calls of 1 ms and six
    of 50 ms put the tail on the slow ones, which a mean or a best-of would
    hide."""
    lat = [0.001] * 100 + [0.05] * 6
    r = _run(latency_s=lat)
    want = statistics.quantiles(lat, n=20)[18] * 1e3
    assert metric_reader("latency_p95_ms", HERE)(r) == pytest.approx(want) and want > 40
    assert metric_reader("latency_p95_ms", HERE)(_run(latency_s=[0.001])) is None


def test_roofline_bytes_and_operations_from_shapes():
    nbytes, ops = roofline.flat_scan_work(10_000_000, 128, "bfloat16", 256, 10)
    assert nbytes == 10_000_000 * 128 * 2 + 10_000_000 * 4 + 256 * 128 * 4 + 256 * 10 * 8
    assert ops == 2 * 256 * 10_000_000 * 128
    t, bound = roofline.least_seconds("NVIDIA H100 80GB HBM3", 10_000_000, 128, "bfloat16", 256, 10)
    assert bound == "bytes" and t == pytest.approx(nbytes / 3.35e12)
    t, bound = roofline.least_seconds("NVIDIA H100 80GB HBM3", 1_000_000, 768, "float32", 256, 10)
    assert bound == "operations" and t == pytest.approx(2 * 256 * 1_000_000 * 768 / 67e12)
    assert roofline.least_seconds("cpu", 10, 4, "float32", 1, 1) is None


def test_scan_roofline_and_api_host_time():
    """The roofline sums every call's least time over its span; the API's
    host time leaves out the calls that took the strict fallback."""
    least, _ = roofline.least_seconds("NVIDIA H100 80GB HBM3", 10_000_000, 128, "bfloat16", 256, 10)
    least1, _ = roofline.least_seconds("NVIDIA H100 80GB HBM3", 10_000_000, 128, "bfloat16", 1, 10)
    r = _run(calls=3, queries=513, wall_s=0.05, call_s=[0.012, 0.030, 0.003], sizes=[256, 256, 1],
             stage_ms=[{"score_flat": 4.0}, {"score_flat": 6.0, "rerank": 2.0}, {"score_flat": 2.0}],
             flags=[{"dot_trick"}, {"dot_trick", "verify_fallback"}, set()])
    value, note = metric_reader("scan_roofline.batch", HERE)(r)
    assert value == pytest.approx(100 * (2 * least + least1) / 0.012) and "bytes" in note
    assert metric_reader("api_host_ms.serial", HERE)(r) == pytest.approx((8.0 + 1.0) / 2)
    assert metric_reader("scan_roofline.batch", HERE)(_run()) is None
    assert metric_reader("api_host_ms.batch", HERE)(_run()) is None
    other = _run(cfg={"index": {"type": "ivf"}}, sizes=[1], stage_ms=[{"score_flat": 1.0}])
    assert metric_reader("scan_roofline.batch", HERE)(other) is None


def test_device_idle_and_trace_reduction():
    ev = lambda name, dev, s, e: types.SimpleNamespace(  # noqa: E731
        name=name, device_type="DeviceType.CUDA" if dev else "DeviceType.CPU",
        time_range=types.SimpleNamespace(start=s, end=e))
    events = [
        ev("portbench.call", False, 0, 1000), ev("aten::copy_", False, 300, 700),
        ev("void scan_wgmma_kernel<0, 2>(CUtensorMap)", True, 0, 200),
        ev("void scan_wgmma_kernel<0, 2>(CUtensorMap)", True, 150, 300),
        ev("Memcpy DtoH", True, 800, 900),
    ]
    s = trace.summarize(events)
    assert s["busy_s"] == pytest.approx(400e-6) and s["scan_kernels"] == 2
    assert s["device_ops"][0] == ["scan_wgmma_kernel", pytest.approx(350e-6)]
    assert s["idle_gaps"] == [["aten::copy_", pytest.approx(500e-6)]]
    r = _run(trace={"busy_s": 0.25, "window_s": 1.0})
    assert metric_reader("device_idle.batch", HERE)(r) == pytest.approx(75.0)
    assert metric_reader("device_idle.batch", HERE)(_run()) is None


def test_idle_gap_named_by_the_host_range_around_it():
    """A gap after hundreds of short host ops is named by the range that
    still runs around it, not by the ops that ended before it."""
    ev = lambda name, dev, s, e: types.SimpleNamespace(  # noqa: E731
        name=name, device_type="DeviceType.CUDA" if dev else "DeviceType.CPU",
        time_range=types.SimpleNamespace(start=s, end=e))
    events = [ev("portbench.call", False, 0, 10_000)]
    events += [ev("cudaLaunchKernel", False, i, i + 0.5) for i in range(300)]
    events += [ev("k", True, 0, 400), ev("k", True, 9_000, 9_500)]
    s = trace.summarize(events)
    assert s["idle_gaps"] == [["portbench.call", pytest.approx(8_600e-6)]]
